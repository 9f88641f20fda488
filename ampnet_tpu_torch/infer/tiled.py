"""Arbitrary-scale tiled inference with stitched per-point predictions,
counterpart of ``ampnet_tpu/infer/tiled.py``.

Per bucket of B same-shape clouds, one bucket program does everything on the
device, batched over the clouds as the JAX program is:

1. balanced k-means tiling on (x, y, NDVI) (``utils/utils.py:500-505``), each
   cloud's reductions over its own points,
2. static-shape cluster grouping via a stable argsort,
3. the window encoder + attention forward over ``[B, k, cap, F]``,
4. scatter of the predictions back to the original point order.

Static shapes come from replicate padding: the cloud is padded up to
``k × cap`` points by duplicating random real points (``np.random``, the
same draws as the JAX package); duplicate predictions are dropped on the way
out.

Dispatch and fetch are split for the serving loop. ``dispatch_many`` uploads
each bucket from pinned memory, enqueues its work and an asynchronous copy
of the results into pinned host memory, records a CUDA event, and returns
without waiting on the device: no ``.item()``, no ``.cpu()``, no
data-dependent shape. ``fetch_many`` waits on each bucket's event, so it may
run on another thread than the one that enqueued the work. All of it runs on
the device's current stream.

A bucket costs the same number of kernel launches whatever B is, so
concurrent requests share the launch cost, which bounds the tiling on the
host. In exact arithmetic a cloud's labels do not depend on its co-batched
clouds. In fp32 a batched reduction or matmul may take its sums in another
order than the same work at B = 1, so a few labels near a tie may differ,
as in the JAX package (whose program is compiled per padded batch shape).

Checkpoint ensembles: ``TiledInferencer`` takes a list of same-signature
models (one ``make_forward`` each, folded and prepared once) and averages their
softmax probabilities on the device per bucket; ``EnsembleInferencer``
averages on the host over member inferencers whose window geometry may
differ. ``evaluate_dataset`` is the tester behind ``test``: per-class IoU over
a dataset, one CSV row, optional figures and error analysis.

Any segmenter of the factory runs here under ``xla``; the command line
gives baseline, classic and PointNet++ ``max_clusters=1``, so a whole cloud is
one window (k = 1) of capacity ``n_points · 2^j``, as the JAX command does
(``ampnet_tpu/cli/main.py:589-611``).

Not ported yet: the mesh (``--num_devices``, ROADMAP.md Queue 1, item 5).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPNetConfig
from ampnet_tpu_torch.core.device import resolve_device
from ampnet_tpu_torch.core.logging import append_results_csv
from ampnet_tpu_torch.core.metrics import confusion_matrix, iou_from_confusion
from ampnet_tpu_torch.data.schema import SEG_CLASS_NAMES
from ampnet_tpu_torch.models.backends import make_forward
from ampnet_tpu_torch.ops.kmeans import balanced_kmeans, num_tiles_test

KMEANS_FEATURE_IDX = (0, 1, 8)  # x, y, NDVI of the 9-feature layout


def model_signature(model) -> tuple:
    """Ordered (state_dict key, shape) pairs: what stacking members share."""
    return tuple((k, tuple(v.shape)) for k, v in model.state_dict().items())


def dihedral_xy(points9: np.ndarray, t: int) -> np.ndarray:
    """Transform ``t`` (0–7) of the square's dihedral group applied to x, y:
    t % 4 counter-clockwise 90° rotations, then a mirror (x → −x) for t ≥ 4.
    Exact coordinate swaps/negations; every other feature is untouched."""
    out = np.array(points9, copy=True)
    x, y = out[:, 0].copy(), out[:, 1].copy()
    if t >= 4:
        x = -x
    for _ in range(t % 4):
        x, y = -y, x
    out[:, 0], out[:, 1] = x, y
    return out


def tta_ensemble(predict_probs, clouds, transforms: int, seeds=None,
                 votes: int = 1) -> list:
    """View ensemble behind every TTA surface: expand each cloud into its
    first T dihedral views × V re-tilings (distinct seeds), run ONE batched
    ``predict_probs(clouds, seeds) -> [(preds, probs), ...]`` over the
    expanded list, average class probabilities in float32, argmax the mean.
    T ≤ 8 because ``dihedral_xy`` has period 8.

    Returns ``[(preds int32, mean_probs float32), ...]`` in input order."""
    T, V = int(transforms), int(votes)
    if not 1 <= T <= 8:
        raise ValueError(
            f"tta transforms must be in 1..8 (dihedral_xy has period 8; more "
            f"would double-count views), got {T}"
        )
    if V < 1:
        raise ValueError(f"votes must be >= 1, got {V}")
    if seeds is None:
        seeds = list(range(len(clouds)))
    views = T * V
    expanded = [dihedral_xy(c, t) for c in clouds for t in range(T) for _ in range(V)]
    eseeds = [s * views + t * V + v for s in seeds for t in range(T) for v in range(V)]
    outs = predict_probs(expanded, eseeds)
    results = []
    for ci in range(len(clouds)):
        mean = np.mean(
            [np.asarray(outs[ci * views + j][1], np.float32) for j in range(views)],
            axis=0,
        )
        results.append((np.argmax(mean, axis=-1).astype(np.int32), mean))
    return results


class TiledInferencer:
    def __init__(
        self,
        model,
        cfg: AMPNetConfig,
        n_points: Optional[int] = None,
        max_clusters: Optional[int] = None,
        backend: str = "xla",
        tiler: str = "balanced",
        max_points_per_call: int = 2_000_000,
        transfer_dtype: Optional[str] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        # checkpoint ensemble: a list of same-signature models, each folded
        # and prepared once; _run_bucket averages their softmax on the device
        models = list(model) if isinstance(model, (list, tuple)) else [model]
        signature = model_signature(models[0])
        if any(model_signature(m) != signature for m in models[1:]):
            raise ValueError("stacked ensemble members must have the same parameter "
                             "names and shapes; wrap differing ones in EnsembleInferencer")
        self.ensemble = len(models)
        self.models = models
        self.cfg = cfg
        self.n_points = n_points or cfg.data.n_points
        self.max_clusters = max_clusters or cfg.data.max_clusters_test
        # 'balanced' = Sinkhorn rebalancing inside every Lloyd iteration;
        # 'fast' = plain Lloyd + one final balanced solve
        if tiler not in ("balanced", "fast"):
            raise ValueError(f"unknown tiler {tiler!r}")
        self.tiler = tiler
        self.backend = backend
        # host→device wire: float16 halves the bytes; int8 quarters them via
        # per-cloud per-column affine quantization (scale + offset ride
        # along as two [B, F] arrays). Compute stays fp32 on the device.
        self.transfer_dtype = np.dtype(transfer_dtype or np.float32)
        if self.transfer_dtype not in (np.dtype(np.float32), np.dtype(np.float16),
                                       np.dtype(np.int8)):
            raise ValueError(
                f"transfer_dtype must be float32, float16 or int8, "
                f"got {self.transfer_dtype}"
            )
        # clouds beyond this size are spatially halved and predicted per half
        self.max_points_per_call = max_points_per_call
        # every (k, cap, probs, batch) shape that has executed at least once;
        # serving tags requests whose micro-batch ran a new shape as cold
        # (first-use kernel build, allocator growth, library plans)
        self._warm_shapes: set = set()
        self._cold_count: int = 0
        self._forwards = [make_forward(m, cfg, backend, device=self.device) for m in models]

    def _mark_program(self, k: int, cap: int, probs: bool, b: int) -> bool:
        key = (k, cap, bool(probs), int(b))
        if key in self._warm_shapes:
            return False
        self._warm_shapes.add(key)
        self._cold_count += 1
        return True

    @property
    def cold_programs_seen(self) -> int:
        """Monotone count of bucket shapes run so far (serving stats)."""
        return self._cold_count

    def _cap_for(self, n: int, k: int) -> int:
        """Static per-cluster capacity: smallest ``n_points * 2**j >= ceil(n/k)``,
        so ``k*cap >= n`` always and the ladder stays O(max_clusters·log N)."""
        need = -(-n // k)  # ceil
        cap = self.n_points
        while cap < need:
            cap *= 2
        return cap

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            # pinned + non_blocking: a pageable upload would wait for the stream
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _run_bucket(self, k: int, cap: int, probs: bool, points, scale, offset, init):
        """One bucket program: ``points`` [B, k*cap, F] in the wire dtype on
        the device, ``init`` [B, k] k-means init indices (None for k = 1) →
        (labels [B, n] int8, probs [B, n, C] float16 or None) in each
        cloud's original point order."""
        b, n, f = points.shape
        int8_wire = self.transfer_dtype == np.dtype(np.int8)

        def to_f32(x, s, o):
            # wire decode: f16/f32 upcast; int8 is the affine dequant of
            # _encode_batch, per cloud (no index tensors: they would need an
            # upload)
            x = x.float()
            return (x + 127.0) * s[:, None, :] + o[:, None, :] if int8_wire else x

        if k > 1:
            pick = lambda t: torch.stack([t[..., c] for c in KMEANS_FEATURE_IDX], dim=-1)
            kfeats = to_f32(pick(points), pick(scale), pick(offset))
            assign, _ = balanced_kmeans(
                kfeats, k, capacities=(cap,) * k,
                lloyd_mode="argmin" if self.tiler == "fast" else "sinkhorn",
                init_idx=init,
            )
            order = torch.argsort(assign, dim=-1, stable=True)  # [B, n]
            # the reorder gather runs in the wire dtype; decode after it
            points = torch.gather(points, 1, order[..., None].expand(b, n, f))
        else:
            order = torch.arange(n, device=points.device).expand(b, n)
        windows = to_f32(points, scale, offset).reshape(b, k, cap, f)
        centroids = windows[..., :2].mean(dim=2)  # [B, k, 2]
        if self.ensemble == 1:
            logits = self._forwards[0](windows, centroids, None)
            preds = logits.argmax(dim=-1)
            p = torch.softmax(logits, dim=-1) if probs else None
        else:
            # mean of the members' fp32 softmax; labels are its argmax
            p = torch.stack([torch.softmax(fwd(windows, centroids, None).float(), dim=-1)
                             for fwd in self._forwards]).mean(dim=0)
            preds = p.argmax(dim=-1)
        # int8 labels (num_classes ≤ 127) quarter the result traffic
        preds = preds.reshape(b, n).to(torch.int8)
        flat = torch.zeros_like(preds).scatter_(1, order, preds)
        if not probs:
            return flat, None
        p = p.reshape(b, n, -1).to(torch.float16)
        pflat = torch.zeros_like(p).scatter_(1, order[..., None].expand_as(p), p)
        return flat, pflat

    def _init_idx(self, n: int, k: int, seed: int, given) -> torch.Tensor:
        """A cloud's [k] k-means init indices: ``given`` when not None, else
        the first k of a permutation from a generator seeded by ``seed``."""
        if given is not None:
            return self._upload(np.asarray(given, np.int64))
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return torch.randperm(n, generator=gen, device=self.device)[:k]

    def _encode_batch(self, rows: np.ndarray):
        """Wire-encode a [B, N, F] cloud batch → (encoded, scales, offsets).
        The int8 wire affine-quantizes per cloud per column:
        q = round((v−lo)/scale) − 127 with scale = (hi−lo)/254, decoded on the
        device as (q+127)·scale + lo; constant columns decode to lo exactly."""
        b, _, f = rows.shape
        if self.transfer_dtype != np.dtype(np.int8):
            return (rows.astype(self.transfer_dtype),
                    np.ones((b, f), np.float32), np.zeros((b, f), np.float32))
        lo = rows.min(axis=1).astype(np.float32)  # [B, F]
        hi = rows.max(axis=1).astype(np.float32)
        scale = (hi - lo) / 254.0
        safe = np.where(scale > 0, scale, 1.0)
        q = np.rint((rows.astype(np.float32) - lo[:, None, :]) / safe[:, None, :]).astype(np.int16)
        q = (q - 127).astype(np.int8)
        return q, scale, lo

    def predict(self, points9: np.ndarray, seed: int = 0, return_probs: bool = False):
        """Per-point class predictions for one [N, F] cloud of any size; with
        ``return_probs`` ``(preds [N], probs [N, num_classes] float16)``."""
        n = points9.shape[0]
        if n > self.max_points_per_call:
            # balanced spatial halving along the wider of x/y, recursing
            # until each piece fits one program
            axis = int(np.ptp(points9[:, 1]) > np.ptp(points9[:, 0]))
            order = np.argsort(points9[:, axis], kind="stable")
            half = n // 2
            a = self.predict(points9[order[:half]], seed, return_probs)
            b = self.predict(points9[order[half:]], seed + 1, return_probs)
            out = np.empty((n,), np.int32)
            if return_probs:
                probs = np.empty((n, a[1].shape[-1]), a[1].dtype)
                out[order[:half]], probs[order[:half]] = a
                out[order[half:]], probs[order[half:]] = b
                return out, probs
            out[order[:half]], out[order[half:]] = a, b
            return out
        return self.predict_many([points9], seeds=[seed], return_probs=return_probs)[0]

    def predict_tta(self, points9: np.ndarray, seed: int = 0, transforms: int = 4,
                    return_probs: bool = False, votes: int = 1):
        """Average class probabilities over the first ``transforms`` dihedral
        views (× ``votes`` re-tilings) of the cloud, argmax the mean."""
        T, V = int(transforms), int(votes)
        if T <= 1 and V <= 1:
            return self.predict(points9, seed, return_probs)
        ((preds, mean),) = tta_ensemble(
            lambda cs, sd: self.predict_many(cs, seeds=sd, return_probs=True),
            [points9], max(T, 1), seeds=[seed], votes=V,
        )
        if return_probs:
            return preds, mean.astype(np.float16)
        return preds

    def predict_many(self, clouds, seeds=None, return_probs: bool = False,
                     init_idx=None) -> list:
        """Predictions for a list of [N_i, F] clouds, same-bucket clouds
        sharing one dispatch. ``init_idx`` (one [k] index array per cloud,
        or None) fixes the k-means initialization, for tests."""
        return self.fetch_many(self.dispatch_many(clouds, seeds, return_probs, init_idx))

    def dispatch_many(self, clouds, seeds=None, return_probs: bool = False,
                      init_idx=None) -> dict:
        """Async half of ``predict_many``: upload + enqueue every bucket and
        return a pending handle at once. Mega-clouds that take the spatial
        halving path are resolved eagerly into the handle."""
        seeds = seeds or list(range(len(clouds)))
        results = [None] * len(clouds)
        buckets: Dict[tuple, list] = {}
        prepped = {}
        cold_before = self._cold_count
        for i, pc in enumerate(clouds):
            n = pc.shape[0]
            if n > self.max_points_per_call:
                results[i] = self.predict(pc, seeds[i], return_probs)
                continue
            k = num_tiles_test(n, self.n_points, self.max_clusters)
            cap = self._cap_for(n, k)
            rng = np.random.default_rng(seeds[i])
            dup = rng.integers(0, n, k * cap - n)  # k*cap >= n by construction
            prepped[i] = (np.concatenate([pc, pc[dup]], axis=0), n)
            buckets.setdefault((k, cap), []).append(i)

        calls = []
        for (k, cap), idxs in buckets.items():
            rows = np.stack([prepped[i][0] for i in idxs])
            self._mark_program(k, cap, return_probs, len(idxs))
            calls.append((k, cap, idxs, rows))

        def launch(call):
            k, cap, idxs, rows = call
            enc, scales, offsets = self._encode_batch(rows)
            pts, sc, off = self._upload(enc), self._upload(scales), self._upload(offsets)
            # grad mode is per thread: each launching thread sets its own
            with torch.inference_mode():
                init = None if k == 1 else torch.stack([
                    self._init_idx(k * cap, k, seeds[i], None if init_idx is None else init_idx[i])
                    for i in idxs])
                flat, pflat = self._run_bucket(k, cap, return_probs, pts, sc, off, init)
            if self.device.type != "cuda":
                return flat, pflat, None
            # results land in pinned host memory; the event marks the copy done
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                    if t is not None else None for t in (flat, pflat)]
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            return host[0], host[1], event

        if len(calls) > 1:
            # overlap per-bucket host prep and uploads across threads
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(len(calls), 8)) as ex:
                outs = list(ex.map(launch, calls))
        else:
            outs = [launch(c) for c in calls]
        pending = [(c[2], out) for c, out in zip(calls, outs)]
        return {
            "results": results,
            "pending": pending,
            "sizes": {i: prepped[i][1] for i in prepped},
            "return_probs": return_probs,
            # any bucket shape in this dispatch ran for the first time
            "cold": self._cold_count > cold_before,
        }

    def fetch_many(self, handle: dict) -> list:
        """Blocking half of ``predict_many``: wait for every pending bucket's
        results and slice off the replicate padding."""
        results, sizes = handle["results"], handle["sizes"]
        for idxs, (flat, pflat, event) in handle["pending"]:
            if event is not None:
                event.synchronize()
            flat = flat.numpy()
            pflat = pflat.numpy() if pflat is not None else None
            for row, i in enumerate(idxs):
                labels = flat[row, : sizes[i]].astype(np.int32)
                results[i] = ((labels, pflat[row, : sizes[i]].copy())
                              if handle["return_probs"] else labels)
        return results


class EnsembleInferencer:
    """Cross-family checkpoint ensemble: the mean of per-point class
    probabilities over member ``TiledInferencer``s that need not share
    window geometry (``n_points``, tiling). Each member scatters its
    predictions back to the original point order, so the host-side mean is
    index-exact. Same-signature members belong stacked inside one
    ``TiledInferencer``; this wrapper composes such groups.

    It has the ``TiledInferencer`` prediction surface (``predict``,
    ``predict_tta``, ``predict_many``, ``dispatch_many``, ``fetch_many``)
    and the serving attributes; ``dispatch_many`` enqueues every member's
    work before any fetch."""

    def __init__(self, members):
        members = list(members)
        if len(members) < 2:
            raise ValueError("EnsembleInferencer needs >= 2 members; a single "
                             "group belongs in TiledInferencer directly")
        ncs = {m.cfg.model.num_classes for m in members}
        if len(ncs) != 1:
            raise ValueError(f"ensemble members disagree on num_classes: {sorted(ncs)}")
        self.members = members
        # the first member stands in for geometry that members may not share
        self.cfg = members[0].cfg
        self.n_points = members[0].n_points
        self.backend = members[0].backend
        self.max_clusters = max(m.max_clusters for m in members)
        self.ensemble = sum(m.ensemble for m in members)

    @property
    def cold_programs_seen(self) -> int:
        return sum(m.cold_programs_seen for m in self.members)

    def dispatch_many(self, clouds, seeds=None, return_probs: bool = False) -> dict:
        # members always return probabilities: the mean needs them
        handles = [m.dispatch_many(clouds, seeds, return_probs=True) for m in self.members]
        return {
            "member_handles": handles,
            "return_probs": return_probs,
            "cold": any(h["cold"] for h in handles),
        }

    def fetch_many(self, handle: dict) -> list:
        per_member = [m.fetch_many(h) for m, h in zip(self.members, handle["member_handles"])]
        outs = []
        for i in range(len(per_member[0])):
            mean = np.mean([np.asarray(r[i][1], np.float32) for r in per_member], axis=0)
            preds = np.argmax(mean, axis=-1).astype(np.int32)
            outs.append((preds, mean.astype(np.float16)) if handle["return_probs"] else preds)
        return outs

    def predict_many(self, clouds, seeds=None, return_probs: bool = False) -> list:
        return self.fetch_many(self.dispatch_many(clouds, seeds, return_probs))

    def predict(self, points9: np.ndarray, seed: int = 0, return_probs: bool = False):
        return self.predict_many([points9], seeds=[seed], return_probs=return_probs)[0]

    def predict_tta(self, points9: np.ndarray, seed: int = 0, transforms: int = 4,
                    return_probs: bool = False, votes: int = 1):
        T, V = int(transforms), int(votes)
        if T <= 1 and V <= 1:
            return self.predict(points9, seed, return_probs)
        ((preds, mean),) = tta_ensemble(
            lambda cs, sd: self.predict_many(cs, seeds=sd, return_probs=True),
            [points9], max(T, 1), seeds=[seed], votes=V,
        )
        if return_probs:
            return preds, mean.astype(np.float16)
        return preds


EVAL_CHUNK = 16  # clouds that test and infer load and predict at once
PLOT_LIMIT = 8  # clouds that test --plot draws


def eval_chunks(n_clouds: int, views: int = 1) -> List[range]:
    """The chunks in which ``test`` and ``infer`` predict ``n_clouds`` clouds:
    ``EVAL_CHUNK`` clouds, shrunk by the ``views`` (tta × tile_votes) each
    cloud costs. A chunk's indices are also its clouds' seeds, so the two
    commands tile every cloud alike."""
    size = max(1, EVAL_CHUNK // views)
    return [range(s, min(s + size, n_clouds)) for s in range(0, n_clouds, size)]


def predict_chunk(inferencer, clouds, seeds, tta: int = 1, tile_votes: int = 1,
                  return_probs: bool = False) -> list:
    """One chunk's labels (with ``return_probs``, (labels, float16 probs)):
    ``predict_many`` on the chunk's seeds, or for tta × tile_votes > 1 the
    argmax of the mean probabilities over the views (``tta_ensemble``)."""
    if tta * tile_votes == 1:
        return inferencer.predict_many(clouds, seeds=seeds, return_probs=return_probs)
    outs = tta_ensemble(
        lambda cs, sd: inferencer.predict_many(cs, seeds=sd, return_probs=True),
        clouds, tta, seeds=seeds, votes=tile_votes)
    return [(p, mean.astype(np.float16)) if return_probs else p for p, mean in outs]


def evaluate_cloud(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> Dict:
    """Per-cloud metrics of the reference tester (test_pointnet_att_segmen.py:186-219):
    IoU of each class present, mIoU over the present classes, overall accuracy,
    and the confusion matrix (int64)."""
    cm = confusion_matrix(torch.as_tensor(np.asarray(preds)), torch.as_tensor(np.asarray(labels)),
                          num_classes)
    iou, valid = (t.numpy() for t in iou_from_confusion(cm))
    cm = cm.numpy()
    out = {"oa": float(np.diag(cm).sum() / max(cm.sum(), 1))}
    for c, name in enumerate(SEG_CLASS_NAMES[:num_classes]):
        out[f"iou_{name}"] = float(iou[c]) if valid[c] else float("nan")
    out["miou"] = float(iou[valid].mean()) if valid.any() else float("nan")
    out["confusion"] = cm
    return out


def evaluate_dataset(inferencer, dataset, out_csv: Optional[str] = None,
                     model_name: str = "ampnet_tpu_torch", plot_dir: Optional[str] = None,
                     tta: int = 1, tile_votes: int = 1,
                     analysis_dir: Optional[str] = None) -> Dict:
    """Evaluate every cloud of ``dataset`` (``EvalCloudDataset``): per-cloud
    rows, a dataset summary of per-class IoU, mIoU, OA and points/s, and one
    summary row appended to ``out_csv`` (test_pointnet_att_segmen.py:272-284).

    Clouds are loaded and predicted in ``eval_chunks`` with their indices as
    seeds; same-bucket clouds in a chunk share one dispatch. ``tta > 1``
    averages class probabilities over that many dihedral views,
    ``tile_votes > 1`` over that many tilings of each view
    (``predict_chunk``). ``plot_dir`` saves pred-vs-truth scatters and
    histograms of the first ``PLOT_LIMIT`` clouds and the dataset's class
    counts; ``analysis_dir`` writes ``analysis.json`` and ``confusion.png``
    (infer/analysis.py). Both need matplotlib, checked before any work."""
    tta, tile_votes = int(tta), int(tile_votes)
    if not 1 <= tta <= 8:
        raise ValueError(f"tta must be in 1..8 (dihedral period), got {tta}")
    if tile_votes < 1:
        raise ValueError(f"tile_votes must be >= 1, got {tile_votes}")
    if plot_dir or analysis_dir:
        from ampnet_tpu_torch.core.plotting import require_matplotlib

        require_matplotlib("plot_dir" if plot_dir else "analysis_dir")
    num_classes = inferencer.cfg.model.num_classes
    analyzer = None
    if analysis_dir:
        from ampnet_tpu_torch.infer.analysis import ErrorAnalysisAccumulator

        analyzer = ErrorAnalysisAccumulator(num_classes)
    rows: List[Dict] = []
    total_cm = np.zeros((num_classes, num_classes), np.int64)
    gt_counts = np.zeros(num_classes, np.int64)
    pred_counts = np.zeros(num_classes, np.int64)
    t0 = time.time()
    n_points_total = 0
    for idx in eval_chunks(len(dataset), tta * tile_votes):
        chunk = [dataset[j] for j in idx]
        chunk_preds = predict_chunk(inferencer, [s["points"] for s in chunk], list(idx),
                                    tta, tile_votes)
        for i, sample, preds in zip(idx, chunk, chunk_preds):
            m = evaluate_cloud(preds, sample["labels"], num_classes)
            total_cm += m.pop("confusion")
            if analyzer is not None:
                analyzer.update(sample["name"], sample["points"], sample["labels"], preds)
            n_points_total += len(preds)
            rows.append({"name": sample["name"], **m})
            if plot_dir:
                labels_np = np.asarray(sample["labels"]).astype(np.int64).ravel()
                valid_lbl = (labels_np >= 0) & (labels_np < num_classes)
                gt_counts += np.bincount(labels_np[valid_lbl], minlength=num_classes)
                # the same mask on both sides: predictions on ignore-labelled
                # points would inflate the predicted bars only
                pred_counts += np.bincount(np.asarray(preds).ravel()[valid_lbl],
                                           minlength=num_classes)[:num_classes]
            if plot_dir and i < PLOT_LIMIT:
                from ampnet_tpu_torch.core.plotting import (
                    plot_class_histograms,
                    plot_predictions_vs_truth,
                )

                os.makedirs(plot_dir, exist_ok=True)
                plot_predictions_vs_truth(
                    sample["points"][:, :3], preds, sample["labels"],
                    save_to=os.path.join(plot_dir, f"{sample['name']}.png"),
                    title=sample["name"])
                plot_class_histograms(
                    preds, save_to=os.path.join(plot_dir, f"{sample['name']}_hist.png"),
                    title=f"{sample['name']} predicted class counts")
        del chunk, chunk_preds
    elapsed = time.time() - t0

    iou, valid = (t.numpy() for t in iou_from_confusion(torch.from_numpy(total_cm)))
    summary = {
        "model": model_name,
        "n_points": inferencer.n_points,
        **{f"iou_{n}": (float(iou[c]) if valid[c] else float("nan"))
           for c, n in enumerate(SEG_CLASS_NAMES[:num_classes])},
        "miou": float(iou[valid].mean()) if valid.any() else float("nan"),
        "oa": float(np.diag(total_cm).sum() / max(total_cm.sum(), 1)),
        "inference_minutes": round(elapsed / 60, 4),
        "points_per_sec": round(n_points_total / max(elapsed, 1e-9), 1),
        "n_clouds": len(rows),
    }
    if plot_dir and rows:
        from ampnet_tpu_torch.core.plotting import plot_class_counts

        os.makedirs(plot_dir, exist_ok=True)
        plot_class_counts({"ground truth": gt_counts, "predicted": pred_counts},
                          save_to=os.path.join(plot_dir, "class_counts.png"),
                          title=f"{model_name}: dataset class balance (GT vs predicted)")
    result = {"summary": summary, "per_cloud": rows}
    if analyzer is not None:
        from ampnet_tpu_torch.infer.analysis import write_analysis

        report = analyzer.finalize()
        write_analysis(report, analysis_dir)
        result["analysis"] = report
    if out_csv:
        append_results_csv(out_csv, summary)
    return result
