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

Not ported yet: ``EnsembleInferencer``, ``evaluate_dataset`` and the mesh
(ROADMAP.md Queue 1, items 3 and 5).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPNetConfig
from ampnet_tpu_torch.core.device import resolve_device
from ampnet_tpu_torch.models.backends import make_forward
from ampnet_tpu_torch.ops.kmeans import balanced_kmeans, num_tiles_test

KMEANS_FEATURE_IDX = (0, 1, 8)  # x, y, NDVI of the 9-feature layout


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
        self.model = model
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
        self._forward = make_forward(model, cfg, backend, device=self.device)

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
        logits = self._forward(windows, centroids, None)
        preds = logits.argmax(dim=-1).reshape(b, n).to(torch.int8)
        # int8 labels (num_classes ≤ 127) quarter the result traffic
        flat = torch.zeros_like(preds).scatter_(1, order, preds)
        if not probs:
            return flat, None
        p = torch.softmax(logits, dim=-1).reshape(b, n, -1).to(torch.float16)
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
