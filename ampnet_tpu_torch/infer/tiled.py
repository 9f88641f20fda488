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
out. Each bucket's batch is padded as JAX pads it: to a power of two (then
to a multiple of the device count) with copies of its first cloud under
seed 0, whose labels are dropped, so a (k, cap) runs at most log2(B) batch
shapes.

The bucket program is JAX's jitted program, compiled once per shape, in CUDA
terms. ``_bucket_fn`` returns one runner per (device, k, cap, probs, rows per
device). On a CUDA device it is a ``_BucketGraph``: its first call runs the
body (``_run_bucket``) once on a side stream, to warm it up (kernel
attributes, library plans, allocator), and those outputs serve that call;
then it captures the body as a CUDA graph. Every later call copies the
wire-encoded points, scales, offsets and k-means inits into the graph's
static inputs and replays it: one ``cudaGraphLaunch`` where the body makes
~8,000 kernel launches. Three rules hold it together:

* the k-means inits are drawn outside the graph, from one seeded
  ``torch.Generator`` per cloud (a replay cannot draw new generator state),
  and copied into the graph's static ``init``;
* every graph of a device allocates from one memory pool, so a block may be
  one graph's static output and another graph's scratch: a replay's outputs
  are copied into fresh pinned host memory, on the stream, before any other
  replay of that device starts;
* one lock per device, held from the first copy into a static input until
  the event after the copy-out is recorded, gives that order on the
  device's stream across the dispatch pool's threads, the serving worker
  and shards that share a card. Captures take the same lock and capture
  thread-locally, so another thread's event waits and pinned allocations
  do not break them.

A capture that fails raises: no CUDA tensor runs the eager body after it,
and nothing turns the graphs off. On the CPU the runner is the eager body.
The kernels' launch counters count a replay's launches (``ops/launch_count.py``).

The body stamps the device's clock three times (``ops/device_stamp.py``):
before the k-means features, after the reorder gather and after the
scatter. The stamps leave with the labels through the per-replay copy into
pinned memory, so a later replay cannot overwrite them (an event recorded
inside the graph could be), and ``fetch_many`` turns them into
``device.tiling`` and ``device.forward`` spans. ``dispatch_many`` and the
runner record the host's stages as spans too, into the ``Spans`` a caller
passes (``core/profiling.py``; the server's, ``infer/server.py``).

Dispatch and fetch are split for the serving loop. ``dispatch_many`` uploads
each bucket from pinned memory, enqueues its work and an asynchronous copy
of the results into pinned host memory, records a CUDA event, and returns
without waiting on the device: no ``.item()``, no ``.cpu()``, no
data-dependent shape. ``fetch_many`` waits on each bucket's event, so it may
run on another thread than the one that enqueued the work. All of it runs on
the device's current stream (the graph's first call also synchronizes the
device once, to capture).

A bucket costs one graph launch whatever B is, so concurrent requests share
it. In exact arithmetic a cloud's labels do not depend on its co-batched
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

Several devices (``devices=[...]``, ``serve --num_devices``): the model,
with its folded and prepared chains, is placed once on each distinct device,
each bucket's padded batch is split into contiguous shards that run on their
devices, each shard one bucket forward; ``fetch_many`` joins them. One
process drives the list, as the JAX mesh's single controller does; clouds
are independent, so no collective is needed. A shard's labels equal
``predict_many`` on one device over the same clouds and seeds. Shards that
share a device share its graph.
"""

from __future__ import annotations

import copy
import functools
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPNetConfig
from ampnet_tpu_torch.core.device import resolve_device
from ampnet_tpu_torch.core.logging import append_results_csv
from ampnet_tpu_torch.core.metrics import confusion_matrix, iou_from_confusion
from ampnet_tpu_torch.core.profiling import NO_SPANS, Spans
from ampnet_tpu_torch.data.schema import SEG_CLASS_NAMES
from ampnet_tpu_torch.models.backends import make_forward
from ampnet_tpu_torch.ops.device_stamp import device_stamp
from ampnet_tpu_torch.ops.kmeans import balanced_kmeans, num_tiles_test
from ampnet_tpu_torch.ops.launch_count import add_launches, recording

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


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:<i>``; other devices as they are."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


# per CUDA device: the lock, the memory pool and the capture stream that all
# of its bucket graphs share (``_BucketGraph``)
_GRAPH_DEVICES: Dict[torch.device, tuple] = {}
_GRAPH_DEVICES_LOCK = threading.Lock()


def _graph_device(dev: torch.device) -> tuple:
    with _GRAPH_DEVICES_LOCK:
        if dev not in _GRAPH_DEVICES:
            with torch.cuda.device(dev):
                _GRAPH_DEVICES[dev] = (threading.Lock(), torch.cuda.graph_pool_handle(),
                                       torch.cuda.Stream(dev))
        return _GRAPH_DEVICES[dev]


class _BucketGraph:
    """One bucket shape's body on a CUDA device, captured as a CUDA graph on
    its first call and replayed on every later one (module docstring)."""

    def __init__(self, body, device: torch.device):
        self.body, self.device = body, device
        self.lock, self.pool, self.stream = _graph_device(device)
        self.inputs = None  # static: points, scale, offset, init (or None)
        self.graph = self.outputs = None
        self.launches: dict = {}  # kernel launches of one replay, by wrapper

    def __call__(self, points, scale, offset, init, spans: Spans = NO_SPANS):
        """``points`` [B, k·cap, F] in the wire dtype, ``scale`` and
        ``offset`` [B, F] (pinned host tensors) and ``init`` ([B, k] int64 on
        the device, or None) → (labels, probs or None, device stamps) in
        fresh pinned host memory, and the event recorded after their copy.
        ``spans`` gets ``graph.lock_wait`` and the call under the lock,
        ``graph.replay`` or, on the first call, ``graph.capture``."""
        given = (points, scale, offset, init)
        t0 = time.perf_counter_ns()
        with self.lock, torch.cuda.device(self.device), torch.inference_mode():
            t1 = time.perf_counter_ns()
            spans.add("graph.lock_wait", t0, t1)
            captured = self.graph is None
            stream = torch.cuda.current_stream(self.device)
            if self.inputs is None:
                self.inputs = tuple(None if t is None else torch.empty_like(t, device=self.device)
                                    for t in given)
            for dst, src in zip(self.inputs, given):
                if dst is not None:
                    dst.copy_(src, non_blocking=True)
            if self.graph is None:
                outputs = self._capture(stream)
            else:
                self.graph.replay()
                add_launches(self.launches)
                outputs = self.outputs
            # copied out before the lock is released: the device's next
            # replay may write these blocks
            host = tuple(None if t is None else
                         torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                             t, non_blocking=True) for t in outputs)
            event = torch.cuda.Event()
            event.record(stream)
            spans.add("graph.capture" if captured else "graph.replay", t1,
                      time.perf_counter_ns())
        return (*host, event)

    def _capture(self, stream):
        """The warm-up, whose outputs this call returns, then the capture."""
        self.stream.wait_stream(stream)
        with torch.cuda.stream(self.stream):
            warm = self.body(*self.inputs)
        stream.wait_stream(self.stream)
        for t in warm:
            if t is not None:
                t.record_stream(stream)
        graph = torch.cuda.CUDAGraph()
        # the launches a capture records run on each replay, not now
        with recording() as launches, torch.cuda.graph(
                graph, pool=self.pool, stream=self.stream, capture_error_mode="thread_local"):
            outputs = self.body(*self.inputs)
        self.graph, self.outputs, self.launches = graph, outputs, launches
        return warm


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
        devices=None,
    ):
        # the devices the bucket batches shard over (``device`` alone by
        # default), each with its index: a bucket finds its forwards by the
        # device its points are on
        self.devices = [_indexed(resolve_device(d)) for d in (devices or [device])]
        self.device = self.devices[0]
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
        # every (k, cap, probs, padded batch) shape that has run at least
        # once, as JAX counts its compiled programs; serving tags requests
        # whose micro-batch ran a new shape as cold (a graph capture)
        self._warm_shapes: set = set()
        self._cold_count: int = 0
        # the bucket runners (``_bucket_fn``) by (device, k, cap, probs, rows)
        self._runners: dict = {}
        self._runners_lock = threading.Lock()
        # each distinct device holds its own copy of the members, prepared once
        self._forwards_on = {}
        for i, dev in enumerate(dict.fromkeys(self.devices)):
            placed = models if i == 0 else [copy.deepcopy(m) for m in models]
            self._forwards_on[dev] = [make_forward(m, cfg, backend, device=dev) for m in placed]

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

    def _run_bucket(self, k: int, cap: int, probs: bool, points, scale, offset, init):
        """A bucket's body, what its graph captures: ``points`` [B, k*cap, F]
        in the wire dtype on one of the devices, ``init`` [B, k] k-means init
        indices (None for k = 1) → (labels [B, n] int8, probs [B, n, C]
        float16 or None) in each cloud's original point order, and ``stamps``
        [3] int64: the device's clock (``ops/device_stamp.py``) before the
        k-means features, after the reorder gather (tiling done) and after
        the scatter (forward, argmax and scatter done)."""
        b, n, f = points.shape
        int8_wire = self.transfer_dtype == np.dtype(np.int8)
        stamps = torch.empty(3, dtype=torch.int64, device=points.device)
        device_stamp(stamps, 0)

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
        device_stamp(stamps, 1)
        windows = to_f32(points, scale, offset).reshape(b, k, cap, f)
        centroids = windows[..., :2].mean(dim=2)  # [B, k, 2]
        forwards = self._forwards_on[points.device]
        if self.ensemble == 1:
            logits = forwards[0](windows, centroids, None)
            preds = logits.argmax(dim=-1)
            p = torch.softmax(logits, dim=-1) if probs else None
        else:
            # mean of the members' fp32 softmax; labels are its argmax
            p = torch.stack([torch.softmax(fwd(windows, centroids, None).float(), dim=-1)
                             for fwd in forwards]).mean(dim=0)
            preds = p.argmax(dim=-1)
        # int8 labels (num_classes ≤ 127) quarter the result traffic
        preds = preds.reshape(b, n).to(torch.int8)
        flat = torch.zeros_like(preds).scatter_(1, order, preds)
        pflat = None
        if probs:
            p = p.reshape(b, n, -1).to(torch.float16)
            pflat = torch.zeros_like(p).scatter_(1, order[..., None].expand_as(p), p)
        device_stamp(stamps, 2)
        return flat, pflat, stamps

    def _bucket_fn(self, k: int, cap: int, probs: bool, device: torch.device, b: int):
        """The runner of a bucket of ``b`` clouds on ``device``, made once:
        ``run(points, scale, offset, init)``. On the CPU it is the eager body
        (→ labels, probs or None, stamps); on a CUDA device a ``_BucketGraph``
        (→ labels, probs or None, stamps in pinned host memory, and an event;
        it also takes the call's ``spans``)."""
        body = functools.partial(self._run_bucket, k, cap, probs)
        if device.type != "cuda":
            return body
        key = (device, k, cap, bool(probs), b)
        with self._runners_lock:
            if key not in self._runners:
                self._runners[key] = _BucketGraph(body, device)
            return self._runners[key]

    def _init_idx(self, n: int, k: int, seed: int, given, device) -> torch.Tensor:
        """A cloud's [k] k-means init indices on ``device``: ``given`` when not
        None, else the first k of a permutation from a generator seeded by
        ``seed``."""
        if given is not None:
            t = torch.from_numpy(np.asarray(given, np.int64))
            # pinned + non_blocking: a pageable upload would wait for the stream
            return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
        gen = torch.Generator(device=device).manual_seed(int(seed))
        return torch.randperm(n, generator=gen, device=device)[:k]

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
                     init_idx=None, spans: Spans = NO_SPANS) -> list:
        """Predictions for a list of [N_i, F] clouds, same-bucket clouds
        sharing one dispatch. ``init_idx`` (one [k] index array per cloud,
        or None) fixes the k-means initialization, for tests."""
        return self.fetch_many(self.dispatch_many(clouds, seeds, return_probs, init_idx, spans))

    def dispatch_many(self, clouds, seeds=None, return_probs: bool = False,
                      init_idx=None, spans: Spans = NO_SPANS) -> dict:
        """Async half of ``predict_many``: upload + enqueue every bucket and
        return a pending handle at once. Mega-clouds that take the spatial
        halving path are resolved eagerly into the handle.

        ``spans`` gets the stages: ``dispatch.pad`` (replicate padding and
        the batch's power-of-two copies), then per bucket call
        ``dispatch.encode``, ``dispatch.init`` (the k-means starts),
        ``dispatch.pin`` (on a card) and ``dispatch.launch`` (the bucket's
        runner, whose graph records under it); ``fetch_many`` records at the
        top of the same group."""
        seeds = seeds or list(range(len(clouds)))
        results = [None] * len(clouds)
        buckets: Dict[tuple, list] = {}
        prepped = {}
        cold_before = self._cold_count
        for i, pc in enumerate(clouds):
            if pc.shape[0] > self.max_points_per_call:
                results[i] = self.predict(pc, seeds[i], return_probs)

        calls = []
        nd = len(self.devices)
        real_points = device_points = 0
        with spans.span("dispatch.pad"):
            for i, pc in enumerate(clouds):
                n = pc.shape[0]
                if n > self.max_points_per_call:
                    continue
                k = num_tiles_test(n, self.n_points, self.max_clusters)
                cap = self._cap_for(n, k)
                rng = np.random.default_rng(seeds[i])
                dup = rng.integers(0, n, k * cap - n)  # k*cap >= n by construction
                prepped[i] = (np.concatenate([pc, pc[dup]], axis=0), n)
                buckets.setdefault((k, cap), []).append(i)
                real_points += n
            for (k, cap), idxs in buckets.items():
                rows = np.stack([prepped[i][0] for i in idxs])
                # JAX's padding: a power of two, so a (k, cap) runs at most
                # log2(B) batch shapes, then a multiple of the device count; the
                # copies of the first cloud (seed 0) have their labels dropped
                b_pad = 1 << (len(idxs) - 1).bit_length()
                b_pad = -(-b_pad // nd) * nd
                if b_pad > len(idxs):
                    rows = np.concatenate([rows, np.repeat(rows[:1], b_pad - len(idxs), axis=0)])
                self._mark_program(k, cap, return_probs, b_pad)
                device_points += b_pad * k * cap
                per = b_pad // nd  # contiguous shards
                for d, dev in enumerate(self.devices):
                    calls.append((k, cap, idxs[d * per:(d + 1) * per],
                                  rows[d * per:(d + 1) * per], dev))

        def launch(call):
            k, cap, idxs, rows, dev = call
            with spans.span("dispatch.encode"):
                wire = [torch.from_numpy(np.ascontiguousarray(a))
                        for a in self._encode_batch(rows)]
            run = self._bucket_fn(k, cap, return_probs, dev, len(rows))
            # grad mode is per thread: each launching thread sets its own
            with torch.inference_mode():
                init = None
                if k > 1:
                    with spans.span("dispatch.init"):
                        init = torch.stack([
                            self._init_idx(k * cap, k, seeds[i],
                                           None if init_idx is None else init_idx[i], dev)
                            for i in idxs] + [self._init_idx(k * cap, k, 0, None, dev)]
                            * (len(rows) - len(idxs)))
                if dev.type != "cuda":
                    with spans.span("dispatch.launch"):
                        return (*run(*wire, init), None)
                # pinned: the copies into the graph's inputs leave the host at once
                with spans.span("dispatch.pin"):
                    wire = [t.pin_memory() for t in wire]
                with spans.span("dispatch.launch") as under:
                    return run(*wire, init, under)

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
            # the bucket calls' real points and their points on the device
            "points": (real_points, device_points),
            "spans": spans.top,
        }

    def fetch_many(self, handle: dict) -> list:
        """Blocking half of ``predict_many``: wait for every pending bucket's
        results and slice off the replicate padding. Records, per bucket
        call, ``batch.fetch_wait``, ``batch.unpack`` and the device's
        ``device.tiling`` and ``device.forward`` from its stamps."""
        results, sizes, spans = handle["results"], handle["sizes"], handle["spans"]
        for idxs, (flat, pflat, stamps, event) in handle["pending"]:
            if event is not None:
                with spans.span("batch.fetch_wait"):
                    event.synchronize()
            with spans.span("batch.unpack"):
                flat = flat.numpy()
                pflat = pflat.numpy() if pflat is not None else None
                for row, i in enumerate(idxs):
                    labels = flat[row, : sizes[i]].astype(np.int32)
                    results[i] = ((labels, pflat[row, : sizes[i]].copy())
                                  if handle["return_probs"] else labels)
            t0, t1, t2 = stamps.tolist()
            spans.add("device.tiling", t0, t1, clock="device")
            spans.add("device.forward", t1, t2, clock="device")
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

    def dispatch_many(self, clouds, seeds=None, return_probs: bool = False,
                      spans: Spans = NO_SPANS) -> dict:
        # members always return probabilities: the mean needs them
        handles = [m.dispatch_many(clouds, seeds, return_probs=True, spans=spans)
                   for m in self.members]
        return {
            "member_handles": handles,
            "return_probs": return_probs,
            "cold": any(h["cold"] for h in handles),
            "points": tuple(map(sum, zip(*(h["points"] for h in handles)))),
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


def eval_chunks(n_clouds: int, views: int = 1, chunk_size: int = EVAL_CHUNK) -> List[range]:
    """The chunks in which ``test`` and ``infer`` predict ``n_clouds`` clouds:
    ``chunk_size`` clouds, shrunk by the ``views`` (tta × tile_votes) each
    cloud costs. A chunk's indices are also its clouds' seeds, so the two
    commands tile every cloud alike."""
    size = max(1, chunk_size // views)
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
                     plot_limit: int = PLOT_LIMIT, chunk_size: int = EVAL_CHUNK,
                     tta: int = 1, tile_votes: int = 1,
                     analysis_dir: Optional[str] = None) -> Dict:
    """Evaluate every cloud of ``dataset`` (``EvalCloudDataset``): per-cloud
    rows, a dataset summary of per-class IoU, mIoU, OA and points/s, and one
    summary row appended to ``out_csv`` (test_pointnet_att_segmen.py:272-284).

    Clouds are loaded and predicted in ``eval_chunks`` of ``chunk_size``
    with their indices as seeds; same-bucket clouds in a chunk share one
    dispatch. ``tta > 1`` averages class probabilities over that many
    dihedral views, ``tile_votes > 1`` over that many tilings of each view
    (``predict_chunk``). ``plot_dir`` saves pred-vs-truth scatters and
    histograms of the first ``plot_limit`` clouds and the dataset's class
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
    for idx in eval_chunks(len(dataset), tta * tile_votes, chunk_size):
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
            if plot_dir and i < plot_limit:
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
