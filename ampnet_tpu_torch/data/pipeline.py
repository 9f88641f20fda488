"""Host input pipeline: padded static-shape batches, the port's own copy of
``ampnet_tpu/data/pipeline.py`` (``pad_windowed_sample``, ``PaddedBatcher``,
``SingleCloudBatcher``, ``HostShardedBatcher``, ``global_device_batch``,
``pad_to_multiple``, ``to_device_batch``). Contract of every batch::

    points     [B, W, N, F] float32  — windows replicate-padded to W=max_windows
    labels     [B, W, N]    int32    — padded windows are all −1 (loss-ignored)
    centroids  [B, W, 2]    float32  — replicate-padded
    cls_label  [B]          int32    — only for classification datasets
    names      list[str]             — host-side only

Point-axis resampling uses ONE index list shared across a cloud's windows, as
the reference collate does (``collate_fns.py:33-41``). Batches are built by a
background thread into a bounded queue (``prefetch`` batches ahead), so host
work overlaps the card's steps; ``workers`` > 0 loads the samples in a
forked process pool (the reference's DataLoader ``num_workers``). The
workers only read samples on the host: they never touch the card. The
training path usually reads its batches from the GPU-resident cache
(data/device_cache.py), which builds each sample once.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

_POOL_DATASET = None


def _pool_init(dataset) -> None:
    global _POOL_DATASET
    _POOL_DATASET = dataset


def _pool_get(i: int):
    return _POOL_DATASET[i]


def pad_windowed_sample(
    sample: Dict[str, np.ndarray],
    n_points: int,
    max_windows: int,
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """Resample the point axis to ``n_points`` (with replacement below it,
    without above it) and replicate-pad windows to ``max_windows`` with
    labels −1 (collate_seq_padd semantics)."""
    pts, lbl, cent = sample["points"], sample["labels"], sample["centroids"]
    w, n, _ = pts.shape
    if n < n_points:
        idx = rng.integers(0, n, n_points)
    elif n > n_points:
        idx = rng.permutation(n)[:n_points]
    else:
        idx = None
    if idx is not None:
        pts, lbl = pts[:, idx, :], lbl[:, idx]
    if w > max_windows:
        pts, lbl, cent = pts[:max_windows], lbl[:max_windows], cent[:max_windows]
        w = max_windows
    if w < max_windows:
        reps = max_windows - w
        pts = np.concatenate([pts, np.repeat(pts[-1:], reps, axis=0)], axis=0)
        cent = np.concatenate([cent, np.repeat(cent[-1:], reps, axis=0)], axis=0)
        lbl = np.concatenate([lbl, np.full((reps, n_points), -1, lbl.dtype)], axis=0)
    return dict(sample, points=pts, labels=lbl, centroids=cent)


def pad_to_multiple(batch: Dict, multiple: int) -> Dict:
    """Pad a short host batch up to a multiple of ``multiple`` clouds by
    replicating earlier samples with all labels −1 (loss-ignored), so the
    ranks and micro-batches split it evenly."""
    b = batch["points"].shape[0]
    if multiple <= 1 or b % multiple == 0:
        return batch
    idx = np.arange(multiple - b % multiple) % b
    out = dict(batch)
    for k in ("points", "centroids"):
        out[k] = np.concatenate([batch[k], batch[k][idx]], axis=0)
    for k in ("labels", "cls_label"):  # padded clouds carry no loss or metric weight
        if k in batch:
            out[k] = np.concatenate([batch[k], np.full_like(batch[k][idx], -1)])
    out["names"] = batch["names"] + [f"<pad:{batch['names'][i]}>" for i in idx]
    return out


class PaddedBatcher:
    """Iterable over static-shape batches. Epoch e draws its order and its
    resampling from ``np.random.default_rng(seed + e)``, as the JAX batcher
    does, so both packages see the same batches for the same seed.

    ``repeats`` (rare-class oversampling): sample i appears ``repeats[i]``
    times in every epoch's pool before the shuffle, and ``len()`` counts the
    repeated pool. ``prefetch`` batches are built ahead by a thread (0: in
    the iterating thread); ``workers`` > 0 loads samples in a forked pool,
    ended by ``close()``. Neither changes a batch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        n_points: int = 2048,
        max_windows: int = 9,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        pad_to_multiple: int = 1,
        prefetch: int = 2,
        workers: int = 0,
        repeats=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_points = n_points
        self.max_windows = max_windows
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.pad_to_multiple = pad_to_multiple
        self.prefetch = prefetch
        self.workers = workers
        self._pool = None
        self.epoch = 0
        if repeats is not None:
            repeats = np.asarray(repeats, np.int64)
            if repeats.shape != (len(dataset),) or (repeats < 1).any():
                raise ValueError("repeats must hold one positive int per dataset sample")
        self.repeats = repeats

    def _base_indices(self) -> np.ndarray:
        """The epoch's pool before the shuffle: each sample at its multiplicity."""
        return repeated_indices(len(self.dataset), self.repeats)

    def __len__(self) -> int:
        n = len(self._base_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_order(self, rng: np.random.Generator) -> np.ndarray:
        """Sample order for one epoch; ``HostShardedBatcher`` takes its slice."""
        order = self._base_indices()
        if self.shuffle:
            rng.shuffle(order)
        return order

    def _load_samples(self, idxs) -> list:
        if self.workers <= 0:
            return [self.dataset[int(i)] for i in idxs]
        if self._pool is None:
            import multiprocessing as mp

            self._pool = mp.get_context("fork").Pool(
                self.workers, initializer=_pool_init, initargs=(self.dataset,))
        return self._pool.map(_pool_get, [int(i) for i in idxs])

    def close(self) -> None:
        """End the worker pool, if one was started."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def _windowed(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A dataset sample in the windowed ``[W, N, F]`` layout."""
        return sample

    def _make_batches(self, rng: np.random.Generator) -> Iterator[Dict]:
        order = self._epoch_order(rng)
        for b in range(len(self)):
            idxs = order[b * self.batch_size: (b + 1) * self.batch_size]
            samples = [pad_windowed_sample(self._windowed(s), self.n_points, self.max_windows, rng)
                       for s in self._load_samples(idxs)]
            batch = {
                "points": np.stack([s["points"] for s in samples]),
                "labels": np.stack([s["labels"] for s in samples]),
                "centroids": np.stack([s["centroids"] for s in samples]),
                "names": [s["name"] for s in samples],
            }
            if "cls_label" in samples[0]:
                batch["cls_label"] = np.asarray([s["cls_label"] for s in samples])
            yield pad_to_multiple(batch, self.pad_to_multiple)

    def __iter__(self) -> Iterator[Dict]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        if self.prefetch <= 0:
            yield from self._make_batches(rng)
            return
        yield from _prefetched(self._make_batches(rng), self.prefetch)


class SingleCloudBatcher(PaddedBatcher):
    """Batches of whole clouds (``CloudDataset``): each cloud is a one-window
    sample, so the same ``[B, W, N, F]`` contract serves the baseline models
    (W = 1; the default 4096 points are the JAX batcher's)."""

    def __init__(self, dataset, batch_size: int, n_points: int = 4096, **kw):
        super().__init__(dataset, batch_size, n_points=n_points, max_windows=1, **kw)

    def _windowed(self, sample):
        pts, lbl = sample["points"][None], sample["labels"][None]  # [1, N, F], [1, N]
        return dict(sample, points=pts, labels=lbl, centroids=pts[:, :, :2].mean(axis=1))


class HostShardedBatcher(PaddedBatcher):
    """Per-host shard loading for multi-process training (JAX
    ``data/pipeline.py::HostShardedBatcher``): every host draws the SAME
    seeded global epoch permutation, then loads only its ``1 / host_count``
    contiguous block of each global batch, so the union of the hosts' batches
    is the single-host epoch. Each host resamples its own clouds from the
    epoch's generator in its own order, as the JAX batcher does.
    ``host_id`` / ``host_count`` default to the process group's rank and
    world size (0 / 1 without a group). Host h's block is what
    ``parallel/mesh.py::rank_rows`` gives rank h at ``grad_accum`` 1."""

    def __init__(self, dataset, global_batch_size: int, host_id: Optional[int] = None,
                 host_count: Optional[int] = None, **kw):
        group = dist.is_initialized()
        if host_id is None:
            host_id = dist.get_rank() if group else 0
        if host_count is None:
            host_count = dist.get_world_size() if group else 1
        if global_batch_size % host_count:
            raise ValueError(f"global_batch_size {global_batch_size} not divisible by "
                             f"host_count {host_count}")
        if kw.get("drop_last") is False:
            # a partial global batch cannot be split evenly across hosts
            raise ValueError("HostShardedBatcher requires drop_last=True")
        self.host_id = host_id
        self.host_count = host_count
        self.global_batch_size = global_batch_size
        super().__init__(dataset, global_batch_size // host_count, **kw)

    def __len__(self) -> int:
        return len(self._base_indices()) // self.global_batch_size

    def _epoch_order(self, rng: np.random.Generator) -> np.ndarray:
        order = super()._epoch_order(rng)
        n = len(self) * self.global_batch_size
        order = order[:n].reshape(-1, self.host_count, self.batch_size)
        return order[:, self.host_id].reshape(-1)


def repeated_indices(n: int, repeats=None) -> np.ndarray:
    """``arange(n)`` with index i ``repeats[i]`` times (all once without)."""
    if repeats is None:
        return np.arange(n)
    return np.repeat(np.arange(n), repeats)


def _prefetched(batches: Iterator[Dict], depth: int) -> Iterator[Dict]:
    """``batches`` built by a daemon thread up to ``depth`` ahead. The
    producer's error is raised here; an abandoned iterator (a single
    ``next``) stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    err: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batches:
                if not put(batch):
                    return
        except Exception as e:  # raised on the consumer's side
            err.append(e)
        finally:
            # delivered even when the queue is full at the producer's end,
            # or the consumer would wait on get() for ever
            put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=1.0)
            except queue.Empty:
                if not t.is_alive():  # died without its sentinel
                    break
                continue
            if item is sentinel:
                break
            yield item
    finally:
        stop.set()
    if err:
        raise err[0]


def global_device_batch(local_batch: Dict, device) -> Dict[str, torch.Tensor]:
    """This host's ``HostShardedBatcher`` slice as tensors on the rank's
    ``device``: the rows the sharded step takes (the JAX function assembles
    the hosts' slices into one global array instead)."""
    return to_device_batch(local_batch, device)


def to_device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The array fields of a batch as tensors on ``device`` (numpy arrays are
    copied there; tensors already there pass through); host-only fields such
    as ``names`` are dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(v).to(device)
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device)
    return out
