"""Host input pipeline: padded static-shape batches, the port's own copy of
``ampnet_tpu/data/pipeline.py`` (``pad_windowed_sample``, ``PaddedBatcher``,
``SingleCloudBatcher``, ``to_device_batch``). Contract of every batch::

    points     [B, W, N, F] float32  — windows replicate-padded to W=max_windows
    labels     [B, W, N]    int32    — padded windows are all −1 (loss-ignored)
    centroids  [B, W, 2]    float32  — replicate-padded
    cls_label  [B]          int32    — only for classification datasets
    names      list[str]             — host-side only

Point-axis resampling uses ONE index list shared across a cloud's windows, as
the reference collate does (``collate_fns.py:33-41``). Batches are built in
the iterating thread: the training path reads them from the GPU-resident
cache (data/device_cache.py), which builds each sample once.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


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


class PaddedBatcher:
    """Iterable over static-shape batches. Epoch e draws its order and its
    resampling from ``np.random.default_rng(seed + e)``, as the JAX batcher
    does, so both packages see the same batches for the same seed."""

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
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_points = n_points
        self.max_windows = max_windows
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.pad_to_multiple = pad_to_multiple
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _pad_batch_to_multiple(self, batch):
        """Pad a short batch up to a multiple of ``pad_to_multiple`` clouds by
        replicating earlier samples with all labels −1 (loss-ignored)."""
        m = self.pad_to_multiple
        b = batch["points"].shape[0]
        if m <= 1 or b % m == 0:
            return batch
        idx = np.arange(m - b % m) % b
        out = dict(batch)
        for k in ("points", "centroids"):
            out[k] = np.concatenate([batch[k], batch[k][idx]], axis=0)
        for k in ("labels", "cls_label"):  # padded clouds carry no loss or metric weight
            if k in batch:
                out[k] = np.concatenate([batch[k], np.full_like(batch[k][idx], -1)])
        out["names"] = batch["names"] + [f"<pad:{batch['names'][i]}>" for i in idx]
        return out

    def _windowed(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A dataset sample in the windowed ``[W, N, F]`` layout."""
        return sample

    def _make_batches(self, rng: np.random.Generator) -> Iterator[Dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        for b in range(len(self)):
            idxs = order[b * self.batch_size: (b + 1) * self.batch_size]
            samples = [pad_windowed_sample(self._windowed(self.dataset[int(i)]), self.n_points,
                                           self.max_windows, rng) for i in idxs]
            batch = {
                "points": np.stack([s["points"] for s in samples]),
                "labels": np.stack([s["labels"] for s in samples]),
                "centroids": np.stack([s["centroids"] for s in samples]),
                "names": [s["name"] for s in samples],
            }
            if "cls_label" in samples[0]:
                batch["cls_label"] = np.asarray([s["cls_label"] for s in samples])
            yield self._pad_batch_to_multiple(batch)

    def __iter__(self) -> Iterator[Dict]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        yield from self._make_batches(rng)


class SingleCloudBatcher(PaddedBatcher):
    """Batches of whole clouds (``CloudDataset``): each cloud is a one-window
    sample, so the same ``[B, W, N, F]`` contract serves the baseline models
    (W = 1; the default 4096 points are the JAX batcher's)."""

    def __init__(self, dataset, batch_size: int, n_points: int = 4096, **kw):
        super().__init__(dataset, batch_size, n_points=n_points, max_windows=1, **kw)

    def _windowed(self, sample):
        pts, lbl = sample["points"][None], sample["labels"][None]  # [1, N, F], [1, N]
        return dict(sample, points=pts, labels=lbl, centroids=pts[:, :, :2].mean(axis=1))


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
