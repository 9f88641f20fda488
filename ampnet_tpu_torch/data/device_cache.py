"""GPU-resident training data: pad once, upload once, gather batches on the
card. The port's counterpart of ``ampnet_tpu/data/device_cache.py``.

* Every sample is padded to the static ``[W, N, F]`` shape ONCE, with the
  ``PaddedBatcher`` padding rules, stacked and uploaded a single time. Each
  sample's resampling is fixed at build time (drawn from
  ``default_rng(seed)`` in dataset order), as in the JAX cache; the host
  batcher re-draws it every epoch, which is the only difference.
* A step then gathers its batch on the card from a ``[B]`` index row; the
  epoch's ``[S, B]`` index matrix takes the host batcher's order
  (``default_rng(seed + epoch)``) and goes up once per epoch.
"""

from __future__ import annotations

import copy
import sys
from typing import Dict, Iterator, Optional

import numpy as np
import torch

# a dataset larger than this stays on the host path under --device_cache auto
DEFAULT_LIMIT_BYTES = 4 * 1024**3


def _single_sample_loader(batcher):
    """A copy of the host batcher that emits one padded sample per batch in
    dataset order, with the same padding rules."""
    loader = copy.copy(batcher)
    loader.batch_size = 1
    loader.shuffle = False
    loader.drop_last = False
    loader.pad_to_multiple = 1
    return loader


def estimate_cache_bytes(batcher) -> int:
    """Padded size of the whole dataset: one padded sample x dataset length."""
    n = len(batcher.dataset)
    if n == 0:
        return 0
    first = next(_single_sample_loader(batcher)._make_batches(np.random.default_rng(batcher.seed)))
    return n * sum(v.nbytes for v in first.values() if isinstance(v, np.ndarray))


def gather_batch(data: Dict[str, torch.Tensor], idx: torch.Tensor,
                 pad: torch.Tensor) -> Dict[str, torch.Tensor]:
    """On-device batch gather from the cache; replicated pad entries get all
    targets −1 (the segmentation labels and ``cls_label``), so the loss's
    ignore_index and the confusion matrix drop them."""
    out = {k: v[idx] for k, v in data.items()}
    for key in ("labels", "cls_label"):
        if key in out:
            t = out[key]
            out[key] = torch.where(pad.reshape((-1,) + (1,) * (t.dim() - 1)),
                                   torch.full((), -1, dtype=t.dtype, device=t.device), t)
    return out


class DeviceCachedBatcher:
    """Wrap a ``PaddedBatcher`` or ``SingleCloudBatcher``; serve its batches
    from a cache on ``device``."""

    def __init__(self, inner, device, limit_bytes: int = DEFAULT_LIMIT_BYTES):
        self.inner = inner
        self.device = torch.device(device)
        self.batch_size = inner.batch_size
        self.n_points = inner.n_points
        self.max_windows = inner.max_windows
        self.seed = inner.seed
        self.shuffle = inner.shuffle
        self.drop_last = inner.drop_last
        self.pad_to_multiple = inner.pad_to_multiple
        self.epoch = inner.epoch
        self.names: list = []
        self._build(limit_bytes)

    def _build(self, limit_bytes: int) -> None:
        loader = _single_sample_loader(self.inner)
        parts = []
        for b in loader._make_batches(np.random.default_rng(self.seed)):  # fixed at build
            self.names.append(b["names"][0])
            parts.append({k: v for k, v in b.items() if isinstance(v, np.ndarray)})
        if not parts:
            self.data = {}
            return
        host = {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}
        nbytes = sum(v.nbytes for v in host.values())
        if nbytes > limit_bytes:
            raise MemoryError(f"device cache would be {nbytes / 2**20:.0f} MiB "
                              f"(> limit {limit_bytes / 2**20:.0f} MiB)")
        self.data = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}

    def __len__(self) -> int:
        n = len(self.names)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self, pad_to: Optional[int] = None):
        """Per-batch (idx, pad, names) for one epoch; advances the epoch
        counter with the host batcher's rng. ``pad_to`` pads every batch to
        one width (the epoch loop wants a rectangular [S, B]); pad entries
        replicate earlier samples and are marked True."""
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        order = np.arange(len(self.names))
        if self.shuffle:
            rng.shuffle(order)
        out = []
        for b in range(len(self)):
            idx = order[b * self.batch_size: (b + 1) * self.batch_size]
            pad = np.zeros(len(idx), bool)
            names = [self.names[i] for i in idx]
            m = self.pad_to_multiple
            width = len(idx)
            if m > 1 and width % m:
                width += m - width % m
            if pad_to is not None:
                width = max(width, pad_to)
            if width > len(idx):
                extra = idx[np.arange(width - len(idx)) % len(idx)]
                idx = np.concatenate([idx, extra])
                pad = np.concatenate([pad, np.ones(len(extra), bool)])
                names = names + [f"<pad:{self.names[i]}>" for i in extra]
            out.append((idx.astype(np.int64), pad, names))
        return out

    def epoch_index_matrix(self):
        """Rectangular ``(idxs [S, B], pads [S, B], names)`` for one epoch."""
        m = max(self.pad_to_multiple, 1)
        batches = self._epoch_indices(pad_to=-(-self.batch_size // m) * m)
        if not batches:
            return (np.zeros((0, self.batch_size), np.int64),
                    np.zeros((0, self.batch_size), bool), [])
        return (np.stack([b[0] for b in batches]), np.stack([b[1] for b in batches]),
                [b[2] for b in batches])

    def __iter__(self) -> Iterator[Dict]:
        for idx, pad, names in self._epoch_indices():
            batch = gather_batch(self.data, torch.from_numpy(idx).to(self.device),
                                 torch.from_numpy(pad).to(self.device))
            batch["names"] = names
            yield batch


def maybe_device_cache(batcher, device, mode: str = "auto",
                       limit_bytes: int = DEFAULT_LIMIT_BYTES):
    """CLI policy: 'on' caches (raises if too big), 'off' returns the host
    batcher, 'auto' caches when the padded dataset fits under ``limit_bytes``."""
    if mode == "off" or batcher is None:
        return batcher
    if mode not in ("on", "auto"):
        raise ValueError(f"device_cache mode {mode!r} (want on/off/auto)")
    if mode == "auto":
        est = estimate_cache_bytes(batcher)
        if est > limit_bytes:
            print(f"device cache skipped: dataset ~{est / 2**20:.0f} MiB "
                  f"> {limit_bytes / 2**20:.0f} MiB; using the host pipeline", file=sys.stderr)
            return batcher
    return DeviceCachedBatcher(batcher, device, limit_bytes=limit_bytes)
