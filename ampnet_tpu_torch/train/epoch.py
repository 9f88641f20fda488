"""Whole epochs over the GPU-resident dataset, counterpart of
``ampnet_tpu/train/epoch.py``.

The JAX package scans its jitted step over the epoch's ``[S, B]`` index
matrix as one XLA program. Here the epoch is a Python loop of eager steps over
the same matrix, uploaded once: each step gathers its batch on the card from
its index row and queues its kernels; every step's metrics stay on the card
and are stacked, so the caller fetches them ONCE per epoch. Nothing in the
loop reads a value back to the host. The step's generator derives from
``(seed, step)``, so a seeded run draws exactly what the per-step path draws.
(Capturing the step in a CUDA graph is a later optimisation.) Under a
process group each rank runs the epoch over its own columns of the index
matrix (``DeviceCachedBatcher.epoch_index_matrix(dp, grad_accum)``) with the
sharded steps, as the JAX epoch shards the matrix along its batch column.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ampnet_tpu_torch.data.device_cache import gather_batch


def stack_metrics(per_step: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-step metric dicts → one dict of ``[S, ...]`` tensors (still on the
    device)."""
    if not per_step:
        return {}
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def make_epoch_fns(train_step: Callable, eval_step: Callable) -> Tuple[Callable, Callable]:
    """``(train_epoch, eval_epoch)`` over the step functions:

    ``train_epoch(state, data, idxs, pads) -> metrics[S, ...]``
    ``eval_epoch(state, data, idxs, pads) -> metrics[S, ...]``

    where ``data`` is the device cache (``DeviceCachedBatcher.data``),
    ``idxs`` ``[S, B]`` int and ``pads`` ``[S, B]`` bool (True = a replicated
    pad entry, labels forced to −1)."""

    def _rows(data, idxs: np.ndarray, pads: np.ndarray):
        dev = next(iter(data.values())).device
        idxs = torch.from_numpy(np.asarray(idxs, np.int64)).to(dev)
        pads = torch.from_numpy(np.asarray(pads, bool)).to(dev)
        for s in range(idxs.shape[0]):
            yield gather_batch(data, idxs[s], pads[s])

    def train_epoch(state, data, idxs, pads) -> Dict[str, torch.Tensor]:
        return stack_metrics([train_step(state, batch) for batch in _rows(data, idxs, pads)])

    def eval_epoch(state, data, idxs, pads) -> Dict[str, torch.Tensor]:
        return stack_metrics([eval_step(state, batch)[0] for batch in _rows(data, idxs, pads)])

    return train_epoch, eval_epoch
