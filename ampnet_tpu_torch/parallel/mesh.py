"""Data parallelism over processes, counterpart of ``ampnet_tpu/parallel/mesh.py``.

The JAX package shards the batch axis of ONE GSPMD program over a device
mesh: XLA reduces every sum across the devices, so the BatchNorm statistics,
the loss normalisers and the confusion are those of the global batch, and so
is the gradient. Here each rank is a process that holds its rows of the
global batch on its own device (NCCL on ``cuda:<rank>``; gloo on the CPU, or
for several ranks that share one card, which NCCL refuses), and the same sums
are reduced explicitly:

* every training BatchNorm in ``norm_mode='batch'`` all-reduces Σx, Σx² and
  its mask count before it forms the mean and variance
  (``models/layers.py::MaskedBatchNorm`` under ``sync_batch_norm``). The
  reduction is differentiable (``all_reduce_sum``: its backward all-reduces
  the incoming gradient), so gradients flow through the global statistics,
  and the running statistics are the same on every rank;
* the CE weight sum and the valid-point count (label-only) are all-reduced
  before any forward and divide each rank's numerators; the T-Net
  regulariser's sum of squares is all-reduced before its square root;
* the parameter gradients are all-reduced by SUM (``all_reduce_grads``): the
  ranks' losses add up to the global loss, so the sum is the global batch's
  gradient. ``DistributedDataParallel``'s average, with its per-rank
  normalisers and statistics, is not;
* the metrics (losses, confusion) are all-reduced, so every rank reads the
  same numbers and takes the same best-checkpoint and early-stop decisions.

Rows: under ``grad_accum = k`` the JAX step splits the GLOBAL batch into k
contiguous micro-batches, each sharded over the devices, so rank r holds its
contiguous share of every micro-batch (``rank_rows``). The shares may be
unequal, as a micro-batch of 3 on 2 ranks is, and a rank may hold no row:
every sum above is global, the BatchNorm's row count included, so each rank
still joins every collective, with zero sums where it holds nothing.

Random draws: each rank draws augmentation and dropout for its own rows from
a generator seeded by ``(seed, step, rank)`` (``TrainState.step_generator``).
A multi-rank trajectory therefore equals one device's only with augmentation
off and dropout 0, as ``ampnet_tpu/parallel/multihost_check.py`` and
``tests/test_parallel.py`` run the JAX one.

Processes start under ``spawn`` (``spawn_ranks``), meet at a ``file://``
store in a temporary directory, and a failed NCCL init raises: nothing falls
back to one rank or to the CPU.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ampnet_tpu_torch.core.device import resolve_device


@dataclass(frozen=True)
class DataParallel:
    """This process's place in the default process group."""

    rank: int
    world: int
    device: torch.device

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (no gradient; ``t`` is not changed)."""
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def barrier(self) -> None:
        self.sum(torch.zeros((), device=self.device))


def init_data_parallel(rank: int, world: int, device="cuda", backend: Optional[str] = None,
                       init_method: Optional[str] = None) -> DataParallel:
    """Join the default process group as ``rank`` of ``world``. ``device``
    ``"cuda"`` means ``cuda:<rank>``; ``backend`` defaults to NCCL on the card
    and gloo on the CPU. Every rank must reach the group: a failed init (NCCL's
    included, which starts here) raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kw)
    dp = DataParallel(rank, world, dev)
    joined = int(dp.sum(torch.ones((), dtype=torch.int64, device=dev)))
    if joined != world:
        raise RuntimeError(f"{joined} of {world} ranks joined the process group")
    return dp


def close_data_parallel() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, fn, world, device, backend, init_method, args):
    dp = init_data_parallel(rank, world, device, backend, init_method)
    try:
        fn(dp, *args)
    finally:
        close_data_parallel()


def spawn_ranks(fn: Callable, world: int, device="cuda", backend: Optional[str] = None,
                args: tuple = ()) -> None:
    """Run ``fn(dp, *args)`` in ``world`` new processes (``spawn``), each in
    the process group as its rank; they meet at a ``file://`` store in a
    temporary directory. ``fn`` must be importable by name. Returns when
    every rank has ended; a rank that raises or exits non-zero raises here
    (``torch.multiprocessing.ProcessRaisedException`` or
    ``ProcessExitedException``), after the others are stopped."""
    with tempfile.TemporaryDirectory(prefix="ampnet_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, device, backend, init, args), nprocs=world,
            start_method="spawn")


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x; the backward sums the incoming gradient over the ranks,
    since every rank's loss reads y."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor, dp: Optional[DataParallel]) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably; ``x`` itself without a group."""
    return x if dp is None else _AllReduceSum.apply(x)


def all_reduce_grads(model: torch.nn.Module, dp: DataParallel) -> None:
    """Replace every parameter's ``.grad`` by its sum over the ranks (one
    collective over the flattened gradients)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = dp.sum(_flatten_dense_tensors(grads))
    for g, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(reduced)


@contextlib.contextmanager
def sync_batch_norm(model: torch.nn.Module, dp: Optional[DataParallel]):
    """Within the block, every ``MaskedBatchNorm`` of ``model`` takes its
    training statistics over all ranks' rows (nothing changes without a group)."""
    from ampnet_tpu_torch.models.layers import MaskedBatchNorm

    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)] if dp else []
    for m in bns:
        m.dp = dp
    try:
        yield
    finally:
        for m in bns:
            m.dp = None


def rank_rows(n: int, world: int, rank: int, grad_accum: int = 1) -> np.ndarray:
    """The rows of an ``n``-row global batch that ``rank`` holds: of each of
    the ``grad_accum`` contiguous micro-batches, the rank's contiguous share,
    as ``np.array_split`` cuts it (the first ``mb % world`` ranks hold one
    row more; a rank may hold none)."""
    k = int(grad_accum)
    if n % k:
        raise ValueError(f"a batch of {n} clouds does not split into {k} equal micro-batches")
    mb = n // k
    lo = rank * (mb // world) + min(rank, mb % world)
    hi = lo + mb // world + (rank < mb % world)
    return (np.arange(k)[:, None] * mb + np.arange(lo, hi)).reshape(-1)


def shard_batch(batch: Dict, dp: DataParallel, grad_accum: int = 1) -> Dict:
    """The rank's rows (``rank_rows``) of a global batch: numpy arrays,
    tensors and the ``names`` list."""
    n = len(batch["points"])
    rows = rank_rows(n, dp.world, dp.rank, grad_accum)
    out = {}
    for key, v in batch.items():
        if isinstance(v, np.ndarray):
            out[key] = v[rows]
        elif isinstance(v, torch.Tensor):
            out[key] = v[torch.from_numpy(rows).to(v.device)]
        elif isinstance(v, list) and len(v) == n:
            out[key] = [v[i] for i in rows]
        else:
            out[key] = v
    return out


def make_sharded_step_fns(cfg, dp: DataParallel, augment: bool = True, teacher=None,
                          grad_accum: int = 0):
    """Data-parallel ``(train_step, eval_step)``: ``train/step.py::make_step_fns``
    under the group ``dp``. Each step takes the rank's rows of the global
    batch (``shard_batch`` with the same ``grad_accum``) and returns the
    global batch's metrics, the same on every rank; ``eval_step``'s
    predictions are the rank's rows. A distillation ``teacher`` runs its eval
    forward on the rank's rows."""
    from ampnet_tpu_torch.train.step import make_step_fns

    return make_step_fns(cfg, augment=augment, grad_accum=grad_accum, teacher=teacher, dp=dp)


def replicate_state(state, dp: DataParallel):
    """Rank 0's parameters and buffers, broadcast to every rank, in place."""
    with torch.no_grad():
        for t in state.model.state_dict().values():
            dist.broadcast(t, 0)
    return state
