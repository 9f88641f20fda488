"""The multi-process training check, counterpart of
``ampnet_tpu/parallel/multihost_check.py``.

Run one copy per process: each joins a process group (gloo on the CPU, NCCL
on ``cuda:<process_id>``), loads only its ``HostShardedBatcher`` slice of
every global batch of the JAX module's deterministic dataset, and runs the
sharded train step (augmentation off, dropout 0). Every process draws the
same seeded global permutation, so the global batches equal a single
process's, and the loss trajectory must equal the single-process run's: step
1 to reduction-order noise, later steps to what Adam's first updates make of
that noise (``tests/test_torch_multihost.py``).

Usage::

  # process i of P, all started together, meeting at one file:
  python -m ampnet_tpu_torch.parallel.multihost_check --num_processes P \\
      --process_id I --init_method file:///tmp/store --device cpu --out out_I.json
  # the single-process golden (the plain step on the global batches):
  python -m ampnet_tpu_torch.parallel.multihost_check --device cpu --out golden.json

It prints ``{"process_id", "num_processes", "losses"}`` as JSON (and writes
it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

W = 2  # windows a sample, as in the JAX module


class DeterministicDataset:
    """Per-index samples, identical on every host: the JAX module's
    ``_DetDataset`` (``default_rng(1000 + i)``)."""

    def __init__(self, n_samples: int, n_points: int):
        self.n, self.n_points = n_samples, n_points

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(1000 + i)
        return {
            "points": rng.normal(size=(W, self.n_points, 9)).astype(np.float32),
            "labels": rng.integers(-1, 5, size=(W, self.n_points)).astype(np.int32),
            "centroids": rng.normal(size=(W, 2)).astype(np.float32),
            "name": f"s{i}",
        }


def run(args) -> dict:
    from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.data.pipeline import HostShardedBatcher, global_device_batch
    from ampnet_tpu_torch.models.amp import AMPNetSegmenter
    from ampnet_tpu_torch.parallel.mesh import (
        close_data_parallel,
        init_data_parallel,
        make_sharded_step_fns,
        replicate_state,
    )
    from ampnet_tpu_torch.train.state import create_train_state
    from ampnet_tpu_torch.train.step import make_step_fns

    dp = None
    if args.num_processes > 1:
        dp = init_data_parallel(args.process_id, args.num_processes, args.device,
                                init_method=args.init_method)
    try:
        cfg = AMPNetConfig(data=DataConfig(n_points=args.n_points, max_windows=W),
                           model=ModelConfig(dropout=0.0))
        batcher = HostShardedBatcher(DeterministicDataset(args.n_samples, args.n_points),
                                     args.global_batch, n_points=args.n_points, max_windows=W,
                                     seed=0, drop_last=True)
        model = AMPNetSegmenter(cfg.model, generator=torch.Generator().manual_seed(0))
        device = dp.device if dp is not None else resolve_device(args.device)
        state = create_train_state(cfg, model, max(len(batcher), 1), device)
        if dp is not None:
            replicate_state(state, dp)
            train_step, _ = make_sharded_step_fns(cfg, dp, augment=False)
        else:
            train_step, _ = make_step_fns(cfg, augment=False)
        losses = []
        for _ in range(args.epochs):
            for local in batcher:
                metrics = train_step(state, global_device_batch(local, state.device))
                losses.append(float(metrics["loss"]))
    finally:
        if dp is not None:
            close_data_parallel()
    return {"process_id": args.process_id, "num_processes": args.num_processes,
            "losses": losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_processes", type=int, default=1)
    ap.add_argument("--process_id", type=int, default=0)
    ap.add_argument("--init_method", default=None,
                    help="the process group's rendezvous, e.g. file:///tmp/store")
    ap.add_argument("--device", default="cuda", help="cuda (cuda:<process_id>) or cpu")
    ap.add_argument("--global_batch", type=int, default=8)
    ap.add_argument("--n_samples", type=int, default=16)
    ap.add_argument("--n_points", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    payload = json.dumps(run(args))
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
    print(payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
