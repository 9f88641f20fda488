"""Stage 3 — offline balanced k-means tiling into exactly-``n_points`` windows
(``data_proc/3_kmeans.py:27-116``), the port's counterpart of
``ampnet_tpu/preproc/tiling.py``.

Reference semantics: k = ceil(N / n_points) capped at 9; if over the cap, random
sample down to 9·n_points; if under k·n_points, duplicate random points up; then
KMeansConstrained(size_min = size_max = n_points) on features (x, y, NDVI) — cols
[0, 1, 9] of the 13-column schema; output tensor [n_points, dims, k]. Clouds below
2·n_points become a single window (randomly sampled down to n_points if larger).
The sampling draws come from ``np.random.default_rng(seed)`` as in JAX.

Two assigners solve the constrained problem:

* ``'exact_mcf'`` (the default of ``preprocess``): the native C++ min-cost-flow
  solver (``ampnet_tpu_torch/native``), built from the port's own copy of the
  source; it raises when it cannot build;
* ``'sinkhorn'``: the port's ``ops/kmeans.py::balanced_kmeans`` on ``device``,
  its start drawn by a ``torch.Generator`` of that device seeded by ``seed``.
  A CUDA generator and a CPU generator give other permutations for one seed,
  and both differ from JAX's ``jax.random``; ``init_idx`` fixes the start.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ampnet_tpu_torch.ops.kmeans import num_tiles_train

KMEANS_COLS = (0, 1, 9)  # x, y, NDVI of the 13-col schema (3_kmeans.py:81)


def kmeans_tile_cloud(
    pc: np.ndarray,  # [N, 13] canonical cloud
    n_points: int = 2048,
    max_clusters: int = 9,
    seed: int = 0,
    assigner: str = "sinkhorn",
    device="cuda",
    init_idx: Optional[np.ndarray] = None,  # [k] sinkhorn start, else drawn from seed
) -> np.ndarray:
    """Returns the windowed tensor [n_points, dims, k] (reference artifact layout)."""
    if assigner not in ("exact_mcf", "sinkhorn"):
        raise ValueError(f"unknown assigner {assigner!r} (exact_mcf | sinkhorn)")
    rng = np.random.default_rng(seed)
    n = pc.shape[0]

    if n < 2 * n_points:  # single window (3_kmeans.py:108-115)
        if n > n_points:
            pc = pc[rng.permutation(n)[:n_points]]
        return np.ascontiguousarray(pc[:, :, None])

    k = num_tiles_train(n, n_points, max_clusters)
    target = k * n_points
    if n > target and k == max_clusters:  # over the cap: sample down (:57-62)
        pc = pc[rng.permutation(n)[:target]]
    elif n < target:  # duplicate up (:64-69)
        extra = rng.integers(0, n, target - n)
        pc = np.concatenate([pc, pc[extra]], axis=0)
    elif n > target:  # ceil() makes this impossible, but keep the reference's
        pc = pc[:target]  # trailing-points trim for safety (:71-73)

    feats = pc[:, KMEANS_COLS].astype(np.float32)
    if assigner == "exact_mcf":
        from ampnet_tpu_torch.native import mcf_balanced_assign

        assign = mcf_balanced_assign(feats, k, n_points, seed=seed)
    else:
        assign = sinkhorn_assign(feats, k, n_points, seed, device, init_idx)

    order = np.argsort(assign, kind="stable")
    windows = pc[order].reshape(k, n_points, pc.shape[1])  # [k, n_points, dims]
    return np.ascontiguousarray(windows.transpose(1, 2, 0))  # [n_points, dims, k]


def sinkhorn_assign(feats: np.ndarray, k: int, size: int, seed: int = 0, device="cuda",
                    init_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """Balanced clusters of exactly ``size`` points of [N, F] ``feats`` by the
    port's Sinkhorn k-means on ``device`` → [N] int32 cluster of each point."""
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.ops.kmeans import balanced_kmeans

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    init = None if init_idx is None else torch.as_tensor(np.asarray(init_idx, np.int64))
    with torch.inference_mode():
        assign, _ = balanced_kmeans(torch.from_numpy(feats).to(dev), k, generator=gen,
                                    capacities=(size,) * k, init_idx=init)
    return assign.cpu().numpy()
