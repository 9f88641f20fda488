"""Balanced k-means tiling, counterpart of ``ampnet_tpu/ops/kmeans.py``.

Lloyd iterations whose assignment step is an entropic optimal transport
(Sinkhorn) between points (uniform mass) and clusters (capacity mass), then an
exact capacity-respecting rounding (per-cluster top-s on transport scores).
Dense ``[B, N, k]`` work over a batch of clouds, with no data-dependent
shapes and no host sync, so a bucket program enqueues it on the card and
returns at once.

Differences from the JAX module, both deliberate:

* the initial centroids come from ``torch.randperm`` on a ``torch.Generator``
  of the tensor's device, which gives other bits than ``jax.random``; tests
  pass the JAX permutation as ``init_idx``;
* ``round_balanced`` picks each cluster's points with a stable descending
  sort, so ties go to the lower index as ``jax.lax.top_k`` does
  (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances [..., N, k] as one matmul + broadcasts."""
    x2 = x.square().sum(dim=-1, keepdim=True)
    c2 = c.square().sum(dim=-1)
    return x2 + c2[..., None, :] - 2.0 * (x @ c.transpose(-1, -2))


def sinkhorn_plan(
    cost: torch.Tensor,  # [..., N, k]
    capacities: torch.Tensor,  # [k], sums to N
    tau,  # float, or a tensor that broadcasts against cost
    iters: int = 30,
) -> torch.Tensor:
    """Entropic OT plan with uniform row marginals and given column marginals."""
    logK = -cost / tau
    log_c = torch.log(capacities.float())
    u = torch.zeros(cost.shape[:-1], device=cost.device)  # log of the unit row mass is 0
    v = torch.zeros((*cost.shape[:-2], cost.shape[-1]), device=cost.device)
    for _ in range(iters):
        # column scaling then row scaling in log space
        v = log_c - torch.logsumexp(logK + u[..., :, None], dim=-2)
        u = -torch.logsumexp(logK + v[..., None, :], dim=-1)
    return torch.exp(logK + u[..., :, None] + v[..., None, :])


def round_balanced(
    scores: torch.Tensor,  # [..., N, k] higher = stronger affinity
    capacities: Tuple[int, ...],
) -> torch.Tensor:
    """Exact capacity-respecting hard assignment: each cluster in turn claims
    its top-``capacity`` still-available points. Leftover points (when
    ``sum(capacities) < N``) get −1."""
    k = scores.shape[-1]
    caps = tuple(int(c) for c in capacities)
    neg = float("-inf")
    assign = torch.full(scores.shape[:-1], -1, dtype=torch.int32, device=scores.device)
    avail = torch.ones(scores.shape[:-1], dtype=torch.bool, device=scores.device)
    for c in range(k):
        s = torch.where(avail, scores[..., c], neg)
        idx = torch.sort(s, dim=-1, descending=True, stable=True).indices[..., : caps[c]]
        take = torch.zeros_like(avail).scatter_(-1, idx, True)
        take &= avail
        assign = torch.where(take, c, assign)
        avail &= ~take
    return assign


def _cluster_sums(w: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Per cloud, ``w^T @ feats``: [..., N, k] weights, [..., N, F] → [..., k, F].

    One 2-D product per cloud. As one batched product over [B, k, N] x
    [B, N, F] (N ~ 74k, k and F tiny) cuBLAS took a 32x32 tile kernel that
    does not split N: 22 ms of a 115 ms four-cloud request on an H100."""
    if w.dim() == 2:
        return w.T @ feats
    flat_w, flat_f = w.reshape(-1, *w.shape[-2:]), feats.reshape(-1, *feats.shape[-2:])
    sums = torch.stack([a.T @ f for a, f in zip(flat_w, flat_f)])
    return sums.reshape(*w.shape[:-2], w.shape[-1], feats.shape[-1])


TAU0, TAU1 = 1.0, 0.05  # annealed entropic temperature, relative to the cost scale


def _anneal(i: int, lloyd_iters: int) -> float:
    """TAU0·(TAU1/TAU0)^(i/(iters−1)), in float32 as the JAX loop computes it."""
    frac = np.float32(i) / np.float32(max(lloyd_iters - 1, 1))
    return float(np.float32(TAU0) * np.float32(TAU1 / TAU0) ** frac)


def balanced_kmeans(
    feats: torch.Tensor,  # [..., N, F] clustering features (e.g. x, y, NDVI)
    k: int,
    generator: Optional[torch.Generator] = None,
    capacities: Optional[Tuple[int, ...]] = None,  # default N/k each
    lloyd_iters: int = 10,
    sinkhorn_iters: int = 30,
    lloyd_mode: str = "sinkhorn",
    init_idx: Optional[torch.Tensor] = None,  # [..., k] initial centroid indices
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (assignment [..., N] int32, centroids [..., k, F]).

    Every cluster gets exactly its capacity. ``lloyd_mode``
    'sinkhorn' balances inside every Lloyd iteration; 'argmin' runs plain
    Lloyd steps and balances once at the end. The initial centroids are
    ``feats[init_idx]``, by default the first k of a random permutation drawn
    from ``generator`` (which must live on ``feats``' device).

    Leading dimensions are a batch of independent clouds (the JAX bucket
    program vmaps this function): every reduction runs over one cloud's own
    points and clusters. A batch needs ``init_idx``, one row per cloud."""
    n = feats.shape[-2]
    dev = feats.device
    feats = feats.float()
    if lloyd_mode not in ("sinkhorn", "argmin"):
        raise ValueError(f"unknown lloyd_mode {lloyd_mode!r}")
    if capacities is None:
        capacities = tuple(n // k + (1 if i < n % k else 0) for i in range(k))
    if len(set(capacities)) == 1:  # the tiler's case: no host→device copy
        cap_arr = torch.full((k,), float(capacities[0]), device=dev)
    else:
        cap_arr = torch.tensor(capacities, dtype=torch.float32).to(dev)

    if init_idx is None:
        if feats.dim() != 2:
            raise ValueError("a batch of clouds needs init_idx, one row per cloud")
        init_idx = torch.randperm(n, generator=generator, device=dev)[:k]
    init_idx = init_idx.to(dev, torch.int64)  # gather's index dtype
    centroids = torch.gather(
        feats, -2, init_idx[..., None].expand(*init_idx.shape, feats.shape[-1]))

    def balanced_update(cost, tau):
        plan = sinkhorn_plan(cost, cap_arr, tau, sinkhorn_iters)
        # capacity-weighted centroid update (plan columns sum to capacities)
        w = plan / plan.sum(dim=-2, keepdim=True).clamp_min(1e-30)
        return plan, _cluster_sums(w, feats)

    def cost_scale(cost):  # per cloud, broadcast over its [N, k]
        return cost.mean(dim=(-2, -1), keepdim=True).clamp_min(1e-12)

    if lloyd_mode == "argmin":
        for _ in range(lloyd_iters):
            cost = _sqdist(feats, centroids)
            onehot = torch.nn.functional.one_hot(cost.argmin(dim=-1), k).float()
            sums = _cluster_sums(onehot, feats)
            counts = onehot.sum(dim=-2)[..., None]
            # empty clusters keep their previous centroid
            centroids = torch.where(counts > 0, sums / counts.clamp_min(1.0), centroids)
        cost = _sqdist(feats, centroids)
        plan, centroids = balanced_update(cost, cost_scale(cost) * TAU1)
    else:
        plan = None
        for i in range(lloyd_iters):
            cost = _sqdist(feats, centroids)
            plan, centroids = balanced_update(cost, cost_scale(cost) * _anneal(i, lloyd_iters))

    return round_balanced(plan, capacities), centroids


def num_tiles_test(n: int, n_points: int, max_clusters: int = 18) -> int:
    """k = floor(N / n_points), capped (utils/utils.py:489-495); 1 if cloud is small."""
    if n < 2 * n_points:
        return 1
    return min(n // n_points, max_clusters)
