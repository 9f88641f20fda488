"""Balanced k-means tiling, counterpart of ``ampnet_tpu/ops/kmeans.py``.

Lloyd iterations whose assignment step is an entropic optimal transport
(Sinkhorn) between points (uniform mass) and clusters (capacity mass), then an
exact capacity-respecting rounding (per-cluster top-s on transport scores) or
the plan's argmax (``exact=False``). Dense ``[B, N, k]`` work over a batch
of clouds, with no data-dependent shapes, no host sync and, for equal
capacities (the tiler's), no host→device copy, so the tiled inferencer's
bucket graph captures it whole (``infer/tiled.py``).

On a card, ``sinkhorn_plan``'s iterations run as three launches of
``csrc/sinkhorn.cu`` each (``sinkhorn_iterations``) and torch's column sum,
for every input they take: a CUDA float32 tensor, no ``point_mask``, at most
``MAX_CLUSTERS`` clusters. Their plan equals the plain loop's bit for bit
(the tiling rounds a near tie otherwise under any other order of the sums),
so every caller, the served path too, gets the plain loop's windows. Every
other input runs the plain loop.

Differences from the JAX module, both deliberate:

* the initial centroids come from ``torch.randperm`` on a ``torch.Generator``
  of the tensor's device, which gives other bits than ``jax.random``; tests
  pass the JAX permutation as ``init_idx``;
* ``round_balanced`` picks each cluster's points with a stable descending
  sort, so ties go to the lower index as ``jax.lax.top_k`` does
  (``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ampnet_tpu_torch.ops import cuda_build

MAX_CLUSTERS = 32  # the kernels' k


def _sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances [..., N, k] as one matmul + broadcasts."""
    x2 = x.square().sum(dim=-1, keepdim=True)
    c2 = c.square().sum(dim=-1)
    return x2 + c2[..., None, :] - 2.0 * (x @ c.transpose(-1, -2))


def sinkhorn_plan(
    cost: torch.Tensor,  # [..., N, k]
    capacities: torch.Tensor,  # [k], sums to N (to the real points under a mask)
    tau,  # float, or a tensor that broadcasts against cost
    iters: int = 30,
    point_mask: Optional[torch.Tensor] = None,  # [..., N] bool, True = a real point
) -> torch.Tensor:
    """Entropic OT plan with uniform row marginals and given column marginals.
    Masked-out rows get no mass: ``logK = -1e30`` and a zero row marginal."""
    logK = -cost / tau
    log_c = torch.log(capacities.float())
    if point_mask is not None:
        logK = torch.where(point_mask[..., None], logK, -1e30)
        row_mass = point_mask.float()
        log_r = torch.log(row_mass.clamp_min(1e-30))
    if point_mask is None and _kernels_take(logK, log_c, iters):
        u, v = sinkhorn_iterations(logK, log_c, iters)
    else:
        u = torch.zeros(cost.shape[:-1], device=cost.device)  # log of the unit row mass is 0
        v = torch.zeros((*cost.shape[:-2], cost.shape[-1]), device=cost.device)
        for _ in range(iters):
            # column scaling then row scaling in log space
            v = log_c - torch.logsumexp(logK + u[..., :, None], dim=-2)
            lse = torch.logsumexp(logK + v[..., None, :], dim=-1)
            u = -lse if point_mask is None else log_r - lse
    plan = torch.exp(logK + u[..., :, None] + v[..., None, :])
    # a masked row's u grows to ~1e30 and logK + u cancels in float32: the
    # row mass sets it to exactly zero, as the JAX module does
    return plan if point_mask is None else plan * row_mass[..., None]


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _kernels_take(logK: torch.Tensor, log_c: torch.Tensor, iters: int) -> bool:
    """Whether ``sinkhorn_plan`` hands its iterations to the kernels: the
    input alone decides (device, dtype, sizes), no flag."""
    return (_on_card(logK) and logK.dtype == torch.float32 and logK.dim() >= 2
            and logK.numel() > 0 and 1 <= logK.shape[-1] <= MAX_CLUSTERS
            and int(np.prod(logK.shape[:-2])) <= 65535 and log_c.dtype == torch.float32
            and log_c.device == logK.device and tuple(log_c.shape) == (logK.shape[-1],)
            and iters >= 1)


_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "sinkhorn_blocks": (_I, [_I]),
    "sinkhorn_columns": (_I, [_P] * 6 + [_I] * 4 + [_P]),
    "sinkhorn_rows": (_I, [_P] * 6 + [_I] * 3 + [_P]),
}


def sinkhorn_iterations(
    logK: torch.Tensor,  # [..., N, k] float32, contiguous, on a CUDA device
    log_c: torch.Tensor,  # [k] float32 log capacities
    iters: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sinkhorn_plan``'s ``iters`` log-domain iterations (no mask) from u = 0
    → (u [..., N], v [..., k]), equal to the plain loop's bit for bit: per
    iteration the kernels of ``csrc/sinkhorn.cu`` (two for the column
    update's maxima and exps, one for the whole row update, whose sum over k
    takes torch's order) and torch's own column sum over the exps, the
    reduction whose order the plain loop's roundings follow. On the current
    stream, memory from
    ``torch.empty``, no host sync: it captures into a CUDA graph. It raises
    on anything else (there is no fallback); ``sinkhorn_iterations.launches``
    counts the kernels' launches (3 an iteration)."""
    if logK.dtype != torch.float32 or log_c.dtype != torch.float32:
        raise TypeError(f"sinkhorn_iterations takes float32, got {logK.dtype} and {log_c.dtype}")
    if not (logK.is_contiguous() and log_c.is_contiguous()):
        raise ValueError("sinkhorn_iterations takes contiguous tensors")
    n, k = (logK.shape[-2], logK.shape[-1]) if logK.dim() >= 2 else (0, 0)
    lead = tuple(logK.shape[:-2])
    b = int(np.prod(lead))
    if not (n >= 1 and 1 <= k <= MAX_CLUSTERS and 1 <= b <= 65535
            and tuple(log_c.shape) == (k,) and iters >= 1):
        raise ValueError(f"sinkhorn_iterations takes logK [..., N, k] with 1 <= k <= "
                         f"{MAX_CLUSTERS}, at most 65535 clouds, log capacities [k] and at least "
                         f"one iteration, got {tuple(logK.shape)}, {tuple(log_c.shape)}, {iters}")
    if not _on_card(logK) or log_c.device != logK.device:
        raise ValueError(f"sinkhorn_iterations runs on a CUDA device, both tensors on it "
                         f"(logK on {logK.device}, log_c on {log_c.device})")
    lib = cuda_build.load("sinkhorn", SIGNATURES)
    dev = logK.device
    exps = torch.empty_like(logK)
    partial = torch.empty((b, lib.sinkhorn_blocks(n), k), dtype=torch.float32, device=dev)
    done = torch.zeros(b, dtype=torch.int32, device=dev)
    colmax = torch.empty((*lead, k), dtype=torch.float32, device=dev)
    v = torch.empty((*lead, k), dtype=torch.float32, device=dev)
    u = torch.empty((*lead, n), dtype=torch.float32, device=dev)  # not read by the first iteration
    for i in range(iters):
        # the column maxima and the column exps: two kernels
        cuda_build.launch(sinkhorn_iterations, lib.sinkhorn_columns, dev,
                          logK.data_ptr(), u.data_ptr(), partial.data_ptr(), done.data_ptr(),
                          exps.data_ptr(), colmax.data_ptr(), b, n, k, int(i == 0), launches=2)
        colsum = exps.sum(dim=-2)
        cuda_build.launch(sinkhorn_iterations, lib.sinkhorn_rows, dev,
                          logK.data_ptr(), colsum.data_ptr(), colmax.data_ptr(), log_c.data_ptr(),
                          v.data_ptr(), u.data_ptr(), b, n, k)
    return u, v


sinkhorn_iterations.launches = 0


def round_balanced(
    scores: torch.Tensor,  # [..., N, k] higher = stronger affinity
    capacities: Tuple[int, ...],
    point_mask: Optional[torch.Tensor] = None,  # [..., N] bool, True = a real point
) -> torch.Tensor:
    """Exact capacity-respecting hard assignment: each cluster in turn claims
    its top-``capacity`` still-available points. Leftover points (when
    ``sum(capacities) < N``) and masked-out points get −1."""
    k = scores.shape[-1]
    caps = tuple(int(c) for c in capacities)
    neg = float("-inf")
    assign = torch.full(scores.shape[:-1], -1, dtype=torch.int32, device=scores.device)
    if point_mask is None:
        avail = torch.ones(scores.shape[:-1], dtype=torch.bool, device=scores.device)
    else:
        scores = torch.where(point_mask[..., None], scores, neg)
        avail = point_mask.clone()
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
    exact: bool = True,
    point_mask: Optional[torch.Tensor] = None,  # [..., N] bool, True = a real point
    lloyd_mode: str = "sinkhorn",
    init_idx: Optional[torch.Tensor] = None,  # [..., k] initial centroid indices
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (assignment [..., N] int32, centroids [..., k, F]).

    With ``exact`` every cluster gets exactly its capacity; without, each
    point takes the argmax of the balanced plan, so sizes are about the
    capacities. ``lloyd_mode`` 'sinkhorn' balances inside every Lloyd
    iteration; 'argmin' runs plain Lloyd steps and balances once at the end.
    Masked-out points (``point_mask`` False) carry no mass and get −1; the
    capacities must then be given, since the padded N does not size them.
    The initial centroids are ``feats[init_idx]``, by default the first k of
    a random permutation drawn from ``generator`` (which must live on
    ``feats``' device).

    Leading dimensions are a batch of independent clouds (the JAX bucket
    program vmaps this function): every reduction runs over one cloud's own
    points and clusters. A batch needs ``init_idx``, one row per cloud."""
    n = feats.shape[-2]
    dev = feats.device
    feats = feats.float()
    if lloyd_mode not in ("sinkhorn", "argmin"):
        raise ValueError(f"unknown lloyd_mode {lloyd_mode!r}")
    if capacities is None:
        if point_mask is not None:
            raise ValueError("balanced_kmeans with point_mask requires explicit capacities")
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
        plan = sinkhorn_plan(cost, cap_arr, tau, sinkhorn_iters, point_mask)
        # capacity-weighted centroid update (plan columns sum to capacities)
        w = plan / plan.sum(dim=-2, keepdim=True).clamp_min(1e-30)
        return plan, _cluster_sums(w, feats)

    def cost_scale(cost):  # per cloud, broadcast over its [N, k]
        return cost.mean(dim=(-2, -1), keepdim=True).clamp_min(1e-12)

    if lloyd_mode == "argmin":
        for _ in range(lloyd_iters):
            cost = _sqdist(feats, centroids)
            if point_mask is not None:
                cost = torch.where(point_mask[..., None], cost, float("inf"))
            onehot = torch.nn.functional.one_hot(cost.argmin(dim=-1), k).float()
            if point_mask is not None:
                onehot = onehot * point_mask[..., None].float()
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

    if exact:
        return round_balanced(plan, capacities, point_mask), centroids
    assign = plan.argmax(dim=-1).to(torch.int32)
    if point_mask is not None:
        assign = torch.where(point_mask, assign, -1)
    return assign, centroids


def cluster_sizes(assign: torch.Tensor, k: int) -> torch.Tensor:
    """Points per cluster, int32: the sum over the first axis of the one-hot
    of ``assign`` (a [N] assignment gives [k]); ids outside [0, k), such as
    the −1 of a masked point, count nowhere, as JAX's ``one_hot`` does."""
    ids = torch.arange(k, device=assign.device)
    return (assign[..., None] == ids).sum(dim=0, dtype=torch.int32)


def num_tiles_test(n: int, n_points: int, max_clusters: int = 18) -> int:
    """k = floor(N / n_points), capped (utils/utils.py:489-495); 1 if cloud is small."""
    if n < 2 * n_points:
        return 1
    return min(n // n_points, max_clusters)


def num_tiles_train(n: int, n_points: int, max_clusters: int = 9) -> int:
    """k = ceil(N / n_points), at least 1, capped (3_kmeans.py:54-57)."""
    return min(max(-(-n // n_points), 1), max_clusters)
