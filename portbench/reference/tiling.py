"""Plain PyTorch reference of one served cloud: replicate padding, balanced
k-means tiling, the windowed forward and the scatter back to point order.

It imports nothing of the measured package. The serving rules it follows:

* a cloud of N points is tiled into k = min(N // n_points, max_clusters)
  windows (1 below 2 · n_points) of capacity cap, the smallest
  n_points · 2^j with k · cap ≥ N (``utils/utils.py:489-495`` of the AMP-Net
  code gives k);
* it is padded to k · cap points with copies of the real points at indices
  ``default_rng(seed).integers(0, N, k · cap − N)`` (the server's per-cloud
  seed is 0);
* balanced k-means on (x, y, NDVI), columns 0, 1 and 8: the first k of
  ``randperm(k · cap)`` on the card from a generator seeded with the cloud's
  seed as the initial centroids; 10 Lloyd iterations, each an entropic
  transport (30 Sinkhorn iterations in log space, uniform point mass,
  capacity cap per cluster) at temperature mean(cost) · τ_i with τ annealed
  from 1 to 0.05 geometrically in float32, then centroids as the plan's
  capacity-weighted means; the last plan is rounded exactly: cluster 0..k−1
  in turn takes its cap highest-scored points still free (a stable
  descending sort, ties to the lower index);
* windows are the clusters in order of their id (points of one cluster in
  index order); their centroid is the mean x, y of the window;
* labels are the argmax of the logits, scattered back, the padding dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.ampnet import FP32, Precision, eval_logits

KMEANS_COLUMNS = (0, 1, 8)
LLOYD_ITERS, SINKHORN_ITERS = 10, 30
TAU0, TAU1 = 1.0, 0.05


def tiles_for(n: int, n_points: int, max_clusters: int):
    """(k, cap) of a cloud of ``n`` points."""
    k = 1 if n < 2 * n_points else min(n // n_points, max_clusters)
    need, cap = -(-n // k), n_points
    while cap < need:
        cap *= 2
    return k, cap


def _anneal(i: int) -> float:
    frac = np.float32(i) / np.float32(LLOYD_ITERS - 1)
    return float(np.float32(TAU0) * np.float32(TAU1 / TAU0) ** frac)


def balanced_kmeans(feats: torch.Tensor, k: int, cap: int, init_idx: torch.Tensor,
                    prec: Precision = FP32) -> torch.Tensor:
    """Assignment [N] (cluster ids) of ``feats`` [B, N, 3] (N = k · cap),
    the same cloud in every row: the reductions run over each row's own
    points, batched as a server batches B clouds; row 0's plan is rounded."""
    b, n, _ = feats.shape
    log_cap = torch.log(torch.full((k,), float(cap), device=feats.device))
    cent = feats[:, init_idx]
    plan = None
    for i in range(LLOYD_ITERS):
        cost = (feats * feats).sum(-1, keepdim=True) + (cent * cent).sum(-1)[:, None, :] \
            - 2.0 * prec.mm(feats, cent.transpose(-1, -2))
        tau = cost.mean(dim=(-2, -1), keepdim=True).clamp_min(1e-12) * _anneal(i)
        log_k = -cost / tau
        u = torch.zeros((b, n), device=feats.device)
        v = torch.zeros((b, k), device=feats.device)
        for _ in range(SINKHORN_ITERS):
            v = log_cap - torch.logsumexp(log_k + u[..., :, None], dim=-2)
            u = -torch.logsumexp(log_k + v[..., None, :], dim=-1)
        plan = torch.exp(log_k + u[..., :, None] + v[..., None, :])
        w = plan / plan.sum(dim=-2, keepdim=True).clamp_min(1e-30)
        cent = torch.stack([prec.mm(w[r].t(), feats[r]) for r in range(b)])
    plan = plan[0]
    assign = torch.full((n,), -1, dtype=torch.int64, device=feats.device)
    free = torch.ones(n, dtype=torch.bool, device=feats.device)
    for c in range(k):
        s = torch.where(free, plan[:, c], float("-inf"))
        take = torch.sort(s, descending=True, stable=True).indices[:cap]
        assign[take] = c
        free[take] = False
    return assign


def predict_cloud(cloud: np.ndarray, weights, device, n_points: int = 2048,
                  max_clusters: int = 18, seed: int = 0, prec: Precision = FP32,
                  batches=(1,)) -> list:
    """Logits [N, C] (float32, on the host) of one [N, 9] float32 cloud, one
    array for each distinct tiling that the cloud gets in a batch of each
    size in ``batches`` (a batch's reductions may round differently, so a
    point near a tie can fall into another window); labels are the argmax."""
    n = cloud.shape[0]
    k, cap = tiles_for(n, n_points, max_clusters)
    dup = np.random.default_rng(seed).integers(0, n, k * cap - n)
    pts = torch.from_numpy(np.concatenate([cloud, cloud[dup]], axis=0)).to(device)
    outs, seen = [], []
    with prec, torch.no_grad():
        for b in batches:
            if k > 1:
                gen = torch.Generator(device=device).manual_seed(int(seed))
                init = torch.randperm(k * cap, generator=gen, device=device)[:k]
                feats = pts[:, list(KMEANS_COLUMNS)].expand(b, -1, -1).contiguous()
                order = torch.argsort(balanced_kmeans(feats, k, cap, init, prec), stable=True)
            else:
                order = torch.arange(k * cap, device=device)
            if any(torch.equal(order, o) for o in seen):
                continue
            seen.append(order)
            windows = pts[order].reshape(1, k, cap, -1)
            centroids = windows[..., :2].mean(dim=2)
            logits = eval_logits(windows, centroids, None, weights, prec)
            out = torch.empty((k * cap, logits.shape[-1]), dtype=logits.dtype, device=device)
            out[order] = logits.reshape(k * cap, -1)
            outs.append(out[:n].cpu().numpy())
    return outs


def served_gaps(logits: list, labels: np.ndarray):
    """(share of points whose label is the argmax of none of ``logits``, the
    widest gap by which a label's logit lies below the best, the least over
    the tilings, over the RMS of the logits)."""
    labels = labels.astype(np.int64)
    c = logits[0].shape[1]
    if labels.shape[0] != logits[0].shape[0] or labels.min() < 0 or labels.max() >= c:
        return 1.0, float("inf")
    gaps = np.stack([lg.max(axis=1) - np.take_along_axis(lg, labels[:, None], axis=1)[:, 0]
                     for lg in logits]).min(axis=0)
    rms = float(np.sqrt(np.mean(np.square(logits[0].astype(np.float64)))))
    return float(np.mean(gaps > 0)), float(gaps.max()) / max(rms, 1e-30)
