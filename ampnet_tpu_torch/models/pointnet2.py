"""PointNet++ (set abstraction + feature propagation), the port's counterpart
of ``ampnet_tpu/models/pointnet2.py``: the reference's SA/FP geometry
(pointnetAtt.py:282-322; SA(1024, 0.1, 32, [32,32,64]) → SA(256, 0.2, 32,
[64,64,128]) → SA(64, 0.4, 32, [128,128,256]) → FP stacks → per-point head),
with the same index rules as the JAX module, so the same inputs pick the
same points:

* farthest point sampling is ``ops/sampling.py``'s, batched over clouds,
  starting at index 0, ties to the lowest index;
* the ball query fills out-of-ball slots with the sentinel N, sorts, keeps the
  first ``nsample`` and replaces sentinels by the group's first member;
* the 3-NN of feature propagation take the three smallest squared
  distances, ties to the lower index (``lax.top_k``'s order), by three
  ``argmin`` passes.

Indices are taken without gradient; features are gathered with them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ampnet_tpu_torch.models.layers import (
    MaskedBatchNorm,
    default_generator,
    dropout,
    make_linear,
)
from ampnet_tpu_torch.ops.sampling import batched_farthest_point_sampling


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, n, 3], b [B, m, 3] → [B, n, m] squared distances, as the JAX
    module takes them: |a|² + |b|² − 2 a·b."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1)
    return a2 + b2[..., None, :] - 2 * (a @ b.transpose(-1, -2))


def ball_query(centers: torch.Tensor, xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """centers [B, S, 3], xyz [B, N, 3] → [B, S, nsample] int64 indices into N:
    the lowest-index points within ``radius``, padded with the first of them
    (a center is one of the points, so the first always exists)."""
    with torch.no_grad():
        n = xyz.shape[1]
        d2 = _sqdist(centers, xyz)
        idx = torch.arange(n, device=xyz.device).expand(d2.shape)
        idx = torch.where(d2 <= radius * radius, idx, n)  # out of the ball → sentinel N
        idx = torch.sort(idx, dim=-1).values[..., :nsample]
        return torch.where(idx == n, idx[..., :1], idx)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] → [B, ..., C]."""
    b, c = points.shape[0], points.shape[-1]
    flat = idx.reshape(b, -1, 1).expand(-1, -1, c)
    return torch.gather(points, 1, flat).reshape(*idx.shape, c)


class _MLP(nn.Module):
    """Bias-free dense + BatchNorm (statistics over every leading axis, no
    mask) + ReLU blocks ``mlp_i``/``bn_i``."""

    def __init__(self, cin: int, mlp: Sequence[int], generator: torch.Generator):
        super().__init__()
        for i, f in enumerate(mlp):
            self.add_module(f"mlp_{i}", make_linear(cin, f, False, generator))
            self.add_module(f"bn_{i}", MaskedBatchNorm(f))
            cin = f
        self.depth = len(mlp)

    def run(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            h = torch.relu(getattr(self, f"bn_{i}")(getattr(self, f"mlp_{i}")(h)))
        return h


class SetAbstraction(_MLP):
    """FPS downsample to ``npoint`` centers + ball-query grouping (relative
    coordinates beside the gathered features) + shared MLP + max pool over
    each group. (The JAX module's ``group_all`` is left out: the segmenter
    never groups all.)"""

    def __init__(self, radius: float, nsample: int, cin: int, mlp: Sequence[int],
                 generator: torch.Generator):
        super().__init__(cin + 3, mlp, generator)
        self.radius, self.nsample = radius, nsample

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, npoint: int):
        # xyz [B, N, 3]; feats [B, N, C]
        new_xyz = gather_points(xyz, batched_farthest_point_sampling(xyz, npoint))  # [B, S, 3]
        idx = ball_query(new_xyz, xyz, self.radius, self.nsample)  # [B, S, ns]
        grouped = torch.cat([gather_points(xyz, idx) - new_xyz[:, :, None],  # relative
                             gather_points(feats, idx)], -1)
        return new_xyz, self.run(grouped).amax(dim=2)  # [B, S, mlp[-1]]


def three_nn(d2: torch.Tensor):
    """The three smallest entries of ``d2 [B, N, S]`` along S in ascending
    order, ties to the lower index → (values, indices), each [B, N, 3]."""
    with torch.no_grad():
        d = d2.clone()
        vals, idxs = [], []
        for _ in range(3):
            i = d.argmin(dim=-1, keepdim=True)
            vals.append(torch.gather(d2, -1, i))
            idxs.append(i)
            d.scatter_(-1, i, float("inf"))
        return torch.cat(vals, -1), torch.cat(idxs, -1)


class FeaturePropagation(_MLP):
    """3-NN inverse-distance interpolation of coarse features back to fine
    points, optionally beside the fine level's skip features, then the MLP."""

    def forward(self, xyz_fine, xyz_coarse, feats_fine, feats_coarse):
        if xyz_coarse.shape[1] == 1:
            interp = feats_coarse.expand(*xyz_fine.shape[:2], feats_coarse.shape[-1])
        else:
            d2, idx = three_nn(_sqdist(xyz_fine, xyz_coarse))  # [B, N, 3]
            w = 1.0 / d2.clamp_min(1e-8)
            w = w / w.sum(dim=-1, keepdim=True)
            interp = torch.einsum("bnk,bnkc->bnc", w, gather_points(feats_coarse, idx))
        h = interp if feats_fine is None else torch.cat([feats_fine, interp], -1)
        return self.run(h)


class PointNet2Segmenter(nn.Module):
    """Per-point semantic segmentation with the reference's SA/FP geometry and
    a per-point head (``head_1`` 128, ``head_bn``, ReLU, dropout, ``head_out``).
    Presents the AMP call signature; the point counts are ``min(1024, N)``,
    ``min(256, N // 2)`` and ``min(64, N // 4)``. It has no T-Nets: the
    transforms it returns are 64×64 identities, so the train step's
    regulariser is a constant."""

    def __init__(self, num_classes: int = 5, drop_rate: float = 0.5, num_features: int = 9,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.sa1 = SetAbstraction(0.1, 32, num_features, (32, 32, 64), g)
        self.sa2 = SetAbstraction(0.2, 32, 64, (64, 64, 128), g)
        self.sa3 = SetAbstraction(0.4, 32, 128, (128, 128, 256), g)
        self.fp3 = FeaturePropagation(128 + 256, (256, 256), g)
        self.fp2 = FeaturePropagation(64 + 256, (256, 128), g)
        self.fp1 = FeaturePropagation(128, (128, 128, 128), g)
        self.head_1 = make_linear(128, 128, False, g)
        self.head_bn = MaskedBatchNorm(128)
        self.head_out = make_linear(128, num_classes, True, g)
        self.drop_rate = drop_rate

    def forward(self, points, centroids=None, window_pad_mask=None, point_mask=None,
                generator: Optional[torch.Generator] = None):
        shape = points.shape
        x = points.reshape(-1, *shape[-2:])  # windows fold into the batch
        xyz = x[..., :3]
        n = xyz.shape[1]
        # the full feature input, as l0_points in the reference
        l1_xyz, l1 = self.sa1(xyz, x, min(1024, n))
        l2_xyz, l2 = self.sa2(l1_xyz, l1, min(256, n // 2))
        l3_xyz, l3 = self.sa3(l2_xyz, l2, min(64, n // 4))
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        l0 = self.fp1(xyz, l1_xyz, None, l1)
        h = torch.relu(self.head_bn(self.head_1(l0)))
        h = dropout(h, self.drop_rate if self.training else 0.0, generator)
        logits = self.head_out(h)
        eye = torch.eye(64, dtype=logits.dtype, device=logits.device)
        t_feat = eye.expand(*shape[:-2], 64, 64)
        return logits.reshape(*shape[:-1], -1), t_feat, None
