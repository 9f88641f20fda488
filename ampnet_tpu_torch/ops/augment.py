"""On-device data augmentation, counterpart of ``ampnet_tpu/ops/augment.py``
(itself replacing the host NumPy loops of ``utils/utils.py:582-645``).

Each op draws from an explicit ``torch.Generator`` on the tensor's device (the
global RNG is never used) and also takes its draw explicitly (``angle=``,
``perm=``, ``noise=`` …), so a test can feed the same draw to this package and
to the JAX one, whose ``jax.random`` bits differ from torch's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _uniform(shape, generator: torch.Generator, device, lo: float = 0.0, hi: float = 1.0):
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def rotation_matrix_z(angle: torch.Tensor) -> torch.Tensor:
    """Right-multiplied z-rotation ``[[c, s, 0], [-s, c, 0], [0, 0, 1]]``
    (rotate_point_cloud_z, utils/utils.py:582-604)."""
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, s, zero]), torch.stack([-s, c, zero]),
                        torch.stack([zero, zero, one])])


def rotate_z(points: torch.Tensor, generator: Optional[torch.Generator] = None,
             angle=None) -> torch.Tensor:
    """Rotate xyz (the first 3 features of ``[..., N, F]``) about the z axis by
    one shared angle (the reference draws one per batch,
    train_pointnet-attention.py:393); uniform in [0, 2π) unless given."""
    if angle is None:
        angle = _uniform((), generator, points.device) * (2 * math.pi)
    angle = torch.as_tensor(angle, dtype=torch.float32, device=points.device)
    rot = rotation_matrix_z(angle).to(points.dtype)
    return torch.cat([points[..., :3] @ rot, points[..., 3:]], dim=-1)


def jitter(points: torch.Tensor, generator: Optional[torch.Generator] = None,
           sigma: float = 0.01, clip: float = 0.05, noise=None) -> torch.Tensor:
    """Per-point Gaussian jitter on xyz, clipped to ±clip (jitter_point_cloud,
    utils/utils.py:957-974); ``noise`` is the unscaled standard-normal draw."""
    if noise is None:
        noise = torch.randn(points[..., :3].shape, generator=generator, device=points.device)
    noise = torch.clamp(sigma * torch.as_tensor(noise, device=points.device), -clip, clip)
    return torch.cat([points[..., :3] + noise.to(points.dtype), points[..., 3:]], dim=-1)


def random_scale(points: torch.Tensor, generator: Optional[torch.Generator] = None,
                 lo: float = 0.8, hi: float = 1.25, scale=None) -> torch.Tensor:
    """One shared xyz scale, uniform in [lo, hi) (random_scale_point_cloud,
    utils/utils.py:995-1011)."""
    if scale is None:
        scale = _uniform((), generator, points.device, lo, hi)
    s = torch.as_tensor(scale, dtype=points.dtype, device=points.device)
    return torch.cat([points[..., :3] * s, points[..., 3:]], dim=-1)


def random_shift(points: torch.Tensor, generator: Optional[torch.Generator] = None,
                 rng: float = 0.1, shift=None) -> torch.Tensor:
    """One shared xyz translation, each uniform in [−rng, rng)
    (shift_point_cloud, utils/utils.py:977-992)."""
    if shift is None:
        shift = _uniform((3,), generator, points.device, -rng, rng)
    s = torch.as_tensor(shift, dtype=points.dtype, device=points.device)
    return torch.cat([points[..., :3] + s, points[..., 3:]], dim=-1)


def random_point_dropout(points: torch.Tensor, generator: Optional[torch.Generator] = None,
                         max_dropout: float = 0.875, labels: Optional[torch.Tensor] = None,
                         ratio=None, u=None):
    """Replace a random fraction of points with the first point of their window
    (static-shape dropout, random_point_dropout, utils/utils.py:940-954):
    ``ratio`` uniform in [0, max_dropout), then a point drops where its
    uniform draw ``u`` (shape ``points.shape[:-1]``) is below ``ratio``. With
    ``labels``, dropped points take the first point's label too and
    ``(points, labels)`` is returned."""
    if ratio is None:
        ratio = _uniform((), generator, points.device) * max_dropout
    if u is None:
        u = torch.rand(points.shape[:-1], generator=generator, device=points.device)
    drop = torch.as_tensor(u, device=points.device) < torch.as_tensor(ratio, device=points.device)
    out = torch.where(drop[..., None], points[..., :1, :].expand_as(points), points)
    if labels is None:
        return out
    return out, torch.where(drop, labels[..., :1].expand_as(labels), labels)


def shuffle_points(points: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None, perm=None):
    """Permute the point axis of ``points`` [..., N, F] and ``labels`` [..., N]
    with one shared permutation (shuffle_data, utils/utils.py:607-617). The
    encoder is permutation-invariant; order-sensitive consumers (FPS seeding,
    visual diffs) see the change."""
    if perm is None:
        perm = torch.randperm(points.shape[-2], generator=generator, device=points.device)
    perm = torch.as_tensor(perm, dtype=torch.long, device=points.device)
    return points[..., perm, :], labels[..., perm]


def shuffle_windows(points: torch.Tensor, labels: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    centroids: Optional[torch.Tensor] = None, perm=None):
    """Permute the window axis of ``[B, W, ...]`` with one shared permutation:
    points, labels (and centroids) move together (shuffle_clusters,
    utils/utils.py:620-632)."""
    if perm is None:
        perm = torch.randperm(points.shape[1], generator=generator, device=points.device)
    perm = torch.as_tensor(perm, dtype=torch.long, device=points.device)
    out = (points[:, perm], labels[:, perm])
    if centroids is not None:
        out = out + (centroids[:, perm],)
    return out
