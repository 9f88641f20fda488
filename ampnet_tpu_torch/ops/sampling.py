"""Point resampling ops, the port's counterpart of ``ampnet_tpu/ops/sampling.py``:
fixed-size random resampling and farthest-point sampling on tensors.

Replaces the host-side NumPy paths of the reference:

* random sample / duplicate to a fixed point count — ``datasets.py:80-89`` and
  ``collate_fns.py:33-41``;
* O(N·S) farthest-point-sampling loop — ``utils/utils.py:889-933``.

``farthest_point_sampling`` is a loop over the S samples on the tensor's
device with one O(N) distance update per step and no host sync inside the
loop (the selected index stays a device tensor);
``batched_farthest_point_sampling`` runs it over B clouds at once (PointNet++). It is the plain version
that the native FPS (``native.fps_native``) is held against. Its squared
distance sums the three axes in one fixed order, ``(dx² + dy²) + dz²``, on
every device.
"""

from __future__ import annotations

from typing import Optional

import torch


def resample_to_fixed_size(
    points: torch.Tensor,  # [N, F]
    n_out: int,
    generator: Optional[torch.Generator] = None,
    valid_mask: Optional[torch.Tensor] = None,  # [N] True = real point
) -> torch.Tensor:
    """Random-sample down / duplicate up to exactly ``n_out`` points.

    Matches the reference's semantics (sample without replacement when N > n_out,
    duplicate random points when N < n_out) on a static-shape input with an optional
    validity mask for padded inputs. The priorities come from ``generator``
    (on ``points``' device), so the draws differ from the JAX package's.

    Contract: ``valid_mask`` must mark at least one point; an all-False mask
    returns ``n_out`` copies of an arbitrary padding point (no host check)."""
    n = points.shape[0]
    dev = points.device
    if valid_mask is None:
        valid_mask = torch.ones(n, dtype=torch.bool, device=dev)
    n_valid = valid_mask.sum()
    # valid points get a random priority, invalid ones -inf: never picked first
    scores = torch.where(valid_mask, torch.rand(n, generator=generator, device=dev),
                         float("-inf"))
    order = torch.argsort(-scores, stable=True)  # valid points in random order, then invalid
    # index i picks order[i % n_valid]: downsample = first n_out random valids,
    # upsample = wrap around (duplicates random valid points)
    pick = order[torch.arange(n_out, device=dev) % n_valid.clamp_min(1)]
    return points[pick]


def farthest_point_sampling(
    points: torch.Tensor,  # [N, >=3] — first 3 columns are xyz (utils.py:894)
    n_samples: int,
    valid_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Indices [n_samples] (int64, on ``points``' device) of the farthest
    points; deterministic, starts at index 0 like the reference
    (utils/utils.py:907-908), or at the first valid point under
    ``valid_mask``."""
    mask = valid_mask[None] if valid_mask is not None else None
    return batched_farthest_point_sampling(points[None], n_samples, mask)[0]


def batched_farthest_point_sampling(
    points: torch.Tensor,  # [B, N, >=3]
    n_samples: int,
    valid_mask: Optional[torch.Tensor] = None,  # [B, N]
) -> torch.Tensor:
    """``farthest_point_sampling`` of each of B clouds at once → [B, n_samples]
    int64: one loop over the samples, each step an O(B·N) update. Ties go to
    the lowest index (``argmax`` takes the first maximum, as ``jnp.argmax``
    does)."""
    xyz = points[..., :3].float()
    b, n = xyz.shape[:2]
    rows = torch.arange(b, device=xyz.device)
    dists = torch.full((b, n), float("inf"), device=xyz.device)
    if valid_mask is None:
        last = torch.zeros(b, dtype=torch.int64, device=xyz.device)
    else:
        dists = torch.where(valid_mask, dists, float("-inf"))
        last = torch.argmax(valid_mask.to(torch.uint8), dim=1)
    selected = torch.empty((b, n_samples), dtype=torch.int64, device=xyz.device)
    selected[:, 0] = last
    for i in range(1, n_samples):
        sq = (xyz - xyz[rows, last][:, None]).square()
        dists = torch.minimum(dists, (sq[..., 0] + sq[..., 1]) + sq[..., 2])
        last = torch.argmax(dists, dim=1)
        selected[:, i] = last
    return selected


def fps_points(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Gathered FPS subset, mirroring the reference's return-points API
    (utils/utils.py:933)."""
    return points[farthest_point_sampling(points, n_samples)]
