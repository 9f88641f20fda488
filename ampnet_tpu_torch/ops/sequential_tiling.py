"""Sequential (non-k-means) window tiling, counterpart of
``ampnet_tpu/ops/sequential_tiling.py``: the reference's legacy tilers
(``utils/utils.py:30-419``, ``split4segmen_point_cloud`` and its family) as
one batched function. A batch of clouds is cut into consecutive windows of
``n_points`` along the point axis, and the ragged tail's pre-padded slots
(target −1) are filled by the reference's policies: ``duplicate`` (random real
points of the same cloud) or ``zero`` (zero points, targets left −1).

Everything runs on the input's device. ``duplicate`` draws its indices from
a ``torch.Generator`` of that device (other bits than ``jax.random``), then
gathers through ``sequential_tiling_from``, which takes the indices: tests
pass JAX's draw there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

def _windows(points: torch.Tensor, n_points: int) -> Tuple[int, int]:
    """(W, W · n_points): the reference drops the last unfillable window
    (utils.py:115-117)."""
    b, n, f = points.shape
    w = n // n_points
    if w == 0:
        raise ValueError(f"cloud of {n} points smaller than one {n_points} window")
    return w, w * n_points


def sequential_tiling_from(
    points: torch.Tensor,  # [B, N, F]
    targets: torch.Tensor,  # [B, N] with −1 marking pre-padded slots
    n_points: int,
    fill: str = "duplicate",
    rand: Optional[torch.Tensor] = None,  # [B, W · n_points] ints in [0, N) for 'duplicate'
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sequential_tiling`` with the duplicate fill's raw indices given:
    slot i of cloud b takes the valid point ``rand[b, i] % n_valid[b]``."""
    b, _, f = points.shape
    w, m = _windows(points, n_points)
    pts, tgt = points[:, :m], targets[:, :m]
    pad = tgt == -1
    if fill == "duplicate":
        if rand is None:
            raise ValueError("the duplicate fill needs its indices (rand)")
        n_valid = (targets != -1).sum(dim=1).clamp_min(1)  # [B]
        idx = torch.as_tensor(rand, device=points.device).long() % n_valid[:, None]
        repl_pts = torch.gather(points, 1, idx[..., None].expand(b, m, f))
        repl_tgt = torch.gather(targets, 1, idx)
        pts = torch.where(pad[..., None], repl_pts, pts)
        tgt = torch.where(pad, repl_tgt, tgt)
    elif fill == "zero":
        pts = torch.where(pad[..., None], torch.zeros((), dtype=pts.dtype, device=pts.device),
                          pts)
        # targets stay −1: the loss ignores them (reference utils.py:139-141)
    else:
        raise ValueError(f"unknown fill {fill!r}")
    return pts.reshape(b, w, n_points, f), tgt.reshape(b, w, n_points)


def sequential_tiling(
    points: torch.Tensor,  # [B, N, F]
    targets: torch.Tensor,  # [B, N] with −1 marking pre-padded slots
    n_points: int,
    generator: Optional[torch.Generator] = None,
    fill: str = "duplicate",  # 'duplicate' | 'zero' (reference duplicate=True/False)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (windows [B, W, n_points, F], window_targets [B, W, n_points])
    with W = N // n_points. ``duplicate`` draws from ``generator`` (a
    generator of the points' device seeded 0 when none is given)."""
    b, n, _ = points.shape
    _, m = _windows(points, n_points)
    rand = None
    if fill == "duplicate":
        if generator is None:
            generator = torch.Generator(device=points.device).manual_seed(0)
        rand = torch.randint(0, n, (b, m), generator=generator, device=points.device)
    return sequential_tiling_from(points, targets, n_points, fill, rand)
