"""Point resampling ops, the port's counterpart of ``ampnet_tpu/ops/sampling.py``:
fixed-size random resampling and farthest-point sampling on tensors.

Replaces the host-side NumPy paths of the reference:

* random sample / duplicate to a fixed point count — ``datasets.py:80-89`` and
  ``collate_fns.py:33-41``;
* O(N·S) farthest-point-sampling loop — ``utils/utils.py:889-933``.

``batched_farthest_point_sampling`` samples B clouds at once (PointNet++);
``farthest_point_sampling`` one cloud through it. It routes by device: a
CUDA tensor runs one launch of the hand-written kernel of ``csrc/fps.cu``
(``batched_farthest_point_sampling_kernel``) for the whole loop, and raises
where the kernel does not take the input (there is no fallback); any other
tensor runs the plain version, ``batched_farthest_point_sampling_plain``: a
loop over the S samples on the tensor's device with one O(B·N) distance
update per step and no host sync inside the loop (the selected index stays a
device tensor). The plain version is what the kernel is held to on the card
and the native FPS (``native.fps_native``) on the host. Both compute the
squared distance as ``(dx² + dy²) + dz²``, ``dx = x - x_last`` and ``dx²``
as ``dx * dx``, each operation rounded to float32 in that order, keep
``torch.minimum``'s running minimum (NaN wins) and take ``torch.argmax``'s
first maximum (NaN counts as the maximum), so the kernel picks the plain
loop's indices bit for bit. ``batched_farthest_point_sampling.launches``
counts the kernel's launches (one a call; a CUDA graph's replays included,
``ops/launch_count.py``).

``ball_query_members`` is PointNet++'s ball query on a squared-distance block
``d2 [B, S, N]``: for each centre the first ``nsample`` in-ball indices in
ascending order, padded with the first of them. It routes by device in the
same way: a CUDA tensor runs one launch of ``csrc/ball_query.cu``
(``ball_query_members_kernel``, a scan of each row that stops at its
``nsample``-th member) or raises, any other tensor the plain body
(``ball_query_members_plain``: the sentinel N outside the ball, a sort of each
row, the first ``nsample`` kept). Both admit ``d2 <= radius * radius``, the
threshold rounded once to float32 as torch compares a float32 tensor with a
Python float, so they pick the same integers; ``ball_query_members.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ampnet_tpu_torch.ops import cuda_build


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


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def batched_farthest_point_sampling(
    points: torch.Tensor,  # [B, N, >=3]
    n_samples: int,
    valid_mask: Optional[torch.Tensor] = None,  # [B, N] bool
) -> torch.Tensor:
    """``farthest_point_sampling`` of each of B clouds at once → [B, n_samples]
    int64 on ``points``' device. Ties go to the lowest index (``argmax`` takes
    the first maximum, as ``jnp.argmax`` does). On a CUDA tensor one launch of
    ``csrc/fps.cu``, else the plain loop; both pick the same indices."""
    if not _on_card(points):
        return batched_farthest_point_sampling_plain(points, n_samples, valid_mask)
    mask = None if valid_mask is None else valid_mask.contiguous()
    return batched_farthest_point_sampling_kernel(points[..., :3].float().contiguous(),
                                                  n_samples, mask)


batched_farthest_point_sampling.launches = 0


def batched_farthest_point_sampling_plain(
    points: torch.Tensor,  # [B, N, >=3]
    n_samples: int,
    valid_mask: Optional[torch.Tensor] = None,  # [B, N] bool
) -> torch.Tensor:
    """The plain version: one loop over the samples on ``points``' device,
    each step an O(B·N) update → [B, n_samples] int64. Starts at index 0, or
    at the first valid point under ``valid_mask``. Masked points start at
    -inf, so a cloud with a valid point never picks one (NaN coordinates
    aside), one without returns index 0 throughout, and once every valid
    point lies at distance 0 the lowest valid index repeats."""
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


FPS_SIGNATURES = {
    "fps_scratch_points": (ctypes.c_int, [ctypes.c_int]),
    "fps_sample": (ctypes.c_int, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
}


def batched_farthest_point_sampling_kernel(
    xyz: torch.Tensor,  # [B, N, 3] float32, contiguous, on a CUDA device
    n_samples: int,
    valid_mask: Optional[torch.Tensor] = None,  # [B, N] bool, contiguous, on xyz's device
) -> torch.Tensor:
    """The whole sampling loop as one launch of ``csrc/fps.cu`` → [B,
    n_samples] int64, equal to ``batched_farthest_point_sampling_plain``'s
    bit for bit. On the current stream, memory from ``torch.empty``, no host
    sync: it captures into a CUDA graph. It raises on anything else (there
    is no fallback) and counts its launch on
    ``batched_farthest_point_sampling.launches``."""
    if xyz.dtype != torch.float32:
        raise TypeError(f"batched_farthest_point_sampling_kernel takes float32 xyz, got "
                        f"{xyz.dtype}")
    if not (xyz.dim() == 3 and xyz.shape[-1] == 3 and 1 <= xyz.shape[0] < 2**31
            and 1 <= xyz.shape[1] < 2**31 and 1 <= n_samples < 2**31):
        raise ValueError(f"batched_farthest_point_sampling_kernel takes xyz [B, N, 3] with B, "
                         f"N >= 1 and at least one sample, got {tuple(xyz.shape)}, {n_samples}")
    if not xyz.is_contiguous():
        raise ValueError("batched_farthest_point_sampling_kernel takes a contiguous xyz")
    b, n = xyz.shape[:2]
    if valid_mask is not None:
        if valid_mask.dtype != torch.bool:
            raise TypeError(f"batched_farthest_point_sampling_kernel takes a bool valid_mask, "
                            f"got {valid_mask.dtype}")
        if tuple(valid_mask.shape) != (b, n) or not valid_mask.is_contiguous():
            raise ValueError(f"batched_farthest_point_sampling_kernel takes a contiguous "
                             f"valid_mask [{b}, {n}], got {tuple(valid_mask.shape)}")
    if not _on_card(xyz) or (valid_mask is not None and valid_mask.device != xyz.device):
        raise ValueError(f"batched_farthest_point_sampling_kernel runs on a CUDA device, "
                         f"every tensor on it (xyz on {xyz.device}, valid_mask on "
                         f"{None if valid_mask is None else valid_mask.device})")
    selected = torch.empty((b, n_samples), dtype=torch.int64, device=xyz.device)
    scratch = cuda_build.load("fps", FPS_SIGNATURES).fps_scratch_points(n)
    minima = torch.empty((b, scratch), dtype=torch.float32, device=xyz.device)
    _fps_sample(xyz, valid_mask, minima, selected)
    return selected


@torch.library.custom_op("ampnet_tpu_torch::fps_sample", mutates_args=("minima", "selected"))
def _fps_sample(xyz: torch.Tensor, valid_mask: Optional[torch.Tensor], minima: torch.Tensor,
                selected: torch.Tensor) -> None:
    """One launch of ``csrc/fps.cu`` into ``selected`` (``minima`` its
    scratch), counted on ``batched_farthest_point_sampling``, as an operator
    of torch's dispatcher: a profiler links the kernel to the op, and so to
    the ranges around the call; a bare ctypes launch is linked to no op."""
    b, n = xyz.shape[:2]
    lib = cuda_build.load("fps", FPS_SIGNATURES)
    cuda_build.launch(batched_farthest_point_sampling, lib.fps_sample, xyz.device,
                      xyz.data_ptr(), None if valid_mask is None else valid_mask.data_ptr(),
                      minima.data_ptr() if minima.numel() else None, selected.data_ptr(), b, n,
                      selected.shape[1])


def ball_query_members(d2: torch.Tensor, radius: float, nsample: int) -> torch.Tensor:
    """``d2 [B, S, N]`` squared distances → ``[B, S, min(nsample, N)]``
    int64: in each row the in-ball indices (``d2 <= radius * radius``) in
    ascending order, the slots past the last padded with the first, all N
    where the row has none. On a CUDA tensor one launch of
    ``csrc/ball_query.cu``, else the plain body; both pick the same
    integers."""
    if not _on_card(d2):
        return ball_query_members_plain(d2, radius, nsample)
    return ball_query_members_kernel(d2.contiguous(), radius, nsample)


ball_query_members.launches = 0


def ball_query_members_plain(d2: torch.Tensor, radius: float, nsample: int) -> torch.Tensor:
    """The plain body on ``d2``'s device: the sentinel N outside the ball, a
    sort of each row, the first ``nsample`` kept and the sentinels replaced
    by the row's first entry (N where the row has no member)."""
    n = d2.shape[-1]
    idx = torch.arange(n, device=d2.device).expand(d2.shape)
    idx = torch.where(d2 <= radius * radius, idx, n)  # out of the ball → sentinel N
    idx = torch.sort(idx, dim=-1).values[..., :nsample]
    return torch.where(idx == n, idx[..., :1], idx)


BALL_QUERY_SIGNATURES = {
    "ball_query_members": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                          ctypes.c_void_p]),
}


def ball_query_members_kernel(d2: torch.Tensor, radius: float, nsample: int) -> torch.Tensor:
    """One launch of ``csrc/ball_query.cu`` → ``[B, S, min(nsample, N)]``
    int64, equal to ``ball_query_members_plain``'s. On the current stream,
    output from ``torch.empty``, no host sync: it captures into a CUDA graph.
    It raises on anything else (there is no fallback) and counts its launch on
    ``ball_query_members.launches``."""
    if d2.dtype != torch.float32:
        raise TypeError(f"ball_query_members_kernel takes float32 d2, got {d2.dtype}")
    if not (d2.dim() == 3 and 1 <= d2.shape[0] * d2.shape[1] < 2**31
            and 1 <= d2.shape[2] < 2**31 and nsample >= 1):
        raise ValueError(f"ball_query_members_kernel takes d2 [B, S, N] with B, S, N >= 1 and "
                         f"nsample >= 1, got {tuple(d2.shape)}, {nsample}")
    if not d2.is_contiguous():
        raise ValueError("ball_query_members_kernel takes a contiguous d2")
    if not _on_card(d2):
        raise ValueError(f"ball_query_members_kernel runs on a CUDA device, got d2 on "
                         f"{d2.device}")
    b, s, n = d2.shape
    members = torch.empty((b, s, min(nsample, n)), dtype=torch.int64, device=d2.device)
    _ball_query_members(d2, radius * radius, members)
    return members


@torch.library.custom_op("ampnet_tpu_torch::ball_query_members", mutates_args=("members",))
def _ball_query_members(d2: torch.Tensor, threshold: float, members: torch.Tensor) -> None:
    """One launch of ``csrc/ball_query.cu`` into ``members`` (ctypes rounds
    ``threshold`` to float32), counted on ``ball_query_members``, as an
    operator of torch's dispatcher, so a profiler links the kernel to the
    ranges around the call (see ``_fps_sample``)."""
    b, s, n = d2.shape
    lib = cuda_build.load("ball_query", BALL_QUERY_SIGNATURES)
    cuda_build.launch(ball_query_members, lib.ball_query_members, d2.device, d2.data_ptr(),
                      members.data_ptr(), b * s, n, members.shape[-1], threshold)


def fps_points(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Gathered FPS subset, mirroring the reference's return-points API
    (utils/utils.py:933)."""
    return points[farthest_point_sampling(points, n_samples)]
