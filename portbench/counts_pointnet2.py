"""Operations of one PointNet++ forward, the yardstick of ``train.mfu`` in
the whole-cloud cell; priced as ``counts.py`` prices AMP-Net's: 2 × the
multiply-adds of the published widths (``portbench/reference/pointnet2.py``)
at the H100's dense TF32 peak, the same peak ``counts.py`` uses.

Counted: the shared MLPs of the three set abstractions (over every grouped
row), of the three feature propagations (over every fine point), the head,
and the distance products of the ball queries and the 3-NN (3 multiply-adds
a pair). Farthest point sampling, the sort of the ball query, the gathers,
the max-pools, BatchNorm and the interpolation are not products and are
not counted: a step that spends its time there reads a low share."""

from __future__ import annotations

from portbench.counts import TF32_PEAK_FLOPS
from portbench.reference.pointnet2 import FP, HEAD, SA, centres


def _macs(cin: int, widths) -> int:
    out = 0
    for c in widths:
        out, cin = out + cin * c, c
    return out


def model_ops(points: int, clouds: int = 1, classes: int = 5, features: int = 9) -> float:
    """Operations of one eval forward over ``clouds`` clouds of ``points``
    points."""
    n = (points, *centres(points))  # points at each level: the cloud, then the centres
    macs, cin = 0, features
    for level, (_, _, nsample, widths) in enumerate(SA):
        macs += n[level + 1] * nsample * _macs(cin + 3, widths)  # the grouped rows
        macs += n[level + 1] * n[level] * 3  # the ball query's distances
        cin = widths[-1]
    coarse = SA[-1][3][-1]
    for (_, widths), fine in zip(FP, (2, 1, 0)):
        skip = SA[fine - 1][3][-1] if fine else 0
        macs += n[fine] * _macs(skip + coarse, widths)
        macs += n[fine] * n[fine + 1] * 3  # the 3-NN's distances
        coarse = widths[-1]
    macs += points * _macs(coarse, (HEAD, classes))
    return 2.0 * clouds * macs


def least_time_s(ops: float) -> float:
    """Least time of that work at the card's dense TF32 peak."""
    return ops / TF32_PEAK_FLOPS
