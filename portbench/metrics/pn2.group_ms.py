"""PointNet++ (``models/pointnet2.py``): device ms a step launched inside
the program's ``pointnet2.group`` ranges, the index gathers of the
members' xyz and features and their concatenation, from a traced stretch
of the window (the forward; the gathers' scatter-add backward runs
outside the ranges)."""

from portbench.metrics import _ranges


def read(layers):
    return _ranges.ms_per_step(layers, "group")
