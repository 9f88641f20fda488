"""PointNet++ (``models/pointnet2.py``): device ms a step launched inside
the program's ``pointnet2.three_nn`` ranges, feature propagation's
distance matrix, three nearest and inverse-distance interpolation, from a
traced stretch of the window (the forward only)."""

from portbench.metrics import _ranges


def read(layers):
    return _ranges.ms_per_step(layers, "three_nn")
