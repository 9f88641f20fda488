"""PointNet++ (``models/pointnet2.py``): device ms a step launched inside
the program's ``pointnet2.fps`` ranges, farthest point sampling (the eager
loop of ``ops/sampling.py``) and the centres' gather, from a traced stretch
of the window (the forward; the backward runs outside the ranges)."""

from portbench.metrics import _ranges


def read(layers):
    return _ranges.ms_per_step(layers, "fps")
