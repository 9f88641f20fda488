"""PointNet++ (``models/pointnet2.py``): device ms a step launched inside
the program's ``pointnet2.ball_query`` ranges, the distance matrix, the
sentinel fill and the full sort, from a traced stretch of the window."""

from portbench.metrics import _ranges


def read(layers):
    return _ranges.ms_per_step(layers, "ball_query")
