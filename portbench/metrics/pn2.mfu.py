"""Device, the whole PointNet++ training step: three times the forward's
least time (``portbench/counts_pointnet2.py``: its products at the card's
dense TF32 peak) for the steps of a traced stretch of the window, over its
seconds, in % (``train.mfu`` for the whole-cloud cell)."""

from portbench.metrics import _device


def read(layers):
    return _device.mfu(layers)
