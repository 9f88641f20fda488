"""Device, in the PointNet++ training step: the share of a traced stretch
of the window in which no device operation ran, in % (``train.idle_share``
for the whole-cloud cell, which reports ``points_per_s``)."""

from portbench.metrics import _device


def read(layers):
    return _device.idle_share(layers)
