"""Device: the share of a traced stretch of the window in which no device
operation ran, in % (torch.profiler's device ops over the stretch's host
time, after one warm-up step of the profiler)."""

from portbench.metrics import _device


def read(layers):
    return _device.idle_share(layers)
