"""Device, the whole forward: its least time (each part at the dense peak
of its precision, int8 chains at the int8 peak; ``portbench/counts.py``)
for the calls of a traced stretch of the window, over its seconds, in %."""

from portbench.metrics import _device


def read(layers):
    return _device.mfu(layers)
