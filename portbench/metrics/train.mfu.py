"""Device, the whole training step: three times the forward's least time
(forward, and backward at twice it) at the card's dense TF32 peak
(``portbench/counts.py``) for the steps of a traced stretch of the window,
over its seconds, in %."""

from portbench.metrics import _device


def read(layers):
    return _device.mfu(layers)
