"""Device, the whole served path: the model's least time for the clouds
completed in a traced stretch of the window (each cloud's forward over k ·
cap = 18 · 4,096 points at the configuration's widths, at the card's dense
TF32 peak; ``portbench/counts.py``), over the stretch's seconds, in %. The
k-means is not model work."""

from portbench.metrics import _device


def read(layers):
    return _device.mfu(layers)
