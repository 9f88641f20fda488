"""Tiled inferencer (``infer/tiled.py``'s ``dispatch_many``): host ms a warm
batch takes to pad, encode, start the k-means, pin and launch its buckets,
the mean ``batch.dispatch`` of the server's spans (``/v1/stats``
``spans``)."""

from portbench.metrics import _spans


def read(layers):
    return _spans.mean_ms(layers, "batch.dispatch")
