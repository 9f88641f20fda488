"""Tiling (``ops/kmeans.py::balanced_kmeans`` and the reorder gather, inside
the bucket graph): device ms of a warm served batch's tiling, from the
graph's own stamps of the card's clock (``ops/device_stamp.py``), the mean
``device.tiling`` of the server's spans (``/v1/stats`` ``spans``)."""

from portbench.metrics import _spans


def read(layers):
    return _spans.mean_ms(layers, "device.tiling")
