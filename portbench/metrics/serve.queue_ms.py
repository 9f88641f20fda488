"""Micro-batcher (``infer/server.py``'s ``PredictionService``): ms a warm
request waits from its enqueue to the start of its batch's dispatch, the
mean ``batch.queue`` of the server's spans (``/v1/stats`` ``spans``)."""

from portbench.metrics import _spans


def read(layers):
    return _spans.mean_ms(layers, "batch.queue")
