"""Forward (the bucket graph's forward, argmax and scatter): device ms of a
warm served batch's forward, from the graph's own stamps of the card's clock
(``ops/device_stamp.py``), the mean ``device.forward`` of the server's spans
(``/v1/stats`` ``spans``)."""

from portbench.metrics import _spans


def read(layers):
    return _spans.mean_ms(layers, "device.forward")
