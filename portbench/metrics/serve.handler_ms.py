"""HTTP front (``infer/server.py``'s handler): ms a warm request spends in
the handler outside ``PredictionService`` (body read, decode, encode,
write), the mean ``http.request`` less the mean ``service.predict`` of the
server's spans (``/v1/stats`` ``spans``)."""

from portbench.metrics import _spans


def read(layers):
    whole, served = _spans.mean_ms(layers, "http.request"), _spans.mean_ms(
        layers, "service.predict")
    if whole is None or served is None:
        return None
    return whole - served
