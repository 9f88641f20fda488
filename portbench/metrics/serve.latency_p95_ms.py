"""The whole request, on the clients' clock: the 95th percentile (nearest
rank) of the time from sending a ``POST /v1/predict`` to holding its
labels, over the requests sent in the untraced rest of the window and
completed inside it (a failed one counts as never answered), in ms."""


def read(layers):
    return layers.get("latency_p95_ms")
