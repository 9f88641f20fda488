"""HTTP front (``infer/server.py``'s handler): the clients' median latency,
send to labels, less the server's warm median (``/v1/stats`` ``latency_s``
``p50``, from the service's enqueue to its result): the time a request
spends outside ``PredictionService``, in ms."""


def read(layers):
    p50 = (layers.get("stats") or {}).get("latency_s", {}).get("p50")
    median = layers.get("client_median_ms")
    if p50 is None or median is None:
        return None
    return median - p50 * 1e3
