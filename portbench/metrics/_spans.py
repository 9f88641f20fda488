"""Shared by the serving readers of the program's own spans: a span name's
mean over the warm requests or batches of the server's ``/v1/stats``
snapshot (``spans``: ``{name: {count, total_s, mean_ms}}``), taken over the
traced run's untraced rest. A server without spans gives None."""


def mean_ms(layers, name):
    span = ((layers.get("stats") or {}).get("spans") or {}).get(name)
    if not span or not span.get("count"):
        return None
    return span["mean_ms"]
