"""Shared by the device readers: the idle share of a traced stretch and
the model's share of the card's peak over it."""


def idle_share(layers):
    trace, span = layers.get("trace"), layers.get("trace_window_s")
    if trace is None or not span or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / span)


def mfu(layers):
    """The model's least time for the work done in the traced stretch
    (``portbench/counts.py``) over the stretch's host time, in %."""
    span, least = layers.get("trace_window_s"), layers.get("trace_model_least_s")
    if not span or not least:
        return None
    return 100.0 * least / span
