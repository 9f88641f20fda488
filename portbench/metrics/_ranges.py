"""Shared by the readers of the program's own host ranges: the device ms a
traced step launched inside one range (``layers["ranges"]``, which holds
only the ranges the trace saw; a program without the range gives None)."""


def ms_per_step(layers, name):
    ranges, steps = layers.get("ranges") or {}, layers.get("trace_steps")
    if name not in ranges or not steps:
        return None
    return ranges[name] / steps * 1e3
