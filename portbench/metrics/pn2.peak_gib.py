"""Device memory of the PointNet++ training step: ``max_memory_allocated``
over the window, after ``reset_peak_memory_stats`` at its start, in GiB
(``train.peak_gib`` for the whole-cloud cell)."""


def read(layers):
    peak = layers.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
