"""Micro-batcher (``PredictionService``): clouds a device batch over the
window (``/v1/stats`` ``breakdown.batch_clouds_mean``)."""


def read(layers):
    return (layers.get("stats") or {}).get("breakdown", {}).get("batch_clouds_mean")
