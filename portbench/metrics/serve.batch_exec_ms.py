"""Tiled inferencer (``infer/tiled.py``): ms from a batch's dispatch until
its fetch completes, the mean over the window's batches (``/v1/stats``
``device_s_total / device_batches``)."""


def read(layers):
    b = (layers.get("stats") or {}).get("breakdown", {})
    if not b.get("device_batches"):
        return None
    return b["device_s_total"] / b["device_batches"] * 1e3
