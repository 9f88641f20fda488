"""Tiled inferencer (``infer/tiled.py``'s ``dispatch_many``): the share of a
warm served batch's device points that are padding (replicated points up to
k · cap, and copies of a cloud up to the power-of-two batch), in %, over the
window's warm batches (``/v1/stats`` ``breakdown.pad_share``)."""


def read(layers):
    share = (layers.get("stats") or {}).get("breakdown", {}).get("pad_share")
    return None if share is None else 100.0 * share
