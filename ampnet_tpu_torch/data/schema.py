"""Segmentation label names and the x/y rescale the serving path needs.

The port's own copy of the two pieces of ``ampnet_tpu/data/schema.py`` that
serving reads (``SEG_CLASS_NAMES``, ``normalize_xy_neg_one``); the rest of the
schema arrives with the data slices.
"""

from __future__ import annotations

import numpy as np

SEG_CLASS_NAMES = ("background", "tower", "lines", "low_med_veg", "high_veg")


def normalize_xy_neg_one(pc: np.ndarray) -> np.ndarray:
    """x,y ∈ [0,1] → [-1,1] (pc_normalize_neg_one, datasets.py:372-384).
    Returns a new array."""
    scale = np.asarray([2.0, 2.0] + [1.0] * (pc.shape[-1] - 2), dtype=pc.dtype)
    shift = np.asarray([-1.0, -1.0] + [0.0] * (pc.shape[-1] - 2), dtype=pc.dtype)
    return pc * scale + shift
