"""Canonical point-cloud schema and label remapping (numpy).

The port's own copy of what it uses of ``ampnet_tpu/data/schema.py``. The
reference preprocessing emits a 13-column float array per point
(``data_proc/2_preprocessing_filter_norm.py:76-86``)::

    0 x   1 y   2 z   3 class   4 I   5 R   6 G   7 B   8 NIR   9 NDVI
   10 x_raw   11 y_raw   12 z_raw

Model input is the 9 features ``[x,y,z,I,R,G,B,NIR,NDVI]`` — columns [0:3] +
[4:10]. Segmentation labels: 15 → 1 (tower), 14 → 2 (power lines), 3,4 → 3
(low/med veg), 5 → 4 (high veg), everything else → 0 (background).
"""

from __future__ import annotations

import numpy as np


class COL:
    """Column indices of the canonical 13-column schema."""

    X, Y, Z, CLASS, I, R, G, B, NIR, NDVI, X_RAW, Y_RAW, Z_RAW = range(13)


NUM_CANONICAL_COLS = 13
SEG_CLASS_NAMES = ("background", "tower", "lines", "low_med_veg", "high_veg")

# classes the datasets drop at load time. The reference's training loaders also
# drop 14 (power lines, datasets.py:339-350) while its test loader keeps and
# evaluates it; the default keeps 14, REFERENCE_NOISE_CLASSES reproduces the
# reference (``train --reference_noise_compat``)
DATASET_NOISE_CLASSES = (30, 7, 2, 8, 13)
REFERENCE_NOISE_CLASSES = (30, 7, 2, 8, 13, 14)

# raw-class → segmentation-class lookup (dense table over raw ids 0..255)
_REMAP_TABLE = np.zeros(256, dtype=np.int32)
_REMAP_TABLE[15] = 1
_REMAP_TABLE[14] = 2
_REMAP_TABLE[3] = 3
_REMAP_TABLE[4] = 3
_REMAP_TABLE[5] = 4


def remap_segmentation_labels(raw_class: np.ndarray) -> np.ndarray:
    """Raw class ids → the 5 segmentation classes; negative ids (padding
    sentinels) stay −1 so the loss's ignore_index survives."""
    ids = np.asarray(raw_class)
    out = _REMAP_TABLE[np.clip(ids, 0, 255).astype(np.int32)]
    return np.where(ids < 0, -1, out).astype(np.int32)


def classification_label(raw_class: np.ndarray) -> np.int32:
    """Binary tower-presence label: 1 iff any point has class 15 or 14
    (datasets.py:424-429)."""
    ids = np.asarray(raw_class)
    return np.int32(((ids == 15) | (ids == 14)).any())


def drop_noise_points(pc: np.ndarray, noise_classes=DATASET_NOISE_CLASSES) -> np.ndarray:
    """Remove noise-class point rows from an [N, 13] or windowed [N, 13, W]
    array; in the windowed layout a row goes if ANY window copy has a noise
    class (datasets.py:339-350)."""
    cls = pc[:, COL.CLASS]
    bad = np.isin(cls, noise_classes)
    if cls.ndim == 2:
        bad = bad.any(axis=1)
    return pc[~bad]


def select_model_features(pc: np.ndarray, extra_features: int = 0) -> np.ndarray:
    """Drop the class and raw-coordinate columns → the 9 model features
    [x,y,z,I,R,G,B,NIR,NDVI] of an [..., 13+] array (datasets.py:359).

    ``extra_features > 0`` appends that many columns from 13 onward: the
    offline geometric eigenfeatures (preproc/geomfeat.py). Raises when the
    array was preprocessed without them."""
    parts = [pc[..., 0:3], pc[..., 4:10]]
    if extra_features:
        end = NUM_CANONICAL_COLS + extra_features
        if pc.shape[-1] < end:
            raise ValueError(
                f"artifact has {pc.shape[-1]} columns but the model wants "
                f"{extra_features} geometric feature columns (13..{end - 1}) — "
                "re-run `ampnet preprocess --geom_features` on this dataset"
            )
        parts.append(pc[..., NUM_CANONICAL_COLS:end])
    return np.concatenate(parts, axis=-1)


def normalize_xy_neg_one(pc: np.ndarray) -> np.ndarray:
    """x,y ∈ [0,1] → [-1,1] (pc_normalize_neg_one, datasets.py:372-384).
    Returns a new array."""
    scale = np.asarray([2.0, 2.0] + [1.0] * (pc.shape[-1] - 2), dtype=pc.dtype)
    shift = np.asarray([-1.0, -1.0] + [0.0] * (pc.shape[-1] - 2), dtype=pc.dtype)
    return pc * scale + shift
