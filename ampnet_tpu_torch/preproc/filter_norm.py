"""The port's own copy of ``ampnet_tpu/preproc/filter_norm.py`` (pure NumPy).

Stage 2 — filter noise/ground classes and normalize into the canonical 13-column
schema (``data_proc/2_preprocessing_filter_norm.py:16-132``), as one vectorized pass.

Exact reference semantics preserved:

* drop classes {2, 7, 8, 13, 24, 30} (``:41-48``);
* drop points with HAG outside [0, max_z] (``:51-53``);
* NDVI = (NIR − R)/(NIR + R) ∈ [−1, 1], then shifted to [0, 1] (``:71,103-104``);
* 13 columns [x, y, HAG, class, I/5000, R/65536, G/65536, B/65536, NIR/65535, NDVI,
  x_raw, y_raw, z_raw] (``:76-86``);
* x, y min-max normalized to [−1, 1] **within the window** (``:93-94``) — note the
  datasets later rescale an assumed [0, 1] range with ``*2−1`` (datasets.py:378-379);
  the reference therefore double-transforms. We default to the [0, 1] convention the
  datasets expect (``xy_range='unit'``) and offer ``xy_range='neg_one'`` for
  bit-compatible reference output;
* windows with fewer than ``min_points`` survivors are dropped (``:107``);
* output naming: ``tower_`` if >10 class-15 points, elif ``powerline_`` if >10
  class-14 points, else ``pc_`` (``:111-119``).

The reference re-attaches NIR through an md5-of-coordinates side table (an artifact of
its NIR living in separate files, ``:59-67``); here NIR arrives as a column.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

DROP_CLASSES = (2, 7, 8, 13, 24, 30)


def filter_and_normalize(
    x: np.ndarray,
    y: np.ndarray,
    hag: np.ndarray,
    classification: np.ndarray,
    intensity: np.ndarray,
    red: np.ndarray,
    green: np.ndarray,
    blue: np.ndarray,
    nir: Optional[np.ndarray] = None,
    z_raw: Optional[np.ndarray] = None,
    max_z: float = 100.0,
    max_intensity: float = 5000.0,
    min_points: int = 1024,
    xy_range: str = "unit",
) -> Tuple[Optional[np.ndarray], str]:
    """Returns (canonical [N, 13] array or None if too small/degenerate, name prefix)."""
    cls = classification.astype(np.int64)
    keep = ~np.isin(cls, DROP_CLASSES)
    keep &= (hag >= 0) & (hag <= max_z)
    if not keep.any():
        return None, "pc_"

    x, y, hag, cls = x[keep], y[keep], hag[keep], cls[keep]
    intensity, red, green, blue = intensity[keep], red[keep], green[keep], blue[keep]
    has_nir = nir is not None
    nir = np.zeros_like(x) if nir is None else nir[keep]
    z_raw = hag if z_raw is None else z_raw[keep]

    if x.max() - x.min() == 0 or y.max() - y.min() == 0:
        return None, "pc_"  # degenerate window (reference guard, :91)

    if has_nir:
        denom = np.maximum(nir + red, 1e-9)
        ndvi = np.clip(((nir - red) / denom + 1.0) / 2.0, 0.0, 1.0)
    else:
        # NIR-less datasets: the reference hardcodes ndvi=0 BEFORE the +1/2
        # shift, i.e. a stored constant 0.5 (2_preprocessing_filter_norm.py:
        # 73-75,104) — computing from a zero NIR channel would give 0.0 and
        # shift the whole feature by 0.5 against reference-trained models
        ndvi = np.full_like(x, 0.5)

    xn = (x - x.min()) / (x.max() - x.min())
    yn = (y - y.min()) / (y.max() - y.min())
    if xy_range == "neg_one":
        xn, yn = 2 * xn - 1, 2 * yn - 1

    pc = np.stack(
        [
            xn,
            yn,
            np.clip(hag / max_z, 0.0, 1.0),
            cls.astype(np.float64),
            np.clip(intensity / max_intensity, 0.0, 1.0),
            red / 65536.0,
            green / 65536.0,
            blue / 65536.0,
            np.clip(nir / 65535.0, 0.0, 1.0),
            ndvi,
            x,
            y,
            z_raw,
        ],
        axis=1,
    ).astype(np.float32)

    if pc.shape[0] < min_points:
        return None, "pc_"

    counts = np.bincount(cls, minlength=16)
    if counts[15] > 10:
        prefix = "tower_"
    elif counts[14] > 10:
        prefix = "powerline_"
    else:
        prefix = "pc_"
    return pc, prefix
