"""Sliding-window object scanner, the port's own numpy copy of
``ampnet_tpu/ops/sliding_window.py`` (reference ``sliding_window_coords``,
``utils/utils.py:668-754``): the reference's legacy pipelines localise tower
candidates in a cloud with it.

The same O(windows · N) masking as the reference, with each y-row's mask
taken once and empty rows skipped whole. Consecutive overlapping windows keep
the denser one (reference ``:729-745``), and the window counter ``i_w`` does
not advance over a skipped row, as in the reference, so windows on either
side of an empty row still count as consecutive.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def sliding_window_scan(
    points: np.ndarray,  # [C, N] reference layout (rows x, y, z, ...)
    step_x: float = 10.0,
    step_y: float = 10.0,
    window_size: Tuple[float, float] = (20.0, 20.0),
    min_points: int = 10,
) -> Tuple[Optional[Dict[int, np.ndarray]], Optional[Dict[int, List[float]]]]:
    """Returns (windows, centers) dicts like the reference, or (None, None) when the
    cloud is smaller than one window and too sparse."""
    x, y = points[0], points[1]
    x_min, x_max = float(x.min()), float(x.max())
    y_min, y_max = float(y.min()), float(y.max())

    if window_size[0] > (x_max - x_min) and window_size[1] > (y_max - y_min):
        if points.shape[1] >= min_points:
            return {0: points}, {0: [float(x.mean()), float(y.mean())]}
        return None, None

    windows: Dict[int, np.ndarray] = {}
    centers: Dict[int, List[float]] = {}
    i_w = 0
    last_w_i = 0

    ys = [yy for yy in range(round(y_min), round(y_max), int(step_y))
          if yy + step_y <= y_max]
    xs = list(range(round(x_min), round(x_max), int(step_x)))

    for yy in ys:
        in_y = (y > yy) & (y < yy + window_size[1])
        if not in_y.any():
            # the reference skips an empty y-row without advancing i_w
            # (utils/utils.py:708-710)
            continue
        for xx in xs:
            i_w += 1
            m = in_y & (x > xx) & (x < xx + window_size[0])
            count = int(m.sum())
            if count < min_points:
                continue
            window = points[:, m]
            center = [float(window[0].mean()), float(window[1].mean())]
            if windows and last_w_i == i_w - 1:
                # a consecutive overlapping candidate: keep the denser window
                last_key = next(reversed(windows))
                if count > windows[last_key].shape[1]:
                    windows[last_key] = window
                    centers[last_key] = center
                    last_w_i = i_w
            else:
                windows[len(windows)] = window
                centers[len(centers)] = center
                last_w_i = i_w
    return windows, centers


def scan_for_towers(
    points: np.ndarray,  # [C, N] with the classification in row 3
    tower_classes: Tuple[int, ...] = (15,),
    **kw,
) -> Tuple[Optional[Dict[int, np.ndarray]], Optional[Dict[int, List[float]]]]:
    """Scan the tower-class points only, the reference's usual use of the
    sliding window (localising pylon candidates)."""
    mask = np.isin(points[3], tower_classes)
    if not mask.any():
        return None, None
    return sliding_window_scan(points[:, mask], **kw)
