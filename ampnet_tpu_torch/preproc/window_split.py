"""The port's own copy of ``ampnet_tpu/preproc/window_split.py`` (pure NumPy).

Stage 1 — split raw LAS tiles into fixed ground-footprint windows.

Replaces the reference's per-window double loop
(``data_proc/1_get_windows_split.py:57-80``) with one vectorized bucketing pass:
window ids are ``floor((xy - min) / w_size)`` and points are grouped with a single
argsort — O(N log N) instead of O(N · windows).

Reference quirks handled deliberately (SURVEY.md §7 hard-part 6):

* classes 135/106 are remapped to 30/31 when materializing windows
  (``:131-132`` — LAS class fields are 5 bits);
* the reference labels a window ``tower_`` by checking ``set(pc[3])`` of the WHOLE
  tile, not the window (``:67-74`` — an upstream bug that marks every window of a
  tile containing any tower). We label per window (the obviously intended behavior)
  and keep ``tile_level_labels=True`` for bug-compatible output;
* the reference increments its window counter twice per stored window (``:63,79``),
  so stored names skip ids — we number windows densely.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

TILE_COLS = ("x", "y", "z", "classification", "intensity", "red", "green", "blue", "nir")


def remap_las_classes(cls: np.ndarray) -> np.ndarray:
    out = cls.copy()
    out[out == 135] = 30
    out[out == 106] = 31
    return out


def split_tile_into_windows(
    tile: np.ndarray,  # [R>=9, N], rows 0..8 = TILE_COLS (reference layout,
    # :48-51); extra rows (e.g. raw z) ride along untouched
    w_size: Tuple[float, float] = (100.0, 100.0),
    tile_level_labels: bool = False,
) -> List[Dict]:
    """Returns a list of ``{'label', 'window_id', 'points' [R, M]}`` dicts.

    The grid is anchored at round(min) like the reference's range() scan.
    """
    x, y = tile[0], tile[1]
    x0, y0 = round(float(x.min())), round(float(y.min()))
    ix = np.floor((x - x0) / w_size[0]).astype(np.int64)
    iy = np.floor((y - y0) / w_size[1]).astype(np.int64)
    ix = np.maximum(ix, 0)
    iy = np.maximum(iy, 0)
    nx = int(ix.max()) + 1 if len(ix) else 0
    wid = iy * nx + ix

    order = np.argsort(wid, kind="stable")
    wid_sorted = wid[order]
    boundaries = np.flatnonzero(np.diff(wid_sorted)) + 1
    groups = np.split(order, boundaries)

    tile_cls = remap_las_classes(tile[3])
    tile_has_tower = bool(np.isin(tile_cls, (15, 14)).any())

    windows = []
    for dense_id, idxs in enumerate(groups):
        pts = tile[:, idxs].copy()
        pts[3] = remap_las_classes(pts[3])
        if tile_level_labels:
            is_tower = tile_has_tower
        else:
            is_tower = bool(np.isin(pts[3], (15, 14)).any())
        windows.append(
            {
                "label": "tower_" if is_tower else "pc_",
                "window_id": dense_id,
                "points": pts,
            }
        )
    return windows


def window_file_name(label: str, dataset: str, tile_name: str, window_id: int) -> str:
    """``<label><DATASET>_<tile>_w<i>`` naming (1_get_windows_split.py:77)."""
    return f"{label}{dataset}_{tile_name}_w{window_id}"
