"""The port's own copy of ``ampnet_tpu/preproc/hag.py`` (pure NumPy).

Height-above-ground computation — replaces the external PDAL ``hag_nn`` stage
(``data_proc/other/pdal_hag.sh:3``, ``README.md:23-26``).

Two implementations:

* ``height_above_ground_grid`` — vectorized raster approach: ground points (ASPRS
  class 2) are binned into a cell grid keeping the minimum elevation per cell, holes
  are filled by iterative neighborhood min-pooling (a separable morphological
  propagation), and every point's HAG is ``z − ground[cell]``. O(N + cells) NumPy,
  no neighbor searches; this is the production path for big tiles.
* ``height_above_ground_knn`` — exact nearest-ground-neighbor semantics like PDAL's
  default (k=1): per-point 2-D nearest ground point, computed in chunks as
  [chunk, n_ground] distance matrices (jit-friendly; used for small tiles and as the
  cross-check oracle in tests).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rasterize_ground(
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    is_ground: np.ndarray,
    cell: float = 2.0,
) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Min-z ground raster over the tile's bounding box; NaN where no ground."""
    x0, y0 = float(x.min()), float(y.min())
    gx = ((x - x0) / cell).astype(np.int64)
    gy = ((y - y0) / cell).astype(np.int64)
    nx, ny = int(gx.max()) + 1, int(gy.max()) + 1
    grid = np.full((ny, nx), np.inf, np.float64)
    np.minimum.at(grid, (gy[is_ground], gx[is_ground]), z[is_ground])
    grid[np.isinf(grid)] = np.nan
    return grid, (x0, y0)


def fill_holes(grid: np.ndarray, max_iters: int = 1000) -> np.ndarray:
    """Propagate ground elevation into NaN cells from their 8-neighborhood
    (averaging available neighbors), iterating until dense."""
    g = grid.copy()
    for _ in range(max_iters):
        nan = np.isnan(g)
        if not nan.any():
            break
        padded = np.pad(g, 1, constant_values=np.nan)
        stacks = [
            padded[1 + dy : 1 + dy + g.shape[0], 1 + dx : 1 + dx + g.shape[1]]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if (dy, dx) != (0, 0)
        ]
        stacked = np.stack(stacks)
        cnt = (~np.isnan(stacked)).sum(axis=0)
        avg = np.where(cnt > 0, np.nansum(stacked, axis=0) / np.maximum(cnt, 1), np.nan)
        g = np.where(nan & (cnt > 0), avg, g)
    return g


def height_above_ground_grid(
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    classification: np.ndarray,
    cell: float = 2.0,
    ground_class: int = 2,
) -> np.ndarray:
    """HAG for every point via the filled min-z ground raster. Falls back to
    ``z - z.min()`` when the tile has no ground points at all."""
    is_ground = classification == ground_class
    if not is_ground.any():
        return z - z.min()
    grid, (x0, y0) = rasterize_ground(x, y, z, is_ground, cell)
    grid = fill_holes(grid)
    gx = np.clip(((x - x0) / cell).astype(np.int64), 0, grid.shape[1] - 1)
    gy = np.clip(((y - y0) / cell).astype(np.int64), 0, grid.shape[0] - 1)
    return z - grid[gy, gx]


def height_above_ground_knn(
    x: np.ndarray,
    y: np.ndarray,
    z: np.ndarray,
    classification: np.ndarray,
    ground_class: int = 2,
    chunk: int = 4096,
) -> np.ndarray:
    """Exact PDAL-hag_nn(k=1) semantics: HAG = z − z[nearest 2-D ground point]."""
    is_ground = classification == ground_class
    if not is_ground.any():
        return z - z.min()
    gxy = np.stack([x[is_ground], y[is_ground]], axis=1)
    gz = z[is_ground]
    out = np.empty_like(z, dtype=np.float64)
    pts = np.stack([x, y], axis=1)
    for s in range(0, len(pts), chunk):
        block = pts[s : s + chunk]
        d2 = ((block[:, None, :] - gxy[None, :, :]) ** 2).sum(-1)
        out[s : s + chunk] = z[s : s + chunk] - gz[np.argmin(d2, axis=1)]
    return out
