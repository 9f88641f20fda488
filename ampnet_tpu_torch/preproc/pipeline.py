"""The fused offline preprocessing pipeline, one tile at a time, the port's
counterpart of ``ampnet_tpu/preproc/pipeline.py``.

Mirrors the reference's four-process chain (``1_get_windows_split.py`` →
``pdal_hag.sh`` → ``2_preprocessing_filter_norm.py`` → ``3_kmeans.py``) as one
function per LAS tile, so the CLI can run tiles serially or fan them out over a
host process pool (the reference parallelizes stages 2 and 3 with
``multiprocessing.Pool(10)`` / ``Pool(5)`` —
``2_preprocessing_filter_norm.py:145-152``, ``3_kmeans.py:119-127``).

The CLI defaults the balanced-k-means stage to the host assigner
(``'exact_mcf'``, the native min-cost-flow solver): exact
``KMeansConstrained`` semantics, no card needed, and safe under a worker
pool. ``'sinkhorn'`` runs the port's balanced k-means on ``device``. Both
give every window exactly ``n_points`` points. Workers are started with
``spawn``, so none inherits the parent's CUDA state.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

GEOM_FEATURES = "ROADMAP.md Queue 1, item 4b (geometry and distillation)"


@dataclass(frozen=True)
class PreprocessParams:
    out_path: str
    dataset: str = "DATA"
    window_size: float = 100.0
    max_z: float = 100.0
    min_points: int = 1024
    n_points: int = 2048
    max_windows: int = 9
    hag_cell: float = 2.0
    artifact_format: str = "npz"
    assigner: str = "exact_mcf"  # 'exact_mcf' (host solver) | 'sinkhorn' (on device)
    device: str = "cuda"  # where 'sinkhorn' runs
    # per-point covariance eigenfeatures (columns 13..18): not ported yet
    geom_features: bool = False

    def __post_init__(self):
        if self.geom_features:
            raise NotImplementedError("geometric feature columns (preproc/geomfeat.py) are not "
                                      f"ported yet: {GEOM_FEATURES}")


def process_tile(tile_path: str, params: PreprocessParams) -> Tuple[List[str], Optional[str]]:
    """Window-split + HAG + filter/norm + k-means-tile one LAS tile.

    Returns (produced window names ["x.pkl", ...], error message or None).
    Errors are returned, not raised — the caller skips-and-continues like the
    reference's ``imap_unordered`` pools (2_preprocessing_filter_norm.py:131-132).
    """
    from ampnet_tpu_torch.data.io_utils import save_cloud
    from ampnet_tpu_torch.data.las_io import read_las
    from ampnet_tpu_torch.preproc.filter_norm import filter_and_normalize
    from ampnet_tpu_torch.preproc.hag import height_above_ground_grid
    from ampnet_tpu_torch.preproc.tiling import kmeans_tile_cloud
    from ampnet_tpu_torch.preproc.window_split import split_tile_into_windows, window_file_name

    tile_name = os.path.splitext(os.path.basename(tile_path))[0]
    try:
        las = read_las(tile_path)
    except Exception as e:
        return [], f"error reading {tile_path}: {e} — skipped"

    # pdal_hag.sh equivalent: HeightAboveGround (LAS extra-bytes HAG wins if present)
    hag = las.height_above_ground
    if hag is None:
        hag = height_above_ground_grid(
            las.x, las.y, las.z, las.classification, cell=params.hag_cell
        )
    has_nir = las.nir is not None
    tile = np.vstack(
        [las.x, las.y, hag, las.classification, las.intensity,
         las.red if las.red is not None else np.zeros(len(las)),
         las.green if las.green is not None else np.zeros(len(las)),
         las.blue if las.blue is not None else np.zeros(len(las)),
         las.nir if has_nir else np.zeros(len(las)),
         las.z]  # raw elevation rides along: canonical col 12 is z, not HAG
    )
    produced: List[str] = []
    windows = split_tile_into_windows(tile, (params.window_size, params.window_size))
    for w in windows:
        pts = w["points"]
        pc, prefix = filter_and_normalize(
            x=pts[0], y=pts[1], hag=pts[2], classification=pts[3],
            intensity=pts[4], red=pts[5], green=pts[6], blue=pts[7],
            nir=pts[8] if has_nir else None, z_raw=pts[9],
            max_z=params.max_z, min_points=params.min_points,
        )
        if pc is None:
            continue
        name = window_file_name(prefix, params.dataset, tile_name, w["window_id"])
        save_cloud(os.path.join(params.out_path, name + ".pkl"), pc)
        windowed = kmeans_tile_cloud(
            pc, n_points=params.n_points, max_clusters=params.max_windows,
            assigner=params.assigner, device=params.device,
        )
        save_cloud(
            os.path.join(params.out_path, f"kmeans_{name}.{params.artifact_format}"),
            windowed,
        )
        produced.append(name + ".pkl")
    return produced, None


def _worker(task: Tuple[str, PreprocessParams]) -> Tuple[List[str], Optional[str]]:
    return process_tile(*task)


def run_pipeline(
    tiles: List[str], params: PreprocessParams, workers: int = 1
) -> Tuple[List[str], List[str]]:
    """Process every tile, optionally over a host process pool.

    Returns (produced names in tile order, error messages). Results keep tile
    order regardless of worker count, so downstream split lists are identical.
    The native solver is built here, once, before any worker starts (a build
    that fails raises here instead of once per tile).
    """
    if params.assigner == "exact_mcf":
        from ampnet_tpu_torch.native import load_native

        load_native()
    if workers <= 1:
        results = [process_tile(t, params) for t in tiles]
    else:
        import multiprocessing as mp

        # 'spawn' keeps workers free of any parent-process CUDA state
        ctx = mp.get_context("spawn")
        with ctx.Pool(workers) as pool:
            results = pool.map(_worker, [(t, params) for t in tiles])
    produced = [name for r, _ in results for name in r]
    errors = [e for _, e in results if e]
    return produced, errors
