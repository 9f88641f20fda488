"""Whole-LAS-tile inference: LAS in → per-point classes out, the port's
counterpart of ``ampnet_tpu/infer/full_tile.py``.

The reference has no single entry point for this — a user must run four offline
stages, then the test script per window (SURVEY.md §3.3). Here one call sweeps an
entire tile:

    tile LAS → HAG (if absent) → footprint windows → filter/normalize →
    one ``predict_many`` over every window (tiled inference on the card) →
    stitch predictions back to the ORIGINAL tile point order → LAS with
    semantic classes (+ metrics against the labels it carries).

Points that the preprocessing filter drops (ground/noise classes, HAG outliers)
keep their original classification in the output and are excluded from metrics —
same population the reference evaluates on.

A checkpoint trained on geometric feature columns (``extra_features``) gets
them recomputed per window at full window density from its metric
coordinates, with the checkpoint's own ``geom_k`` and ``geom_radius_norm``,
as ``preprocess --geom_features`` computed them for training.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ampnet_tpu_torch.data.las_io import LasCloud, read_las, write_las
from ampnet_tpu_torch.data.schema import remap_segmentation_labels
from ampnet_tpu_torch.infer.tiled import evaluate_cloud, tta_ensemble
from ampnet_tpu_torch.preproc.filter_norm import DROP_CLASSES, filter_and_normalize
from ampnet_tpu_torch.preproc.hag import height_above_ground_grid
from ampnet_tpu_torch.preproc.window_split import split_tile_into_windows

# model class id → output LAS class id (inverse of the training remap)
SEG_TO_LAS = np.array([1, 15, 14, 3, 5], np.int32)


def tile_windows(las: LasCloud, window_size: float = 100.0, max_z: float = 100.0,
                 min_points: int = 0, hag_cell: float = 2.0, extra_features: int = 0,
                 geom_k: int = 24, geom_radius_norm: str = "absolute"):
    """The host stages of a tile: HAG (unless the LAS carries it), footprint
    windows, filter and normalise, and with ``extra_features`` the geometric
    columns (``geometric_features`` of the window's metric x, y and HAG) →
    (model features [N_w, 9 + extra_features] float32 of each window, the
    tile indices of its points, their raw classes)."""
    if extra_features:
        from ampnet_tpu_torch.preproc.geomfeat import N_GEOM_FEATURES, geometric_features

        if extra_features != N_GEOM_FEATURES:
            raise ValueError(f"checkpoint wants {extra_features} geom columns, this build "
                             f"computes {N_GEOM_FEATURES}")
    n = len(las)
    hag = las.height_above_ground
    if hag is None:
        hag = height_above_ground_grid(las.x, las.y, las.z, las.classification,
                                       cell=hag_cell)
    zeros = np.zeros(n)
    has_nir = las.nir is not None  # NIR-less tiles must reach filter_and_
    # normalize as nir=None so NDVI is the reference constant 0.5, not a 0.0
    # computed against a zero channel (preproc/filter_norm.py)
    tile = np.vstack([
        las.x, las.y, hag, las.classification, las.intensity,
        las.red if las.red is not None else zeros,
        las.green if las.green is not None else zeros,
        las.blue if las.blue is not None else zeros,
        las.nir if has_nir else zeros,
        np.arange(n, dtype=np.float64),  # row 9: original point index
    ])
    win_feats, win_kept, win_cls = [], [], []
    for w in split_tile_into_windows(tile, (window_size, window_size)):
        pts = w["points"]
        orig_idx = pts[9].astype(np.int64)
        pc, _ = filter_and_normalize(
            x=pts[0], y=pts[1], hag=pts[2], classification=pts[3],
            intensity=pts[4], red=pts[5], green=pts[6], blue=pts[7],
            nir=pts[8] if has_nir else None,
            max_z=max_z, min_points=min_points,
        )
        if pc is None or pc.shape[0] == 0:
            continue
        # recover which original points survived the filter: filter_and_normalize
        # keeps order, so recompute its keep mask here
        cls = pts[3].astype(np.int64)
        keep = ~np.isin(cls, DROP_CLASSES) & (pts[2] >= 0) & (pts[2] <= max_z)
        kept_idx = orig_idx[keep]
        assert len(kept_idx) == pc.shape[0]
        feats = np.concatenate([pc[:, 0:3], pc[:, 4:10]], axis=1)
        if extra_features:
            xyz = np.stack([pc[:, 10], pc[:, 11], pc[:, 2] * max_z], axis=1)
            feats = np.concatenate([feats, geometric_features(
                xyz, k=geom_k, radius_norm=geom_radius_norm)], axis=1)
        feats[:, 0] = feats[:, 0] * 2 - 1
        feats[:, 1] = feats[:, 1] * 2 - 1
        win_feats.append(feats.astype(np.float32))
        win_kept.append(kept_idx)
        win_cls.append(cls[keep])
    return win_feats, win_kept, win_cls


def predict_tile(
    inferencer,
    las: LasCloud,
    window_size: float = 100.0,
    max_z: float = 100.0,
    min_points: int = 0,
    hag_cell: float = 2.0,
    tta: int = 1,
    votes: int = 1,
) -> Tuple[np.ndarray, Dict]:
    """Per-point predicted segmentation class (−1 where filtered out) + metrics.

    Every window goes into ONE ``predict_many`` with seeds ``range(windows)``:
    same-bucket windows batch into single device calls. ``tta``/``votes``
    average class probabilities over dihedral views / re-tilings per window
    through ``tta_ensemble`` with its default seeds (the flags of ``test``).
    The geometric columns follow the inferencer's ``cfg.data``."""
    n = len(las)
    preds = np.full(n, -1, np.int32)
    labels = np.full(n, -1, np.int32)
    data = inferencer.cfg.data
    win_feats, win_kept, win_cls = tile_windows(
        las, window_size, max_z, min_points, hag_cell, data.extra_features, data.geom_k,
        data.geom_radius_norm)
    if win_feats:
        if int(tta) * int(votes) > 1:
            outs = [
                p for p, _ in tta_ensemble(
                    lambda cs, sd: inferencer.predict_many(cs, seeds=sd, return_probs=True),
                    win_feats, int(tta), votes=int(votes),
                )
            ]
        else:
            outs = inferencer.predict_many(win_feats, seeds=list(range(len(win_feats))))
        for p, kept_idx, kcls in zip(outs, win_kept, win_cls):
            preds[kept_idx] = p
            labels[kept_idx] = remap_segmentation_labels(kcls)

    evaluated = labels >= 0
    metrics = {}
    if evaluated.any():
        metrics = evaluate_cloud(
            preds[evaluated], labels[evaluated], inferencer.cfg.model.num_classes
        )
        metrics.pop("confusion", None)
        metrics["points_evaluated"] = int(evaluated.sum())
        metrics["points_total"] = int(n)
    return preds, metrics


def classify_las_file(
    inferencer,
    in_path: str,
    out_path: Optional[str] = None,
    **kw,
) -> Dict:
    """Read a LAS tile, predict, optionally write a LAS whose classification field
    carries the predicted classes (filtered points keep their original class):
    point format 8 when the tile has NIR, else 3."""
    las = read_las(in_path, mmap=True)  # GB-scale tiles stream from disk
    preds, metrics = predict_tile(inferencer, las, **kw)
    if out_path:
        out_cls = np.asarray(las.classification, np.int32).copy()
        m = preds >= 0
        out_cls[m] = SEG_TO_LAS[preds[m]]
        out = LasCloud(
            x=las.x, y=las.y, z=las.z, intensity=las.intensity,
            classification=out_cls, red=las.red, green=las.green, blue=las.blue,
            nir=las.nir,
        )
        write_las(out_path, out, point_format=8 if las.nir is not None else 3)
    return metrics
