"""Segmentation error analysis: confusion structure + boundary attribution.

The reference's only quantitative error surface is the wrong-prediction CSVs of
the binary classification tester (baseline/test_classification.py:136-167);
segmentation errors are inspected visually via 3-D scatters
(utils/utils_plot.py:100-171). This module adds the segmentation analog: a
streaming accumulator that, alongside the usual confusion matrix, attributes
every error to *class-boundary* vs *interior* points, so "tower IoU is 0.30"
decomposes into "X % of tower errors sit within k neighbors of another class"
(ambiguous transition zones: tower tops merging into lines, bases into
background) vs genuine interior misses the model should have gotten.

Definitions
-----------
boundary point
    a labeled point whose ``k`` nearest neighbors (same cloud, normalized
    x/y/z coordinates) include at least one point with a *different*
    ground-truth label. Everything else is interior.
error
    prediction != ground-truth label on a valid (label >= 0) point.

All statistics are exact and host-side (a scipy ``cKDTree`` per cloud, where
the JAX package uses sklearn's ``KDTree``: on points with no ties in distance
both give the same neighbour sets); this is an offline diagnostic, not part of
the serving path. The port's own copy of ``ampnet_tpu/infer/analysis.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ampnet_tpu_torch.data.schema import SEG_CLASS_NAMES


def precision_recall_from_confusion(cm: np.ndarray) -> Dict:
    """Per-class precision/recall/support from a confusion matrix.

    ``cm[i, j]`` counts ground-truth class ``i`` predicted as class ``j``
    (the layout core.metrics.confusion_matrix produces). Absent classes get
    NaN rather than a misleading 0.
    """
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diag(cm)
    support = cm.sum(axis=1)
    predicted = cm.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        recall = np.where(support > 0, tp / support, np.nan)
        precision = np.where(predicted > 0, tp / predicted, np.nan)
    out: Dict = {}
    names = SEG_CLASS_NAMES[: cm.shape[0]]
    for c, name in enumerate(names):
        row = cm[c]
        top_wrong = None
        if support[c] > 0:
            wrong = row.copy()
            wrong[c] = 0
            if wrong.sum() > 0:
                j = int(wrong.argmax())
                top_wrong = {
                    "predicted_as": names[j],
                    "fraction_of_errors": float(wrong[j] / wrong.sum()),
                }
        out[name] = {
            "support": int(support[c]),
            "precision": float(precision[c]),
            "recall": float(recall[c]),
            "top_confusion": top_wrong,
        }
    return out


def boundary_mask(xyz: np.ndarray, labels: np.ndarray, k: int = 8) -> np.ndarray:
    """True for valid points with a differently-labeled point among their k
    nearest valid neighbors. Ignore-labeled (< 0) points are excluded from both
    the query set and the neighbor pool and come back False."""
    from scipy.spatial import cKDTree

    labels = np.asarray(labels).astype(np.int64).ravel()
    valid = labels >= 0
    out = np.zeros(labels.shape[0], dtype=bool)
    pts = np.asarray(xyz, dtype=np.float64)[valid]
    lab = labels[valid]
    n = pts.shape[0]
    if n < 2:
        return out
    kq = min(k + 1, n)  # +1: the query point is its own nearest neighbor
    _, idx = cKDTree(pts).query(pts, k=kq)
    neigh = lab[idx[:, 1:]]  # drop self (column 0)
    out[valid] = (neigh != lab[:, None]).any(axis=1)
    return out


class ErrorAnalysisAccumulator:
    """Streaming per-cloud error attribution; plugs into evaluate_dataset.

    Accumulates, per ground-truth class: point / error counts split by the
    boundary mask, plus the dataset confusion matrix and the per-cloud rows
    that let the report name the worst clouds for a class.
    """

    def __init__(self, num_classes: int, k_neighbors: int = 8):
        self.num_classes = int(num_classes)
        self.k = int(k_neighbors)
        self.points = np.zeros((num_classes, 2), dtype=np.int64)  # [class, interior|boundary]
        self.errors = np.zeros((num_classes, 2), dtype=np.int64)
        self.cm = np.zeros((num_classes, num_classes), dtype=np.int64)
        self.per_cloud: List[Dict] = []

    def update(self, name: str, points9: np.ndarray, labels: np.ndarray,
               preds: np.ndarray) -> None:
        labels = np.asarray(labels).astype(np.int64).ravel()
        preds = np.asarray(preds).astype(np.int64).ravel()
        valid = (labels >= 0) & (labels < self.num_classes)
        bnd = boundary_mask(np.asarray(points9)[:, :3], labels, self.k)
        err = valid & (preds != labels)
        np.add.at(self.cm, (labels[valid], preds[valid]), 1)
        row = {"name": str(name)}
        for c in range(self.num_classes):
            cls = valid & (labels == c)
            for side, m in ((0, cls & ~bnd), (1, cls & bnd)):
                self.points[c, side] += int(m.sum())
                self.errors[c, side] += int((m & err).sum())
            if cls.any():
                tp = int((cls & ~err).sum())
                fn = int((cls & err).sum())
                fp = int((valid & (preds == c) & (labels != c)).sum())
                row[f"iou_{SEG_CLASS_NAMES[c]}"] = (
                    tp / (tp + fn + fp) if tp + fn + fp else float("nan")
                )
                row[f"n_{SEG_CLASS_NAMES[c]}"] = int(cls.sum())
        self.per_cloud.append(row)

    def finalize(self) -> Dict:
        names = SEG_CLASS_NAMES[: self.num_classes]
        per_class: Dict = {}
        for c, name in enumerate(names):
            n_int, n_bnd = (int(v) for v in self.points[c])
            e_int, e_bnd = (int(v) for v in self.errors[c])
            n_all, e_all = n_int + n_bnd, e_int + e_bnd
            per_class[name] = {
                "points": n_all,
                "boundary_fraction": n_bnd / n_all if n_all else float("nan"),
                "error_rate": e_all / n_all if n_all else float("nan"),
                "error_rate_interior": e_int / n_int if n_int else float("nan"),
                "error_rate_boundary": e_bnd / n_bnd if n_bnd else float("nan"),
                "errors_at_boundary_fraction": e_bnd / e_all if e_all else float("nan"),
            }
        report = {
            "k_neighbors": self.k,
            "per_class": per_class,
            "precision_recall": precision_recall_from_confusion(self.cm),
            "confusion": self.cm.tolist(),
        }
        # the worst clouds per class (lowest per-cloud IoU, min 50 points) —
        # the segmentation analog of the reference's wrong-prediction CSVs
        worst: Dict[str, List] = {}
        for name in names:
            rows = [
                r for r in self.per_cloud
                if r.get(f"n_{name}", 0) >= 50
                and np.isfinite(r.get(f"iou_{name}", float("nan")))
            ]
            rows.sort(key=lambda r: r[f"iou_{name}"])
            worst[name] = [
                {"name": r["name"], "iou": round(float(r[f"iou_{name}"]), 4),
                 "points": r[f"n_{name}"]}
                for r in rows[:5]
            ]
        report["worst_clouds"] = worst
        return report


def write_analysis(report: Dict, out_dir: str,
                   plot: bool = True) -> Optional[str]:
    """Write analysis.json (+ confusion heatmap PNG) under out_dir."""
    import json
    import os

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "analysis.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    if plot:
        from ampnet_tpu_torch.core.plotting import plot_confusion

        plot_confusion(
            np.asarray(report["confusion"], dtype=np.float64),
            save_to=os.path.join(out_dir, "confusion.png"),
        )
    return path
