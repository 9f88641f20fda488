"""The figures that ``test`` and ``infer`` draw, the port's own copies of four
functions of ``ampnet_tpu/core/plotting.py`` (reference ``utils/utils_plot.py``):
the prediction-vs-truth scatter, per-class count and confidence histograms,
dataset class counts and the confusion heatmap.

matplotlib is optional: each function imports it (Agg backend) when called,
and a command that would draw checks ``require_matplotlib`` before any work.
The rest of the JAX module waits for ROADMAP.md Queue 1, item 6.
"""

from __future__ import annotations

import importlib.util
from typing import Optional, Sequence

import numpy as np

from ampnet_tpu_torch.data.schema import SEG_CLASS_NAMES

# one colour per semantic class (utils_plot.py:104-118)
CLASS_COLORS = {
    0: "#9e9e9e",  # background, grey
    1: "#d62728",  # tower, red
    2: "#1f77b4",  # power lines, blue
    3: "#98df8a",  # low/med vegetation, light green
    4: "#2ca02c",  # high vegetation, green
}


def require_matplotlib(what: str) -> None:
    """Raise ``ModuleNotFoundError`` naming ``what`` when matplotlib is not
    installed; callers check before any work, so no figure is skipped."""
    if importlib.util.find_spec("matplotlib") is None:
        raise ModuleNotFoundError(f"{what} draws figures with matplotlib, which is not "
                                  "installed here", name="matplotlib")


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, fig, save_to, **savefig):
    if save_to:
        fig.savefig(save_to, **savefig)
        plt.close(fig)
        return save_to
    return fig


def _scatter(ax, pc: np.ndarray, labels: np.ndarray, title: str, point_size: float):
    for c, color in CLASS_COLORS.items():
        m = labels == c
        if m.any():
            ax.scatter(pc[m, 0], pc[m, 1], pc[m, 2], s=point_size, c=color,
                       label=SEG_CLASS_NAMES[c], depthshade=False)
    ax.set_title(title)
    ax.set_xlabel("x")
    ax.set_ylabel("y")


def plot_predictions_vs_truth(points: np.ndarray, preds: np.ndarray,
                              targets: Optional[np.ndarray] = None,
                              save_to: Optional[str] = None, point_size: float = 1.0,
                              title: str = ""):
    """Side-by-side 3-D scatter of predictions and ground truth, xyz in the
    first three columns of ``points`` (plot_pointcloud_with_labels,
    utils_plot.py:100-171)."""
    plt = _pyplot()
    ncols = 2 if targets is not None else 1
    fig = plt.figure(figsize=(7 * ncols, 6))
    ax = fig.add_subplot(1, ncols, 1, projection="3d")
    _scatter(ax, points, np.asarray(preds), f"{title} predictions", point_size)
    ax.legend(loc="upper right", fontsize=7)
    if targets is not None:
        ax2 = fig.add_subplot(1, ncols, 2, projection="3d")
        _scatter(ax2, points, np.asarray(targets), f"{title} ground truth", point_size)
    fig.tight_layout()
    return _finish(plt, fig, save_to, dpi=120)


def plot_class_histograms(labels: np.ndarray, probs: Optional[np.ndarray] = None,
                          class_names: Sequence[str] = SEG_CLASS_NAMES,
                          title: Optional[str] = None, save_to: Optional[str] = None):
    """Points per class, and with ``probs`` [N, C] each predicted class's
    confidence histogram (the reference's plot_hist family)."""
    plt = _pyplot()
    labels = np.asarray(labels).ravel()
    ncols = 2 if probs is not None else 1
    fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 4), tight_layout=True)
    axes = np.atleast_1d(axes)
    counts = [(labels == c).sum() for c in range(len(class_names))]
    colors = [CLASS_COLORS.get(c, "#333333") for c in range(len(class_names))]
    axes[0].bar(range(len(class_names)), counts, color=colors)
    axes[0].set_xticks(range(len(class_names)))
    axes[0].set_xticklabels(class_names, rotation=30, ha="right")
    axes[0].set_ylabel("points")
    axes[0].set_title("points per class")
    if probs is not None:
        probs = np.asarray(probs, np.float32)
        conf = probs[np.arange(len(labels)), np.clip(labels, 0, probs.shape[1] - 1)]
        for c, name in enumerate(class_names):
            m = labels == c
            if m.any():
                axes[1].hist(conf[m], bins=25, range=(0, 1), histtype="step",
                             label=name, color=colors[c])
        axes[1].set_xlabel("prediction confidence")
        axes[1].set_ylabel("points")
        axes[1].set_yscale("log")
        axes[1].legend(fontsize=7)
        axes[1].set_title("confidence by predicted class")
    if title:
        fig.suptitle(title)
    return _finish(plt, fig, save_to, bbox_inches="tight", dpi=100)


def plot_class_counts(counts_by_series: dict, class_names: Sequence[str] = SEG_CLASS_NAMES,
                      title: Optional[str] = None, save_to: Optional[str] = None):
    """Grouped per-class point-count bars, e.g. ground truth beside predicted."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4), tight_layout=True)
    n_series = max(len(counts_by_series), 1)
    width = 0.8 / n_series
    xs = np.arange(len(class_names))
    for i, (name, counts) in enumerate(counts_by_series.items()):
        ax.bar(xs + (i - (n_series - 1) / 2) * width, counts[:len(class_names)],
               width=width, label=name)
    ax.set_xticks(xs)
    ax.set_xticklabels(class_names, rotation=30, ha="right")
    ax.set_ylabel("points")
    ax.set_yscale("log")
    ax.legend()
    if title:
        ax.set_title(title)
    return _finish(plt, fig, save_to, bbox_inches="tight", dpi=100)


def plot_confusion(cm: np.ndarray, class_names: Sequence[str] = SEG_CLASS_NAMES,
                   title: Optional[str] = None, save_to: Optional[str] = None):
    """Row-normalized confusion heatmap (the recall view) with the raw counts
    written in each cell."""
    plt = _pyplot()
    cm = np.asarray(cm, dtype=np.float64)
    names = list(class_names)[: cm.shape[0]]
    row_sum = cm.sum(axis=1, keepdims=True)
    norm = np.divide(cm, row_sum, out=np.zeros_like(cm), where=row_sum > 0)
    fig, ax = plt.subplots(figsize=(6, 5), tight_layout=True)
    im = ax.imshow(norm, vmin=0.0, vmax=1.0, cmap="Blues")
    fig.colorbar(im, ax=ax, label="fraction of ground-truth class")
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=30, ha="right")
    ax.set_yticks(range(len(names)))
    ax.set_yticklabels(names)
    ax.set_xlabel("predicted")
    ax.set_ylabel("ground truth")
    for i in range(len(names)):
        for j in range(len(names)):
            ax.text(j, i, f"{int(cm[i, j]):,}", ha="center", va="center",
                    fontsize=7, color="white" if norm[i, j] > 0.5 else "black")
    if title:
        ax.set_title(title)
    return _finish(plt, fig, save_to, bbox_inches="tight", dpi=100)
