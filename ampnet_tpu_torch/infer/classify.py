"""Classification evaluation and serving, counterpart of
``ampnet_tpu/infer/classify.py`` (reference ``baseline/test_classification.py``):
accuracy, precision/recall/F1, precision-recall AUC, the wrong-prediction
CSV, and ``CloudClassifier``, the serving engine of ``serve --task
classification``.

The precision-recall AUC is the average precision of scikit-learn's
``average_precision_score`` (the step-wise sum over the distinct scores,
without interpolation), computed here in numpy: the port does not depend on
scikit-learn.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ampnet_tpu_torch.core.device import resolve_device
from ampnet_tpu_torch.core.logging import append_results_csv
from ampnet_tpu_torch.core.profiling import NO_SPANS, Spans
from ampnet_tpu_torch.data.datasets import resample_points
from ampnet_tpu_torch.data.pipeline import to_device_batch
from ampnet_tpu_torch.train.cls_step import binary_metrics_from_confusion


def average_precision(targets: np.ndarray, scores: np.ndarray) -> float:
    """Average precision of binary ``targets`` ranked by ``scores``:
    Σ_k (R_k − R_{k−1}) P_k over the distinct scores in decreasing order, as
    scikit-learn computes it (0 when there is no positive)."""
    order = np.argsort(scores, kind="mergesort")[::-1]
    y, s = np.asarray(targets, np.float64)[order], np.asarray(scores)[order]
    last = np.r_[np.where(np.diff(s))[0], y.size - 1]  # the last index of each distinct score
    tps = np.cumsum(y)[last]
    fps = 1 + last - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] > 0 else np.ones_like(tps)
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def evaluate_classification(state, eval_step, batcher, out_dir: Optional[str] = None,
                            model_name: str = "ampnet_cls") -> Dict:
    """Run ``eval_step`` (``make_cls_step_fns``) over every batch of
    ``batcher``; drop the padded entries (``cls_label`` −1); return accuracy,
    precision, recall, F1, ``n_samples`` and ``pr_auc``. With ``out_dir``,
    append the wrong predictions to ``wrong_predictions.csv`` and the summary
    row to ``classification-results.csv``."""
    names_all, preds_all, targets_all, probs_all = [], [], [], []
    for batch in batcher:
        metrics, preds = eval_step(state, to_device_batch(batch, state.device))
        names_all += batch["names"]
        preds_all.append(preds.cpu().numpy())
        targets_all.append(np.asarray(batch["cls_label"]))
        probs_all.append(metrics["pos_prob"].cpu().numpy())
    preds, targets, probs = (np.concatenate(a) for a in (preds_all, targets_all, probs_all))
    valid = targets >= 0
    names_all = [n for n, v in zip(names_all, valid) if v]
    preds, targets, probs = preds[valid], targets[valid], probs[valid]

    cm = np.zeros((2, 2))
    for t, p in zip(targets, preds):
        cm[int(t), int(p)] += 1
    out = binary_metrics_from_confusion(cm)
    out["n_samples"] = int(len(preds))
    out["pr_auc"] = average_precision(targets, probs) if len(preds) else float("nan")

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for n, t, p in zip(names_all, targets, preds):
            if t != p:  # false positives and negatives, as the reference lists them
                append_results_csv(os.path.join(out_dir, "wrong_predictions.csv"),
                                   {"name": n, "target": int(t), "pred": int(p)})
        append_results_csv(os.path.join(out_dir, "classification-results.csv"),
                           {"model": model_name, **out})
    return out


class CloudClassifier:
    """Serving engine of the binary tower classification: one label (and the
    class probabilities) per cloud of any size, behind the
    ``dispatch_many``/``fetch_many``/``predict_many`` surface of
    ``TiledInferencer``, so the HTTP server drives either task.

    Each cloud is resampled to ``n_points`` (``resample_points`` from
    ``default_rng(seed)``, the reference LidarDataset semantics), presented as
    one real window replicated to the checkpoint's ``max_windows`` (the
    training collate's shape: windowed classifier heads mix that many
    windows) with the replicas under the window pad mask, and classified in one
    forward whose batch is padded to a power of two. ``dispatch_many``
    enqueues the forward and an asynchronous copy of the int8 labels and
    float16 probabilities into pinned memory and records an event;
    ``fetch_many`` waits on it."""

    def __init__(self, model, cfg, n_points: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.n_points = n_points or cfg.data.n_points
        self.n_windows = cfg.data.max_windows
        # the serving surface of the segmentation engine
        self.max_clusters = 1
        self.backend = "xla"
        self.ensemble = 1
        self.cold_programs_seen = 0

    def _run(self, points: torch.Tensor):
        """points [B, n_points, F] → (labels [B] int8, probs [B, C] float16)."""
        b, w = points.shape[0], self.n_windows
        windows = points[:, None].expand(b, w, *points.shape[1:])
        centroids = windows[..., :2].mean(dim=2)
        pad = (torch.arange(w, device=points.device) > 0).expand(b, w)
        logits = self.model(windows, centroids, pad)[0]
        probs = torch.softmax(logits, dim=-1)
        return logits.argmax(dim=-1).to(torch.int8), probs.to(torch.float16)

    def dispatch_many(self, clouds, seeds=None, return_probs: bool = False,
                      spans: Spans = NO_SPANS) -> Dict:
        """``spans`` gets ``dispatch.pad`` (the resampling and the batch's
        copies), ``dispatch.pin`` (on a card) and ``dispatch.launch``; it has
        no tiling, so no device stamps."""
        seeds = seeds or list(range(len(clouds)))
        with spans.span("dispatch.pad"):
            rows = np.stack([resample_points(np.asarray(c, np.float32), self.n_points,
                                             np.random.default_rng(s))
                             for c, s in zip(clouds, seeds)])
            b = len(clouds)
            b_pad = 1 << (b - 1).bit_length()
            if b_pad > b:
                rows = np.concatenate([rows, np.repeat(rows[:1], b_pad - b, axis=0)])
        x = torch.from_numpy(rows)
        event = None
        if self.device.type == "cuda":
            with spans.span("dispatch.pin"):
                x = x.pin_memory()
        with spans.span("dispatch.launch"):
            x = x.to(self.device, non_blocking=True)
            with torch.inference_mode():
                out = self._run(x)
            if self.device.type == "cuda":
                out = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True) for t in out)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
        return {"out": out, "event": event, "n": b, "return_probs": return_probs,
                "spans": spans.top}

    def fetch_many(self, handle: Dict) -> list:
        spans = handle["spans"]
        if handle["event"] is not None:
            with spans.span("batch.fetch_wait"):
                handle["event"].synchronize()
        with spans.span("batch.unpack"):
            labels, probs = (t.numpy() for t in handle["out"])
            n = handle["n"]
            if handle["return_probs"]:
                return [(labels[i:i + 1].astype(np.int32), probs[i]) for i in range(n)]
            return [labels[i:i + 1].astype(np.int32) for i in range(n)]

    def predict_many(self, clouds, seeds=None, return_probs: bool = False) -> list:
        return self.fetch_many(self.dispatch_many(clouds, seeds, return_probs))
