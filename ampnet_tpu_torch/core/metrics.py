"""Segmentation metrics, counterpart of ``ampnet_tpu/core/metrics.py``
(reference ``utils/get_metrics.py``):

* per-class IoU = TP / (TP + FN + FP)                       (get_metrics.py:6-17)
* accuracy = mean(pred == target) over un-padded points     (get_metrics.py:20-31)
* class-weight schemes EFS / INS / ISNS / sklearn           (get_metrics.py:34-77)

The confusion matrix is computed on the device with exact integer counts
(one ``scatter_add_`` over ``target·C + pred``; ``bincount`` would read its
input's range back to the host), so a step's metrics never leave the card
until the epoch ends. Padded points (target −1) are excluded.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def confusion_matrix(preds: torch.Tensor, targets: torch.Tensor, num_classes: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``cm[t, p]`` = number of points with target t predicted p, int64."""
    preds = preds.reshape(-1).long()
    targets = targets.reshape(-1).long()
    mask = (targets >= 0) if mask is None else mask.reshape(-1)
    cells = num_classes * num_classes
    # masked-out points land in one extra bin that is dropped
    idx = torch.where(mask, targets * num_classes + preds,
                      torch.full((), cells, dtype=torch.long, device=preds.device))
    counts = torch.zeros(cells + 1, dtype=torch.long, device=preds.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts[:cells].reshape(num_classes, num_classes)


def iou_from_confusion(cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class IoU and a validity flag (union > 0), in float32."""
    cm = cm.double()
    tp = torch.diagonal(cm)
    union = cm.sum(dim=1) + cm.sum(dim=0) - tp
    valid = union > 0
    return torch.where(valid, tp / union.clamp_min(1.0), torch.zeros_like(tp)).float(), valid


def iou_per_class(preds: torch.Tensor, targets: torch.Tensor, num_classes: int,
                  mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class IoU and validity of ``preds`` against ``targets``."""
    return iou_from_confusion(confusion_matrix(preds, targets, num_classes, mask))


def mean_iou(iou: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """mIoU over the classes present (test_pointnet_att_segmen.py:186-219)."""
    return torch.where(valid, iou, torch.zeros_like(iou)).sum() / valid.sum().clamp_min(1)


def accuracy(preds: torch.Tensor, targets: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    preds, targets = preds.reshape(-1), targets.reshape(-1)
    mask = ((targets >= 0) if mask is None else mask.reshape(-1)).float()
    return ((preds == targets).float() * mask).sum() / mask.sum().clamp_min(1.0)


def balanced_accuracy(preds: torch.Tensor, targets: torch.Tensor, num_classes: int,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Macro-averaged recall over the classes present
    (sklearn.balanced_accuracy_score, get_metrics.py:28)."""
    cm = confusion_matrix(preds, targets, num_classes, mask).double()
    support = cm.sum(dim=1)
    present = support > 0
    recall = torch.where(present, torch.diagonal(cm) / support.clamp_min(1.0),
                         torch.zeros_like(support))
    return (recall.sum() / present.sum().clamp_min(1)).float()


def segmentation_metrics(preds: torch.Tensor, targets: torch.Tensor, num_classes: int,
                         mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Every per-epoch scalar the reference logs (train_pointnet-attention.py:280-309)."""
    cm = confusion_matrix(preds, targets, num_classes, mask)
    iou, valid = iou_from_confusion(cm)
    return {
        "confusion": cm,
        "iou": iou,
        "iou_valid": valid,
        "miou": mean_iou(iou, valid),
        "accuracy": (torch.diagonal(cm).sum().double() / cm.sum().clamp_min(1)).float(),
    }


# -- class weighting schemes (reference utils/get_metrics.py:34-77) ---------------


def weights_effective_num_of_samples(samples_per_cls, beta: float) -> np.ndarray:
    """'EFS' — Cui et al. effective number of samples (get_metrics.py:34-39)."""
    samples_per_cls = np.asarray(samples_per_cls, dtype=np.float64)
    w = (1.0 - beta) / (1.0 - np.power(beta, samples_per_cls))
    return (w / w.sum()).astype(np.float32)


def weights_inverse_num_of_samples(samples_per_cls, power: float = 1.0) -> np.ndarray:
    """'INS' (power=1) / 'ISNS' (power=0.5) — get_metrics.py:42-45."""
    w = 1.0 / np.power(np.asarray(samples_per_cls, dtype=np.float64), power)
    return (w / w.sum()).astype(np.float32)


def weights_sklearn(samples_per_cls) -> np.ndarray:
    """'sklearn' balanced weights — get_metrics.py:48-51."""
    samples_per_cls = np.asarray(samples_per_cls, dtype=np.float64)
    w = samples_per_cls.sum() / (len(samples_per_cls) * samples_per_cls)
    return (w / w.sum()).astype(np.float32)


def get_class_weights(method: str, samples_per_cls, beta: float = 0.999):
    """Dispatch matching get_weights4class (get_metrics.py:54-77); None for an
    unknown method, like the reference."""
    if method == "EFS":
        return weights_effective_num_of_samples(samples_per_cls, beta)
    if method == "INS":
        return weights_inverse_num_of_samples(samples_per_cls, 1.0)
    if method == "ISNS":
        return weights_inverse_num_of_samples(samples_per_cls, 0.5)
    if method == "sklearn":
        return weights_sklearn(samples_per_cls)
    return None


def weights_for_samples(class_weights: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each sample's class weight, flattened (get_weights4sample,
    get_metrics.py:80-98), indexed as JAX's ``take`` indexes: a label in
    [−C, 0) counts from the end, one outside [−C, C) gives NaN."""
    c = class_weights.shape[0]
    idx = labels.reshape(-1).long()
    idx = torch.where(idx < 0, idx + c, idx)
    inside = (idx >= 0) & (idx < c)
    out = class_weights[idx.clamp(0, c - 1)]
    return torch.where(inside, out, torch.full((), float("nan"), dtype=out.dtype,
                                               device=out.device))
