"""The train and eval steps of the classification task (binary tower
detection), counterpart of ``ampnet_tpu/train/cls_step.py``.

Reference semantics: NLL/CE with EFS/INS/ISNS class weights
(``baseline/train_classification.py:138-143,179``; AMP variant
``train_pointnet-attention.py:115-135``), the T-Net regulariser, and accuracy,
precision, recall and F1 from the confusion matrix
(``baseline/test_classification.py:136-167``). The PointNet classifiers
return log-probabilities; the CE of log-probabilities is their NLL, so one
loss serves every family. Padded clouds carry ``cls_label`` −1 and are
ignored. As in the segmentation step, ``rotate_z`` turns the points only,
metrics stay on the device, and one generator per step draws the rotation
and the dropout masks.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPNetConfig
from ampnet_tpu_torch.core.metrics import confusion_matrix
from ampnet_tpu_torch.ops.augment import rotate_z
from ampnet_tpu_torch.parallel.mesh import all_reduce_grads, sync_batch_norm
from ampnet_tpu_torch.train.losses import (
    orthogonality_regularizer,
    weighted_cross_entropy,
    weighted_cross_entropy_parts,
)
from ampnet_tpu_torch.train.step import Batch, _forward, global_mean


def make_cls_step_fns(cfg: AMPNetConfig, class_weights: Optional[np.ndarray] = None,
                      num_out: int = 2, augment: bool = True,
                      dp=None) -> Tuple[Callable, Callable]:
    """``(train_step, eval_step)`` with the signatures of
    ``train/step.py::make_step_fns``; ``eval_step``'s metrics add
    ``pos_prob`` [B], the positive class's softmax probability (the rank's
    rows under a process group ``dp``). Under ``dp`` the CE weight sum over
    clouds, the regulariser, every BatchNorm and the gradients are the global
    batch's, as in ``make_step_fns``."""
    reg_w = cfg.train.reg_weight
    world = 1 if dp is None else dp.world
    weights_by_device: Dict[torch.device, Optional[torch.Tensor]] = {}

    def weights_on(device):
        """The class weights on ``device``, copied there once."""
        if device not in weights_by_device:
            weights_by_device[device] = (None if class_weights is None else torch.tensor(
                np.asarray(class_weights, np.float32), device=device))
        return weights_by_device[device]

    def train_step(state, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        cw = weights_on(state.device)
        gen = state.step_generator(None if dp is None else dp.rank)
        aug = dict(batch, points=rotate_z(batch["points"], gen)) if augment else batch
        state.optimizer.zero_grad(set_to_none=True)
        with sync_batch_norm(model, dp):
            logits, t_feat, _ = _forward(model, aug, gen)
            if dp is None:
                ce = weighted_cross_entropy(logits, aug["cls_label"], cw)
            else:  # the rank's share of the global batch's CE
                num, den = weighted_cross_entropy_parts(logits, aug["cls_label"], cw)
                ce = num / dp.sum(den).clamp_min(1e-12)
            # the same global norm on every rank: each carries 1/world of it
            loss = ce + reg_w * orthogonality_regularizer(t_feat, dp) / world
            loss.backward()
        preds = logits.detach().argmax(-1)
        loss, ce = loss.detach(), ce.detach()
        cm = confusion_matrix(preds, batch["cls_label"], num_out)
        if dp is not None:
            all_reduce_grads(model, dp)
            loss, ce = dp.sum(torch.stack([loss, ce])).unbind()
            cm = dp.sum(cm)
        state.apply_gradients()
        return {"loss": loss, "ce_loss": ce, "confusion": cm}

    def eval_step(state, batch: Batch):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                logits, _, _ = _forward(model, batch, None)
        finally:
            model.train(was_training)
        ce = global_mean(weighted_cross_entropy_parts(logits, batch["cls_label"],
                                                      weights_on(state.device)), dp)
        preds = logits.argmax(-1)
        cm = confusion_matrix(preds, batch["cls_label"], num_out)
        return {"loss": ce, "ce_loss": ce, "confusion": cm if dp is None else dp.sum(cm),
                # positive-class probability for PR curves (test_classification.py AUC)
                "pos_prob": torch.softmax(logits.float(), dim=-1)[..., 1]}, preds

    return train_step, eval_step


def binary_metrics_from_confusion(cm: np.ndarray) -> Dict[str, float]:
    """precision / recall / F1 / accuracy for the positive (tower) class, as
    the reference tester computes them (baseline/test_classification.py:136-167)."""
    tn, fp, fn, tp = cm[0, 0], cm[0, 1], cm[1, 0], cm[1, 1]
    precision = tp / max(tp + fp, 1e-9)
    recall = tp / max(tp + fn, 1e-9)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {
        "accuracy": float((tp + tn) / max(cm.sum(), 1e-9)),
        "precision": float(precision),
        "recall": float(recall),
        "f1": float(f1),
    }
