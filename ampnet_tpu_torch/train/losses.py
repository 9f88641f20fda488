"""Loss functions, counterpart of ``ampnet_tpu/train/losses.py``.

* ``weighted_cross_entropy`` is torch ``CrossEntropyLoss(weight=w,
  reduction='mean', ignore_index=-1)`` (reference
  ``train_pointnet-attention.py:138``): per-point CE scaled by the target's
  class weight, summed, divided by the SUM of the weights of non-ignored
  targets. Each loss also comes in parts (numerator, denominator), so gradient
  accumulation can divide every micro-batch by the global denominator.
* ``orthogonality_regularizer`` is ``‖I − A·Aᵀ‖_F`` over every window's
  feature transform (``train_pointnet-attention.py:463-467``), with ``+1e-12``
  inside the square root: the T-Nets' zero-initialised ``fc_out`` starts the
  transforms at exactly the identity, where an unguarded sqrt has an infinite
  derivative and the first gradient would be NaN.
"""

from __future__ import annotations

from typing import Optional

import torch

from ampnet_tpu_torch.models.layers import at_least_float32
from ampnet_tpu_torch.parallel.mesh import all_reduce_sum


def _as_weights(class_weights, device) -> Optional[torch.Tensor]:
    if class_weights is None:
        return None
    return torch.as_tensor(class_weights, dtype=torch.float32, device=device)


def _per_point_ce(logits: torch.Tensor, targets: torch.Tensor, class_weights,
                  ignore_index: int):
    """Flattened per-point (ce, weight); weight 0 for ignored targets."""
    num_classes = logits.shape[-1]
    logits = at_least_float32(logits.reshape(-1, num_classes))
    targets = targets.reshape(-1).long()
    valid = targets != ignore_index
    safe_t = torch.where(valid, targets, torch.zeros_like(targets))
    shifted = logits - logits.amax(dim=-1, keepdim=True)
    logz = torch.log(torch.exp(shifted).sum(dim=-1))
    ce = logz - shifted.gather(1, safe_t[:, None])[:, 0]
    w = valid.float()
    weights = _as_weights(class_weights, logits.device)
    if weights is not None:
        w = weights[safe_t] * w
    return ce, w


def weighted_cross_entropy_parts(logits, targets, class_weights=None, ignore_index: int = -1):
    """(numerator ``Σ ce·w``, weight sum ``Σ w``) of the torch weighted mean."""
    ce, w = _per_point_ce(logits, targets, class_weights, ignore_index)
    return (ce * w).sum(), w.sum()


def weighted_cross_entropy(logits, targets, class_weights=None, ignore_index: int = -1):
    num, den = weighted_cross_entropy_parts(logits, targets, class_weights, ignore_index)
    return num / den.clamp_min(1e-12)


def cross_entropy_weight_sum(targets, class_weights=None, ignore_index: int = -1):
    """The denominator of the torch weighted mean, from the targets alone."""
    targets = targets.reshape(-1).long()
    valid = targets != ignore_index
    weights = _as_weights(class_weights, targets.device)
    if weights is None:
        return valid.float().sum()
    return (weights[torch.where(valid, targets, torch.zeros_like(targets))] * valid.float()).sum()


def weighted_focal_parts(logits, targets, class_weights=None, gamma: float = 2.0,
                         ignore_index: int = -1):
    """(numerator, weight sum) of the α-weighted focal loss (Lin et al. 2017):
    per-point CE times ``(1 − p_t)^γ``; the same label-only denominator as the
    CE, so γ = 0 is exactly the weighted CE."""
    ce, w = _per_point_ce(logits, targets, class_weights, ignore_index)
    pt = torch.exp(-ce)
    # clip keeps the γ<1 gradient finite at pt→1; value impact ≤ 1e-12·ce
    mod = torch.pow(torch.clamp(1.0 - pt, 1e-12, 1.0), float(gamma))
    return (mod * ce * w).sum(), w.sum()


def weighted_focal(logits, targets, class_weights=None, gamma: float = 2.0,
                   ignore_index: int = -1):
    num, den = weighted_focal_parts(logits, targets, class_weights, gamma, ignore_index)
    return num / den.clamp_min(1e-12)


def distillation_kl_parts(student_logits, teacher_probs, targets, temperature: float = 1.0,
                          ignore_index: int = -1):
    """(numerator, valid count) of ``T² · KL(p_T ‖ softmax(student / T))``
    over non-ignored points (Hinton et al. 2015); ``teacher_probs`` come in
    already tempered."""
    num_classes = student_logits.shape[-1]
    t = float(temperature)
    lg = at_least_float32(student_logits.reshape(-1, num_classes)) / t
    tp = teacher_probs.reshape(-1, num_classes).float()
    valid = (targets.reshape(-1) != ignore_index).float()
    logp_s = torch.log_softmax(lg, dim=-1)
    kl = (tp * (torch.log(torch.clamp(tp, 1e-12, 1.0)) - logp_s)).sum(-1)
    return (kl * valid).sum() * t * t, valid.sum()


def distillation_kl(student_logits, teacher_probs, targets, temperature: float = 1.0,
                    ignore_index: int = -1):
    num, den = distillation_kl_parts(student_logits, teacher_probs, targets, temperature,
                                     ignore_index)
    return num / den.clamp_min(1.0)


def orthogonality_regularizer(transforms: torch.Tensor, dp=None) -> torch.Tensor:
    """Frobenius norm of (I − A·Aᵀ) over a stack of ``[..., D, D]`` matrices —
    one number, like torch.norm over the whole batch (…:463-464). Under a
    process group ``dp`` the sum of squares is the global batch's (summed
    over the ranks, differentiably), so every rank reads the same norm."""
    d = transforms.shape[-1]
    a = at_least_float32(transforms.reshape(-1, d, d))
    diff = torch.eye(d, dtype=a.dtype, device=a.device) - a @ a.transpose(1, 2)
    return torch.sqrt(all_reduce_sum(diff.square().sum(), dp) + 1e-12)
