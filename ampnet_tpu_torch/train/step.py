"""The train and eval steps, counterpart of ``ampnet_tpu/train/step.py``
(the reference ``train_loop``, ``train_pointnet-attention.py:337-475``).

One step: on-device augmentation from the step's generator, one batched
``[B·W, N, C]`` encoder pass, masked attention, masked weighted CE (or focal)
plus ``reg_weight`` times the T-Net regulariser, ``backward``, one Adam update.
Metrics stay on the device as tensors (``loss``, ``ce_loss``, ``reg_loss``,
a ``[C, C]`` ``confusion`` matrix, ``grad_norm``; under focal also
``focal_loss``, with ``ce_loss`` the true CE): nothing here reads a value back
to the host, so steps queue on the card without a sync.

In training the batch carries no point mask, so the replicate-padded windows
enter every trunk BatchNorm's statistics, and the T-Net FC BatchNorms act on
all ``B·W`` windows; only the labels (−1) and the attention's key mask keep
padded windows out, as in the JAX step. ``rotate_z`` turns the points and not
the centroids, so the positional encoding sees unrotated centroids, as in JAX.

``grad_accum=K`` splits the batch into K equal micro-batches with one Adam
update: each micro-batch's data loss is its CE numerator over the GLOBAL weight
sum (known from the labels before any forward), so the summed gradient is the
full-batch CE gradient exactly; the regulariser is scaled by 1/K (a mean of
per-micro norms); the BatchNorm running statistics chain from one micro-batch
to the next.

Distillation (``teacher=``, train/distill.py): the frozen teachers run on the
augmented batch before the student's forward, and the data term becomes
``(1 − α)·CE + α·T²·KL(teacher ‖ student)`` (``distill_alpha``,
``distill_temp``); under ``grad_accum`` each micro-batch's KL numerator is
divided by the batch's global count of valid points, so that gradient is
exact too. A batch may carry more columns than the student reads (a
geometric teacher's): the student reads its own prefix,
``num_features + extra_features``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ampnet_tpu_torch.core.config import AMPNetConfig
from ampnet_tpu_torch.core.metrics import confusion_matrix
from ampnet_tpu_torch.ops.augment import (
    jitter,
    random_point_dropout,
    random_scale,
    random_shift,
    rotate_z,
    shuffle_windows,
)
from ampnet_tpu_torch.parallel.mesh import all_reduce_grads, sync_batch_norm
from ampnet_tpu_torch.train.losses import (
    cross_entropy_weight_sum,
    distillation_kl,
    distillation_kl_parts,
    orthogonality_regularizer,
    weighted_cross_entropy,
    weighted_cross_entropy_parts,
    weighted_focal,
    weighted_focal_parts,
)
from ampnet_tpu_torch.train.state import TrainState

AUGMENTATIONS = ("shuffle_windows", "rotate_z", "jitter", "scale", "shift", "point_dropout")

Batch = Dict[str, torch.Tensor]


def window_pad_mask_from_labels(labels: torch.Tensor) -> torch.Tensor:
    """A window is padding iff every label in it is −1
    (train_pointnet-attention.py:428-431)."""
    return (labels == -1).all(dim=-1)


def augment_batch(batch: Batch, recipe, generator: torch.Generator) -> Batch:
    """The recipe's augmentations in order, each drawing from ``generator``."""
    points, labels, centroids = batch["points"], batch["labels"], batch.get("centroids")
    for name in recipe:
        if name == "shuffle_windows":  # shared permutation (train_pointnet-attention.py:390)
            out = shuffle_windows(points, labels, generator, centroids)
            points, labels = out[0], out[1]
            centroids = out[2] if centroids is not None else None
        elif name == "rotate_z":  # one shared angle (…:393,403); centroids stay
            points = rotate_z(points, generator)
        elif name == "jitter":
            points = jitter(points, generator)
        elif name == "scale":
            points = random_scale(points, generator)
        elif name == "shift":
            points = random_shift(points, generator)
        elif name == "point_dropout":  # labels follow the replacement points
            points, labels = random_point_dropout(points, generator, labels=labels)
        else:
            raise ValueError(f"unknown augmentation {name!r}")
    out = dict(batch, points=points, labels=labels)
    if centroids is not None:
        out["centroids"] = centroids
    return out


def _pad_mask(batch: Batch) -> torch.Tensor:
    pad_mask = batch.get("window_pad_mask")
    return window_pad_mask_from_labels(batch["labels"]) if pad_mask is None else pad_mask


def _forward(model, batch: Batch, generator: Optional[torch.Generator],
             width: Optional[int] = None):
    """The model on ``batch``; a batch wider than ``width`` (a geometric
    teacher's columns) gives the model its first ``width`` columns."""
    points = batch["points"]
    if width is not None and points.shape[-1] > width:
        points = points[..., :width]
    return model(points, batch.get("centroids"), _pad_mask(batch), batch.get("point_mask"),
                 generator=generator)


def global_mean(parts, dp=None) -> torch.Tensor:
    """A loss from its (numerator, denominator) parts, both summed over the
    ranks under a process group ``dp`` (no gradient there: metrics only)."""
    num, den = parts
    if dp is not None:
        num, den = dp.sum(torch.stack([num, den])).unbind()
    return num / den.clamp_min(1e-12)


def make_step_fns(
    cfg: AMPNetConfig,
    augment: bool = True,
    grad_accum: int = 0,  # 0 → cfg.train.grad_accum
    teacher=None,
    dp=None,
) -> Tuple[Callable, Callable]:
    """``(train_step, eval_step)`` over the config.

    ``train_step(state, batch) -> metrics`` updates ``state`` in place (model
    parameters, BatchNorm running statistics, Adam, ``step``);
    ``eval_step(state, batch) -> (metrics, preds)`` runs the model in eval mode
    and leaves it in the mode it found it in. ``teacher``: ``[(cfg, model or
    [model, ...]), ...]`` distills those teachers into the step (metric
    ``distill_loss``).

    ``dp`` (``parallel/mesh.py``; ``make_sharded_step_fns``): the steps of
    one rank of a process group, over the rank's rows of the global batch.
    The training BatchNorms, the CE and KL normalisers and the regulariser
    take the global batch's sums, each micro-batch's loss is the rank's share
    of the global loss, the gradients are summed over the ranks before
    ``grad_norm`` and Adam, and every metric is the global batch's."""
    t = cfg.train
    reg_w = t.reg_weight
    num_classes = cfg.model.num_classes
    ignore = t.ignore_index
    grad_accum = grad_accum or t.grad_accum
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    focal_gamma = float(t.focal_gamma)
    if focal_gamma < 0:
        raise ValueError(f"focal_gamma must be >= 0, got {focal_gamma}")
    recipe = tuple(t.augmentations) if augment else ()
    unknown = [a for a in recipe if a not in AUGMENTATIONS]
    if unknown:
        raise ValueError(f"unknown augmentation {unknown[0]!r}")
    alpha, temp = float(t.distill_alpha), float(t.distill_temp)
    if teacher is not None and not 0.0 < alpha <= 1.0:
        raise ValueError(f"distillation needs 0 < distill_alpha <= 1, got {alpha}")
    if temp <= 0:
        raise ValueError(f"distill_temp must be > 0, got {temp}")
    teacher_fn = None
    if teacher is not None:
        from ampnet_tpu_torch.train.distill import make_teacher_fn

        teacher_fn = make_teacher_fn(teacher, temperature=temp)
    width = int(cfg.data.num_features + cfg.data.extra_features)

    weights_by_device: Dict[torch.device, torch.Tensor] = {}

    def weights_on(device) -> torch.Tensor:
        """The class weights on ``device``, copied there once: a copy from
        host memory per step would wait for the card every step."""
        if device not in weights_by_device:
            weights_by_device[device] = torch.tensor(t.class_weights, dtype=torch.float32,
                                                     device=device)
        return weights_by_device[device]

    if focal_gamma > 0:
        data_loss = lambda lg, lb, cw: weighted_focal(lg, lb, cw, focal_gamma, ignore)
        data_loss_parts = lambda lg, lb, cw: weighted_focal_parts(lg, lb, cw, focal_gamma, ignore)
    else:
        data_loss = lambda lg, lb, cw: weighted_cross_entropy(lg, lb, cw, ignore)
        data_loss_parts = lambda lg, lb, cw: weighted_cross_entropy_parts(lg, lb, cw, ignore)

    world = 1 if dp is None else dp.world

    def train_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        with sync_batch_norm(model, dp):
            metrics = _train_step(state, batch)
        state.apply_gradients()
        return metrics

    def _train_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        cw = weights_on(state.device)
        gen = state.step_generator(None if dp is None else dp.rank)
        aug = augment_batch(batch, recipe, gen)
        if teacher_fn is not None:  # on the batch the student sees, before its forward
            aug["teacher_probs"] = teacher_fn(aug["points"], aug.get("centroids"),
                                              _pad_mask(aug), aug.get("point_mask"))
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1 and dp is None:
            logits, t_feat, _ = _forward(model, aug, gen, width)
            ce = data_loss(logits, aug["labels"], cw)
            data = ce
            if teacher_fn is not None:
                dl = distillation_kl(logits, aug["teacher_probs"], aug["labels"], temp, ignore)
                data = (1.0 - alpha) * ce + alpha * dl
                dl = dl.detach()
            reg = orthogonality_regularizer(t_feat)
            loss = data + reg_w * reg
            loss.backward()
            logits = logits.detach()
            cm = confusion_matrix(logits.argmax(-1), aug["labels"], num_classes)
            # under focal the objective's data term is not the CE: "ce_loss"
            # stays the true CE so it means one quantity across runs
            true_ce = (weighted_cross_entropy(logits, aug["labels"], cw, ignore)
                       if focal_gamma > 0 else ce.detach())
            loss, ce, reg = loss.detach(), ce.detach(), reg.detach()
        else:
            b = aug["points"].shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
            mb = b // grad_accum
            # the global CE normaliser: label-only, known before any forward
            w_total = cross_entropy_weight_sum(aug["labels"], cw, ignore)
            # the global KL normaliser, label-only as well: the valid points
            n_total = (aug["labels"] != ignore).float().sum()
            if dp is not None:
                w_total, n_total = dp.sum(torch.stack([w_total, n_total])).unbind()
            w_total, n_total = w_total.clamp_min(1e-12), n_total.clamp_min(1.0)
            loss = ce = true_ce = reg = dl = torch.zeros((), device=state.device)
            cm = torch.zeros((num_classes, num_classes), dtype=torch.long, device=state.device)
            for k in range(grad_accum):
                micro = {key: v[k * mb:(k + 1) * mb] for key, v in aug.items()
                         if isinstance(v, torch.Tensor)}
                logits, t_feat, _ = _forward(model, micro, gen, width)
                ce_k = data_loss_parts(logits, micro["labels"], cw)[0] / w_total
                data_k = ce_k
                if teacher_fn is not None:
                    dl_k = distillation_kl_parts(logits, micro["teacher_probs"],
                                                 micro["labels"], temp, ignore)[0] / n_total
                    data_k = (1.0 - alpha) * ce_k + alpha * dl_k
                    dl = dl + dl_k.detach()
                # the same global norm on every rank: each carries 1/world of it
                reg_k = orthogonality_regularizer(t_feat, dp)
                loss_k = data_k + reg_w * reg_k / (grad_accum * world)
                loss_k.backward()
                logits = logits.detach()
                tce_k = (weighted_cross_entropy_parts(logits, micro["labels"], cw, ignore)[0]
                         / w_total
                         if focal_gamma > 0 else ce_k.detach())
                loss, ce, reg = loss + loss_k.detach(), ce + ce_k.detach(), reg + reg_k.detach()
                true_ce = true_ce + tce_k
                cm = cm + confusion_matrix(logits.argmax(-1), micro["labels"], num_classes)
            reg = reg / grad_accum
            if dp is not None:
                all_reduce_grads(model, dp)
                loss, ce, true_ce, dl = dp.sum(torch.stack([loss, ce, true_ce, dl])).unbind()
                cm = dp.sum(cm)
        grad_norm = torch.stack([p.grad.square().sum() for p in model.parameters()
                                 if p.grad is not None]).sum().sqrt()
        metrics = {"loss": loss, "ce_loss": true_ce, "reg_loss": reg, "confusion": cm,
                   "grad_norm": grad_norm}
        if focal_gamma > 0:
            metrics["focal_loss"] = ce
        if teacher_fn is not None:
            metrics["distill_loss"] = dl
        return metrics

    def eval_step(state: TrainState, batch: Batch):
        model = state.model
        cw = weights_on(state.device)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                logits, _, _ = _forward(model, batch, None, width)
        finally:
            model.train(was_training)
        ce = global_mean(data_loss_parts(logits, batch["labels"], cw), dp)
        preds = logits.argmax(-1)
        cm = confusion_matrix(preds, batch["labels"], num_classes)
        # validation loss is the data term only (train_pointnet-attention.py:471-473)
        metrics = {"loss": ce, "ce_loss": ce, "confusion": cm if dp is None else dp.sum(cm)}
        if focal_gamma > 0:
            metrics["ce_loss"] = global_mean(
                weighted_cross_entropy_parts(logits, batch["labels"], cw, ignore), dp)
            metrics["focal_loss"] = ce
        return metrics, preds

    return train_step, eval_step
