"""In-step knowledge distillation, counterpart of ``ampnet_tpu/train/distill.py``.

The frozen teachers run inside the student's train step on the exact
augmented batch the student sees (shared rotation, shuffle, dropout), so the
soft targets always match the student's view of the points, and no second
dataset pass or stored soft labels are needed.

Teachers come from the same comma-separated checkpoint groups as inference
ensembles (``cli/main.py::_restore_groups``): the members of a group share a
signature and run one after the other here; cross-family groups (attention +
GRU) are summed with them, and the sum is divided by the member count. The
encoders are per-point MLPs and pooling, so a teacher accepts the student's
(W, N) geometry whatever its own training geometry was. Teachers run their
plain modules in eval mode, as the JAX package runs ``model.apply(train=
False)``: never a fused backend, which would change the numbers. Under a
process group each rank's teachers run on the rank's own rows, and the step
divides the KL numerators by the global count of valid points
(``train/step.py``), as the JAX sharded step runs its teachers per shard.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ampnet_tpu_torch.models.layers import at_least_float32


def make_teacher_fn(groups: Sequence[Tuple], temperature: float = 1.0) -> Callable:
    """``teacher_probs(points, centroids, pad_mask, point_mask) -> [..., C]``:
    the tempered softmax of every member's logits, averaged over all members,
    with no gradient. ``groups``: ``[(cfg, model or [model, ...]), ...]``.
    Each group reads its own column prefix, ``num_features + extra_features``
    (the batch carries the widest schema; the geometric columns come last),
    and raises when the batch is narrower."""
    entries = []
    for g_cfg, models in groups:
        models = list(models) if isinstance(models, (list, tuple)) else [models]
        width = int(g_cfg.data.num_features + g_cfg.data.extra_features)
        entries.append((models, width))
    total = sum(len(models) for models, _ in entries)
    if total == 0:
        raise ValueError("distillation teacher needs at least one member")

    def teacher_probs(points: torch.Tensor, centroids: Optional[torch.Tensor],
                      pad_mask: Optional[torch.Tensor],
                      point_mask: Optional[torch.Tensor]) -> torch.Tensor:
        acc = None
        with torch.no_grad():
            for models, width in entries:
                if points.shape[-1] < width:
                    raise ValueError(
                        f"teacher expects {width} feature columns but the batch "
                        f"carries {points.shape[-1]} — train on a dataset "
                        "preprocessed with the teacher's --geom_features setting")
                for model in models:
                    model.eval()
                    dtype = next(model.parameters()).dtype
                    cast = lambda t: t.to(dtype) if t is not None and t.is_floating_point() else t
                    logits = model(cast(points[..., :width]), cast(centroids), pad_mask,
                                   point_mask)[0]
                    p = torch.softmax(at_least_float32(logits) / float(temperature), dim=-1)
                    acc = p if acc is None else acc + p
        return acc / total

    return teacher_probs
