"""Train state: the model, one Adam with the reference's LR schedule, counters
and the per-step generator. Counterpart of ``ampnet_tpu/train/state.py``.

The reference runs two identically configured Adams (encoder and head,
``train_pointnet-attention.py:140-149``); Adam is elementwise, so one Adam
over all parameters is the same optimizer, as in the JAX package.

* **Adam** is ``torch.optim.Adam`` with optax's defaults (β 0.9/0.999,
  eps 1e-8). It updates the parameters in place, much as the JAX step donates
  them: a caller that must keep a step's state takes ``snapshot()`` first.
* **Schedule.** The learning rate of update ``count`` (the number of updates
  before it, which optax reads before it increments) follows optax's
  ``piecewise_constant_schedule`` with boundaries ``milestone ·
  steps_per_epoch``: it is scaled by ``gamma`` for every boundary
  ``b <= count``. It is not torch's epoch-driven ``MultiStepLR``.
* **lr_scale** multiplies the update (the plateau knob, reference
  ``adjust_learning_rate``, utils/utils.py:459-470). Adam's update is linear
  in the learning rate, so it is applied as ``lr · lr_scale``. It is kept
  float32-representable, as the JAX state keeps it a float32 array.
* **Generator.** Step ``s`` draws its augmentation and dropout from a
  ``torch.Generator`` seeded from ``(seed, s)``, as the JAX step folds the
  step into its key, so a per-step loop and an epoch loop draw the same.
  Under a process group each rank draws from ``(seed, s, rank)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ampnet_tpu_torch.core.config import AMPNetConfig
from ampnet_tpu_torch.core.weights import adam_tensors, flax_leaf_map

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def piecewise_constant_lr(init_value: float, milestones: Sequence[int], gamma: float,
                          steps_per_epoch: int):
    """``count → lr``: optax ``piecewise_constant_schedule(init_value,
    {m · steps_per_epoch: gamma})`` (equal boundaries collapse into one, as
    the dict does in the JAX package)."""
    spe = max(int(steps_per_epoch), 1)
    boundaries = sorted({int(m) * spe for m in (milestones or ())})

    def schedule(count: int) -> float:
        lr = init_value
        for b in boundaries:
            if count >= b:
                lr *= gamma
        return lr

    return schedule


@dataclass
class StateSnapshot:
    """A train state's tensors at one moment (device copies when taken for an
    async save): model tensors and Adam moments by torch name, the Flax path
    of each (``core/weights.py::flax_leaf_map``), and the counters."""

    tensors: Dict[str, torch.Tensor]
    adam: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    leaf_map: List
    count: int
    step: int
    epoch: int
    lr_scale: float


class TrainState:
    def __init__(self, model: torch.nn.Module, schedule, seed: int = 0):
        self.model = model
        self.optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                          betas=ADAM_BETAS, eps=ADAM_EPS)
        self.schedule = schedule
        self.seed = int(seed)
        self.step = 0
        self.epoch = 0
        self.lr_scale = 1.0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def learning_rate(self) -> float:
        """The learning rate the next update takes, lr_scale included."""
        return self.schedule(self.step) * self.lr_scale

    def step_generator(self, rank: Optional[int] = None) -> torch.Generator:
        """This step's generator, seeded from (seed, step) alone; a rank of a
        process group draws for its own rows from (seed, step, rank)."""
        entropy = (self.seed, self.step) if rank is None else (self.seed, self.step, rank)
        seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def apply_gradients(self) -> None:
        """One Adam update from the parameters' ``.grad``; step += 1."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.learning_rate()
        self.optimizer.step()
        self.step += 1

    def scale_lr(self, factor: float) -> None:
        self.lr_scale = float(np.float32(self.lr_scale) * np.float32(factor))

    def snapshot(self, copy: bool = True) -> StateSnapshot:
        """The state's tensors and counters; ``copy`` clones every tensor on
        its device (enqueued, no host sync), so later steps cannot change it."""
        grab = (lambda t: t.detach().clone()) if copy else (lambda t: t.detach())
        count, moments = adam_tensors(self.model, self.optimizer)
        return StateSnapshot(
            tensors={k: grab(v) for k, v in self.model.state_dict().items()},
            adam={k: (grab(m), grab(v)) for k, (m, v) in moments.items()},
            leaf_map=flax_leaf_map(self.model), count=count, step=self.step,
            epoch=self.epoch, lr_scale=self.lr_scale,
        )


def create_train_state(cfg: AMPNetConfig, model: torch.nn.Module, steps_per_epoch: int = 0,
                       device="cuda") -> TrainState:
    """A fresh train state for ``model`` (moved to ``device``) with the
    config's schedule and seed."""
    t = cfg.train
    model.to(device)
    return TrainState(model, piecewise_constant_lr(t.learning_rate, t.lr_milestones,
                                                   t.lr_gamma, steps_per_epoch), seed=t.seed)
