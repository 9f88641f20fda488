"""The trainer, counterpart of ``ampnet_tpu/train/trainer.py`` (the reference
``train_att`` loop, ``train_pointnet-attention.py:29-334``).

* Per-step metrics come back as ``[C, C]`` confusion matrices and scalars that
  stay on the device; each epoch fetches them once and derives per-class IoU
  and accuracy on the host (no ``.item()`` inside the step loop).
* A GPU-resident dataset (``DeviceCachedBatcher``) runs through the epoch
  loop of ``train/epoch.py`` (``epoch_dispatch='auto'``); a host batcher,
  or any batcher under ``epoch_dispatch='off'``, runs step by step. Both
  take the same steps on the same batches.
* Epoch e draws its order from ``seed + e + 1``: the JAX trainer peeks one
  batch of its train data at construction, which spends epoch 0's draw, and
  the port spends it too, so both packages train on the same orders.
* Best-val-loss checkpointing (best train loss without a val split) and
  ``epochs_since_improvement`` as in the reference (``:314-330``), plateau
  ``lr_scale`` decay and early stop; ``resume`` restores params, Adam state
  and counters.
* The optimizer updates the parameters in place, so an async save first takes
  a snapshot of the state on the device (copies, no host sync); the writer
  thread fetches and writes that snapshot, never the live tensors.
* The eval pass runs the model in eval mode and puts it back in train mode.
* Any model of the factory trains here; the classification task passes its
  own steps (``train/cls_step.py``) as ``step_fns``, and its epoch metrics
  carry the ``no_tower``/``tower`` tags.
* ``teacher`` distills frozen teachers into the segmentation step
  (``train/distill.py``); its ``distill_loss`` joins the epoch metrics.
* ``dp`` (``parallel/mesh.py``) makes this the trainer of one rank of a
  process group: rank 0's weights are broadcast, each step takes the rank's
  rows of every global batch (or its columns of the cache's index matrix),
  and the steps return the global batch's metrics, so every rank takes the
  same best-checkpoint, plateau and early-stop decisions. Only rank 0 prints
  and writes checkpoints and CSV logs; ``fit`` ends when rank 0's last write
  has landed, so a ``resume`` on every rank reads it.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ampnet_tpu_torch.core.checkpoint import CheckpointManager
from ampnet_tpu_torch.core.config import AMPNetConfig
from ampnet_tpu_torch.core.device import resolve_device
from ampnet_tpu_torch.core.logging import MetricsLogger
from ampnet_tpu_torch.core.metrics import iou_from_confusion
from ampnet_tpu_torch.data.device_cache import DeviceCachedBatcher
from ampnet_tpu_torch.data.pipeline import to_device_batch
from ampnet_tpu_torch.parallel.mesh import replicate_state, shard_batch
from ampnet_tpu_torch.train.epoch import make_epoch_fns, stack_metrics
from ampnet_tpu_torch.train.state import create_train_state
from ampnet_tpu_torch.train.step import make_step_fns

IOU_TAGS = ("bckg", "tower", "cables", "low_veg", "high_veg")
CLS_TAGS = ("no_tower", "tower")
LOSS_KEYS = ("loss", "ce_loss", "focal_loss", "reg_loss", "distill_loss")


def parameter_counts(model: torch.nn.Module) -> Dict[str, int]:
    """Trainable parameters per top-level module and in total (the reference
    prints a table of these, train_pointnet-attention.py:165-178)."""
    out = {name: sum(p.numel() for p in mod.parameters())
           for name, mod in model.named_children()}
    out["total"] = sum(out.values())
    return out


def epoch_metrics(confusions: List[np.ndarray], losses: Dict[str, List[float]]) -> Dict:
    """Host-side aggregation with the reference's per-batch-mean convention
    (train_pointnet-attention.py:232-241), plus the dataset-level mIoU and
    accuracy from the summed confusion."""
    out = {k: float(np.mean(v)) for k, v in losses.items() if v}
    n_cls = confusions[0].shape[0]
    tags = IOU_TAGS if n_cls == len(IOU_TAGS) else (
        CLS_TAGS if n_cls == 2 else tuple(f"class{i}" for i in range(n_cls)))
    per_batch = {t: [] for t in tags}
    total = np.zeros_like(confusions[0])
    for cm in confusions:
        total += cm
        iou, valid = iou_from_confusion(torch.from_numpy(cm))
        for c, tag in enumerate(tags):
            if bool(valid[c]):
                per_batch[tag].append(float(iou[c]))
    for tag, vals in per_batch.items():
        out[f"iou_{tag}"] = float(np.mean(vals)) if vals else float("nan")
    iou, valid = iou_from_confusion(torch.from_numpy(total))
    out["miou"] = float(iou[valid].mean()) if bool(valid.any()) else float("nan")
    out["accuracy"] = float(np.diag(total).sum() / max(total.sum(), 1))
    return out


class _Unlogged:
    """The loggers of a rank other than 0: only rank 0 writes the CSVs."""

    def scalar(self, *args) -> None:
        pass

    scalars = flush = close = scalar


class Trainer:
    def __init__(
        self,
        cfg: AMPNetConfig,
        model: torch.nn.Module,
        train_data,
        val_data,
        workdir: str,
        name: str = "ampnet",
        task: str = "segmentation",
        augment: bool = True,
        device="cuda",
        step_fns: Optional[Tuple[Callable, Callable]] = None,
        teacher=None,
        dp=None,
        epoch_dispatch: str = "auto",
    ):
        if epoch_dispatch not in ("auto", "off"):
            raise ValueError(f"epoch_dispatch {epoch_dispatch!r} (want auto/off)")
        self.epoch_dispatch = epoch_dispatch
        self.dp = dp
        self.writer = dp is None or dp.rank == 0
        self.device = dp.device if dp is not None else resolve_device(device)
        self.cfg = cfg
        self.train_data = train_data
        self.val_data = val_data
        train_data.epoch += 1  # the JAX trainer's peek: next(iter(train_data))
        self.workdir = workdir
        self.name = name
        self.task = task
        self.steps_per_epoch = max(len(train_data), 1)
        self.state = create_train_state(cfg, model, self.steps_per_epoch, self.device)
        if dp is not None:
            replicate_state(self.state, dp)
        # the segmentation steps (distilling ``teacher``, train/distill.py)
        # unless the caller brings its own (classification)
        self.train_step, self.eval_step = step_fns or make_step_fns(
            cfg, augment=augment, teacher=teacher, dp=dp)
        self.train_epoch, self.eval_epoch = make_epoch_fns(self.train_step, self.eval_step)
        self.ckpt = CheckpointManager(f"{workdir}/checkpoints")
        if self.writer:
            counts = parameter_counts(model)
            print("Trainable params: " + ", ".join(f"{k}={v:,}" for k, v in counts.items()))
            self.log_train = MetricsLogger(f"{workdir}/logs", f"{name}_train")
            self.log_val = MetricsLogger(f"{workdir}/logs", f"{name}_val")
        else:
            self.log_train = self.log_val = _Unlogged()
        self.best_val_loss = float("inf")
        self.epochs_since_improvement = 0
        self.epoch = 0

    def resume(self, ckpt_name: Optional[str] = None) -> bool:
        """Restore params, Adam state and counters (train_pointnet-attention.py:151-162)."""
        name = ckpt_name or f"{self.name}_best"
        if not self.ckpt.exists(name):
            return False
        _, meta = self.ckpt.restore(name, self.state)
        self.epoch = self.state.epoch
        self.epochs_since_improvement = int(meta.get("epochs_since_improvement", 0))
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        return True

    def _dispatch(self, data, train: bool) -> Dict[str, torch.Tensor]:
        """Queue one epoch's steps; the metrics come back stacked, on the device."""
        # under a group, the rank's rows: of each micro-batch when training
        accum = self.cfg.train.grad_accum if train else 1
        if isinstance(data, DeviceCachedBatcher) and self.epoch_dispatch == "auto":
            idxs, pads, _ = data.epoch_index_matrix(self.dp, accum)
            if idxs.shape[0] == 0:
                return {}
            fn = self.train_epoch if train else self.eval_epoch
            return fn(self.state, data.data, idxs, pads)
        per_step = []
        for batch in data:
            if self.dp is not None:
                batch = shard_batch(batch, self.dp, accum)
            dev = to_device_batch(batch, self.device)
            per_step.append(self.train_step(self.state, dev) if train
                            else self.eval_step(self.state, dev)[0])
        return stack_metrics(per_step)

    @staticmethod
    def _collect(ms: Dict[str, torch.Tensor]) -> Dict:
        """ONE device→host fetch of an epoch's stacked metrics, aggregated."""
        if not ms:
            return {}
        host = {k: v.cpu().numpy() for k, v in ms.items()}
        losses = {k: [float(x) for x in host[k]] for k in LOSS_KEYS if k in host}
        return epoch_metrics(list(host["confusion"]), losses)

    def _run_epoch(self, data, train: bool) -> Dict:
        return self._collect(self._dispatch(data, train))

    def fit(self, epochs: Optional[int] = None) -> Dict:
        epochs = epochs or self.cfg.train.epochs
        history = {"train": [], "val": []}
        t_start = time.time()
        try:
            self._fit_loop(epochs, history)
        except BaseException:
            # land an in-flight async checkpoint, but let a failed write not
            # hide the training failure
            try:
                self.ckpt.wait()
            except Exception as e:
                print(f"async checkpoint also failed during teardown: {e}", file=sys.stderr)
            raise
        self.ckpt.wait()
        if self.dp is not None:  # rank 0's last checkpoint is on disk for every rank
            self.dp.barrier()
        self.log_train.scalar("total_hours", (time.time() - t_start) / 3600, self.epoch)
        self.log_train.flush()
        return history

    def _improved(self, loss: float, metrics: Dict) -> None:
        if loss < self.best_val_loss:
            self.best_val_loss = loss
            self.epochs_since_improvement = 0
            self._save_best(metrics)
        else:
            self.epochs_since_improvement += 1

    def _fit_loop(self, epochs: int, history: Dict) -> None:
        for epoch in range(self.epoch, epochs):
            self.epoch = epoch
            t_ep = time.time()
            tm = self._run_epoch(self.train_data, train=True)
            wall = time.time() - t_ep
            td = self.train_data
            n_clouds = len(td) * td.batch_size
            if not td.drop_last:  # the last batch may be short: count real clouds
                n_clouds = min(n_clouds, len(td._base_indices()))
            tm["epoch_seconds"] = wall
            tm["windows_per_sec"] = n_clouds * td.max_windows / max(wall, 1e-9)
            self.log_train.scalars(tm, epoch)
            history["train"].append(tm)

            if self.val_data is None or len(self.val_data) == 0:
                # no validation split: the best train loss picks the checkpoint
                self._improved(tm.get("loss", float("inf")), tm)
            else:
                vm = self._run_epoch(self.val_data, train=False)
                self.log_val.scalars(vm, epoch)
                self.log_val.scalar("epochs_since_improvement", self.epochs_since_improvement,
                                    epoch)
                history["val"].append(vm)
                self._improved(vm.get("loss", float("inf")), vm)
            self.log_train.flush()
            self.log_val.flush()
            t = self.cfg.train
            if (t.plateau_patience and self.epochs_since_improvement > 0
                    and self.epochs_since_improvement % t.plateau_patience == 0):
                # plateau LR decay (reference adjust_learning_rate semantics)
                self.state.scale_lr(t.plateau_gamma)
                self.log_train.scalar("lr_scale", self.state.lr_scale, epoch)
            if t.early_stop_patience and self.epochs_since_improvement >= t.early_stop_patience:
                break  # baseline/train_segmentation.py:266

    def _save_best(self, metrics: Dict) -> None:
        self.state.epoch = self.epoch
        if not self.writer:
            return
        meta = dict(
            task=self.task,
            accuracy=metrics.get("accuracy", 0.0),
            epochs_since_improvement=self.epochs_since_improvement,
            config_json=self.cfg.to_json(),
            weighing_method=self.cfg.train.weighing_method,
            batch_size=self.train_data.batch_size,
            learning_rate=self.cfg.train.learning_rate,
            number_of_points=self.train_data.n_points,
            extra_meta={"best_val_loss": self.best_val_loss},
        )
        if self.cfg.train.async_checkpoint:
            # device copies, so the next steps' in-place updates cannot reach
            # what the writer thread fetches
            self.ckpt.save_async(f"{self.name}_best", self.state.snapshot(copy=True), **meta)
        else:
            self.ckpt.save(f"{self.name}_best", self.state, **meta)

    def close(self) -> None:
        self.ckpt.wait()
        self.log_train.close()
        self.log_val.close()
