"""Model factory: one constructor for every architecture × task, the port's
counterpart of ``ampnet_tpu/models/factory.py`` (the reference spreads them
over six training scripts)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ampnet_tpu_torch.core.config import AMPNetConfig
from ampnet_tpu_torch.models.adapter import SingleWindowClassifier, SingleWindowSegmenter
from ampnet_tpu_torch.models.amp import AMPNetClassifier, AMPNetSegmenter
from ampnet_tpu_torch.models.pointnet2 import PointNet2Segmenter

ARCHS = ("attention", "gru", "baseline", "classic", "pointnet2")
WINDOWED = ("attention", "gru")  # the families that take several windows per cloud
TASKS = ("segmentation", "classification")


def build_model(cfg: AMPNetConfig, arch: str = "attention", task: str = "segmentation",
                num_cls_out: int = 2, generator: Optional[torch.Generator] = None):
    """arch: 'attention' (AMP-Net), 'gru' (sequential windows), 'baseline'
    (light single-window PointNet), 'classic' (original 1024-d PointNet),
    'pointnet2' (segmentation only). Windowed classifiers size their window
    mix to ``cfg.data.max_windows``. Weights are drawn from ``generator``."""
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; expected one of {TASKS}")
    mcfg, nf = cfg.model, cfg.data.num_features
    if arch in WINDOWED:
        mcfg = dataclasses.replace(mcfg, context=arch)
        if task == "segmentation":
            return AMPNetSegmenter(mcfg, num_features=nf, generator=generator)
        return AMPNetClassifier(mcfg, num_out=num_cls_out, num_windows=cfg.data.max_windows,
                                num_features=nf, generator=generator)
    if arch == "pointnet2":
        if task != "segmentation":
            raise ValueError("pointnet2 supports segmentation only")
        return PointNet2Segmenter(mcfg.num_classes, num_features=nf, generator=generator)
    variant = "light" if arch == "baseline" else "classic"
    point_dim = 2 if variant == "light" else 3
    if task == "segmentation":
        return SingleWindowSegmenter(mcfg.num_classes, variant, point_dim, nf, generator)
    return SingleWindowClassifier(num_cls_out, variant, point_dim, nf, generator)
