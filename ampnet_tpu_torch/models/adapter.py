"""Adapters giving the single-window baseline models the AMP call signature
``(points, centroids, window_pad_mask, point_mask, generator)``, so the train
steps and inference take every family alike. Counterparts of
``ampnet_tpu/models/adapter.py``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ampnet_tpu_torch.models.pointnet import ClassificationPointNet, SegmentationPointNet


class SingleWindowSegmenter(nn.Module):
    """A whole-cloud ``SegmentationPointNet`` as a ``[B, W, N, F]`` model:
    windows fold into the batch, with no cross-window context (the point of
    the baseline, baseline/train_segmentation.py)."""

    def __init__(self, num_classes: int = 5, variant: str = "light", point_dim: int = 2,
                 num_features: int = 9, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = SegmentationPointNet(num_classes, variant, point_dim, num_features, generator)

    def forward(self, points, centroids=None, window_pad_mask=None, point_mask=None,
                generator: Optional[torch.Generator] = None):
        if points.dim() != 4:
            logits, t_feat = self.net(points, point_mask)
            return logits, t_feat, None
        b, w, n, f = points.shape
        pmask = point_mask.reshape(b * w, n) if point_mask is not None else None
        logits, t_feat = self.net(points.reshape(b * w, n, f), pmask)
        return logits.reshape(b, w, n, -1), t_feat.reshape(b, w, *t_feat.shape[1:]), None


class SingleWindowClassifier(nn.Module):
    """A ``ClassificationPointNet``; multi-window inputs are classified from
    their first (only real) window."""

    def __init__(self, num_classes: int = 2, variant: str = "light", point_dim: int = 2,
                 num_features: int = 9, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = ClassificationPointNet(num_classes, variant, point_dim,
                                          num_features=num_features, generator=generator)

    def forward(self, points, centroids=None, window_pad_mask=None, point_mask=None,
                generator: Optional[torch.Generator] = None):
        if points.dim() == 4:
            points = points[:, 0]
            point_mask = point_mask[:, 0] if point_mask is not None else None
        logp, t_feat = self.net(points, point_mask, generator=generator)
        return logp, t_feat, None
