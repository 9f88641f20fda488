"""AMP-Net segmenter (inference), counterpart of ``ampnet_tpu/models/amp.py``.

The whole cloud batch lives in one ``[B, W, N, C]`` tensor: the window
encoder runs as a single ``[B*W, N, C]`` pass and the per-point broadcast of
the window context is a view. Module names follow the Flax tree
(``encoder.input_tnet.trunk.mlp_0.dense`` …), which is what
``core/weights.py`` relies on.

Architecture (AMP 'base' encoder, pointnetAtt.py:50-112):
  input [.., N, F] → T-Net over the first ``point_dim`` coords → concat
  (transformed coords ‖ the full F-feature input, so mlp_a takes F+point_dim
  channels) → MLP →64→64 → 64×64 feature T-Net → local 64-d features
  → MLP 64→64→128→128→G → masked max-pool → global G-d feature.
Head with attention (pointnetAtt.py:154-209): centroid pos-enc 2→16→G
(leaky ReLU), masked 8-head MHA over window tokens, per-point
[local ‖ attended-G] → G/2 → 64 → num_classes.

Not ported yet, and refused at construction: the ``gru`` context and the
classification heads (ROADMAP Queue 1, item 4), ``local_agg='edge'`` and
``att_geom_tokens`` (same item). Dropout arrives with the training slice; the
eval forward has none.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ampnet_tpu_torch.core.config import ModelConfig
from ampnet_tpu_torch.models.attention import WindowMHA
from ampnet_tpu_torch.models.layers import (
    MaskedBatchNorm,
    SharedMLP,
    TNet,
    make_linear,
    masked_max_pool,
)

FAMILIES_TODO = "ROADMAP.md Queue 1, item 4 (other families and contexts)"


def _default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class WindowEncoder(nn.Module):
    """Shared PointNet window encoder over ``[B, W, N, F]`` (or ``[B, N, F]``).

    Returns per-point local features ``[B, W, N, 64]``, per-window global
    features ``[B, W, G]`` and the 64×64 feature transforms ``[B, W, 64, 64]``."""

    def __init__(self, cfg: ModelConfig, num_features: int = 9,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.local_agg != "none":
            raise NotImplementedError(
                f"local_agg={cfg.local_agg!r} is not ported yet: {FAMILIES_TODO}")
        g = _default_generator(generator)
        self.cfg = cfg
        mode = cfg.bn_mode
        self.input_tnet = TNet(cfg.point_dim, cfg.point_dim, g, norm_mode=mode)
        self.mlp_a = SharedMLP(num_features + cfg.point_dim, (64, 64), g, norm_mode=mode)
        self.feature_tnet = TNet(64, 64, g, norm_mode=mode)
        self.mlp_b = SharedMLP(64, (64, 128, 128, cfg.global_feat), g, norm_mode=mode)

    def forward(
        self,
        points: torch.Tensor,
        point_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        squeeze_windows = points.dim() == 3
        if squeeze_windows:
            points = points[:, None]
            point_mask = point_mask[:, None] if point_mask is not None else None
        B, W, N, Fdim = points.shape
        x = points.reshape(B * W, N, Fdim)
        mask = point_mask.reshape(B * W, N) if point_mask is not None else None

        coords = x[..., : cfg.point_dim]
        t_in = self.input_tnet(coords, mask)
        coords_t = coords @ t_in
        # AMP quirk kept on purpose: transformed coords ‖ the FULL input
        # (pointnetAtt.py:66,86)
        h = torch.cat([coords_t, x], dim=-1)
        h = self.mlp_a(h, mask)
        t_feat = self.feature_tnet(h, mask)
        local_feats = h @ t_feat  # [B*W, N, 64]
        global_feats = masked_max_pool(self.mlp_b(local_feats, mask), mask)

        local_feats = local_feats.reshape(B, W, N, -1)
        global_feats = global_feats.reshape(B, W, cfg.global_feat)
        t_feat = t_feat.reshape(B, W, 64, 64)
        if squeeze_windows:
            local_feats, global_feats, t_feat = local_feats[:, 0], global_feats[:, 0], t_feat[:, 0]
        return local_feats, global_feats, t_feat


class CentroidPositionalEncoding(nn.Module):
    """MLP 2→16→embed_dim with leaky ReLU (pointnetAtt.py:160-161,183-185)."""

    def __init__(self, embed_dim: int, generator: torch.Generator):
        super().__init__()
        self.fc1 = make_linear(2, 16, True, generator)
        self.fc2 = make_linear(16, embed_dim, True, generator)

    def forward(self, centroids: torch.Tensor) -> torch.Tensor:  # [B, W, 2]
        return self.fc2(F.leaky_relu(self.fc1(centroids), negative_slope=0.01))


class AttentionContext(nn.Module):
    """Cross-window context via centroid pos-enc + masked MHA."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.pos_enc = CentroidPositionalEncoding(cfg.global_feat, generator)
        self.mha = WindowMHA(cfg.global_feat, cfg.att_heads, generator)

    def forward(self, global_feats, centroids, window_pad_mask):
        tokens = global_feats
        if centroids is not None:
            tokens = tokens + self.pos_enc(centroids)
        return self.mha(tokens, key_padding_mask=window_pad_mask)


class SegmentationHead(nn.Module):
    """Per-point head over [local ‖ context] (pointnetAtt.py:167-174,199-207);
    its dense layers carry biases (torch Conv1d default)."""

    def __init__(self, cfg: ModelConfig, ctx_dim: int, generator: torch.Generator):
        super().__init__()
        mid = max(cfg.global_feat // 2, 64) if ctx_dim >= 128 else 128
        self.dense_1 = make_linear(cfg.local_feat + ctx_dim, mid, True, generator)
        self.bn_1 = MaskedBatchNorm(mid, norm_mode=cfg.bn_mode)
        self.dense_2 = make_linear(mid, 64, True, generator)
        self.bn_2 = MaskedBatchNorm(64, norm_mode=cfg.bn_mode)
        self.dense_out = make_linear(64, cfg.num_classes, True, generator)

    def forward(self, local_feats, context, point_mask=None):
        B, W, N, _ = local_feats.shape
        ctx = context[:, :, None, :].expand(B, W, N, context.shape[-1])
        h = torch.cat([local_feats, ctx], dim=-1)
        h = torch.relu(self.bn_1(self.dense_1(h), point_mask))
        h = torch.relu(self.bn_2(self.dense_2(h), point_mask))
        return self.dense_out(h)


class AMPNetSegmenter(nn.Module):
    """Full AMP-Net segmentation model: encoder + context + per-point head.

    Inputs::
        points          [B, W, N, F]   window-tiled feature tensor
        centroids       [B, W, 2]      per-window x/y centroids (pos-enc)
        window_pad_mask [B, W]         True for replicate-padded windows
        point_mask      [B, W, N]      True for real points (None = all real)

    Returns ``(logits [B, W, N, num_classes], feature_transforms, attn_weights)``.
    Weights are initialized as Flax initializes them (lecun-normal kernels,
    zero biases, identity BN, zero ``fc_out``), from ``generator``."""

    def __init__(self, cfg: ModelConfig, num_features: int = 9,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.context not in ("attention", "none"):
            raise NotImplementedError(
                f"context={cfg.context!r} is not ported yet: {FAMILIES_TODO}")
        if cfg.att_geom_tokens:
            raise NotImplementedError(
                f"att_geom_tokens is not ported yet: {FAMILIES_TODO}")
        g = _default_generator(generator)
        self.cfg = cfg
        self.encoder = WindowEncoder(cfg, num_features, g)
        if cfg.context == "attention":
            self.context = AttentionContext(cfg, g)
        self.head = SegmentationHead(cfg, cfg.global_feat, g)

    def forward(self, points, centroids=None, window_pad_mask=None, point_mask=None):
        local_feats, global_feats, t_feat = self.encoder(points, point_mask)
        attn_weights = None
        if self.cfg.context == "attention":
            ctx, attn_weights = self.context(global_feats, centroids, window_pad_mask)
        else:
            ctx = global_feats
        logits = self.head(local_feats, ctx, point_mask)
        return logits, t_feat, attn_weights
