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
GRU context (pointnetAtt.py:212-233): a unidirectional GRU over the window
sequence, hidden ``gru_hidden``; the head then takes a 64-d context and its
middle width is 128. Classification (pointnetAtt.py:115-151, 261-279): the
same encoder and context (attention without positional encoding), then a
learned weighted sum over the windows (``mix_kernel [W, 1]``) and an FC head.

Training: ``model.train()`` selects batch BatchNorm statistics and dropout
(``attn_drop`` on the attention weights, ``drop_1``/``drop_2`` after the head's
ReLUs), ``model.eval()`` running statistics and no dropout, as Flax's
``train`` flag does. Dropout masks come from the ``generator`` the caller
passes to ``forward``; the global RNG is never used.

Not ported yet, and refused at construction: ``local_agg='edge'`` and
``att_geom_tokens`` (ROADMAP.md Queue 1, item 4b).
"""

from __future__ import annotations

import math
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
    default_generator,
    dropout,
    make_linear,
    masked_max_pool,
)

GEOMETRY_TODO = "ROADMAP.md Queue 1, item 4b (geometry and distillation)"


class WindowEncoder(nn.Module):
    """Shared PointNet window encoder over ``[B, W, N, F]`` (or ``[B, N, F]``).

    Returns per-point local features ``[B, W, N, 64]``, per-window global
    features ``[B, W, G]`` and the 64×64 feature transforms ``[B, W, 64, 64]``."""

    def __init__(self, cfg: ModelConfig, num_features: int = 9,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.local_agg != "none":
            raise NotImplementedError(
                f"local_agg={cfg.local_agg!r} is not ported yet: {GEOMETRY_TODO}")
        g = default_generator(generator)
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
    """Cross-window context via centroid pos-enc + masked MHA; without
    ``use_pos_enc`` (the classifier) there is no ``pos_enc`` at all, as in the
    Flax tree."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, use_pos_enc: bool = True):
        super().__init__()
        if use_pos_enc:
            self.pos_enc = CentroidPositionalEncoding(cfg.global_feat, generator)
        self.mha = WindowMHA(cfg.global_feat, cfg.att_heads, generator, drop_rate=cfg.dropout)

    def forward(self, global_feats, centroids, window_pad_mask, generator=None):
        tokens = global_feats
        if centroids is not None and hasattr(self, "pos_enc"):
            tokens = tokens + self.pos_enc(centroids)
        return self.mha(tokens, key_padding_mask=window_pad_mask, generator=generator)


class GRUCell(nn.Module):
    """Flax ``GRUCell``'s parameters and arithmetic: input dense layers ``ir``,
    ``iz``, ``in`` (biased), hidden ``hr``, ``hz`` (no bias) and ``hn``
    (biased); ``r = σ(ir x + hr h)``, ``z = σ(iz x + hz h)``,
    ``n = tanh(in x + r·hn h)``, ``h' = (1 − z)·n + z·h``. Input kernels are
    lecun-normal, hidden kernels orthogonal, biases zero (Flax's inits)."""

    def __init__(self, cin: int, hidden: int, generator: torch.Generator):
        super().__init__()
        for gate in ("ir", "iz", "in"):
            self.add_module(gate, make_linear(cin, hidden, True, generator))
        for gate in ("hr", "hz", "hn"):
            lin = make_linear(hidden, hidden, gate == "hn", generator)
            with torch.no_grad():
                nn.init.orthogonal_(lin.weight, generator=generator)
            self.add_module(gate, lin)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """``xs [B, W, E]`` → the hidden state after every window ``[B, W, H]``,
        from a zero carry, over every window (padded ones included), as the
        JAX scan runs."""
        ir, iz, in_, hr, hz, hn = (getattr(self, k) for k in ("ir", "iz", "in", "hr", "hz", "hn"))
        xr, xz, xn = ir(xs), iz(xs), in_(xs)  # the input side, every window at once
        h = xs.new_zeros(xs.shape[0], hr.out_features)
        out = []
        for t in range(xs.shape[1]):
            r = torch.sigmoid(xr[:, t] + hr(h))
            z = torch.sigmoid(xz[:, t] + hz(h))
            n = torch.tanh(xn[:, t] + r * hn(h))
            h = (1.0 - z) * n + z * h
            out.append(h)
        return torch.stack(out, dim=1)


class GRUContext(nn.Module):
    """Sequential cross-window context (SegmentationWithGRU,
    pointnetAtt.py:212-233): a unidirectional GRU over the window sequence,
    hidden size ``gru_hidden``, written out in torch ops (W ≤ 25). It takes
    ``AttentionContext``'s arguments and returns (``[B, W, H]``, None)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.gru = GRUCell(cfg.global_feat, cfg.gru_hidden, generator)

    def forward(self, global_feats, centroids=None, window_pad_mask=None, generator=None):
        return self.gru(global_feats), None


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
        self.drop_rate = cfg.dropout

    def forward(self, local_feats, context, point_mask=None, generator=None):
        B, W, N, _ = local_feats.shape
        ctx = context[:, :, None, :].expand(B, W, N, context.shape[-1])
        h = torch.cat([local_feats, ctx], dim=-1)
        rate = self.drop_rate if self.training else 0.0
        h = dropout(torch.relu(self.bn_1(self.dense_1(h), point_mask)), rate, generator)
        h = dropout(torch.relu(self.bn_2(self.dense_2(h), point_mask)), rate, generator)
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
    zero biases, identity BN, zero ``fc_out``), from ``generator``; every
    BatchNorm takes ``cfg.bn_momentum``."""

    def __init__(self, cfg: ModelConfig, num_features: int = 9,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.cfg = cfg
        self.encoder = WindowEncoder(cfg, num_features, g)
        self.context, ctx_dim = _make_context(cfg, g, use_pos_enc=True)
        self.head = SegmentationHead(cfg, ctx_dim, g)
        _set_bn_momentum(self, cfg.bn_momentum)

    def forward(self, points, centroids=None, window_pad_mask=None, point_mask=None,
                generator: Optional[torch.Generator] = None):
        local_feats, global_feats, t_feat = self.encoder(points, point_mask)
        ctx, attn_weights = _run_context(self.context, global_feats, centroids,
                                         window_pad_mask, generator)
        logits = self.head(local_feats, ctx, point_mask, generator=generator)
        return logits, t_feat, attn_weights


def _make_context(cfg: ModelConfig, g: torch.Generator, use_pos_enc: bool):
    """(context module or None, context width) for ``cfg.context``."""
    if cfg.att_geom_tokens:
        raise NotImplementedError(f"att_geom_tokens is not ported yet: {GEOMETRY_TODO}")
    if cfg.context == "attention":
        return AttentionContext(cfg, g, use_pos_enc), cfg.global_feat
    if cfg.context == "gru":
        return GRUContext(cfg, g), cfg.gru_hidden
    if cfg.context == "none":
        return None, cfg.global_feat
    raise ValueError(f"unknown context {cfg.context!r}")


def _run_context(context, global_feats, centroids, window_pad_mask, generator):
    """(per-window context, attention weights or None); no context module
    passes the global features on."""
    if context is None:
        return global_feats, None
    return context(global_feats, centroids, window_pad_mask, generator=generator)


def _set_bn_momentum(model: nn.Module, momentum: float) -> None:
    for mod in model.modules():
        if isinstance(mod, MaskedBatchNorm):
            mod.momentum = momentum


class ClassificationHead(nn.Module):
    """Window-mixing conv + FC head (ClassificationWithAttention,
    pointnetAtt.py:127-149): Conv1d(num_w → 1) over the window axis — a learned
    weighted sum, ``mix_kernel [W, 1]`` and ``mix_bias [1]``, so the window
    count is part of the checkpoint — then ReLU, ``fc_2`` → 128, ``bn_2`` (always
    batch statistics over ``[B, 128]``), ReLU, ``fc_3`` → ``num_out``."""

    def __init__(self, in_dim: int, num_windows: int, num_out: int, generator: torch.Generator):
        super().__init__()
        self.mix_kernel = nn.Parameter(torch.randn(num_windows, 1, generator=generator)
                                       / math.sqrt(num_windows))
        self.mix_bias = nn.Parameter(torch.zeros(1))
        self.fc_2 = make_linear(in_dim, 128, True, generator)
        self.bn_2 = MaskedBatchNorm(128)
        self.fc_3 = make_linear(128, num_out, True, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:  # [B, W, E] → [B, num_out]
        h = torch.einsum("bwe,wo->be", tokens, self.mix_kernel.to(tokens.dtype))
        h = torch.relu(h + self.mix_bias.to(tokens.dtype))
        h = torch.relu(self.bn_2(self.fc_2(h)))
        return self.fc_3(h)


class AMPNetClassifier(nn.Module):
    """Binary (or k-way) cloud classification from the window tokens
    (ClassificationWithAttention / ClassificationFromGRU,
    pointnetAtt.py:115-151, 261-279): the window encoder, the context
    (attention WITHOUT positional encoding, as the reference comments it out,
    pointnetAtt.py:120-121, 134-137; or the GRU), then ``ClassificationHead``
    over all ``num_windows`` windows. Returns ``(logits [B, num_out],
    feature_transforms, attn_weights)``."""

    def __init__(self, cfg: ModelConfig, num_out: int = 2, num_windows: int = 9,
                 num_features: int = 9, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.cfg = cfg
        self.encoder = WindowEncoder(cfg, num_features, g)
        self.context, ctx_dim = _make_context(cfg, g, use_pos_enc=False)
        self.head = ClassificationHead(ctx_dim, num_windows, num_out, g)
        _set_bn_momentum(self, cfg.bn_momentum)

    def forward(self, points, centroids=None, window_pad_mask=None, point_mask=None,
                generator: Optional[torch.Generator] = None):
        _, global_feats, t_feat = self.encoder(points, point_mask)
        ctx, attn_weights = _run_context(self.context, global_feats, None, window_pad_mask,
                                         generator)
        return self.head(ctx), t_feat, attn_weights
