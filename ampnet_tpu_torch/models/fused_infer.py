"""Fused inference path for the AMP window encoder, counterpart of
``ampnet_tpu/models/fused_infer.py``.

Every Conv+BN+ReLU chain of the encoder runs as one ``fused_mlp_chain``
launch with BatchNorm folded in — four per forward: the input T-Net trunk
(3→64→128→256, pool only), mlp_a (12→64→64, activations), the feature T-Net
trunk (64→64→128→256, pool only) and mlp_b (64→64→128→128→256, pool only).
The T-Net trunks and mlp_b write only their pooled vectors. The tiny FC heads
and the [N,64]×[64,64] feature transform stay plain torch.

On CUDA tensors the chains run the hand-written kernel; on CPU tensors its
plain version (the tests' path).
"""

from __future__ import annotations

import torch

from ampnet_tpu_torch.models.folded_infer import (
    encoder_of,
    folded_chain_params,
    tnet_head_folded,
)
from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain


def _tnet_apply(tnet, x: torch.Tensor) -> torch.Tensor:
    """T-Net: fused trunk (pool only) + plain FC head → [M, D, D]."""
    ws, bs = folded_chain_params(tnet.trunk)
    g = fused_mlp_chain(x, ws, bs, pool=True, return_acts=False)  # [M, bottleneck]
    return tnet_head_folded(tnet, g)


def encode_windows_fused(model, points: torch.Tensor):
    """Inference-mode (local_feats, global_feats, t_feat) of the AMP encoder
    through the fused chains. ``points``: [B, W, N, F] or [M, N, F], fp32."""
    enc = encoder_of(model)
    squeeze = points.dim() == 4
    if squeeze:
        b, w, n, f = points.shape
        x = points.reshape(b * w, n, f)
    else:
        x = points

    coords = x[..., : enc.cfg.point_dim].contiguous()
    t_in = _tnet_apply(enc.input_tnet, coords)
    h = torch.cat([coords @ t_in, x], dim=-1)

    a_w, a_b = folded_chain_params(enc.mlp_a)
    h = fused_mlp_chain(h, a_w, a_b)  # [M, N, 64]
    t_feat = _tnet_apply(enc.feature_tnet, h)
    local = h @ t_feat

    b_w, b_b = folded_chain_params(enc.mlp_b)
    glob = fused_mlp_chain(local, b_w, b_b, pool=True, return_acts=False)

    if squeeze:
        local = local.reshape(b, w, n, -1)
        glob = glob.reshape(b, w, -1)
        t_feat = t_feat.reshape(b, w, *t_feat.shape[1:])
    return local, glob, t_feat
