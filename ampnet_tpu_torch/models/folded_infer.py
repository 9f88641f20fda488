"""Folded inference encoder and attention head with a selectable compute
dtype, counterpart of ``ampnet_tpu/models/folded_infer.py``.

Inference BatchNorm is an affine map of its running statistics, so every
Conv+BN(+ReLU) block of the AMP window encoder folds into its dense kernel:
y = relu(x @ W' + b'). With ``dtype=torch.bfloat16`` the per-point chains
(T-Net trunks, mlp_a, mlp_b, the head) run in bf16, while the small
precision-sensitive pieces (T-Net FC heads and the [D, D] transforms, the
window-token attention) stay fp32.

The functions read the weights from the port's modules (``AMPNetSegmenter``
or a bare ``WindowEncoder``) and fold them on every call, so a module whose
weights change is never served stale folded copies; the heads also take
folded parameters computed once (``tnet_fc_params``, ``head_params``), as
the ``fused`` and ``int8`` forwards of ``make_forward`` pass them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ampnet_tpu_torch.models.attention import mha_forward
from ampnet_tpu_torch.models.layers import SharedMLP, TNet
from ampnet_tpu_torch.ops.fused_mlp import fold_bn


def _fold(dense, bn):
    """(W' [Cin, Cout], b') of one Linear + MaskedBatchNorm pair."""
    return fold_bn(dense.weight.t(), bn.scale, bn.bias, bn.mean, bn.var,
                   eps=bn.eps, dense_bias=dense.bias)


def folded_chain_params(mlp: SharedMLP):
    """(W', b') per block of a SharedMLP, with BN folded (fp32)."""
    ws, bs = [], []
    for blk in mlp.blocks():
        w, b = _fold(blk.dense, blk.bn)
        ws.append(w)
        bs.append(b)
    return ws, bs


def _chain(h: torch.Tensor, ws, bs, dtype) -> torch.Tensor:
    """relu(h @ W' + b') chain in ``dtype``."""
    h = h.to(dtype)
    for w, b in zip(ws, bs):
        h = torch.relu(h @ w.to(dtype) + b.to(dtype))
    return h


def tnet_fc_params(tnet: TNet):
    """(W', b') per FC layer of a T-Net head, with BN folded (fp32)."""
    return [_fold(getattr(tnet, f"fc_{i}"), getattr(tnet, f"fc_bn_{i}"))
            for i in range(tnet.n_fc)]


def tnet_head_folded(tnet: TNet, g: torch.Tensor, fc=None) -> torch.Tensor:
    """T-Net FC head over pooled trunk features (fp32), BN folded →
    [M, D, D] transforms. ``fc``: ``tnet_fc_params(tnet)``, folded here when
    not given."""
    g = g.float()
    for w, b in fc or tnet_fc_params(tnet):
        g = torch.relu(g @ w + b)
    out = g @ tnet.fc_out.weight.t() + tnet.fc_out.bias
    d = tnet.output_dim
    return out.reshape(-1, d, d) + torch.eye(d, dtype=out.dtype, device=out.device)


def _tnet_apply(tnet: TNet, x: torch.Tensor, dtype) -> torch.Tensor:
    ws, bs = folded_chain_params(tnet.trunk)
    return tnet_head_folded(tnet, _chain(x, ws, bs, dtype).amax(dim=-2))


def encoder_of(model):
    """The WindowEncoder of a full segmenter, or the encoder itself."""
    return model.encoder if hasattr(model, "encoder") else model


def encode_windows_folded(model, points: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """Inference-mode (local, global, t_feat) of the AMP encoder, BN folded.

    Mirrors ``WindowEncoder.forward`` including the transformed-coords ‖
    full-input concat (pointnetAtt.py:66,86). ``points``: [B, W, N, F] or
    [M, N, F]."""
    dtype = dtype or torch.float32
    enc = encoder_of(model)
    squeeze = points.dim() == 4
    if squeeze:
        b, w, n, f = points.shape
        x = points.reshape(b * w, n, f)
    else:
        x = points
    x = x.float()

    coords = x[..., : enc.cfg.point_dim]
    t_in = _tnet_apply(enc.input_tnet, coords, dtype)
    h = torch.cat([coords @ t_in, x], dim=-1)
    a_w, a_b = folded_chain_params(enc.mlp_a)
    h = _chain(h, a_w, a_b, dtype)  # [M, N, 64] in dtype
    t_feat = _tnet_apply(enc.feature_tnet, h, dtype)
    local = h @ t_feat.to(dtype)
    b_w, b_b = folded_chain_params(enc.mlp_b)
    glob = _chain(local, b_w, b_b, dtype).amax(dim=-2)

    if squeeze:
        local = local.reshape(b, w, n, -1)
        glob = glob.reshape(b, w, -1)
        t_feat = t_feat.reshape(b, w, *t_feat.shape[1:])
    return local, glob, t_feat


def head_params(model):
    """(W', b') of the segmentation head's two Dense + BN layers, BN folded."""
    head = model.head
    return [_fold(head.dense_1, head.bn_1), _fold(head.dense_2, head.bn_2)]


def attention_head_folded(
    model,
    local: torch.Tensor,  # [B, W, N, L]
    glob: torch.Tensor,  # [B, W, E]
    centroids: Optional[torch.Tensor],
    pad_mask: Optional[torch.Tensor],
    num_heads: int = 8,
    dtype: Optional[torch.dtype] = None,
    head=None,
) -> torch.Tensor:
    """AttentionContext + SegmentationHead (eval), BN folded, fp32 logits out.
    The window-token attention runs fp32; the per-point head in ``dtype``.
    ``head``: ``head_params(model)``, folded here when not given."""
    dtype = dtype or torch.float32
    ctx_m = model.context
    tokens = glob.float()
    if centroids is not None:
        pe = ctx_m.pos_enc
        h = F.leaky_relu(centroids @ pe.fc1.weight.t() + pe.fc1.bias, negative_slope=0.01)
        tokens = tokens + (h @ pe.fc2.weight.t() + pe.fc2.bias)
    mha = ctx_m.mha
    ctx, _ = mha_forward(tokens, pad_mask, num_heads,
                         mha.in_proj.weight.t(), mha.in_proj.bias,
                         mha.out_proj.weight.t(), mha.out_proj.bias)

    E = ctx.shape[-1]
    h = torch.cat([local.to(dtype),
                   ctx[:, :, None, :].expand(*local.shape[:3], E).to(dtype)], dim=-1)
    for w, b in head or head_params(model):
        h = torch.relu(h @ w.to(dtype) + b.to(dtype))
    out = h @ model.head.dense_out.weight.t().to(dtype) + model.head.dense_out.bias.to(dtype)
    return out.float()
