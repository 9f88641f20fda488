"""int8 inference path for the AMP window encoder, counterpart of
``ampnet_tpu/models/quantized_infer.py``.

The same structure as models/fused_infer.py, but the two big chains run
through ``quantized_mlp_chain`` (dynamic per-block activation scales,
per-channel weight scales): mlp_a (12→64→64, activations) and mlp_b
(64→64→128→128→256, pooled only). The T-Net trunks stay on the fp32
``fused_mlp_chain``, and the T-Net FC heads, the transforms, attention and
the segmentation head stay fp32: they are a small share of the work and the
most sensitive to precision.

On CUDA tensors the chains run the hand-written kernels; on CPU tensors
their plain versions (the tests' path).
"""

from __future__ import annotations

from typing import Optional

import torch

from ampnet_tpu_torch.models.folded_infer import encoder_of, folded_chain_params
from ampnet_tpu_torch.models.fused_infer import fold_tnet, tnet_apply
from ampnet_tpu_torch.ops.quantized_mlp import (
    prepare_quantized_chain,
    quantize_chain,
    quantized_mlp_chain,
)


def quantize_encoder_chains(model):
    """(mlp_a, mlp_b) of ``model``'s encoder, each as the weight arguments
    ``quantized_mlp_chain`` takes after x: BatchNorm folded from the running
    statistics, then quantized per output channel; on the card laid out for
    the kernel, ``(PreparedQuantizedChain,)``, on the CPU the plain (int8
    weights, weight scales, fp32 biases). An eval-mode model gives the same
    numbers every time, so a caller may compute them once."""
    enc = encoder_of(model)
    out = []
    with torch.no_grad():
        for mlp in (enc.mlp_a, enc.mlp_b):
            ws, bs = folded_chain_params(mlp)
            wq, w_scale = quantize_chain(ws)
            out.append((prepare_quantized_chain(wq, w_scale, bs),) if wq[0].is_cuda
                       else (wq, w_scale, bs))
    return tuple(out)


def fold_encoder_tnets(model):
    """(input T-Net, feature T-Net) of ``model``'s encoder as ``FoldedTNet``:
    the fp32 trunks prepared for ``fused_mlp_chain``, the FC heads folded."""
    enc = encoder_of(model)
    return fold_tnet(enc.input_tnet), fold_tnet(enc.feature_tnet)


def encode_windows_int8(model, points: torch.Tensor, chains: Optional[tuple] = None,
                        tnets: Optional[tuple] = None):
    """Inference-mode (local_feats, global_feats, t_feat) of the AMP encoder
    with int8 mlp_a and mlp_b. ``points``: [B, W, N, F] or [M, N, F], fp32;
    ``chains``: ``quantize_encoder_chains(model)`` and ``tnets``:
    ``fold_encoder_tnets(model)``, each computed here when not given."""
    enc = encoder_of(model)
    mlp_a, mlp_b = chains or quantize_encoder_chains(model)
    t_in_chain, t_feat_chain = tnets or fold_encoder_tnets(model)
    squeeze = points.dim() == 4
    if squeeze:
        b, w, n, f = points.shape
        x = points.reshape(b * w, n, f)
    else:
        x = points

    coords = x[..., : enc.cfg.point_dim].contiguous()
    # T-Nets stay fp32 (their output multiplies the features)
    t_in = tnet_apply(enc.input_tnet, coords, t_in_chain)
    h = torch.cat([coords @ t_in, x], dim=-1)
    h = quantized_mlp_chain(h, *mlp_a)  # [M, N, 64]

    t_feat = tnet_apply(enc.feature_tnet, h, t_feat_chain)
    local = h @ t_feat
    glob = quantized_mlp_chain(local, *mlp_b, pool=True, return_acts=False)

    if squeeze:
        local = local.reshape(b, w, n, -1)
        glob = glob.reshape(b, w, -1)
        t_feat = t_feat.reshape(b, w, *t_feat.shape[1:])
    return local, glob, t_feat
