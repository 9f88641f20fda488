"""Fused inference path for the AMP window encoder, counterpart of
``ampnet_tpu/models/fused_infer.py``.

Every Conv+BN+ReLU chain of the encoder runs as one ``fused_mlp_chain``
launch with BatchNorm folded in — four per forward: the input T-Net trunk
(3→64→128→256, pool only), mlp_a (12→64→64, activations), the feature T-Net
trunk (64→64→128→256, pool only) and mlp_b (64→64→128→128→256, pool only).
The T-Net trunks and mlp_b write only their pooled vectors. The tiny FC heads
and the [N,64]×[64,64] feature transform stay plain torch.

``prepare_encoder_chains`` folds and prepares the four chains (and the
T-Net FC heads) once; ``make_forward`` calls it once per forward it builds.

On CUDA tensors the chains run the hand-written kernel; on CPU tensors its
plain version (the tests' path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ampnet_tpu_torch.models.folded_infer import (
    encoder_of,
    folded_chain_params,
    tnet_fc_params,
    tnet_head_folded,
)
from ampnet_tpu_torch.ops.fused_mlp import PreparedChain, fused_mlp_chain, prepare_chain


@dataclass(frozen=True)
class FoldedTNet:
    """A T-Net's trunk prepared for ``fused_mlp_chain`` and its FC head
    folded (``tnet_fc_params``)."""

    trunk: PreparedChain
    fc: tuple


def fold_tnet(tnet) -> FoldedTNet:
    with torch.no_grad():
        return FoldedTNet(prepare_chain(*folded_chain_params(tnet.trunk)),
                          tuple(tnet_fc_params(tnet)))


def prepare_encoder_chains(model) -> dict:
    """The encoder's four chains, BatchNorm folded from the running
    statistics and laid out for the kernel: ``input_tnet`` and
    ``feature_tnet`` as ``FoldedTNet``, ``mlp_a`` and ``mlp_b`` as
    ``PreparedChain``. An eval-mode model gives the same numbers every time,
    so a caller computes them once."""
    enc = encoder_of(model)
    with torch.no_grad():
        return {
            "input_tnet": fold_tnet(enc.input_tnet),
            "mlp_a": prepare_chain(*folded_chain_params(enc.mlp_a)),
            "feature_tnet": fold_tnet(enc.feature_tnet),
            "mlp_b": prepare_chain(*folded_chain_params(enc.mlp_b)),
        }


def tnet_apply(tnet, x: torch.Tensor, folded: FoldedTNet) -> torch.Tensor:
    """T-Net: fused trunk (pool only) + plain FC head → [M, D, D]."""
    g = fused_mlp_chain(x, folded.trunk, pool=True, return_acts=False)  # [M, bottleneck]
    return tnet_head_folded(tnet, g, folded.fc)


def encode_windows_fused(model, points: torch.Tensor, chains: Optional[dict] = None):
    """Inference-mode (local_feats, global_feats, t_feat) of the AMP encoder
    through the fused chains. ``points``: [B, W, N, F] or [M, N, F], fp32;
    ``chains``: ``prepare_encoder_chains(model)``, computed here when not
    given."""
    enc = encoder_of(model)
    chains = chains or prepare_encoder_chains(model)
    squeeze = points.dim() == 4
    if squeeze:
        b, w, n, f = points.shape
        x = points.reshape(b * w, n, f)
    else:
        x = points

    coords = x[..., : enc.cfg.point_dim].contiguous()
    t_in = tnet_apply(enc.input_tnet, coords, chains["input_tnet"])
    h = torch.cat([coords @ t_in, x], dim=-1)

    h = fused_mlp_chain(h, chains["mlp_a"])  # [M, N, 64]
    t_feat = tnet_apply(enc.feature_tnet, h, chains["feature_tnet"])
    local = h @ t_feat

    glob = fused_mlp_chain(local, chains["mlp_b"], pool=True, return_acts=False)

    if squeeze:
        local = local.reshape(b, w, n, -1)
        glob = glob.reshape(b, w, -1)
        t_feat = t_feat.reshape(b, w, *t_feat.shape[1:])
    return local, glob, t_feat
