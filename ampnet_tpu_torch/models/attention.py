"""Masked multi-head self-attention over window-global tokens, counterpart of
``ampnet_tpu/models/attention.py``.

Written out in plain torch — no ``nn.MultiheadAttention``, no SDPA: the
sequence is the ≤ 25 window tokens of one cloud, and torch's module gives NaN
for a fully padded key row where this one (like the JAX module) pads with
``finfo(float32).min`` and gets uniform weights. Joint ``in_proj`` with bias
(columns split q/k/v), scaled dot product, key-padding mask (True = ignore),
out-projection with bias; returns the weights averaged over heads.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ampnet_tpu_torch.models.layers import make_linear


class WindowMHA(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, generator: torch.Generator):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by {num_heads} heads")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj = make_linear(embed_dim, 3 * embed_dim, True, generator)
        self.out_proj = make_linear(embed_dim, embed_dim, True, generator)

    def forward(
        self,
        tokens: torch.Tensor,  # [B, W, E]
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, W] True = pad/ignore
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return mha_forward(
            tokens, key_padding_mask, self.num_heads,
            self.in_proj.weight.t(), self.in_proj.bias,
            self.out_proj.weight.t(), self.out_proj.bias,
        )


def mha_forward(tokens, key_padding_mask, num_heads, w_in, b_in, w_out, b_out):
    """The attention arithmetic on kernels in ``[Cin, Cout]`` layout; shared by
    the module and the folded backends. Returns (out [B, W, E], weights
    averaged over heads [B, W, W])."""
    B, W, E = tokens.shape
    H = num_heads
    D = E // H
    q, k, v = (tokens @ w_in + b_in).split(E, dim=-1)

    def heads(t):
        return t.reshape(B, W, H, D).transpose(1, 2)  # [B, H, W, D]

    q, k, v = heads(q), heads(k), heads(v)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    if key_padding_mask is not None:
        neg = torch.finfo(torch.float32).min
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], neg)
    weights = torch.softmax(scores, dim=-1)
    out = (weights @ v).transpose(1, 2).reshape(B, W, E)
    return out @ w_out + b_out, weights.mean(dim=1)
