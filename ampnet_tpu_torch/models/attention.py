"""Masked multi-head self-attention over window-global tokens, counterpart of
``ampnet_tpu/models/attention.py``.

Written out in plain torch — no ``nn.MultiheadAttention``, no SDPA: the
sequence is the ≤ 25 window tokens of one cloud, and torch's module gives NaN
for a fully padded key row where this one (like the JAX module) pads with
``finfo(float32).min`` and gets uniform weights. Joint ``in_proj`` with bias
(columns split q/k/v), scaled dot product, key-padding mask (True = ignore),
out-projection with bias; returns the weights averaged over heads. In
training, dropout (``attn_drop``) acts on the softmax weights before the value
product, and the averaged weights returned are the post-dropout ones, as in
the JAX module. Under a bfloat16 compute dtype the projections run in
bfloat16, the scores and the softmax in float32 (the JAX einsum's
``preferred_element_type``), and the weights go back to bfloat16 for the
value product.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ampnet_tpu_torch.models.layers import at_least_float32, dropout, make_linear


class WindowMHA(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, generator: torch.Generator,
                 drop_rate: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by {num_heads} heads")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.drop_rate = drop_rate
        self.in_proj = make_linear(embed_dim, 3 * embed_dim, True, generator)
        self.out_proj = make_linear(embed_dim, embed_dim, True, generator)

    def forward(
        self,
        tokens: torch.Tensor,  # [B, W, E]
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, W] True = pad/ignore
        generator: Optional[torch.Generator] = None,  # dropout masks in training
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        rate = self.drop_rate if self.training else 0.0
        params = (self.in_proj.weight.t(), self.in_proj.bias,
                  self.out_proj.weight.t(), self.out_proj.bias)
        dt = self.in_proj.compute_dtype
        if dt is not None:
            tokens, params = tokens.to(dt), tuple(p.to(dt) for p in params)
        return mha_forward(tokens, key_padding_mask, self.num_heads, *params,
                           drop_rate=rate, generator=generator)


def mha_forward(tokens, key_padding_mask, num_heads, w_in, b_in, w_out, b_out,
                drop_rate: float = 0.0, generator: Optional[torch.Generator] = None):
    """The attention arithmetic on kernels in ``[Cin, Cout]`` layout; shared by
    the module and the folded backends. Returns (out [B, W, E], weights
    averaged over heads [B, W, W]); ``drop_rate`` > 0 applies dropout to the
    softmax weights with masks from ``generator``."""
    B, W, E = tokens.shape
    H = num_heads
    D = E // H
    q, k, v = (tokens @ w_in + b_in).split(E, dim=-1)

    def heads(t):
        return t.reshape(B, W, H, D).transpose(1, 2)  # [B, H, W, D]

    q, k, v = heads(q), heads(k), heads(v)
    scores = (at_least_float32(q) @ at_least_float32(k).transpose(-1, -2)) / math.sqrt(D)
    if key_padding_mask is not None:
        neg = torch.finfo(torch.float32).min
        scores = scores.masked_fill(key_padding_mask[:, None, None, :], neg)
    weights = dropout(torch.softmax(scores, dim=-1), drop_rate, generator)
    out = (weights.to(v.dtype) @ v).transpose(1, 2).reshape(B, W, E)
    return out @ w_out + b_out, weights.mean(dim=1)
