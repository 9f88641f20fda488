"""Shared model building blocks (PyTorch), counterparts of
``ampnet_tpu/models/layers.py``.

* The reference's ``nn.Conv1d(cin, cout, 1)`` layers are pointwise: here they
  are ``nn.Linear`` over ``[..., N, Cin]``, the JAX package's layout. No
  Conv1d: that would route float32 through cuDNN, in TF32 by default.
* Parameter and buffer names follow the Flax tree (``dense``/``bn``,
  ``scale``/``bias``/``mean``/``var``), so ``core/weights.py`` maps a Flax
  variable tree onto the modules path for path.
* ``MaskedBatchNorm`` follows ``model.train()`` / ``model.eval()`` as the
  Flax module follows ``use_running_average=not train``: batch statistics
  (updating the running ones) in training, running statistics in eval, and
  per-window statistics in both under ``norm_mode='window'``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or one seeded 0: a model's init draws from it."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default Dense init (variance 1/fan_in), for an ``nn.Linear``
    weight ``[Cout, Cin]``, drawn from an explicit generator."""
    with torch.no_grad():
        w = torch.randn(weight.shape, generator=generator) / math.sqrt(weight.shape[1])
        weight.copy_(w)


def make_linear(cin: int, cout: int, bias: bool, generator: torch.Generator,
                zero: bool = False) -> nn.Linear:
    lin = nn.Linear(cin, cout, bias=bias)
    with torch.no_grad():
        if zero:
            lin.weight.zero_()
        else:
            lecun_normal_(lin.weight, generator)
        if bias:
            lin.bias.zero_()
    return lin


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is when float64: statistics and losses are
    taken in float32 as in the JAX package, and a float64 model (the card
    against the CPU in ``chip_smoke.py``) keeps its precision."""
    return x if x.dtype == torch.float64 else x.float()


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout`` in training: keep each entry with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``, drawing the mask from
    ``generator`` (never the global RNG)."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the trailing feature axis with an optional validity mask.

    In training (``norm_mode='batch'``) it normalizes with batch statistics
    over every non-feature axis, only over ``mask``-true positions when a mask
    is given (denominator clamped to ≥ 1), with the *biased* variance
    E[x²] − E[x]², and updates the running statistics as
    ``ra = momentum·ra + (1 − momentum)·batch`` (Flax's sense of momentum: 0.9
    here is torch's 0.1). ``nn.BatchNorm1d`` is not used: its running variance
    is unbiased. In eval it normalizes with the running statistics.
    ``norm_mode='window'`` uses per-sample statistics over the point axis in
    both modes and keeps no running statistics, as the JAX module does."""

    def __init__(self, features: int, eps: float = 1e-5, norm_mode: str = "batch",
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.norm_mode = norm_mode
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm_mode == "window" and x.dim() >= 2:
            xf = at_least_float32(x)
            if mask is None:
                mean = xf.mean(dim=-2, keepdim=True)
                var = xf.square().mean(dim=-2, keepdim=True) - mean.square()
            else:
                mw = mask.float()[..., None]
                denom = mw.sum(dim=-2, keepdim=True).clamp_min(1.0)
                mean = (xf * mw).sum(dim=-2, keepdim=True) / denom
                var = (xf.square() * mw).sum(dim=-2, keepdim=True) / denom - mean.square()
        elif self.training:
            xf = at_least_float32(x)
            dims = tuple(range(x.dim() - 1))
            if mask is None:
                mean = xf.mean(dim=dims)
                var = xf.square().mean(dim=dims) - mean.square()
            else:
                m = mask.float()[..., None]
                denom = m.sum(dim=dims).clamp_min(1.0)
                mean = (xf * m).sum(dim=dims) / denom
                var = (xf.square() * m).sum(dim=dims) / denom - mean.square()
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean.to(x.dtype)) * torch.rsqrt(var + self.eps).to(x.dtype)
        return y * self.scale.to(x.dtype) + self.bias.to(x.dtype)


class PointMLP(nn.Module):
    """One pointwise dense → BN → ReLU block (the reference's Conv1d(k=1)+BN+ReLU)."""

    def __init__(self, cin: int, features: int, generator: torch.Generator,
                 use_bias: bool = False, relu: bool = True, norm_mode: str = "batch"):
        super().__init__()
        self.dense = make_linear(cin, features, use_bias, generator)
        self.bn = MaskedBatchNorm(features, norm_mode=norm_mode)
        self.relu = relu

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.bn(self.dense(x), mask)
        return torch.relu(x) if self.relu else x


class SharedMLP(nn.Module):
    """A chain of PointMLP blocks (``mlp_0``, ``mlp_1``, ...) — the per-point trunk."""

    def __init__(self, cin: int, features: Sequence[int], generator: torch.Generator,
                 use_bias: bool = False, norm_mode: str = "batch"):
        super().__init__()
        self.names = []
        for i, f in enumerate(features):
            self.add_module(f"mlp_{i}", PointMLP(cin, f, generator, use_bias=use_bias,
                                                 norm_mode=norm_mode))
            self.names.append(f"mlp_{i}")
            cin = f

    def blocks(self):
        return [getattr(self, n) for n in self.names]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for blk in self.blocks():
            x = blk(x, mask)
        return x


def masked_max_pool(x: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -2) -> torch.Tensor:
    """Max over the point axis, ignoring padded points. Total: a fully masked
    window pools to 0, not −inf (``ampnet_tpu/models/layers.py:142-156``)."""
    if mask is not None:
        neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
        out = torch.where(mask[..., None], x, neg).amax(dim=dim)
        any_real = mask.any(dim=-1)
        return torch.where(any_real[..., None], out, torch.zeros_like(out))
    return x.amax(dim=dim)


class TNet(nn.Module):
    """Spatial/feature transformer predicting a [D, D] matrix (+ identity);
    the AMP-Net variant (pointnetAtt.py:7-47): bias-free trunk D→64→128→256,
    max-pool, FC 256→256→128 with BN, zero-init ``fc_out`` with bias."""

    def __init__(self, cin: int, output_dim: int, generator: torch.Generator,
                 bottleneck: int = 256, conv_features=(64, 128), fc_features=(256, 128),
                 use_bias: bool = False, norm_mode: str = "batch"):
        super().__init__()
        self.output_dim = output_dim
        self.trunk = SharedMLP(cin, tuple(conv_features) + (bottleneck,), generator,
                               use_bias=use_bias, norm_mode=norm_mode)
        self.n_fc = len(fc_features)
        c = bottleneck
        for i, f in enumerate(fc_features):
            self.add_module(f"fc_{i}", make_linear(c, f, use_bias, generator))
            # the FC head acts on [M, C]: always batch-mode statistics
            self.add_module(f"fc_bn_{i}", MaskedBatchNorm(f))
            c = f
        self.fc_out = make_linear(c, output_dim * output_dim, True, generator, zero=True)

    def head(self, g: torch.Tensor) -> torch.Tensor:
        """FC head over pooled trunk features [..., bottleneck] → [..., D, D]."""
        for i in range(self.n_fc):
            g = torch.relu(getattr(self, f"fc_bn_{i}")(getattr(self, f"fc_{i}")(g)))
        m = self.fc_out(g)
        m = m.reshape(*m.shape[:-1], self.output_dim, self.output_dim)
        return m + torch.eye(self.output_dim, dtype=m.dtype, device=m.device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.head(masked_max_pool(self.trunk(x, mask), mask))
