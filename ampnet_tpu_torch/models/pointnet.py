"""Classic and light single-window PointNet variants, counterparts of
``ampnet_tpu/models/pointnet.py``. Both operate on one whole cloud (no window
decomposition):

* **classic** — the original PointNet dims (``pointNet/model/pointnet.py``):
  1024-bottleneck T-Nets with biases and FC layers (512, 256), encoder
  9→64→64→[64×64 T]→64→128→1024, cls head 1024→512→256→k (log-softmax), seg
  head 1088→512→256→128→k. The transformed coordinates REPLACE the originals.
* **light** — the slimmed 256-d variant of the baseline scripts
  (``pointNet/model/light_pointnet_256.py``): bias-free convs/FCs, T-Net on
  x,y only, encoder 9→64→64→[64×64 T]→64→128→256, cls head 256→128→64→k, seg
  head 320→256→128→64→k.

Every BatchNorm here takes the default momentum 0.9 (the JAX modules are
built without ``cfg.bn_momentum``). Module names follow the Flax tree.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ampnet_tpu_torch.models.layers import (
    MaskedBatchNorm,
    SharedMLP,
    TNet,
    default_generator,
    dropout,
    make_linear,
    matmul_promoted,
    masked_max_pool,
)


class _PointNetEncoder(nn.Module):
    """The shared trunk: input T-Net over the first ``point_dim`` coordinates
    (transformed coordinates replace the originals), mlp_a, the 64×64
    feature T-Net, mlp_b, masked max-pool. Returns (local [B, N, 64], global
    [B, G], feature transforms [B, 64, 64])."""

    def __init__(self, point_dim: int, global_feat: int, num_features: int, bottleneck: int,
                 fc_features, use_bias: bool, generator: torch.Generator):
        super().__init__()
        self.point_dim = point_dim
        kw = dict(bottleneck=bottleneck, fc_features=fc_features, use_bias=use_bias)
        self.input_tnet = TNet(point_dim, point_dim, generator, **kw)
        self.mlp_a = SharedMLP(num_features, (64, 64), generator, use_bias=use_bias)
        self.feature_tnet = TNet(64, 64, generator, **kw)
        self.mlp_b = SharedMLP(64, (64, 128, global_feat), generator, use_bias=use_bias)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        d = self.point_dim
        coords = matmul_promoted(x[..., :d], self.input_tnet(x[..., :d], mask))
        h = self.mlp_a(torch.cat([coords, x[..., d:]], dim=-1), mask)
        t_feat = self.feature_tnet(h, mask)
        local = h @ t_feat
        return local, masked_max_pool(self.mlp_b(local, mask), mask), t_feat


class ClassicPointNetEncoder(_PointNetEncoder):
    """BasePointNet of pointNet/model/pointnet.py:47-97 (1024-d global)."""

    def __init__(self, point_dim: int = 3, global_feat: int = 1024, num_features: int = 9,
                 generator: Optional[torch.Generator] = None):
        super().__init__(point_dim, global_feat, num_features, 1024, (512, 256), True,
                         default_generator(generator))


class LightPointNetEncoder(_PointNetEncoder):
    """Slim 256-d encoder of light_pointnet_256.py:48-97: bias-free, T-Net on x,y."""

    def __init__(self, point_dim: int = 2, global_feat: int = 256, num_features: int = 9,
                 generator: Optional[torch.Generator] = None):
        super().__init__(point_dim, global_feat, num_features, 256, (256, 128), False,
                         default_generator(generator))


def _encoder(variant: str, point_dim: int, num_features: int, g: torch.Generator):
    if variant == "classic":
        return ClassicPointNetEncoder(point_dim, num_features=num_features, generator=g), 1024
    if variant == "light":
        return LightPointNetEncoder(point_dim, num_features=num_features, generator=g), 256
    raise ValueError(f"unknown PointNet variant {variant!r} (classic | light)")


class ClassificationPointNet(nn.Module):
    """Cloud classification returning log-probabilities
    (pointnet.py:100-125 / light_pointnet_256.py:100-116): the encoder's global
    feature, FC + BN + ReLU blocks (``fc_i``/``bn_i``), dropout, ``fc_out``."""

    def __init__(self, num_classes: int = 2, variant: str = "light", point_dim: int = 2,
                 drop_rate: float = 0.3, num_features: int = 9,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.encoder, c = _encoder(variant, point_dim, num_features, g)
        dims, use_bias = ((512, 256), True) if variant == "classic" else ((128, 64), False)
        for i, d in enumerate(dims):
            self.add_module(f"fc_{i}", make_linear(c, d, use_bias, g))
            self.add_module(f"bn_{i}", MaskedBatchNorm(d))
            c = d
        self.n_fc = len(dims)
        self.fc_out = make_linear(c, num_classes, True, g)
        self.drop_rate = drop_rate

    def forward(self, x, mask=None, generator: Optional[torch.Generator] = None):
        _, h, t_feat = self.encoder(x, mask)
        for i in range(self.n_fc):
            h = torch.relu(getattr(self, f"bn_{i}")(getattr(self, f"fc_{i}")(h)))
        h = dropout(h, self.drop_rate if self.training else 0.0, generator)
        return torch.log_softmax(self.fc_out(h), dim=-1), t_feat


class SegmentationPointNet(nn.Module):
    """Per-point segmentation over [global ‖ local]
    (pointnet.py:128-154 / light_pointnet_256.py:128-153): biased dense + masked
    BN + ReLU blocks (``head_i``/``bn_i``), ``head_out``. Returns raw logits."""

    def __init__(self, num_classes: int = 5, variant: str = "light", point_dim: int = 2,
                 num_features: int = 9, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = default_generator(generator)
        self.encoder, c = _encoder(variant, point_dim, num_features, g)
        dims = (512, 256, 128) if variant == "classic" else (256, 128, 64)
        c += 64  # the local features ride beside the global one
        for i, d in enumerate(dims):
            self.add_module(f"head_{i}", make_linear(c, d, True, g))
            self.add_module(f"bn_{i}", MaskedBatchNorm(d))
            c = d
        self.n_head = len(dims)
        self.head_out = make_linear(c, num_classes, True, g)

    def forward(self, x, mask=None):
        local, glob, t_feat = self.encoder(x, mask)
        gb = glob[..., None, :].expand(*glob.shape[:-1], local.shape[-2], glob.shape[-1])
        h = torch.cat([gb, local], dim=-1)
        for i in range(self.n_head):
            h = torch.relu(getattr(self, f"bn_{i}")(getattr(self, f"head_{i}")(h), mask))
        return self.head_out(h), t_feat
