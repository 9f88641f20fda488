"""Inference backends: one forward signature over several implementations,
counterpart of ``ampnet_tpu/models/backends.py`` (same backend names, so
command lines carry over).

* ``'xla'``    — the ``nn.Module`` forward (``AMPNetSegmenter``), the port's
  reference path (the name is kept from the JAX package, where it meant the
  Flax model under XLA);
* ``'folded'`` — inference BatchNorm folded into the dense kernels, plain
  torch (models/folded_infer.py);
* ``'bf16'``   — the same assembly with the per-point chains in bfloat16;
* ``'fused'``  — the encoder's four chains through the ``fused_mlp_chain``
  CUDA kernel (models/fused_infer.py) + the folded attention/head;
* ``'int8'``   — not ported yet: it needs ``quantized_mlp_chain``
  (ROADMAP.md Queue 2).

``forward(points [B, W, N, F], centroids [B, W, 2], pad_mask)`` returns fp32
per-point logits. Every non-'xla' backend folds the RUNNING BatchNorm
statistics, so ``make_forward`` refuses ``bn_mode='window'`` models, and the
reassembled layouts refuse ``local_agg`` and ``att_geom_tokens`` models, as
the JAX package does.

``make_forward`` runs on the card unless asked for the CPU. On the fp32 path
TF32 is off for matmuls and cuDNN alike (``core/device.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ampnet_tpu_torch.core.device import resolve_device
from ampnet_tpu_torch.models.folded_infer import attention_head_folded, encode_windows_folded
from ampnet_tpu_torch.models.fused_infer import encode_windows_fused

BACKENDS = ("xla", "folded", "bf16", "fused", "int8")


def make_forward(model, cfg, backend: str = "xla", device="cuda") -> Callable:
    """forward(points, centroids, pad_mask) → logits, for ``model`` moved to
    ``device`` and put in eval mode. Inputs must already live on ``device``."""
    dev = resolve_device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    model.to(dev).eval()
    if backend == "xla":

        def forward(points, centroids, pad_mask):
            with torch.inference_mode():
                return model(points, centroids, pad_mask)[0]

        return forward

    if getattr(cfg.model, "bn_mode", "batch") != "batch":
        raise ValueError(
            f"backend {backend!r} folds running BatchNorm statistics, which "
            f"bn_mode={cfg.model.bn_mode!r} models neither use nor update — "
            "use backend='xla' for window-mode BatchNorm"
        )
    if getattr(cfg.model, "local_agg", "none") != "none":
        raise ValueError(
            f"backend {backend!r} reassembles the reference encoder layout and "
            f"does not know the local_agg={cfg.model.local_agg!r} edge block — "
            "use backend='xla' for edge-aggregation models"
        )
    if getattr(cfg.model, "att_geom_tokens", False):
        raise ValueError(
            f"backend {backend!r} reassembles the reference attention layout "
            "and does not know the geom-token encoding (att_geom_tokens) — "
            "use backend='xla' for geom-token models"
        )
    if backend == "int8":
        raise NotImplementedError(
            "backend 'int8' needs the quantized_mlp_chain kernel, which is not "
            "ported yet (ROADMAP.md Queue 2)")
    if cfg.model.context != "attention":
        raise ValueError(f"backend {backend!r} evaluates the attention head; "
                         f"context={cfg.model.context!r} needs backend='xla'")
    heads = cfg.model.att_heads

    if backend in ("folded", "bf16"):
        dtype = torch.bfloat16 if backend == "bf16" else torch.float32

        def forward(points, centroids, pad_mask):
            with torch.inference_mode():
                local, glob, _ = encode_windows_folded(model, points, dtype=dtype)
                return attention_head_folded(model, local, glob, centroids, pad_mask,
                                             num_heads=heads, dtype=dtype)

        return forward

    def forward(points, centroids, pad_mask):
        with torch.inference_mode():
            local, glob, _ = encode_windows_fused(model, points)
            return attention_head_folded(model, local, glob, centroids, pad_mask,
                                         num_heads=heads)

    return forward
