"""ampnet_tpu_torch — the PyTorch / CUDA port of ``ampnet_tpu`` for an NVIDIA
H100 (Hopper, ``sm_90a``).

The JAX package stays beside it as the reference; this package imports
nothing of it (and no JAX). Its layout mirrors the JAX package so each
counterpart is easy to find:

core      config dataclasses, device selection, weights carried across
data      the schema pieces the serving path reads
models    AMP-Net segmenter (``nn.Module``) and the inference backends
ops       balanced k-means tiling; ``fused_mlp_chain`` (CUDA kernel in
          ``csrc/fused_mlp.cu`` + its plain PyTorch version)
infer     tiled whole-cloud inference and the HTTP server
cli       ``python -m ampnet_tpu_torch serve``

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
