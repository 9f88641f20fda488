"""ampnet_tpu_torch — the PyTorch / CUDA port of ``ampnet_tpu`` for an NVIDIA
H100 (Hopper, ``sm_90a``).

The JAX package stays beside it as the reference; this package imports
nothing of it (and no JAX). Its layout mirrors the JAX package so each
counterpart is easy to find:

core      config dataclasses, device selection, weights carried across (Flax
          trees, optax Adam state, reference ``.pth``), metrics, checkpoints,
          CSV logging
data      schema, artifact loaders, LAS I/O, synthetic scenes, windowed
          datasets, padded batchers and the GPU-resident dataset cache
preproc   offline LAS → windows stages: window split, height above ground,
          filter and normalise, balanced k-means tiling, split lists
native    the host min-cost-flow solver and FPS (C++ in ``csrc/``, ctypes)
models    every family of the factory (AMP-Net attention and GRU segmenters
          and classifiers, classic / light PointNet, PointNet++;
          ``nn.Module``, train and eval) and the inference backends
ops       balanced k-means tiling; sampling (FPS); augmentation;
          ``fused_mlp_chain`` and ``quantized_mlp_chain`` (CUDA kernels in
          ``csrc/`` + their plain PyTorch versions)
train     losses, train state (Adam + schedule), segmentation and
          classification train/eval steps, the epoch loop and the Trainer
infer     tiled whole-cloud and whole-tile LAS inference, evaluation, cloud
          classification and the HTTP server
cli       ``python -m ampnet_tpu_torch synth|preprocess|fps|train|test|infer|
          export|serve|demo``

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
