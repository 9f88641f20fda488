#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ampnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX or of ``ampnet_tpu``. Phases, each of which fails
the run (non-zero exit, no result line) when it does not hold:

1. card   -- the ``nvidia-smi`` name and power limit line;
2. build  -- ``nvcc`` builds every CUDA source of ``ampnet_tpu_torch/csrc``
   (``SOURCES``) for ``sm_90a``, and ``g++`` the host solver
   (``balanced_assign.cc``), one process each, all started together;
3. kernels -- each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it (and at the bench geometry, padded
   or prime window counts, ``relu_last=False`` and, for the int8 chain, an
   explicit ``block_windows``), timed with CUDA events beside its bound, the
   plain version's time and a library yardstick; then, untimed, at ragged
   shapes (``EDGE_CASES``; for the int8 chain also ``INT8_EDGE_CASES``:
   explicit ``block_windows``, a last block whose length is not a multiple
   of 4, and x as a view into its storage at an offset). The int8 kernel
   must agree with its plain version in every element; its printed rows add
   the bound of its own plan (``design bound``: the recomputed layers and
   the int8 x_q traffic). ``sinkhorn_iterations`` (``SINKHORN_CASES``: 1 and 4
   served clouds, one unbatched preprocessing cloud) must give the plain
   loop's plan, centroids and assignment bit for bit, and
   ``batched_farthest_point_sampling`` (``FPS_LEVELS``: the whole-cloud
   PointNet++ step's three levels, 32 x 16,384 -> 1,024, 32 x 1,024 -> 256
   and 32 x 256 -> 64, on two seeds, and the first level under a mask) the
   plain loop's indices, one launch a call, and ``ball_query_members``
   (``BALL_QUERY_LEVELS``: the same step's ball queries, 32 x 1,024 centres
   over 16,384 points at radius 0.1, 32 x 256 over 1,024 at 0.2 and 32 x 64
   over 256 at 0.4, 32 members, on the model's own distances from two
   seeds) the plain body's integers, one launch a call, beside its bound,
   the bytes of d2 a scan stopping at each row's last member reads. Each time is taken on two clocks
   (``kernel_timing.py``): ``ms``, back-to-back calls as a caller makes them,
   which include the wrapper's host time where that is the slower side, and
   ``device_ms``, the same calls replayed from a CUDA graph. ``fused_mlp_chain``'s
   bound takes its operations at the rate of its 3xTF32 design, with the
   one-TF32-product bound (``tf32_bound_ms``) and the fp32 CUDA-core bound
   (``fp32_bound_ms``) beside it;
4. model  -- backend ``fused`` against the module forward (``xla``) at
   ``[2, 18, 4096, 9]``, from seeded random weights and BatchNorm statistics;
   backend ``int8`` against ``xla`` and against the same ``int8`` forward on a
   CPU copy of the model (the chains' plain versions);
5. serve  -- the ``serve`` entry point (``--backend fused --device cuda``, then
   ``--backend int8 --device cuda``) on 127.0.0.1 answers binary and JSON
   requests for 50,000- and 20,000-point clouds (two bucket shapes, one
   micro-batch holding both) from concurrent clients; every answer equals a
   direct ``TiledInferencer.predict_many`` on the same clouds and seeds as
   the micro-batch it was served in, and the kernels' launch counters show
   that every bucket forward went through them (fused: 4 ``fused_mlp_chain``
   launches; int8: 2 ``quantized_mlp_chain`` and 2 ``fused_mlp_chain``);
6. train  -- the training slice at full width: (a) a seeded learnable
   dataset on disk (96 train and 32 val clouds of 9 windows x 2048 points, 13
   columns, labels a seeded function of z and NDVI); (b) one ``train_step`` on
   the card against the same step on a CPU copy (same weights and
   ``[4, 9, 2048, 9]`` batch, dropout 0, no augmentation: loss to 1e-5
   relative, gradients to 1e-4 of each parameter's largest, parameters to
   1e-4); (c) ``python -m ampnet_tpu_torch train ... --device cuda --epochs 2
   --batch_size 32`` through ``cli.main.main``; (d) 10 steps on one batch, the
   loss must fall; (e) the best checkpoint restored into a fresh ``Trainer``,
   bitwise; (f) that checkpoint directory served by ``serve --backend fused
   --device cuda``: a 50,000-point request equals ``predict_many`` on the
   restored model, 4 ``fused_mlp_chain`` launches per bucket forward; (g) the
   ``train:`` line, 3 warm steps at batch 32 x 9 x 2048 on the card;
7. evaluate -- phase 6's checkpoint on two 50,000- and two 20,000-point raw
   13-column clouds (labels phase 6's function of z and NDVI), each run
   through ``cli.main.main`` with ``--device cuda``: (a) ``test --backend
   fused``, whose CSV row and summary equal a summary recomputed from
   ``TiledInferencer.predict_many`` on the same chunk and seeds to 1e-6; (b)
   ``export`` to a ``.pth``, then ``test`` of the checkpoint and its export,
   one stacked group of 2 whose labels equal (a)'s; (c) ``test --backend
   int8``, labels agreeing with (a)'s on > 0.97 of the points; (d) ``infer``,
   whose predictions equal (a)'s labels; (e) ``test --tta 2 --tile_votes 2``.
   The launch counters show each run's kernels per bucket forward (fused 4,
   the stacked pair 8, int8 2 + 2); the ``eval:`` line prints each test's
   mIoU and points/s beside the card;
8. tiles -- the host data stages and whole-tile inference at full width,
   each through ``cli.main.main``: (a) ``synth`` of 2 LAS tiles of 9
   windows x 50,000 points on 5 m of terrain (with synth's ground returns,
   about 1.1 M points); (b) ``preprocess`` (n_points 2048, max_windows 9,
   the native min-cost-flow solver) with ``--workers 1`` and ``--workers
   2``, whose outputs must be equal, and ``--assigner sinkhorn --device
   cuda`` on one tile, every window exactly 2048 points; (c) one window's
   Sinkhorn assignment on the card and on the CPU from one start (exact
   sizes, agreement >= 0.999), and the native MCF's cost <= the plain
   greedy's on its cost matrix; (d) the native FPS, naive and grid, equal to
   the torch FPS on the card on a window of each tile (one launch of
   ``csrc/fps.cu`` a window, counted), and ``fps`` over every window; (e) ``infer`` of both tiles with phase 6's checkpoint under
   ``--backend fused`` and ``--backend int8``: labels equal ``predict_many``
   on the same windows and seeds, each classified LAS carries them at every
   unfiltered point, ``tile_metrics.json`` holds both tiles, launches 4 and
   2 + 2 per bucket forward; the fused run once more warm and traced; (f)
   ``demo --backend fused`` on the card at the verify recipe: exit 0, its
   summary JSON, 4 launches per bucket forward of its test. The ``data:``
   line prints every time, points/s, and a warm tile's host stages (read,
   HAG, split, filter) against its ``predict_many``;
9. families -- the GRU, classification and PointNet families at full
   published width (global 256, GRU hidden 64, classic 1024), each command
   through ``cli.main.main`` with ``--device cuda``, on a seeded dataset of
   half tower, half landscape clouds (9 x 2048 windowed artifacts and
   6,000-point wholes): (a) the dataset; (b) one train step of the GRU and
   classic segmenters and of the attention classifier on the card against a
   CPU copy (phase 6's tolerances); (c) ``train --epochs 2`` of gru (32 x 9 x
   2048), baseline, classic and pointnet2 (32 clouds x 4096) and
   ``--task classification`` of attention and baseline, with each run's warm
   step ms, windows or clouds/s and peak GiB; (d) ``test`` of each checkpoint:
   the segmentation row equal to a summary recomputed from ``predict_many``
   to 1e-6 (the whole-cloud families as k = 1 buckets), the classification
   row equal to a recount of ``CloudClassifier.predict_many`` on test's own
   resampled points (baseline) or of the module on test's batches
   (attention); (e) ``serve --task classification`` and ``serve`` of the GRU
   under the default backend (``folded`` falls back to ``xla``, printed),
   answers equal to ``predict_many``; ``test`` of an ``attention,gru``
   ensemble (phase 6's checkpoint beside the GRU); GRU ``export`` → ``.pth``
   → ``test`` with equal labels; ``demo --arch pointnet2`` at the verify
   recipe; (f) ``test --backend fused`` of the GRU exits 1 with the JAX
   message. Neither MLP-chain kernel launches in any of these runs (the JAX
   package runs the families only under ``xla``); the FPS and ball-query
   kernels launch exactly three times each a PointNet++ forward that the
   card runs (one a set abstraction), more than 0 in each PointNet++ run.
   The ``families:`` line prints each run's numbers beside the card;
10. geometry -- the eigenfeature columns, the edge block, the geometry tokens
   and distillation at full published width (``geometry_phase``): (a)
   ``preprocess --geom_features`` of phase 8's tiles (``--geom_k 24``, then
   ``--geom_radius_norm median``; columns 13..18 in [0, 1], the first 13 equal
   to phase 8's artifacts bit for bit); (b) both kernels against their plain
   versions at ``serve_geom:mlp_a`` ([18, 4096], 18 → 64 → 64: the scalar
   x-load path), timed as in phase 3; (c) a 15-column learnable dataset,
   the geometry model's card step against the CPU's, ``train
   --geom_features`` 2 epochs and its warm step; (d) that checkpoint served
   under ``fused`` and ``int8`` with 15-column bodies (answers =
   ``predict_many``, labels against ``xla`` >= 0.999 / > 0.97, launches 4
   and 2 + 2 a bucket forward), ``test`` of (a)'s clouds and whole-tile
   ``infer`` of phase 8's tiles under both, with the geometry recomputed;
   (e) ``train --geom_features --local_agg edge --att_geom_tokens`` at 32 x
   9 x 2048, its card step against the CPU's, warm step, kNN ms, ``test``
   under ``xla`` and ``--backend fused`` exiting 1 with the JAX message;
   (f) ``train --distill_from`` (c) and (e) into a plain 9-column student,
   ``--grad_accum`` 1 and 2, and its card step against the CPU's; (g)
   ``demo --geom_features --backend fused``. (e) and (f) launch neither
   kernel. The ``geometry:`` line prints every number beside the card;
11. parallel -- data parallelism at full width (``parallel_phase``): (a)
   one NCCL rank (world size 1) through the sharded step against the plain
   step, on seeded weights and a 32 x 9 x 2048 batch of phase 6's data
   (dropout 0, no augmentation): loss to 1e-5 relative, gradients to 1e-4 of each
   parameter's largest, running statistics to 1e-6, and the warm step of
   each timed; (b) two gloo ranks sharing the card (NCCL refuses two ranks
   on one device) against one process on the global batch: in float64 the
   summed gradients to 1e-4 (grad_accum 1 and 2) and 3 steps' losses to
   3e-3 (step 1 to 1e-5); in float32 the losses bit-identical across ranks
   and step 1 to 1e-5, the later steps printed beside one process against
   itself on the same clouds reversed (the float32 noise floor); (c)
   ``train --num_devices 2 --device cuda`` exits 1 naming the counts on one
   card (trains 1 epoch, rank 0 alone writing, on two or more); (d)
   ``TiledInferencer(devices=[cuda:0, cuda:0])`` under fused and int8, each
   shard's answers equal to ``predict_many`` on one device, launches per
   shard bucket forward as in phase 5, and ``serve --num_devices 2`` exiting
   1 on one card; (e) the window-axis forward on 1 x 2 and 2 x 1 grids of
   cuda:0 against the single forward to 2e-5. No kernel launches in (a), (b)
   and (e). The ``parallel:`` line prints every number beside the card;
12. training options -- at full width on phase 6's data (``options_phase``):
   (a) a bfloat16 step against the float32 step on one 32 x 9 x 2048 batch,
   the loss within the CPU test's bfloat16 floor (5.1e-3 of the float32
   loss), step ms, windows/s and peak GiB of each, and ``train --dtype
   bfloat16`` for 1 epoch; (b) the remat step against the plain step (loss,
   gradients, running statistics, no further apart than the plain step from
   itself), each timed; (c) ``train --oversample_factor 3
   --oversample_classes auto --seg_weighing EFS``: printed weights and
   counts equal the port's functions on the host, ``len(repeated pool) //
   32`` steps; (d) ``--epoch_dispatch off`` against ``auto``: the same epoch
   metrics; (e) the host batcher with prefetch 2 and 2 forked workers
   against prefetch 0: the same batches, and an epoch of each through the
   trainer; (f) ``test --backend fused`` (4 ``fused_mlp_chain`` launches a
   bucket forward) and ``--backend xla`` (bfloat16 logits, no launch) of
   (a)'s checkpoint on phase 7's clouds. (a)-(e) launch neither kernel. The
   ``train_options:`` line prints every number beside the card;
13. bench and observability (``bench_phase``): (a) ``python -m
   ampnet_tpu_torch bench --device cuda`` through ``cli.main.main`` under
   ``AMPNET_BACKEND=fused``: exactly one stdout line with the JAX bench's
   keys, ``value`` > 0 and ``vs_baseline`` from the pinned baseline; the
   fp32 and bf16 train arms without an error; 4 ``fused_mlp_chain``
   launches per bench forward; (b) ``measure_forward`` under ``int8`` (2
   ``quantized_mlp_chain`` + 2 ``fused_mlp_chain`` a forward) and ``xla``
   (none); (c) the bench forward's logits at [32, 9, 2048, 9] under fused
   (5e-3, argmax agreement > 0.999) and int8 (> 0.97) against xla; (d)
   ``core/profiling.py``'s ``trace`` of 4 fused forwards (16 launches by
   the counters) names the ``fused_mlp_chain`` kernel at least 12 times,
   their device ms by kernel (torch.profiler), ``StepTimer`` over 10 forwards
   (each host time at least the CUDA-event time of its call), the phase's
   ``EnergyTracker`` report, a ``MetricsLogger`` scalar and histogram (the
   sinks it wrote: TensorBoard events only where the package imports); (e)
   ``sequential_tiling`` of 32 clouds x 20,000 points on the card equal to
   the CPU (``zero``, and ``duplicate`` from one index draw), and
   ``scan_for_towers`` on phase 8's first tile. The ``bench:`` line prints
   every number beside the card;
14. bucket graphs (``graph_phase``): each tiled-inference bucket is captured
   once as a CUDA graph and replayed (``infer/tiled.py``). (a) Under
   ``fused``, ``int8`` and ``xla`` at the k = 18 and k = 9 buckets of cap
   4096 and a k = 1 one, and a stacked pair and two shards on ``cuda:0``
   under ``fused`` at the k = 18 one, with probabilities off and on: every
   call's labels and float16 probabilities equal, element for element, the
   eager body on the inputs that call was given, the capturing call and two
   replays (the second with other clouds, so the static inputs are re-read);
   (b) the CUDA runtime calls a warm dispatch enqueues (torch.profiler): one
   ``cudaGraphLaunch`` per bucket, and under 50 kernel and copy enqueues
   for a 1-cloud ``fused`` request, beside the eager body's; (c) a traced
   replay names the ``fused_mlp_chain`` kernel (``chain_kernel`` of a
   ``Chain``) under ``fused`` and the int8 chain and absmax kernels under
   ``int8``, and the counters grow by 4, and by 2 + 2, per replayed bucket
   forward, ``device_stamp``'s by 3 and ``sinkhorn_iterations``' by 900 (the
   bucket's k-means: 3 an iteration); (d) the capture ms of each shape,
   the graphs held, the cold count equal to the graphs captured, and the
   memory reserved; (e) a warm k = 18 bucket replayed 10 times: its device
   stamps rise in each replay, the stamp kernel launches 3 times a replay,
   and the median whole interval and tiling interval lie within 10 % of
   CUDA events around replays of the same graph and of a graph of the
   body's tiling alone. The ``graphs:`` line prints every number beside the
   card;
15. results -- one ``{"kernels": [...]}`` line (``device_stamp``'s entry
   holds its launches in phase 14 and (e)'s readings, ``sinkhorn_iterations``' its
   launches in phase 14 and phase 3's cases, ``batched_farthest_point_sampling``'
   its launches in phase 8's windows and phase 9's PointNet++ runs, and phase
   3's cases, ``ball_query_members``' its launches in phase 9's PointNet++
   runs and phase 3's cases), then as the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kernel_timing import HBM_BYTES_PER_S

SEED = 0
# ampnet_tpu_torch/csrc/<name>.cu (nvcc) or .cc (g++, the host solver) ->
# (the package module that declares its C signatures, the table's name there)
SOURCES = {"fused_mlp": ("ops.fused_mlp", "SIGNATURES"),
           "quantized_mlp": ("ops.quantized_mlp", "SIGNATURES"),
           "device_stamp": ("ops.device_stamp", "SIGNATURES"),
           "sinkhorn": ("ops.kmeans", "SIGNATURES"), "fps": ("ops.sampling", "FPS_SIGNATURES"),
           "ball_query": ("ops.sampling", "BALL_QUERY_SIGNATURES"),
           "balanced_assign": ("native", "SIGNATURES")}
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, dense TF32 and
# int8 on the tensor cores (HBM3's rate is kernel_timing.py's)
FP32_PEAK_FLOPS = 67e12
TF32_PEAK_FLOPS = 495e12
INT8_PEAK_OPS = 1979e12
# fused_mlp_chain issues three TF32 products per fp32 product (3xTF32)
TF32_PRODUCTS = 3
# fp32 rounding of sums of up to 256 products, taken in another order than
# cuBLAS takes them: about K * 2^-24 relative, 1.5e-5 at K = 256; the 3xTF32
# split of fused_mlp_chain adds about 2^-21 relative per product. The int8
# chain's kernel and plain version round alike (exact int32 sums, no FMA), so
# 0 elements are expected to differ there; the bound is the same.
KERNEL_RTOL = 1e-4
# k = 18 windows of cap 4096, and k = 9 of cap 4096, at n_points 2048
SERVE_CLOUD_POINTS = (50_000, 50_000, 50_000, 50_000, 50_000, 20_000, 20_000)
SERVE_GEOM = (18, 4096)  # (M, N) of one served cloud's chains: 18 windows of 4096 points
BENCH_GEOM = (288, 2048)  # (M, N) at the bench geometry, 32 clouds x 9 windows
MODEL_SHAPE = (2, 18, 4096)  # [B, W, N] of the backends-against-xla checks


def _say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0]


def roofline(flops, nbytes):
    """The bounds of fp32 chain work, in ms: (bound_ms, bound_by,
    tf32_bound_ms, fp32_bound_ms). bound_ms takes the operations at the
    rate of the kernel's 3xTF32 design (three TF32 products per fp32 product
    at 495 TFLOP/s); tf32_bound_ms at one TF32 product per fp32 product, the
    least time of the function on the tensor cores at TF32; fp32_bound_ms at
    the 67 TFLOP/s fp32 rate of the CUDA cores, the bound of the kernel's
    earlier CUDA-core design. Bytes over 3.35 TB/s in all three."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = TF32_PRODUCTS * flops / TF32_PEAK_FLOPS * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            max(flops / TF32_PEAK_FLOPS * 1e3, t_bytes),
            max(flops / FP32_PEAK_FLOPS * 1e3, t_bytes))


def chain_bound(m, n, dims, pool, return_acts):
    """(bound_ms, bound_by, tf32_bound_ms, fp32_bound_ms, flops, bytes) of one chain call:
    each input read once, each output written once, fp32 (``roofline``)."""
    flops = 2.0 * m * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = 4.0 * (m * n * dims[0] + params
                    + (m * n * dims[-1] if return_acts else 0) + (m * dims[-1] if pool else 0))
    return (*roofline(flops, nbytes), flops, nbytes)


def seeded_model(cfg, arch="attention", task="segmentation"):
    """A model of the factory (the flagship segmenter by default) with seeded
    random weights, BatchNorm statistics and T-Net output layers (Flax init
    leaves those zero)."""
    from ampnet_tpu_torch.models.factory import build_model
    from ampnet_tpu_torch.models.layers import MaskedBatchNorm, TNet

    g = torch.Generator().manual_seed(SEED)
    model = build_model(cfg, arch, task, generator=g)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, MaskedBatchNorm):
                mod.mean.normal_(0.0, 0.1, generator=g)
                mod.var.uniform_(0.5, 1.5, generator=g)
                mod.scale.uniform_(0.8, 1.2, generator=g)
                mod.bias.normal_(0.0, 0.1, generator=g)
            elif isinstance(mod, TNet):
                mod.fc_out.weight.normal_(0.0, 0.01, generator=g)
                mod.fc_out.bias.normal_(0.0, 0.01, generator=g)
    return model.eval()


def compare(case, out, ref, what="kernel"):
    """An output against its plain version's on the same inputs → (largest
    absolute difference, count of elements that differ). The difference must
    stay within KERNEL_RTOL of the reference's largest magnitude (at least 1)."""
    torch.cuda.synchronize()
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err, scale, ndiff = 0.0, 1.0, 0
    for o, r in zip(out, ref, strict=True):
        if o.shape != r.shape or not torch.isfinite(o).all():
            raise RuntimeError(f"{case}: {what} output {tuple(o.shape)} is not finite "
                               f"or not of shape {tuple(r.shape)}")
        err = max(err, (o - r).abs().max().item())
        scale = max(scale, r.abs().max().item())
        ndiff += int((o != r).sum().item())
    if err > KERNEL_RTOL * scale:
        raise RuntimeError(f"{case}: {what} disagrees with the plain version: "
                           f"max_abs_err {err} > {KERNEL_RTOL} * {scale}")
    return err, ndiff


def kernel_err(case, x, ws, bs, kw) -> float:
    """fused_mlp_chain's kernel against its plain version on the same inputs:
    the largest absolute difference (``compare``)."""
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain, fused_mlp_chain_reference

    return compare(case, fused_mlp_chain(x, ws, bs, **kw),
                   fused_mlp_chain_reference(x, ws, bs, **kw))[0]


def cuda_launches(fn) -> dict:
    """Device operations (kernels, memsets, copies) one call of ``fn``
    enqueues, by name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:48]: e.count for e in prof.key_averages() if e.device_type.name == "CUDA"}


# ragged shapes the serving path does not give the kernel, checked untimed:
# (M, N, widths, pool, return_acts, relu_last)
EDGE_CASES = [
    (1, 1, (3, 64, 128, 256), True, False, True),  # one point
    (7, 65, (12, 64, 64), True, True, True),  # a row past one tile
    (3, 129, (5, 33, 70), True, True, False),  # widths off the 32-column grid
    (2, 200, (256, 256, 256, 256, 256), True, True, True),  # four layers, widest
    (4, 64, (128, 1), True, True, False),  # one output channel
]
# the int8 chain alone, with x's largest |value| in its last element: (M, N,
# widths, block_windows, offset of x in its storage in floats, pool,
# return_acts). Each block's absmax reads 16 bytes at a time where the
# block's start allows and the rest one float at a time.
INT8_EDGE_CASES = [
    (5, 33, (6, 64, 64), 2, 0, True, True),  # the last block: 198 floats, not 4k
    (4, 33, (6, 64, 64), 2, 198, True, True),  # x_big[1:]: 8 bytes past 16
    (4, 33, (12, 64, 64), 2, 2, False, True),  # 2 floats in: no 16-byte row loads
]


def edge_phase(dev):
    """Phase 3b: both kernels against their plain versions at EDGE_CASES,
    and the int8 chain at INT8_EDGE_CASES, with seeded random weights
    (variance 1/fan_in), quantized per channel for the int8 chain."""
    from ampnet_tpu_torch.ops.quantized_mlp import (
        prepare_quantized_chain,
        quantize_chain,
        quantized_mlp_chain,
        quantized_mlp_chain_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def chain(dims):
        ws = [torch.randn(a, b, generator=gen, device=dev) / a ** 0.5
              for a, b in zip(dims[:-1], dims[1:])]
        return ws, [0.1 * torch.randn(b, generator=gen, device=dev) for b in dims[1:]]

    def int8_check(case, x, ws, bs, kw):
        qs, ss = quantize_chain(ws)
        err, ndiff = compare(case, quantized_mlp_chain(x, prepare_quantized_chain(qs, ss, bs), **kw),
                             quantized_mlp_chain_reference(x, qs, ss, bs, **kw))
        if ndiff:
            raise RuntimeError(f"{case}: {ndiff} elements differ from the plain version")
        return err, ndiff

    for m, n, dims, pool, acts, relu_last in EDGE_CASES:
        ws, bs = chain(dims)
        x = torch.randn(m, n, dims[0], generator=gen, device=dev)
        kw = dict(pool=pool, return_acts=acts, relu_last=relu_last)
        case = f"edge {m}x{n} {list(dims)}"
        err = kernel_err(case, x, ws, bs, kw)
        q_err, q_diff = int8_check(f"int8 {case}", x, ws, bs, kw)
        _say(f"  edge M={m} N={n} dims={list(dims)} {kw}: fused err={err:.3g}; "
             f"int8 err={q_err:.3g}, {q_diff} elements differ")
    for m, n, dims, bw, offset, pool, acts in INT8_EDGE_CASES:
        ws, bs = chain(dims)
        storage = torch.randn(offset + m * n * dims[0], generator=gen, device=dev)
        x = storage[offset:].view(m, n, dims[0])
        x[-1, -1, -1] = 2 * x.abs().max()  # the largest |x| sets the last block's scale
        kw = dict(pool=pool, return_acts=acts, block_windows=bw)
        err, ndiff = int8_check(f"int8 edge {m}x{n} {list(dims)} offset {offset}", x, ws, bs, kw)
        _say(f"  int8 edge M={m} N={n} dims={list(dims)} x at float {offset} of its storage "
             f"{kw}: err={err:.3g}, {ndiff} elements differ")


# the peak bound_ms of a fused_mlp_chain row is taken at, when operations bound it
TF32_BOUND_PEAK = "3 TF32 products per fp32 product at 495 TFLOP/s (dense TF32)"


def fused_case_row(case, ws, bs, x, pool, acts, relu_last) -> dict:
    """One fused_mlp_chain case on ``x`` [M, N, Cin]: the kernel against its
    plain version from plain weights (the wrapper prepares them) and on a
    chain prepared once, as the forward runs it; timed on both clocks
    (``kernel_timing.py``) beside its bounds and the plain chain, which is
    the cuBLAS fp32 layer chain; printed."""
    from kernel_timing import device_ms, host_ms

    from ampnet_tpu_torch.ops.fused_mlp import (
        fused_mlp_chain,
        fused_mlp_chain_reference,
        prepare_chain,
    )

    m, n = x.shape[:2]
    dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    kw = dict(pool=pool, return_acts=acts, relu_last=relu_last)
    err = kernel_err(case, x, ws, bs, kw)
    prepared = prepare_chain(ws, bs)
    err = max(err, compare(case, fused_mlp_chain(x, prepared, **kw),
                           fused_mlp_chain_reference(x, ws, bs, **kw))[0])
    iters = 20 if m * n >= 1 << 16 else 100
    kern = lambda: fused_mlp_chain(x, prepared, **kw)
    plain = lambda: fused_mlp_chain_reference(x, ws, bs, **kw)
    # in turns, plain kernel kernel plain, within one card and one call
    p1, k1, k2, p2 = (host_ms(f, iters) for f in (plain, kern, kern, plain))
    dp1, dk1, dk2, dp2 = (device_ms(f, iters) for f in (plain, kern, kern, plain))
    bound_ms, bound_by, tf32_bound_ms, fp32_bound_ms, flops, nbytes = chain_bound(
        m, n, dims, pool, acts)
    row = {
        "name": f"fused_mlp_chain:{case}", "case": case, "shape": [m, n, dims],
        "route": "cuda", "source": "ampnet_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "ampnet_tpu/ops/pallas/fused_mlp.py:69",
        "max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
        # the plain version IS the cuBLAS fp32 layer chain (TF32 off)
        "library_ms": (p1 + p2) / 2,
        "device_ms": (dk1 + dk2) / 2, "plain_device_ms": (dp1 + dp2) / 2,
        "library_device_ms": (dp1 + dp2) / 2,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_peak": TF32_BOUND_PEAK if bound_by == "operations" else "3.35 TB/s (HBM3)",
        "tf32_bound_ms": tf32_bound_ms, "fp32_bound_ms": fp32_bound_ms,
        "flops": flops, "bytes": nbytes,
    }
    _say(f"  {case:24s} M={m:4d} N={n:5d} dims={dims} err={err:.3g} "
         f"kernel={row['ms']:.4f} ms (device {row['device_ms']:.4f}) "
         f"plain={row['plain_ms']:.4f} ms (device {row['plain_device_ms']:.4f}) "
         f"bound={bound_ms:.4f} ms ({bound_by}) 1xTF32 bound={tf32_bound_ms:.4f} ms "
         f"fp32 bound={fp32_bound_ms:.4f} ms")
    return row


def kernel_phase(model, dev):
    """Phase 3: fused_mlp_chain against its plain version → (the per-forward
    row, the four serving chains summed; one row per case). The kernel is
    held against the plain version from plain weights (the wrapper prepares
    them) and timed on a chain prepared once, as the forward runs it, on
    both clocks (``fused_case_row``)."""
    from ampnet_tpu_torch.models.folded_infer import folded_chain_params

    enc = model.encoder
    chains = {
        "input_tnet": (folded_chain_params(enc.input_tnet.trunk), True, False),
        "mlp_a": (folded_chain_params(enc.mlp_a), False, True),
        "feature_tnet": (folded_chain_params(enc.feature_tnet.trunk), True, False),
        "mlp_b": (folded_chain_params(enc.mlp_b), True, False),
    }
    # (case, chain, M, N, pool, return_acts, relu_last)
    cases = [(f"serve:{c}", c, *SERVE_GEOM, p, a, True) for c, (_, p, a) in chains.items()]
    cases += [(f"bench:{c}", c, *BENCH_GEOM, p, a, True) for c, (_, p, a) in chains.items()]
    cases += [("prime_m:mlp_a", "mlp_a", 37, 1000, True, True, True),
              ("relu_last_false:mlp_b", "mlp_b", 5, 100, True, True, False)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for case, chain, m, n, pool, acts, relu_last in cases:
        (ws, bs), _, _ = chains[chain]
        ws = [w.detach().to(dev).contiguous() for w in ws]
        bs = [b.detach().to(dev).contiguous() for b in bs]
        x = torch.randn(m, n, ws[0].shape[0], generator=gen, device=dev)
        rows.append(fused_case_row(case, ws, bs, x, pool, acts, relu_last))
        del x
    serve = [r for r in rows if r["case"].startswith("serve:")]
    bound_ms, bound_by, tf32_bound_ms, fp32_bound_ms = roofline(
        sum(r["flops"] for r in serve), sum(r["bytes"] for r in serve))
    total = {
        "name": "fused_mlp_chain", "case": "serve: the four chains of one forward, summed",
        "route": "cuda", "source": "ampnet_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "ampnet_tpu/ops/pallas/fused_mlp.py:69",
        "max_abs_err": max(r["max_abs_err"] for r in serve),
        "ms": sum(r["ms"] for r in serve), "plain_ms": sum(r["plain_ms"] for r in serve),
        "library_ms": sum(r["library_ms"] for r in serve),
        **{k: sum(r[k] for r in serve)
           for k in ("device_ms", "plain_device_ms", "library_device_ms")},
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_peak": TF32_BOUND_PEAK if bound_by == "operations" else "3.35 TB/s (HBM3)",
        "tf32_bound_ms": tf32_bound_ms, "fp32_bound_ms": fp32_bound_ms,
    }
    _say(f"  serve, four chains summed: kernel={total['ms']:.4f} ms "
         f"(device {total['device_ms']:.4f}) library={total['library_ms']:.4f} ms "
         f"(device {total['library_device_ms']:.4f}) bound={bound_ms:.4f} ms ({bound_by}) "
         f"1xTF32 bound={tf32_bound_ms:.4f} ms fp32 bound={fp32_bound_ms:.4f} ms")
    return total, rows


def int8_bound(m, n, dims, pool, return_acts):
    """(bound_ms, bound_by, ops, bytes) of one int8 chain call: int8
    operations on the tensor cores; fp32 x in, fp32 activations and/or
    pooled vectors out, int8 weights and fp32 scales and biases in, each once."""
    ops = 2.0 * m * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    params = sum(a * b + 8 * b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = (4.0 * (m * n * dims[0] + (m * n * dims[-1] if return_acts else 0)
                     + (m * dims[-1] if pool else 0)) + params)
    t_ops, t_bytes = ops / INT8_PEAK_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def int8_design_bound(m, n, dims, pool, return_acts, g, tile_rows=64):
    """(design_bound_ms, bound_by, ops, bytes) of the kernel's plan for one
    int8 chain call: pass p of L runs layers 0..p-1 again (the recompute),
    over the zero windows too except in the last pass; x is read twice
    (absmax and the quantizing pass), x_q (int8, Cin padded to 32, whole
    64-row tiles) written once and read by each later pass; outputs and
    parameters once."""
    layers = len(dims) - 1
    m_pad = m + (-m % g)
    macs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    ops = 2.0 * n * (m_pad * sum(sum(macs[:p]) for p in range(1, layers))
                     + m * sum(macs))
    xq = m_pad * -(-n // tile_rows) * tile_rows * -(-dims[0] // 32) * 32
    params = sum(a * b + 8 * b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = (8.0 * m * n * dims[0] + (layers * xq if layers > 1 else 0) + params
              + 4.0 * ((m * n * dims[-1] if return_acts else 0) + (m * dims[-1] if pool else 0)))
    t_ops, t_bytes = ops / INT8_PEAK_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def int_mm_chain(x, wq_cols, w_scale, biases, g, pool, relu_last, return_acts):
    """The same int8 chain as one ``torch._int_mm`` per layer (cuBLASLt) and
    torch elementwise ops for the quantization: the library yardstick, timed
    here and used nowhere in the port. ``wq_cols``: each layer's int8 weights
    as a column-major [K, Cout] view, K zero-padded to a multiple of 8 (12 →
    16) for ``_int_mm``'s shape rules."""
    m, n, cin = x.shape
    pad = -m % g
    if pad:
        x = torch.cat([x, x.new_zeros((pad, n, cin))], dim=0)
    h = x.reshape(-1, g * n, cin)
    for i, (q, s_w, b) in enumerate(zip(wq_cols, w_scale, biases)):
        amax = h.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-12)
        s_x = amax / torch.full_like(amax, 127.0)
        hq = torch.round(h / s_x).clamp_(-127, 127).to(torch.int8)
        if hq.shape[-1] != q.shape[0]:
            hq = torch.nn.functional.pad(hq, (0, q.shape[0] - hq.shape[-1]))
        acc = torch._int_mm(hq.reshape(-1, q.shape[0]), q).reshape(*h.shape[:2], -1)
        h = acc.float() * (s_x * s_w) + b
        if i < len(wq_cols) - 1 or relu_last:
            h = torch.relu(h)
    h = h.reshape(-1, n, h.shape[-1])[:m]
    if pool and return_acts:
        return h, h.amax(dim=1)
    return h.amax(dim=1) if pool else h


def int8_case_row(case, args, x, pool, acts, relu_last, bw):
    """One quantized_mlp_chain case on ``x`` [M, N, Cin] with the weight
    arguments ``args`` (a prepared chain, as the forward holds it, or the
    plain weights on the CPU): the kernel against its plain version, every
    element, and the ``_int_mm`` chain; timed on both clocks beside its bound
    and the bound of its own plan; printed → (row, (plan ops, plan bytes))."""
    from kernel_timing import device_ms, host_ms

    from ampnet_tpu_torch.ops.quantized_mlp import (
        block_windows_for,
        quantized_mlp_chain,
        quantized_mlp_chain_reference,
    )

    wq, s_w, bs = (args[0].wq, args[0].w_scale, args[0].biases) if len(args) == 1 else args
    m, n = x.shape[:2]
    dims = [wq[0].shape[0]] + [q.shape[1] for q in wq]
    g = block_windows_for(m, n, max(dims[1:]), bw)
    # column-major [K, Cout] weights, K padded to a multiple of 8
    wq_cols = [torch.nn.functional.pad(q, (0, 0, 0, -q.shape[0] % 8)).t().contiguous().t()
               for q in wq]
    kw = dict(pool=pool, return_acts=acts, relu_last=relu_last, block_windows=bw)
    kern = lambda: quantized_mlp_chain(x, *args, **kw)
    plain = lambda: quantized_mlp_chain_reference(x, wq, s_w, bs, **kw)
    library = lambda: int_mm_chain(x, wq_cols, s_w, bs, g, pool, relu_last, acts)
    err, ndiff = compare(case, kern(), plain())
    if ndiff:
        raise RuntimeError(f"int8 {case}: {ndiff} elements differ from the plain version")
    lib_err, lib_diff = compare(case, library(), plain(), what="the _int_mm chain")
    bound_ms, bound_by, ops, nbytes = int8_bound(m, n, dims, pool, acts)
    design_ms, design_by, design_ops, design_bytes = int8_design_bound(
        m, n, dims, pool, acts, g)
    row = {
        "name": f"quantized_mlp_chain:{case}", "case": case, "shape": [m, n, dims],
        "block_windows": g, "padded_windows": -m % g,
        "route": "cuda", "source": "ampnet_tpu_torch/csrc/quantized_mlp.cu",
        "replaces": "ampnet_tpu/ops/pallas/quantized_mlp.py:46",
        "max_abs_err": err, "elements_differ": ndiff,
        "library_max_abs_err": lib_err, "library_elements_differ": lib_diff,
        "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops, "bytes": nbytes,
    }
    iters = 20 if m * n >= 1 << 16 else 100
    # in turns, plain kernel kernel plain, within one card and one call
    p1, k1, k2, p2 = (host_ms(f, iters) for f in (plain, kern, kern, plain))
    l1, l2 = host_ms(library, iters), host_ms(library, iters)
    dp1, dk1, dk2, dp2 = (device_ms(f, iters) for f in (plain, kern, kern, plain))
    dl1, dl2 = device_ms(library, iters), device_ms(library, iters)
    row.update({"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": (l1 + l2) / 2,
                "device_ms": (dk1 + dk2) / 2, "plain_device_ms": (dp1 + dp2) / 2,
                "library_device_ms": (dl1 + dl2) / 2,
                "cuda_launches_per_call": {
                    name: sum(cuda_launches(fn).values())
                    for name, fn in (("kernel", kern), ("plain", plain), ("library", library))}})
    if case.startswith("serve:"):
        _say(f"  int8 {case}: the kernel's device operations per call: "
             + json.dumps(cuda_launches(kern)))
    _say(f"  int8 {case:22s} M={m:4d} N={n:5d} dims={dims} g={g} err={err:.3g} "
         f"differ={ndiff} library_err={lib_err:.3g} kernel={row['ms']:.4f} ms "
         f"(device {row['device_ms']:.4f}) plain={row['plain_ms']:.4f} ms "
         f"(device {row['plain_device_ms']:.4f}) library={row['library_ms']:.4f} ms "
         f"(device {row['library_device_ms']:.4f}) "
         f"bound={bound_ms:.4f} ms ({bound_by}) share={bound_ms / row['device_ms']:.3f} "
         f"design bound={design_ms:.4f} ms ({design_by}) launches/call="
         + json.dumps(row["cuda_launches_per_call"]))
    return row, (design_ops, design_bytes)


def quantized_phase(model, dev):
    """Phase 3c: quantized_mlp_chain against its plain version, with the
    seeded model's folded and quantized mlp_a and mlp_b → (the per-forward
    row, the two serving chains summed; one row per case). The kernel runs
    on the chains prepared once, as the forward runs them (``int8_case_row``)."""
    from ampnet_tpu_torch.models.quantized_infer import quantize_encoder_chains

    (mlp_a,), (mlp_b,) = quantize_encoder_chains(model)  # prepared, as make_forward holds them
    chains = {"mlp_a": (mlp_a, False, True), "mlp_b": (mlp_b, True, False)}
    # (case, chain, M, N, pool, return_acts, relu_last, block_windows); the
    # padded case has g = 4 and 3 zero windows, bench:mlp_a g = 2
    cases = [(f"serve:{c}", c, *SERVE_GEOM, p, a, True, 0) for c, (_, p, a) in chains.items()]
    cases += [(f"bench:{c}", c, *BENCH_GEOM, p, a, True, 0) for c, (_, p, a) in chains.items()]
    cases += [("padded_m:mlp_a", "mlp_a", 37, 1000, True, True, True, 0),
              ("relu_last_false:mlp_b", "mlp_b", 5, 100, True, True, False, 0),
              ("block_windows_3:mlp_a", "mlp_a", *SERVE_GEOM, False, True, True, 3)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows, served_design = [], []  # served_design: (ops, bytes) of the plan, printed only
    for case, chain, m, n, pool, acts, relu_last, bw in cases:
        prepared, _, _ = chains[chain]
        x = torch.randn(m, n, prepared.wq[0].shape[0], generator=gen, device=dev)
        row, design = int8_case_row(case, (prepared,), x, pool, acts, relu_last, bw)
        if case.startswith("serve:"):
            served_design.append(design)
        rows.append(row)
        del x
    serve = [r for r in rows if r["case"].startswith("serve:")]
    t_ops = sum(r["ops"] for r in serve) / INT8_PEAK_OPS * 1e3
    t_bytes = sum(r["bytes"] for r in serve) / HBM_BYTES_PER_S * 1e3
    d_ops = sum(o for o, _ in served_design) / INT8_PEAK_OPS * 1e3
    d_bytes = sum(b for _, b in served_design) / HBM_BYTES_PER_S * 1e3
    total = {
        "name": "quantized_mlp_chain", "case": "serve: mlp_a and mlp_b of one int8 forward, summed",
        "route": "cuda", "source": "ampnet_tpu_torch/csrc/quantized_mlp.cu",
        "replaces": "ampnet_tpu/ops/pallas/quantized_mlp.py:46",
        "max_abs_err": max(r["max_abs_err"] for r in serve),
        "ms": sum(r["ms"] for r in serve), "plain_ms": sum(r["plain_ms"] for r in serve),
        "library_ms": sum(r["library_ms"] for r in serve),
        **{k: sum(r[k] for r in serve)
           for k in ("device_ms", "plain_device_ms", "library_device_ms")},
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    _say(f"  int8 serve, both chains summed: kernel={total['ms']:.4f} ms "
         f"(device {total['device_ms']:.4f}) library={total['library_ms']:.4f} ms "
         f"(device {total['library_device_ms']:.4f}) bound={total['bound_ms']:.4f} ms "
         f"({total['bound_by']}) design bound={max(d_ops, d_bytes):.4f} ms "
         f"({'operations' if d_ops >= d_bytes else 'bytes'})")
    return total, rows


def model_phase(model, cfg, dev):
    """Phase 4: fused and int8 against the module forward at
    [*MODEL_SHAPE, 9], and int8 against itself on a CPU copy of the model."""
    from ampnet_tpu_torch.models.backends import make_forward

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    pts = torch.randn(*MODEL_SHAPE, cfg.data.num_features, generator=gen, device=dev) * 0.5
    cent = pts[..., :2].mean(dim=2)
    xla = make_forward(model, cfg, "xla", device=dev)(pts, cent, None)
    fused = make_forward(model, cfg, "fused", device=dev)(pts, cent, None)
    torch.cuda.synchronize()
    want = (*MODEL_SHAPE, cfg.model.num_classes)
    if xla.shape != want or fused.shape != want:
        raise RuntimeError(f"logits {tuple(xla.shape)} / {tuple(fused.shape)}, want {want}")
    if not (torch.isfinite(xla).all() and torch.isfinite(fused).all()):
        raise RuntimeError("non-finite logits")
    diff = (fused - xla).abs().max().item()
    agree = (fused.argmax(-1) == xla.argmax(-1)).float().mean().item()
    _say(f"  fused vs xla, points {list(pts.shape)} -> logits {list(want)}: "
         f"max_abs_diff={diff:.3g} (<= 5e-3) "
         f"argmax agreement={agree:.6f} (> 0.999) |logits|max={xla.abs().max().item():.3g}")
    if not (diff <= 5e-3 and agree > 0.999):
        raise RuntimeError("backend fused does not track the module forward")

    int8 = make_forward(model, cfg, "int8", device=dev)(pts, cent, None)
    cpu_model = copy.deepcopy(model)  # make_forward moves the copy to the CPU
    int8_cpu = make_forward(cpu_model, cfg, "int8", device="cpu")(pts.cpu(), cent.cpu(), None)
    torch.cuda.synchronize()
    if int8.shape != want or int8_cpu.shape != want:
        raise RuntimeError(f"int8 logits {tuple(int8.shape)} / {tuple(int8_cpu.shape)}, "
                           f"want {want}")
    if not (torch.isfinite(int8).all() and torch.isfinite(int8_cpu).all()):
        raise RuntimeError("non-finite int8 logits")
    agree_xla = (int8.argmax(-1) == xla.argmax(-1)).float().mean().item()
    int8_cpu = int8_cpu.to(dev)
    agree_cpu = (int8.argmax(-1) == int8_cpu.argmax(-1)).float().mean().item()
    _say(f"  int8 vs xla: max_abs_diff={(int8 - xla).abs().max().item():.3g} "
         f"argmax agreement={agree_xla:.6f} (> 0.97); int8 vs int8 on the CPU (plain "
         f"chains): max_abs_diff={(int8 - int8_cpu).abs().max().item():.3g} "
         f"argmax agreement={agree_cpu:.6f} (>= 0.999)")
    if not (agree_xla > 0.97 and agree_cpu >= 0.999):
        raise RuntimeError("backend int8 does not track the module forward or its CPU path")


def _post(url, body: bytes, ctype: str, timeout: float = 600.0) -> bytes:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise RuntimeError(f"HTTP {r.status} from {url}")
        return r.read()


# kernel launches per bucket forward, by backend: fused runs all four encoder
# chains through fused_mlp_chain; int8 runs mlp_a and mlp_b through
# quantized_mlp_chain and the two T-Net trunks through fused_mlp_chain
LAUNCHES_PER_FORWARD = {
    "fused": {"fused_mlp_chain": 4, "quantized_mlp_chain": 0},
    "int8": {"fused_mlp_chain": 2, "quantized_mlp_chain": 2},
}


def serve_phase(model, cfg, backend: str, device: str = "cuda", ckpt=None):
    """Phase 5: the serve entry point answers concurrent clients with
    ``backend``. Returns (launches of each kernel counted while serving,
    bucket forwards dispatched, the labels served by cloud, the clouds). The
    clouds carry the model's ``num_features + extra_features`` columns. It
    serves ``model`` as a reference ``.pth`` (and the fused run also traces a
    warm round and prints the request breakdown), or the checkpoint directory
    ``ckpt`` when given (phase 10's geometry checkpoint)."""
    from ampnet_tpu_torch.cli.main import build_parser, make_server
    from ampnet_tpu_torch.core.weights import flax_variables, save_reference_pth
    from ampnet_tpu_torch.ops import cuda_build
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain
    from ampnet_tpu_torch.ops.quantized_mlp import quantized_mlp_chain

    wrappers = {"fused_mlp_chain": fused_mlp_chain, "quantized_mlp_chain": quantized_mlp_chain}

    rng = np.random.default_rng(SEED)
    clouds = []
    for n in SERVE_CLOUD_POINTS:
        c = rng.normal(size=(n, cfg.data.num_features + cfg.data.extra_features)).astype(
            np.float32) * 0.5
        c[:, :2] = rng.uniform(-1.0, 1.0, size=(n, 2))
        clouds.append(c)
    # (client, clouds, wire): 5 binary requests and 1 JSON request from 3
    # clients; the JSON one carries a 50k- and a 20k-point cloud, so one
    # micro-batch holds two bucket shapes, launched from two threads
    plan = [(0, (0,), "binary"), (0, (1,), "binary"), (1, (2,), "binary"),
            (1, (3, 5), "json"), (2, (4,), "binary"), (2, (6,), "binary")]

    # request bodies, encoded once: the clients share this process with the
    # server, and encoding 70k points as JSON would hold its interpreter
    bodies = [(clouds[cis[0]].tobytes(), "application/octet-stream") if wire == "binary"
              else (json.dumps({"clouds": [clouds[ci].tolist() for ci in cis]}).encode(),
                    "application/json")
              for _, cis, wire in plan]

    cuda_build.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD) as tmp:
        details = ckpt is None
        if details:
            ckpt = os.path.join(tmp, "smoke_attention.pth")
            save_reference_pth(flax_variables(model), ckpt,
                               meta={"number_of_points": cfg.data.n_points})
        args = build_parser().parse_args([
            "serve", "--model_checkpoint", ckpt, "--backend", backend,
            "--device", device, "--host", "127.0.0.1", "--port", "0",
        ])
        server = make_server(args)
        thread = threading.Thread(target=server.httpd.serve_forever, daemon=True)
        thread.start()
        inferencer = server.service.inferencer
        # record what each micro-batch dispatched and what it fetched: the
        # reference for an answer is predict_many on that same micro-batch
        calls, fetched = [], {}
        dispatch, fetch = inferencer.dispatch_many, inferencer.fetch_many

        def record_dispatch(batch, seeds=None, return_probs=False, **kw):
            handle = dispatch(batch, seeds, return_probs, **kw)
            calls.append(([c.copy() for c in batch], list(seeds), return_probs, handle))
            return handle

        def record_fetch(handle):
            out = fetch(handle)
            fetched[id(handle)] = out
            return out

        inferencer.dispatch_many, inferencer.fetch_many = record_dispatch, record_fetch
        try:
            host, port = server.address
            url = f"http://{host}:{port}"
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                _say(f"  healthz: {r.read().decode()}")

            def run_clients():
                """Every client's requests, 3 clients at once → (labels by
                cloud, wall seconds)."""
                served, errors = {}, []

                def client(cid):
                    try:
                        for (c, cis, wire), req in zip(plan, bodies):
                            if c != cid:
                                continue
                            body = _post(url + "/v1/predict", *req)
                            if wire == "binary":
                                served[cis[0]] = np.frombuffer(body, np.int8).astype(np.int32)
                            else:
                                for ci, labels in zip(cis, json.loads(body)["labels"]):
                                    served[ci] = np.asarray(labels, np.int32)
                    except Exception as e:  # reported and failed below
                        errors.append(f"client {cid}: {e!r}")

                t0 = time.perf_counter()
                clients = [threading.Thread(target=client, args=(i,)) for i in range(3)]
                for t in clients:
                    t.start()
                for t in clients:
                    t.join(timeout=900)
                if errors or any(t.is_alive() for t in clients):
                    raise RuntimeError(f"serving clients failed: {errors or 'timed out'}")
                return served, time.perf_counter() - t0

            for fn in wrappers.values():  # the main path's run starts here
                fn.launches = 0
            served, wall = run_clients()
            launches = {name: fn.launches for name, fn in wrappers.items()}  # ... and ends here
            inferencer.dispatch_many, inferencer.fetch_many = dispatch, fetch
            with urllib.request.urlopen(url + "/v1/stats", timeout=60) as r:
                stats = json.loads(r.read())
            _say(f"  backend {backend}: served {len(plan)} requests ({sum(SERVE_CLOUD_POINTS)} "
                 f"points in {len(clouds)} clouds) from 3 clients in {wall:.3f} s")
            _say("  stats: " + json.dumps(stats))

            # one forward per bucket of each dispatched micro-batch
            forwards = sum(len(h["pending"]) for *_, h in calls)
            _say("  micro-batches (clouds per bucket): "
                 + json.dumps([[len(idxs) for idxs, _ in h["pending"]] for *_, h in calls]))
            for name, per in LAUNCHES_PER_FORWARD[backend].items():
                if launches[name] != per * forwards:
                    raise RuntimeError(f"{name} launched {launches[name]} times while serving "
                                       f"{forwards} bucket forwards; want {per * forwards}")
            if not any(len(h["pending"]) > 1 for *_, h in calls):
                raise RuntimeError("no micro-batch held two bucket shapes")
            check_served(inferencer, cfg, clouds, served, calls, fetched)
            _say("  launches while serving: " + ", ".join(
                f"{name} {launches[name]} (= {per} x {forwards} bucket forwards)"
                for name, per in LAUNCHES_PER_FORWARD[backend].items()))
            if backend == "fused" and details:
                round_ = warm_round(run_clients, served, inferencer)
                _say("  breakdown: " + json.dumps(request_breakdown(inferencer, clouds[:4],
                                                                    round_)))
        finally:
            inferencer.dispatch_many, inferencer.fetch_many = dispatch, fetch
            server.close()
            thread.join(timeout=60)
    return launches, forwards, served, clouds


def warm_round(run_clients, served, inferencer, tries=3) -> dict:
    """The same traffic again with the card traced (kernel activity only):
    the share of the round's wall time in which no kernel ran (and its wall
    and busy ms, and the kernels run). A round is warm when it ran no new
    bucket shape (a micro-batch's size depends on arrival times, and a new
    padded size captures a graph); up to ``tries`` rounds are run until one
    is, and the new shapes of each are reported."""
    from torch.profiler import ProfilerActivity, profile

    new_shapes = []
    for _ in range(tries):
        cold = inferencer.cold_programs_seen
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again, wall = run_clients()
            torch.cuda.synchronize()
        new_shapes.append(inferencer.cold_programs_seen - cold)
        if not new_shapes[-1]:
            break
    if sorted(again) != sorted(served) or any(again[c].shape != served[c].shape for c in served):
        raise RuntimeError("the warm round's answers do not cover the same clouds")
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    idle = f"{1.0 - busy / (wall * 1e3):.4f}" if busy > 0 else "not measured"
    _say(f"  warm round, traced: {sum(SERVE_CLOUD_POINTS)} points from 3 clients in "
         f"{wall * 1e3:.2f} ms; device busy {busy:.2f} ms; idle share {idle}; "
         f"{sum(e.count for e in kernels)} kernels; new shapes by round {new_shapes}")
    return {"points": sum(SERVE_CLOUD_POINTS), "clients": 3, "wall_ms": wall * 1e3,
            "device_busy_ms": busy, "idle_share": idle,
            "kernels": sum(e.count for e in kernels), "new_shapes_by_round": new_shapes}


def check_served(inferencer, cfg, clouds, served, calls, fetched):
    """Every served answer equals what its micro-batch fetched, and each
    micro-batch's labels equal a direct ``predict_many`` on the same clouds
    and seeds. Also prints how far each cloud's labels, served within a
    micro-batch, agree with the cloud predicted alone (fp32 sums may run in
    another order at another batch size)."""
    if sorted(served) != list(range(len(clouds))):
        raise RuntimeError(f"answers for clouds {sorted(served)}, want 0..{len(clouds) - 1}")
    by_cloud = {}
    for batch, seeds, probs, handle in calls:
        if probs or id(handle) not in fetched:
            raise RuntimeError("a micro-batch asked for probabilities or was never fetched")
        direct = inferencer.predict_many(batch, seeds=seeds)
        for cloud, got, want in zip(batch, fetched[id(handle)], direct):
            if not np.array_equal(got, want):
                raise RuntimeError(f"a served micro-batch differs from predict_many on the "
                                   f"same clouds ({(got != want).sum()} of {want.size})")
            ci = next(i for i, c in enumerate(clouds) if c.shape == cloud.shape
                      and np.array_equal(c, cloud))
            by_cloud[ci] = got
    agree = []
    for ci, labels in sorted(served.items()):
        want = by_cloud.get(ci)
        if want is None or not np.array_equal(labels, want):
            raise RuntimeError(f"cloud {ci}: the answer differs from its micro-batch's labels")
        if labels.min() < 0 or labels.max() >= cfg.model.num_classes:
            raise RuntimeError(f"cloud {ci}: labels outside 0..{cfg.model.num_classes - 1}")
        alone = inferencer.predict_many([clouds[ci]], seeds=[0])[0]
        agree.append(float((labels == alone).mean()))
    _say("  every answer equals predict_many on its micro-batch; label agreement "
         "with each cloud predicted alone: " + json.dumps(agree))


def request_breakdown(inferencer, clouds, round_) -> dict:
    """Where a warm served request's time goes, in ms: ``dispatch_many``
    must return without a host sync (CUDA sync debug mode raises on one), so
    its host time is the enqueue cost; the tiling and the forward of one
    cloud are then timed alone (eagerly, as the bucket's graph captured
    them), the int8 forward of the same windows beside the served one, and
    a request of one cloud beside one of ``len(clouds)`` clouds in one
    bucket: host enqueue beside device span (CUDA events), the kernels'
    summed device time and the host's kernel and copy enqueues from
    torch.profiler. ``round_`` (``warm_round``) joins the line."""
    from torch.profiler import ProfilerActivity, profile

    from ampnet_tpu_torch.infer.tiled import KMEANS_FEATURE_IDX
    from ampnet_tpu_torch.models.backends import make_forward
    from ampnet_tpu_torch.ops.kmeans import balanced_kmeans, num_tiles_test

    dev = inferencer.device
    cloud = clouds[0]
    n = cloud.shape[0]
    k = num_tiles_test(n, inferencer.n_points, inferencer.max_clusters)
    cap = inferencer._cap_for(n, k)
    out = {"points": n, "k": k, "cap": cap}

    # every shape warm first: a bucket graph's capture synchronizes the card once
    inferencer.predict_many(list(clouds), seeds=[0] * len(clouds))
    inferencer.predict_many([cloud], seeds=[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        handle = inferencer.dispatch_many(list(clouds), seeds=[0] * len(clouds))
        out[f"dispatch_host_ms_x{len(clouds)}"] = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t0 = time.perf_counter()
    inferencer.fetch_many(handle)
    out[f"fetch_wait_ms_x{len(clouds)}"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        handle = inferencer.dispatch_many([cloud], seeds=[0])
        out["dispatch_host_ms_x1"] = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    inferencer.fetch_many(handle)

    rows = np.concatenate([cloud, cloud[np.random.default_rng(0).integers(0, n, k * cap - n)]])
    feats = torch.from_numpy(rows[:, list(KMEANS_FEATURE_IDX)]).to(dev)
    windows = torch.from_numpy(rows).to(dev).reshape(1, k, cap, -1)
    cent = windows[..., :2].mean(dim=2)
    int8_forward = make_forward(inferencer.models[0], inferencer.cfg, "int8", device=dev)
    requests = {
        "request_x1": lambda: inferencer.predict_many([cloud], seeds=[0]),
        f"request_x{len(clouds)}": lambda: inferencer.predict_many(
            list(clouds), seeds=[0] * len(clouds)),
    }
    parts = {
        "tiling": lambda: balanced_kmeans(
            feats, k, generator=torch.Generator(device=dev).manual_seed(0),
            capacities=(cap,) * k),
        "forward": lambda: inferencer._forwards_on[dev][0](windows, cent, None),
        "forward_int8": lambda: int8_forward(windows, cent, None),
        **requests,
    }
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        t1 = time.perf_counter()
        end.synchronize()
        t2 = time.perf_counter()
        out[name] = {"host_enqueue_ms": (t1 - t0) * 1e3, "wall_ms": (t2 - t0) * 1e3,
                     "device_span_ms": start.elapsed_time(end)}
    # the kernels' device time beside the span: a span that follows the host
    # enqueue shows a launch-bound part
    for name in (*requests, "forward", "forward_int8"):
        fn = parts[name]
        for _ in range(3):  # a trace of a short call sometimes comes back without device events
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            if kernels:
                break
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        out[name]["kernel_launches"] = sum(e.count for e in kernels)
        out[name]["device_busy_ms"] = busy if busy > 0 else "not measured"
        host = {e.key: e.count for e in prof.key_averages()
                if e.device_type.name == "CPU" and e.key.startswith("cu")}
        out[name]["host_enqueues"] = enqueues(host)
        out[name]["graph_launches"] = host.get("cudaGraphLaunch", 0)
        top = {}
        for e in kernels:  # kernels whose names share 60 characters are summed
            top[e.key[:60]] = top.get(e.key[:60], 0.0) + e.self_device_time_total / 1e3
        out[name]["top_kernels_ms"] = dict(sorted(top.items(), key=lambda kv: -kv[1])[:8])
    out["warm_round"] = round_
    return out


# the training phase's data: clouds of 9 windows x 2048 points, 13 columns
TRAIN_CLOUDS, VAL_CLOUDS = 96, 32
TRAIN_WINDOWS, TRAIN_POINTS = 9, 2048
STEP_BATCH = 4  # clouds in the card-against-CPU step
TRAIN_BATCH = 32  # clouds per step of the train command and the train: line
# Adam's first update is about lr * sign(g): where |g| is rounding noise, its
# sign and the parameter it moves are not determined (tests/test_torch_train.py)
GRAD_NOISE = 1e-7


def class_thresholds(rng):
    """The seeded (tower, line, vegetation, high vegetation) thresholds of z
    and NDVI that decide a point's raw class: the first four draws of ``rng``."""
    return (rng.uniform(0.55, 0.75), rng.uniform(0.3, 0.45), rng.uniform(0.4, 0.6),
            rng.uniform(0.15, 0.3))


def raw_class(z, ndvi, thresholds):
    """Raw class ids from z and NDVI: high and low vegetation (5, 3) above the
    NDVI threshold, else tower (15), lines (14) or background (1) by height."""
    t_tower, t_line, t_veg, t_high = thresholds
    return np.where(ndvi >= t_veg, np.where(z > t_high, 5, 3),
                    np.where(z > t_tower, 15, np.where(z > t_line, 14, 1)))


def write_learnable_dataset(folder, seed=SEED):
    """``kmeans_<name>.pt`` artifacts ``[N, 13, W]`` and the split lists. Each
    window has its own x/y extent, height range and NDVI level; the raw class
    is a seeded function of z and NDVI (tower, lines, low and high vegetation,
    background), so the task can be learnt."""
    from ampnet_tpu_torch.data.io_utils import save_cloud, write_split_list

    rng = np.random.default_rng(seed)
    thresholds = class_thresholds(rng)
    names = []
    n, w = TRAIN_POINTS, TRAIN_WINDOWS
    for i in range(TRAIN_CLOUDS + VAL_CLOUDS):
        pc = np.empty((n, 13, w), np.float32)
        lo = rng.uniform(0.0, 0.4, size=(2, w))
        hi = lo + rng.uniform(0.3, 0.6, size=(2, w))
        pc[:, 0:2] = lo + (hi - lo) * rng.uniform(size=(n, 2, w))
        pc[:, 2] = rng.uniform(size=(n, w)) * rng.uniform(0.2, 1.0, size=w)
        ndvi_level = rng.uniform(0.1, 0.9, size=w)
        pc[:, 9] = np.clip(ndvi_level + 0.25 * rng.normal(size=(n, w)), 0.0, 1.0)
        pc[:, 4:9] = rng.uniform(size=(n, 5, w)) * rng.uniform(0.3, 1.0, size=(5, w))
        pc[:, 10:13] = rng.uniform(0, 100, size=(n, 3, w))
        pc[:, 3] = raw_class(pc[:, 2], pc[:, 9], thresholds)
        save_cloud(os.path.join(folder, f"kmeans_cloud{i:03d}.pt"), pc)
        names.append(f"cloud{i:03d}.pkl")
    write_split_list(os.path.join(folder, "train_seg_files.txt"), names[:TRAIN_CLOUDS])
    write_split_list(os.path.join(folder, "val_seg_files.txt"), names[TRAIN_CLOUDS:])
    return names


def step_batch(folder, names, dev, batch=STEP_BATCH, extra=0):
    """The first ``batch`` train clouds as one batch on ``dev``, with the 9
    model features and ``extra`` geometric columns."""
    from ampnet_tpu_torch.data.datasets import WindowedCloudDataset
    from ampnet_tpu_torch.data.pipeline import PaddedBatcher, to_device_batch

    b = PaddedBatcher(WindowedCloudDataset(folder, names[:batch], extra_features=extra), batch,
                      n_points=TRAIN_POINTS, max_windows=TRAIN_WINDOWS, shuffle=False)
    return to_device_batch(next(iter(b)), dev)


def biases_before_batch_norm(model) -> set:
    """Names of the dense biases that feed a batch-statistics BatchNorm
    (``dense`` → ``bn``, ``fc_i`` → ``fc_bn_i`` or ``bn_i``, ``head_i`` /
    ``dense_i`` → ``bn_i``): the normalisation removes them, so their exact
    gradient is 0 and rounding alone decides its sign."""
    from ampnet_tpu_torch.models.layers import MaskedBatchNorm

    out = set()
    for prefix, mod in model.named_modules():
        kids = dict(mod.named_children())
        for name, kid in kids.items():
            if not isinstance(kid, torch.nn.Linear) or kid.bias is None:
                continue
            head, _, idx = name.rpartition("_")
            bns = ["bn"] if name == "dense" else [f"fc_bn_{idx}", f"bn_{idx}"] if head else []
            if any(isinstance(kids.get(b), MaskedBatchNorm) for b in bns):
                out.add(f"{prefix}.{name}.bias" if prefix else f"{name}.bias")
    return out


def step_on_card_and_cpu(model, cfg, batch, dev, dtype, step=None, step_for=None) -> dict:
    """One train_step (``step``, else the segmentation step, else
    ``step_for(device, dtype)``'s step for each side, as a distilling step
    needs its teachers there) in ``dtype`` on the card and on a CPU copy of
    ``model``, same batch: how far loss,
    gradients, parameters and BatchNorm statistics land apart. A parameter
    entry's sign is determined where the CPU's |g| exceeds max(GRAD_NOISE,
    1e-4 of its parameter's largest |g|); a bias that feeds a
    batch-statistics BatchNorm (``biases_before_batch_norm``) has no
    determined entry, and its largest |g| is reported as
    ``cancelled_bias_grad_max``."""
    from ampnet_tpu_torch.train.state import create_train_state
    from ampnet_tpu_torch.train.step import make_step_fns

    if step_for is not None:
        steps = {"card": step_for(dev, dtype), "cpu": step_for(torch.device("cpu"), dtype)}
    else:
        step = step or make_step_fns(cfg, augment=False)[0]
        steps = {"card": step, "cpu": step}
    states = {"card": create_train_state(cfg, copy.deepcopy(model).to(dev, dtype), 1, dev),
              "cpu": create_train_state(cfg, copy.deepcopy(model).to("cpu", dtype), 1, "cpu")}
    cast = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    t0 = time.perf_counter()
    loss = {"card": float(steps["card"](states["card"], cast)["loss"])}
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss["cpu"] = float(steps["cpu"](states["cpu"], {k: v.cpu() for k, v in cast.items()})["loss"])
    cpu_s = time.perf_counter() - t0
    out = {"loss_card": loss["card"], "loss_cpu": loss["cpu"],
           "loss_rel_err": abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"]),
           "grad_err_of_max": 0.0, "param_err": 0.0, "params_beyond_1e-4": 0,
           "params_determined": 0, "undetermined_param_diff": 0.0, "noise_grad_max": 0.0,
           "cancelled_bias_grad_max": 0.0}
    cpu_params = dict(states["cpu"].model.named_parameters())
    cancelled = biases_before_batch_norm(states["cpu"].model)
    for name, p in states["card"].model.named_parameters():
        q = cpu_params[name]
        g, g_ref = p.grad.cpu().double(), q.grad.double()
        scale = g_ref.abs().max().item()
        if name in cancelled:  # zero in exact arithmetic, whatever rounding leaves
            out["cancelled_bias_grad_max"] = max(out["cancelled_bias_grad_max"],
                                                 g.abs().max().item(), scale)
        elif scale < GRAD_NOISE:  # exactly zero in exact arithmetic: noise on both
            out["noise_grad_max"] = max(out["noise_grad_max"], g.abs().max().item(), scale)
        else:
            err = (g - g_ref).abs().max().item() / scale
            if err > out["grad_err_of_max"]:
                out["grad_err_of_max"], out["grad_err_worst"] = err, name
        determined = g_ref.abs() > max(GRAD_NOISE, 1e-4 * scale)
        if name in cancelled:
            determined = torch.zeros_like(determined)
        d = (p.detach().cpu().double() - q.detach().double()).abs()
        out["params_determined"] += int(determined.sum())
        if determined.any():
            out["param_err"] = max(out["param_err"], d[determined].max().item())
            out["params_beyond_1e-4"] += int((d[determined] > 1e-4).sum())
        if (~determined).any():
            out["undetermined_param_diff"] = max(out["undetermined_param_diff"],
                                                 d[~determined].max().item())
    out["bn_stats_err"] = max((a.cpu() - b).abs().max().item() for (_, a), (_, b) in zip(
        states["card"].model.named_buffers(), states["cpu"].model.named_buffers()))
    out.update(card_step_s=card_s, cpu_step_s=cpu_s, lr=states["cpu"].schedule(0))
    return out


def card_against_cpu_step(cfg, batch, dev, model=None, step=None, what="",
                          off_share=1e-4, step_for=None) -> dict:
    """(b): one train_step on the card against the same step on a CPU copy,
    same weights and batch, dropout 0, no augmentation.

    float64 holds the step itself: the loss to 1e-5 relative, each gradient
    to 1e-4 of its parameter's largest, each determined parameter entry to
    1e-4. float32, the path training runs, is held to the loss (1e-5
    relative), every parameter within the two updates' reach (2 lr), at most
    ``off_share`` (1e-4) of the determined entries beyond 1e-4, and gradients
    within 5e-2 of their max: each max-pool routes a channel's gradient to
    one of 2048 points, and near-ties fall to another point under another
    summation order (PERF.md §6 has the measured spread;
    tests/test_torch_train.py holds float32 to 1e-4 at 64 points a window,
    against JAX). ``model`` (else the seeded flagship) and ``step`` (else the
    segmentation step) serve the other families; ``step_for`` a step that
    differs by device (``step_on_card_and_cpu``)."""
    model = (model or seeded_model(cfg)).train()
    res = {}
    for name, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        r = step_on_card_and_cpu(model, cfg, batch, dev, dtype, step, step_for)
        res[name] = r
        _say(f"  {what}card step against CPU step, {name}, batch "
             f"{list(batch['points'].shape)}: " + json.dumps(r))
        reach = 2 * r["lr"] * (1 + 1e-5)
        common = (r["loss_rel_err"] <= 1e-5 and r["undetermined_param_diff"] <= reach
                  and r["noise_grad_max"] <= 10 * GRAD_NOISE)
        if name == "float64":
            ok = common and r["grad_err_of_max"] <= 1e-4 and r["param_err"] <= 1e-4
        else:
            ok = (common and r["grad_err_of_max"] <= 5e-2 and r["param_err"] <= reach
                  and r["params_beyond_1e-4"] <= off_share * r["params_determined"])
        if not ok:
            raise RuntimeError(f"the card's {what}{name} train step does not match the CPU's")
    return res


def train_csv_rows(out_dir) -> dict:
    """{epoch: {tag: value}} of the attention segmenter's train CSV under
    ``out_dir``."""
    rows = {}
    with open(os.path.join(out_dir, "logs", "attention_segmentation_train", "scalars.csv")) as f:
        for line in f.read().splitlines()[1:]:
            _, step_, tag, value = line.split(",")
            rows.setdefault(int(step_), {})[tag] = float(value)
    return rows


def train_cli(data_dir, out_dir, dev) -> dict:
    """(c): the train command line at full width on the card, 2 epochs."""
    from ampnet_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["train", data_dir, "--path_list_files", data_dir, "--out_path", out_dir,
                       "--device", str(dev), "--epochs", "2", "--batch_size", str(TRAIN_BATCH),
                       "--seed", str(SEED)])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    if rc != 0:
        raise RuntimeError(f"train exited {rc}: {text[-2000:]}")
    summary = json.loads(text[text.index("{"): text.rindex("}") + 1])
    rows = train_csv_rows(out_dir)
    ckpt = os.path.join(out_dir, "checkpoints", "attention_segmentation_best")
    losses = [rows[e]["loss"] for e in sorted(rows) if "loss" in rows[e]]
    out = {"wall_s": wall, "train_loss": losses,
           "epoch_seconds": [rows[e]["epoch_seconds"] for e in sorted(rows) if "loss" in rows[e]],
           "windows_per_sec": [rows[e]["windows_per_sec"] for e in sorted(rows)
                               if "loss" in rows[e]],
           "val_loss": summary.get("loss"), "val_miou": summary.get("miou")}
    _say(f"  train CLI, 2 epochs at batch {TRAIN_BATCH} x {TRAIN_WINDOWS} x {TRAIN_POINTS}: "
         + json.dumps(out))
    if len(losses) != 2 or not all(np.isfinite(losses)) or not np.isfinite(summary["loss"]):
        raise RuntimeError(f"train losses {losses}, val {summary.get('loss')}")
    if not all(os.path.exists(os.path.join(ckpt, f)) for f in ("meta.json", "state.pt")):
        raise RuntimeError(f"no best checkpoint in {ckpt}")
    return out


def overfit_one_batch(cfg, batch, dev) -> float:
    """(d): 10 steps on one batch, no augmentation: last loss / first loss."""
    from ampnet_tpu_torch.train.state import create_train_state
    from ampnet_tpu_torch.train.step import make_step_fns

    state = create_train_state(cfg, seeded_model(cfg).train(), 1, dev)
    step, _ = make_step_fns(cfg, augment=False)
    losses = torch.stack([step(state, batch)["loss"] for _ in range(10)]).tolist()
    ratio = losses[-1] / losses[0]
    _say(f"  10 steps on one batch: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
         f"(ratio {ratio:.4f}): " + json.dumps(losses))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError("the loss did not fall on a fixed batch")
    return ratio


def resume_bitwise(cfg, data_dir, out_dir, names, dev):
    """(e): the best checkpoint restored into a fresh Trainer, bitwise."""
    from ampnet_tpu_torch.core.checkpoint import payload, read_payload
    from ampnet_tpu_torch.data.datasets import WindowedCloudDataset
    from ampnet_tpu_torch.data.pipeline import PaddedBatcher
    from ampnet_tpu_torch.models.amp import AMPNetSegmenter
    from ampnet_tpu_torch.train.trainer import Trainer

    batcher = PaddedBatcher(WindowedCloudDataset(data_dir, names[:TRAIN_CLOUDS]), TRAIN_BATCH,
                            n_points=TRAIN_POINTS, max_windows=TRAIN_WINDOWS)
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(cfg, AMPNetSegmenter(cfg.model), batcher, None, out_dir,
                          name="attention_segmentation", device=dev)
    try:
        if not trainer.resume():
            raise RuntimeError("resume found no best checkpoint")
        saved = read_payload(trainer.ckpt.path("attention_segmentation_best"))
        restored = payload(trainer.state.snapshot(copy=False))
        n = 0

        def same(a, b, where):
            nonlocal n
            for k in a:
                if isinstance(a[k], dict):
                    same(a[k], b[k], f"{where}/{k}")
                elif not (a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])):
                    raise RuntimeError(f"restored {where}/{k} differs from the checkpoint")
                else:
                    n += 1
        same(saved, restored, "")
        _say(f"  resume: {n} tensors (params, batch_stats, Adam count/mu/nu, step, epoch, "
             f"lr_scale) bitwise equal to state.pt; step {trainer.state.step}, "
             f"epoch {trainer.state.epoch}")
    finally:
        trainer.close()


def serve_trained(ckpt, dev):
    """(f): the trained checkpoint directory through ``serve --backend fused``;
    one 50,000-point request against ``predict_many`` on the restored model.
    Returns the fused_mlp_chain launches counted while serving it."""
    from ampnet_tpu_torch.cli.main import build_parser, make_server
    from ampnet_tpu_torch.core.checkpoint import load_model
    from ampnet_tpu_torch.infer.tiled import TiledInferencer
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain

    rng = np.random.default_rng(SEED + 5)
    cloud = rng.normal(size=(50_000, 9)).astype(np.float32) * 0.5
    cloud[:, :2] = rng.uniform(-1.0, 1.0, size=(50_000, 2))
    server = make_server(build_parser().parse_args([
        "serve", "--model_checkpoint", ckpt, "--backend", "fused", "--device", str(dev),
        "--host", "127.0.0.1", "--port", "0"]))
    thread = threading.Thread(target=server.httpd.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.address
        fused_mlp_chain.launches = 0  # the served request's run starts here
        labels = np.frombuffer(_post(f"http://{host}:{port}/v1/predict", cloud.tobytes(),
                                     "application/octet-stream"), np.int8).astype(np.int32)
        launches = fused_mlp_chain.launches  # ... and ends here
    finally:
        server.close()
        thread.join(timeout=60)
    cfg, model = load_model(ckpt, dev)
    want = TiledInferencer(model, cfg, backend="fused", device=dev).predict_many(
        [cloud], seeds=[0])[0]
    _say(f"  served the trained checkpoint: {cloud.shape[0]} points, labels "
         f"{np.bincount(labels, minlength=cfg.model.num_classes).tolist()}, "
         f"{launches} fused_mlp_chain launches for 1 bucket forward")
    if launches != LAUNCHES_PER_FORWARD["fused"]["fused_mlp_chain"]:
        raise RuntimeError(f"fused_mlp_chain launched {launches} times for one bucket forward")
    if not np.array_equal(labels, want):
        raise RuntimeError(f"served labels differ from predict_many ({(labels != want).sum()})")
    return launches


def step_parts_ms(state, cfg, data, idx, pad) -> dict:
    """Device ms of one train step's parts (CUDA events): the gather from the
    cache, the augmentation, forward + loss, backward, the Adam update. The
    same calls ``make_step_fns``'s step makes, cut at the part boundaries."""
    from ampnet_tpu_torch.data.device_cache import gather_batch
    from ampnet_tpu_torch.train.losses import orthogonality_regularizer, weighted_cross_entropy
    from ampnet_tpu_torch.train.step import augment_batch, window_pad_mask_from_labels

    t = cfg.train
    cw = torch.tensor(t.class_weights, dtype=torch.float32, device=state.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    batch = gather_batch(data, idx, pad)
    ev[1].record()
    gen = state.step_generator()
    aug = augment_batch(batch, t.augmentations, gen)
    ev[2].record()
    state.optimizer.zero_grad(set_to_none=True)
    logits, t_feat, _ = state.model(aug["points"], aug["centroids"],
                                    window_pad_mask_from_labels(aug["labels"]), generator=gen)
    loss = (weighted_cross_entropy(logits, aug["labels"], cw, t.ignore_index)
            + t.reg_weight * orthogonality_regularizer(t_feat))
    ev[3].record()
    loss.backward()
    ev[4].record()
    state.apply_gradients()
    ev[5].record()
    torch.cuda.synchronize()
    parts = ("gather", "augment", "forward_and_loss", "backward", "adam")
    return {p: ev[i].elapsed_time(ev[i + 1]) for i, p in enumerate(parts)}


def train_line(cfg, data_dir, names, dev, card):
    """(g): 3 warm steps at batch TRAIN_BATCH x 9 x 2048 (default recipe, dropout 0.3)
    from the device cache: host step ms, device busy ms and idle share from
    torch.profiler, the top device operations, windows/s, peak memory; then
    the step's parts on CUDA events and the checkpoint layer's host times."""
    from torch.profiler import ProfilerActivity, profile

    from ampnet_tpu_torch.core.checkpoint import CheckpointManager
    from ampnet_tpu_torch.data.datasets import WindowedCloudDataset
    from ampnet_tpu_torch.data.device_cache import DeviceCachedBatcher, gather_batch
    from ampnet_tpu_torch.data.pipeline import PaddedBatcher
    from ampnet_tpu_torch.train.state import create_train_state
    from ampnet_tpu_torch.train.step import make_step_fns

    cache = DeviceCachedBatcher(PaddedBatcher(
        WindowedCloudDataset(data_dir, names[:TRAIN_CLOUDS]), TRAIN_BATCH,
        n_points=TRAIN_POINTS, max_windows=TRAIN_WINDOWS), dev)
    idxs, pads, _ = cache.epoch_index_matrix()
    batch = gather_batch(cache.data, torch.from_numpy(idxs[0]).to(dev),
                         torch.from_numpy(pads[0]).to(dev))
    state = create_train_state(cfg, seeded_model(cfg).train(), len(cache), dev)
    step, _ = make_step_fns(cfg)
    for _ in range(2):  # warm: allocator, cuBLAS plans
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        m = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = {}
    for e in kernels:
        top[e.key[:60]] = top.get(e.key[:60], 0.0) + e.self_device_time_total / 1e3 / 3
    windows = int(batch["points"].shape[0] * batch["points"].shape[1])
    idx0, pad0 = torch.from_numpy(idxs[0]).to(dev), torch.from_numpy(pads[0]).to(dev)
    runs = [step_parts_ms(state, cfg, cache.data, idx0, pad0) for _ in range(3)]
    parts = {k: sum(r[k] for r in runs) / 3 for k in runs[0]}
    # the checkpoint layer: a device snapshot (enqueue) and a synchronous save
    ckpt = CheckpointManager(os.path.join(data_dir, "ckpt_timing"))
    t0 = time.perf_counter()
    snap = state.snapshot(copy=True)
    parts["snapshot_enqueue_ms_host"] = (time.perf_counter() - t0) * 1e3
    del snap
    t0 = time.perf_counter()
    ckpt.save("timing", state, config_json=cfg.to_json())
    parts["checkpoint_save_ms_host"] = (time.perf_counter() - t0) * 1e3
    out = {
        "card": card, "batch": list(batch["points"].shape), "step_ms_host": step_ms,
        "traced_step_ms": traced_ms / 3,
        "device_busy_ms_per_step": busy / 3 if busy > 0 else "not measured",
        "idle_share": 1.0 - busy / traced_ms if busy > 0 else "not measured",
        "device_ops_per_step": sum(e.count for e in kernels) / 3,
        "windows_per_sec": windows / (step_ms / 1e3),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "loss": float(m["loss"]),
        "step_parts_device_ms": parts,
        "top_device_ops_ms_per_step": dict(sorted(top.items(), key=lambda kv: -kv[1])[:10]),
    }
    _say("train: " + json.dumps(out))
    return out


def train_phase(dev, card, work) -> tuple:
    """Phase 6: the training slice (a)-(g) in the directory ``work`` →
    (fused_mlp_chain launches counted while serving the trained checkpoint,
    the checkpoint directory)."""
    import gc

    from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig

    cfg = AMPNetConfig()
    t_phase = time.perf_counter()
    data_dir, out_dir = os.path.join(work, "data"), os.path.join(work, "out")
    os.makedirs(data_dir)
    t0 = time.perf_counter()
    names = write_learnable_dataset(data_dir)
    _say(f"  (a) wrote {len(names)} clouds of {TRAIN_WINDOWS} x {TRAIN_POINTS} points in "
         f"{time.perf_counter() - t0:.2f} s")
    no_drop = AMPNetConfig(model=ModelConfig(dropout=0.0))
    batch = step_batch(data_dir, names, dev)
    _say("  (b)")
    card_against_cpu_step(no_drop, batch, dev)
    _say("  (c)")
    train_cli(data_dir, out_dir, dev)
    _say("  (d)")
    overfit_one_batch(cfg, batch, dev)
    _say("  (e)")
    resume_bitwise(cfg, data_dir, out_dir, names, dev)
    _say("  (f)")
    ckpt = os.path.join(out_dir, "checkpoints", "attention_segmentation_best")
    launches = serve_trained(ckpt, dev)
    gc.collect()
    torch.cuda.empty_cache()
    _say("  (g)")
    train_line(cfg, data_dir, names, dev, card)
    _say(f"  train phase: {time.perf_counter() - t_phase:.2f} s")
    return launches, ckpt


EVAL_CLOUD_POINTS = (50_000, 50_000, 20_000, 20_000)  # k = 18 and k = 9, cap 4096
# kernel launches per bucket forward of each evaluate run (a stacked ensemble
# of M members launches M times the single model's)
EVAL_RUNS = {
    "test_fused": LAUNCHES_PER_FORWARD["fused"],
    "test_ensemble": {k: 2 * v for k, v in LAUNCHES_PER_FORWARD["fused"].items()},
    "test_int8": LAUNCHES_PER_FORWARD["int8"],
    "infer_fused": LAUNCHES_PER_FORWARD["fused"],
    "test_tta": LAUNCHES_PER_FORWARD["fused"],
}


def write_eval_clouds(folder, seed=SEED):
    """Raw 13-column ``.pkl`` clouds (x, y in [0, 1]; height range and NDVI
    level vary over the cloud) with phase 6's raw class of z and NDVI, and a
    ``test_seg_files.txt`` listing them in file-name order."""
    from ampnet_tpu_torch.data.io_utils import save_cloud, write_split_list

    thresholds = class_thresholds(np.random.default_rng(seed))  # phase 6's
    rng = np.random.default_rng(seed + 7)
    names = []
    for i, n in enumerate(EVAL_CLOUD_POINTS):
        pc = np.empty((n, 13), np.float32)
        pc[:, 0:2] = rng.uniform(size=(n, 2))
        fx, fy, phase = rng.uniform(1.0, 3.0), rng.uniform(1.0, 3.0), rng.uniform(0, 2 * np.pi)
        wave = np.sin(2 * np.pi * fx * pc[:, 0] + phase) * np.cos(2 * np.pi * fy * pc[:, 1])
        pc[:, 2] = rng.uniform(size=n) * (0.6 + 0.4 * wave)
        pc[:, 9] = np.clip(0.5 + 0.4 * wave + 0.25 * rng.normal(size=n), 0.0, 1.0)
        pc[:, 4:9] = rng.uniform(size=(n, 5)) * rng.uniform(0.3, 1.0, size=5)
        pc[:, 10:13] = rng.uniform(0, 100, size=(n, 3))
        pc[:, 3] = raw_class(pc[:, 2], pc[:, 9], thresholds)
        names.append(f"eval{i}.pkl")
        save_cloud(os.path.join(folder, names[-1]), pc)
    write_split_list(os.path.join(folder, "test_seg_files.txt"), names)
    return names


@contextlib.contextmanager
def eval_probe():
    """While the command lines run: each TiledInferencer bucket forward (a
    call of a bucket's runner: its graph's capturing call or a replay) is
    counted with its ensemble size, and the labels predict_many returns are
    recorded in call order."""
    from ampnet_tpu_torch.infer.tiled import TiledInferencer

    rec = {"forwards": 0, "ensembles": set(), "labels": []}
    lock = threading.Lock()
    bucket_fn, predict_many = TiledInferencer._bucket_fn, TiledInferencer.predict_many

    def counted_bucket_fn(self, *key):
        run = bucket_fn(self, *key)

        def counted(*args):
            with lock:  # buckets of one dispatch run on a thread each
                rec["forwards"] += 1
                rec["ensembles"].add(self.ensemble)
            return run(*args)

        return counted

    def recorded_predict_many(self, clouds, seeds=None, return_probs=False, init_idx=None):
        out = predict_many(self, clouds, seeds, return_probs, init_idx)
        rec["labels"] += [o[0] if return_probs else o for o in out]
        return out

    TiledInferencer._bucket_fn = counted_bucket_fn
    TiledInferencer.predict_many = recorded_predict_many
    try:
        yield rec
    finally:
        TiledInferencer._bucket_fn, TiledInferencer.predict_many = bucket_fn, predict_many


def eval_cli(run, argv):
    """One command line through ``cli.main.main`` on the card: exit 0, and
    the launches of each kernel equal ``EVAL_RUNS[run]`` per bucket forward.
    Returns (the summary ``test`` prints, else None; launches; probe record;
    wall seconds)."""
    from ampnet_tpu_torch.cli.main import main as cli_main
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain
    from ampnet_tpu_torch.ops.quantized_mlp import quantized_mlp_chain

    wrappers = {"fused_mlp_chain": fused_mlp_chain, "quantized_mlp_chain": quantized_mlp_chain}
    buf = io.StringIO()
    with eval_probe() as rec:
        for fn in wrappers.values():  # this run of the main path starts here
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}  # ... and ends here
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv[:2])} exited {rc}: {buf.getvalue()[-2000:]}")
    for name, per in {**EVAL_RUNS, **TILE_RUNS, **GEOM_RUNS, **OPTION_RUNS}[run].items():
        if launches[name] != per * rec["forwards"]:
            raise RuntimeError(f"{run}: {name} launched {launches[name]} times for "
                               f"{rec['forwards']} bucket forwards; want {per} each")
    _say(f"  {run}: exit 0 in {wall:.2f} s; {rec['forwards']} bucket forwards, ensemble "
         f"{sorted(rec['ensembles'])}; launches " + json.dumps(launches))
    summary = last_json(buf.getvalue()) if argv[0] in ("test", "demo") else None
    return summary, launches, rec, wall


def traced_cli(argv) -> dict:
    """One command line again through ``cli.main.main``, the card traced
    (kernel activity only): its wall ms on the host clock, the device's busy
    ms and idle share, and the device operations it enqueued."""
    from torch.profiler import ProfilerActivity, profile

    from ampnet_tpu_torch.cli.main import main as cli_main

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if rc != 0:
        raise RuntimeError(f"traced {' '.join(argv[:2])} exited {rc}")
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall if busy > 0 else "not measured",
            "device_ops": sum(e.count for e in kernels)}


def summary_of(labels_by_cloud, dataset, num_classes) -> dict:
    """Per-class IoU, mIoU and OA over the dataset from labels alone (numpy,
    float64): the summary that ``test`` must print."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    for preds, sample in zip(labels_by_cloud, dataset):
        valid = sample["labels"] >= 0
        np.add.at(cm, (sample["labels"][valid], preds[valid]), 1)
    tp = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - tp
    present = union > 0
    iou = np.where(present, tp / np.maximum(union, 1), 0.0)
    from ampnet_tpu_torch.data.schema import SEG_CLASS_NAMES

    out = {f"iou_{n}": float(iou[c]) if present[c] else float("nan")
           for c, n in enumerate(SEG_CLASS_NAMES[:num_classes])}
    out["miou"] = float(iou[present].mean())
    out["oa"] = float(tp.sum() / cm.sum())
    return out


def same_summary(what, got, want) -> None:
    for k, v in want.items():
        g = float(got[k])
        if np.isnan(v) != np.isnan(g) or (not np.isnan(v) and abs(g - v) > 1e-6):
            raise RuntimeError(f"{what}: {k} = {g}, recomputed from predict_many {v}")


def evaluate_phase(ckpt, dev, card, work) -> dict:
    """Phase 7: the trained checkpoint through (a) ``test --backend fused``,
    (b) ``export`` and ``test`` of the checkpoint and its export stacked, (c)
    ``test --backend int8``, (d) ``infer`` and (e) ``test --tta 2
    --tile_votes 2`` (run ``test_tta``), on seeded 13-column clouds, then
    (a) and (e) once more under torch.profiler → each run's launches of each
    kernel (the traced repeats not counted)."""
    from ampnet_tpu_torch.cli.main import main as cli_main
    from ampnet_tpu_torch.core.checkpoint import load_model
    from ampnet_tpu_torch.data.datasets import EvalCloudDataset
    from ampnet_tpu_torch.infer.tiled import TiledInferencer

    t_phase = time.perf_counter()
    data = os.path.join(work, "eval")
    os.makedirs(data)
    names = write_eval_clouds(data)
    _say(f"  wrote {len(names)} clouds of {list(EVAL_CLOUD_POINTS)} points")
    pth = os.path.join(work, "exported.pth")
    test = ["test", data, "--path_list_files", data, "--device", str(dev)]
    out = {}

    def run(tag, argv, views=1):
        out[tag] = eval_cli(tag, argv)
        got = len(out[tag][2]["labels"])
        if got != len(names) * views:  # else a label comparison could pass on nothing
            raise RuntimeError(f"{tag}: predict_many returned labels of {got} clouds, "
                               f"want {len(names) * views}")
        return out[tag]

    # (a) the tester over one chunk of 4 clouds, seeds 0..3
    argv_a = [*test, "--model_checkpoint", ckpt, "--backend", "fused"]
    summary_a, _, rec_a, _ = run("test_fused", [*argv_a, "--out_path", os.path.join(work, "a")])
    cfg, model = load_model(ckpt, dev)
    ds = EvalCloudDataset(data, names)
    samples = [ds[i] for i in range(len(ds))]
    direct = TiledInferencer(model, cfg, max_clusters=18, backend="fused", device=dev)
    labels = direct.predict_many([s["points"] for s in samples], seeds=list(range(len(samples))))
    if len(labels) != len(names) or not all(np.array_equal(x, y) for x, y in zip(labels, rec_a["labels"])):
        raise RuntimeError("test's labels differ from predict_many on the same chunk and seeds")
    want = summary_of(labels, samples, cfg.model.num_classes)
    with open(os.path.join(work, "a", "IoU-results.csv")) as f:
        header, row = f.read().splitlines()
    same_summary("IoU-results.csv", dict(zip(header.split(","), row.split(","))), want)
    same_summary("test's summary", summary_a, want)
    # (b) its export beside it: one group of two members of equal weights
    with contextlib.redirect_stdout(io.StringIO()):
        if cli_main(["export", "--model_checkpoint", ckpt, "--out", pth,
                     "--device", str(dev)]) != 0:
            raise RuntimeError("export exited non-zero")
    summary_b, _, rec_b, _ = run("test_ensemble", [*test, "--model_checkpoint", f"{ckpt},{pth}",
                                                   "--backend", "fused",
                                                   "--out_path", os.path.join(work, "b")])
    if rec_b["ensembles"] != {2}:
        raise RuntimeError(f"the checkpoint and its export ran as ensembles {rec_b['ensembles']}")
    if not all(np.array_equal(x, y) for x, y in zip(rec_b["labels"], rec_a["labels"])):
        raise RuntimeError("the ensemble of two equal members labels differently from one")
    # (c) the int8 backend against fused
    summary_c, _, rec_c, _ = run("test_int8", [*test, "--model_checkpoint", ckpt, "--backend",
                                               "int8", "--out_path", os.path.join(work, "c")])
    agree = float(np.mean(np.concatenate(rec_c["labels"]) == np.concatenate(rec_a["labels"])))
    if not agree > 0.97:
        raise RuntimeError(f"int8 labels agree with fused on {agree} of the points")
    # (d) infer: the same chunk and seeds as (a)
    run("infer_fused", ["infer", data, "--model_checkpoint", ckpt, "--backend", "fused",
                        "--device", str(dev), "--out_path", os.path.join(work, "d")])
    for name, want_labels in zip(names, rec_a["labels"]):
        preds = np.load(os.path.join(work, "d", name.replace(".pkl", "_preds.npy")))
        if preds.dtype != np.int32 or not np.array_equal(preds, want_labels):
            raise RuntimeError(f"infer's {name} predictions differ from test's labels")
    # (e) test-time augmentation and tile votes
    argv_e = [*argv_a, "--tta", "2", "--tile_votes", "2"]
    summary_e, *_ = run("test_tta", [*argv_e, "--out_path", os.path.join(work, "e")], views=4)
    line = {"card": card, "points": int(sum(EVAL_CLOUD_POINTS)),
            "int8_label_agreement_with_fused": agree}
    for tag, s in (("test_fused", summary_a), ("test_ensemble", summary_b),
                   ("test_int8", summary_c), ("test_tta", summary_e)):
        if not np.isfinite(s["miou"]) or s["n_clouds"] != len(names):
            raise RuntimeError(f"{tag}: summary {s}")
        line[tag] = {"miou": s["miou"], "points_per_sec": s["points_per_sec"],
                     "wall_s": out[tag][3]}
    # (a) and (e) once more, warm and traced: where their wall time goes
    line["traced"] = {tag: traced_cli([*argv, "--out_path", os.path.join(work, f"{tag}_traced")])
                      for tag, argv in (("test_fused", argv_a), ("test_tta", argv_e))}
    _say("eval: " + json.dumps(line))
    _say(f"  evaluate phase: {time.perf_counter() - t_phase:.2f} s")
    return {tag: r[1] for tag, r in out.items()}


# phase 8: 2 tiles of 9 windows of 50,000 points (100 m x 100 m each) on 5 m of
# terrain, plus the ground returns synth adds; the demo at the verify recipe
TILES, TILE_WINDOWS, TILE_WINDOW_POINTS, TERRAIN_RELIEF = 2, 9, 50_000, 5.0
DEMO_ARGS = ("--epochs", "2", "--n_tiles", "3", "--points_per_window", "5000",
             "--number_of_points", "256")
FPS_SAMPLES = 8192  # the fps command's default
# kernel launches per bucket forward of each phase 8 run
TILE_RUNS = {
    "tile_infer_fused": LAUNCHES_PER_FORWARD["fused"],
    "tile_infer_int8": LAUNCHES_PER_FORWARD["int8"],
    "demo_test": LAUNCHES_PER_FORWARD["fused"],
}


def last_json(text: str) -> dict:
    """The last (indented) JSON object a command printed."""
    start = text.rfind("\n{")
    return json.loads(text[start + 1 if start >= 0 else text.index("{"):])


def quiet_cli(argv) -> float:
    """One command line through ``cli.main.main`` (its output swallowed) →
    wall seconds; it must exit 0."""
    from ampnet_tpu_torch.cli.main import main as cli_main

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main(argv)
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv[:1])} exited {rc}")
    return time.perf_counter() - t0


def same_outputs(dir_a, dir_b) -> int:
    """Two preprocess outputs hold the same files, clouds equal as arrays and
    split lists as text → the count of files."""
    from ampnet_tpu_torch.data.io_utils import load_cloud

    files = sorted(os.listdir(dir_a))
    if files != sorted(os.listdir(dir_b)):
        raise RuntimeError(f"{dir_a} and {dir_b} hold other files")
    for f in files:
        a, b = os.path.join(dir_a, f), os.path.join(dir_b, f)
        same = (open(a).read() == open(b).read() if f.endswith(".txt")
                else np.array_equal(load_cloud(a), load_cloud(b)))
        if not same:
            raise RuntimeError(f"{f} differs between {dir_a} and {dir_b}")
    return len(files)


def host_solver_checks(pre_dir, dev) -> dict:
    """Phase 8 (c)-(d) on the preprocessed windows: the Sinkhorn assignment on
    the card and on the CPU from one start (exact sizes, agreement), the
    native FPS (naive and grid) against the torch FPS on the card (its
    kernel, ``csrc/fps.cu``, on a whole window), and the
    native MCF's cost against the plain greedy's on one window."""
    from ampnet_tpu_torch.data.io_utils import load_cloud
    from ampnet_tpu_torch.native import (
        assign_plain,
        balanced_assign,
        balanced_kmeans_native,
        fps_native,
    )
    from ampnet_tpu_torch.ops.kmeans import num_tiles_train
    from ampnet_tpu_torch.ops.sampling import (
        batched_farthest_point_sampling,
        farthest_point_sampling,
    )
    from ampnet_tpu_torch.preproc.tiling import KMEANS_COLS, sinkhorn_assign

    out = {}
    clouds = sorted(f for f in os.listdir(pre_dir)
                    if f.endswith(".pkl") and not f.startswith("kmeans_"))
    pc = load_cloud(os.path.join(pre_dir, clouds[0]))
    npts = min(2048, pc.shape[0] // 2)
    k = num_tiles_train(pc.shape[0], npts, 9)
    feats = np.ascontiguousarray(pc[: k * npts, list(KMEANS_COLS)], np.float32)
    init = np.random.default_rng(SEED).permutation(k * npts)[:k]
    t0 = time.perf_counter()
    on_card = sinkhorn_assign(feats, k, npts, SEED, dev, init_idx=init)
    out["sinkhorn_card_ms"] = (time.perf_counter() - t0) * 1e3
    on_cpu = sinkhorn_assign(feats, k, npts, SEED, "cpu", init_idx=init)
    for where, a in (("card", on_card), ("cpu", on_cpu)):
        sizes = np.bincount(a, minlength=k)
        if not (sizes == npts).all():
            raise RuntimeError(f"sinkhorn on the {where}: window sizes {sizes.tolist()}")
    out["sinkhorn_card_cpu_agreement"] = float((on_card == on_cpu).mean())
    if not out["sinkhorn_card_cpu_agreement"] >= 0.999:
        raise RuntimeError(f"sinkhorn card against CPU from one start: "
                           f"{out['sinkhorn_card_cpu_agreement']}")
    # the native FPS against the torch FPS on the card, one window of each tile
    fps_ms = {"native_naive": 0.0, "native_grid": 0.0, "torch_card": 0.0}
    windows = (clouds[0], clouds[-1])
    batched_farthest_point_sampling.launches = 0  # one launch a window from here
    for name in windows:
        xyz = load_cloud(os.path.join(pre_dir, name))[:, :3]
        s = min(FPS_SAMPLES, xyz.shape[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = farthest_point_sampling(torch.from_numpy(xyz).to(dev), s).cpu().numpy()
        fps_ms["torch_card"] += (time.perf_counter() - t0) * 1e3
        for method in ("naive", "grid"):
            t0 = time.perf_counter()
            got = fps_native(xyz, s, method=method)
            fps_ms[f"native_{method}"] += (time.perf_counter() - t0) * 1e3
            if not np.array_equal(got, want):
                first = int(np.flatnonzero(got != want)[0])
                raise RuntimeError(f"{name}: native FPS ({method}) differs from the torch "
                                   f"FPS on the card from sample {first} of {s}")
    out["fps_ms_two_windows"] = fps_ms
    out["fps_launches"] = batched_farthest_point_sampling.launches
    if out["fps_launches"] != len(windows):
        raise RuntimeError(f"the torch FPS on the card launched its kernel "
                           f"{out['fps_launches']} times for {len(windows)} windows; want one "
                           f"a window")
    # one window's cost matrix: the exact solver against the plain greedy
    _, cents = balanced_kmeans_native(feats, k, np.full(k, npts, np.int32), seed=SEED)
    cost = ((feats[:, None, :] - cents[None]) ** 2).sum(-1).astype(np.float32)
    caps = np.full(k, npts, np.int32)
    t0 = time.perf_counter()
    exact = balanced_assign(cost, caps)
    out["mcf_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = assign_plain(cost, caps)
    out["greedy_ms"] = (time.perf_counter() - t0) * 1e3
    rows = np.arange(len(feats))
    for tag, a in (("mcf", exact), ("greedy", plain)):
        if not (np.bincount(a, minlength=k) == npts).all():
            raise RuntimeError(f"{tag}: window sizes not exact")
        out[f"{tag}_cost"] = float(cost[rows, a].astype(np.float64).sum())
    if not out["mcf_cost"] <= out["greedy_cost"] + 1e-3:
        raise RuntimeError(f"MCF cost {out['mcf_cost']} above the greedy's {out['greedy_cost']}")
    _say(f"  (c-d) host solver on [{k * npts}, {k}]: sinkhorn card = cpu on "
         f"{out['sinkhorn_card_cpu_agreement']}, native FPS = torch FPS on 2 windows, "
         f"MCF cost {out['mcf_cost']:.4f} <= greedy {out['greedy_cost']:.4f}")
    return out


def check_tile_run(run, tiles, out_dir, rec, ckpt, backend, dev) -> None:
    """Phase 8 (e): the labels ``infer`` recorded equal ``predict_many`` on
    the same windows and seeds; each classified LAS carries them at every
    unfiltered point and the input's class elsewhere; tile_metrics.json
    holds every tile."""
    from ampnet_tpu_torch.core.checkpoint import load_model
    from ampnet_tpu_torch.data.las_io import read_las
    from ampnet_tpu_torch.infer.full_tile import SEG_TO_LAS, tile_windows
    from ampnet_tpu_torch.infer.tiled import TiledInferencer

    cfg, model = load_model(ckpt, dev)
    direct = TiledInferencer(model, cfg, backend=backend, device=dev)
    recorded = list(rec["labels"])
    with open(os.path.join(out_dir, "tile_metrics.json")) as f:
        metrics = json.load(f)
    geom = (cfg.data.extra_features, cfg.data.geom_k, cfg.data.geom_radius_norm)
    for path in tiles:
        name = os.path.splitext(os.path.basename(path))[0]
        las = read_las(path)
        feats, kept, _ = tile_windows(las, 100.0, 100.0, 0, 2.0, *geom)
        want = direct.predict_many(feats, seeds=list(range(len(feats))))
        got, recorded = recorded[: len(feats)], recorded[len(feats):]
        if len(got) != len(want) or not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"{run}: {name}'s labels differ from predict_many on its "
                               f"windows and seeds")
        out = read_las(os.path.join(out_dir, f"{name}_classified.las"))
        expect = las.classification.astype(np.int64).copy()
        for idx, labels in zip(kept, want):
            expect[idx] = SEG_TO_LAS[labels]
        if len(out) != len(las) or not np.array_equal(out.classification, expect):
            raise RuntimeError(f"{run}: {name}_classified.las does not carry the labels")
        m = metrics.get(name, {})
        if m.get("points_total") != len(las) or not np.isfinite(m.get("miou", np.nan)):
            raise RuntimeError(f"{run}: tile_metrics.json for {name}: {m}")
    if recorded:
        raise RuntimeError(f"{run}: {len(recorded)} more windows were predicted than tiled")


def tiles_phase(ckpt, dev, card, work, windows=TILE_WINDOWS, points=TILE_WINDOW_POINTS,
                demo_args=DEMO_ARGS) -> dict:
    """Phase 8: (a) ``synth`` of TILES LAS tiles; (b) ``preprocess`` under
    ``exact_mcf`` with 1 and 2 workers, equal, and under ``--assigner
    sinkhorn`` on the card for one tile, every window exactly n_points; (c-d)
    ``host_solver_checks`` and ``fps``; (e) whole-tile ``infer`` of both
    tiles with phase 6's checkpoint under ``fused`` and ``int8``
    (``check_tile_run``), the fused one once more warm and traced; (f)
    ``demo`` on the card → each run's launches of each kernel. Prints the
    ``data:`` line."""
    from ampnet_tpu_torch.core.checkpoint import load_model
    from ampnet_tpu_torch.data.io_utils import load_cloud
    from ampnet_tpu_torch.data.las_io import read_las
    from ampnet_tpu_torch.infer.full_tile import tile_windows
    from ampnet_tpu_torch.infer.tiled import TiledInferencer

    t_phase = time.perf_counter()
    root = os.path.join(work, "tiles")
    las_dir, one_dir = os.path.join(root, "las"), os.path.join(root, "one_tile")
    data = {"card": card}
    data["synth_s"] = quiet_cli(["synth", "--out_path", las_dir, "--n_tiles", str(TILES),
                                 "--windows_per_tile", str(windows), "--points_per_window",
                                 str(points), "--terrain_relief", str(TERRAIN_RELIEF),
                                 "--seed", str(SEED)])
    tiles = sorted(os.path.join(las_dir, f) for f in os.listdir(las_dir))
    n_las = sum(len(read_las(t)) for t in tiles)
    data["las_points"], data["las_mb"] = n_las, sum(os.path.getsize(t) for t in tiles) / 2**20
    _say(f"  (a) synth: {len(tiles)} tiles, {n_las} points, {data['las_mb']:.1f} MiB in "
         f"{data['synth_s']:.2f} s")
    # (b) preprocess, serial and pooled, then sinkhorn on the card for one tile
    pre = {w: os.path.join(root, f"pre_w{w}") for w in (1, 2)}
    for w, out in pre.items():
        data[f"preprocess_w{w}_s"] = quiet_cli(["preprocess", "--in_path", las_dir, "--out_path",
                                                out, "--workers", str(w)])
    n_files = same_outputs(pre[1], pre[2])
    kmeans = [f for f in os.listdir(pre[1]) if f.startswith("kmeans_")]
    for f in kmeans:
        shape = load_cloud(os.path.join(pre[1], f)).shape
        if shape[:2] != (2048, 13):
            raise RuntimeError(f"{f}: windowed shape {shape}")
    os.makedirs(one_dir)
    os.symlink(tiles[0], os.path.join(one_dir, os.path.basename(tiles[0])))
    sink = os.path.join(root, "pre_sinkhorn")
    data["preprocess_sinkhorn_one_tile_s"] = quiet_cli(
        ["preprocess", "--in_path", one_dir, "--out_path", sink, "--assigner", "sinkhorn",
         "--device", str(dev)])
    for f in os.listdir(sink):
        if f.startswith("kmeans_") and load_cloud(os.path.join(sink, f)).shape[0] != 2048:
            raise RuntimeError(f"sinkhorn {f}: windows of other than 2048 points")
    data["windows"] = len(kmeans)
    data["preprocess_s_per_tile"] = data["preprocess_w1_s"] / len(tiles)
    _say(f"  (b) preprocess: {len(kmeans)} windows, workers 1 = workers 2 over {n_files} "
         f"files; sinkhorn on the card: every window 2048 points")
    # (c-d) the host solver, and the fps command over every window
    data["host_solver"] = host_solver_checks(pre[1], dev)
    data["fps_s"] = quiet_cli(["fps", "--in_path", pre[1], "--out_path",
                               os.path.join(root, "fps"), "--n_points", str(FPS_SAMPLES)])
    # (e) whole-tile infer under fused and int8
    launches, runs = {}, {}
    for backend in ("fused", "int8"):
        run, out = f"tile_infer_{backend}", os.path.join(root, f"infer_{backend}")
        argv = ["infer", las_dir, "--model_checkpoint", ckpt, "--backend", backend,
                "--device", str(dev), "--out_path", out]
        _, launches[run], rec, wall = eval_cli(run, argv)
        check_tile_run(run, tiles, out, rec, ckpt, backend, dev)
        runs[run] = {"wall_s": wall, "points_per_sec": n_las / wall,
                     "bucket_forwards": rec["forwards"]}
        if backend == "fused":
            runs[run]["traced_warm"] = traced_cli([*argv[:-1], out + "_traced"])
    data.update(runs)
    # where a warm tile's time goes: the host stages against predict_many
    cfg, model = load_model(ckpt, dev)
    direct = TiledInferencer(model, cfg, backend="fused", device=dev)
    t0 = time.perf_counter()
    las = read_las(tiles[0], mmap=True)
    feats, _, _ = tile_windows(las)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct.predict_many(feats, seeds=list(range(len(feats))))
    data["one_tile_warm"] = {"points": len(las), "windows": len(feats),
                             "read_hag_split_filter_ms": host_ms,
                             "predict_many_ms": (time.perf_counter() - t0) * 1e3}
    _say("  (e) infer: labels = predict_many, classified LAS and tile_metrics.json checked")
    # (f) the demo on the card
    demo = os.path.join(root, "demo")
    summary, launches["demo_test"], _, data["demo_s"] = eval_cli(
        "demo_test", ["demo", "--out_path", demo, *demo_args, "--backend", "fused",
                      "--device", str(dev)])
    if not np.isfinite(summary["miou"]) or summary["n_clouds"] < 1:
        raise RuntimeError(f"demo: summary {summary}")
    data["demo_summary"] = {k: summary[k] for k in ("miou", "oa", "n_clouds",
                                                    "points_per_sec")}
    _say("data: " + json.dumps(data))
    _say(f"  tiles phase: {time.perf_counter() - t_phase:.2f} s")
    return launches, data


# phase 9: the GRU, classification and PointNet families at full published
# width (global 256, GRU hidden 64, classic 1024) on a seeded dataset of
# half tower and half landscape clouds
FAM_TRAIN, FAM_VAL, FAM_TEST = 64, 16, 4
FAM_CLOUD_POINTS = 6_000  # a whole .pkl cloud: 2 windows of 4096 for the windowed families
WHOLE_POINTS = 4096  # SingleCloudBatcher's default (JAX data/pipeline.py:251)
FAM_RUNS = (("gru", "segmentation"), ("baseline", "segmentation"), ("classic", "segmentation"),
            ("pointnet2", "segmentation"), ("attention", "classification"),
            ("baseline", "classification"))
CLS_WEIGHTS = (0.3, 0.7)  # the card-against-CPU classification step's class weights


def write_family_dataset(folder, seed=SEED):
    """Per cloud a ``kmeans_<name>.pt`` artifact ``[2048, 13, 9]`` (phase 6's
    recipe) and the whole cloud ``<name>.pkl`` (FAM_CLOUD_POINTS of its
    points). Every odd cloud is landscape: its tower and line points (raw 15,
    14) become background, so ``classification_label`` takes both values.
    Split lists: FAM_TRAIN / FAM_VAL / FAM_TEST clouds."""
    from ampnet_tpu_torch.data.io_utils import save_cloud, write_split_list

    thresholds = class_thresholds(np.random.default_rng(seed))  # phase 6's classes
    rng = np.random.default_rng(seed + 11)
    n, w = TRAIN_POINTS, TRAIN_WINDOWS
    names = []
    for i in range(FAM_TRAIN + FAM_VAL + FAM_TEST):
        pc = np.empty((n, 13, w), np.float32)
        lo = rng.uniform(0.0, 0.4, size=(2, w))
        pc[:, 0:2] = lo + rng.uniform(0.3, 0.6, size=(2, w)) * rng.uniform(size=(n, 2, w))
        pc[:, 2] = rng.uniform(size=(n, w)) * rng.uniform(0.2, 1.0, size=w)
        pc[:, 9] = np.clip(rng.uniform(0.1, 0.9, size=w) + 0.25 * rng.normal(size=(n, w)), 0, 1)
        pc[:, 4:9] = rng.uniform(size=(n, 5, w)) * rng.uniform(0.3, 1.0, size=(5, w))
        pc[:, 10:13] = rng.uniform(0, 100, size=(n, 3, w))
        cls = raw_class(pc[:, 2], pc[:, 9], thresholds)
        pc[:, 3] = np.where((i % 2 == 1) & np.isin(cls, (14, 15)), 1, cls)
        name = f"fam{i:03d}"
        save_cloud(os.path.join(folder, f"kmeans_{name}.pt"), pc)
        whole = pc.transpose(2, 0, 1).reshape(-1, 13)
        save_cloud(os.path.join(folder, f"{name}.pkl"),
                   whole[rng.permutation(len(whole))[:FAM_CLOUD_POINTS]])
        names.append(f"{name}.pkl")
    cut = (FAM_TRAIN, FAM_TRAIN + FAM_VAL)
    for split, part in zip(("train", "val", "test"), (names[:cut[0]], names[cut[0]:cut[1]],
                                                     names[cut[1]:])):
        write_split_list(os.path.join(folder, f"{split}_seg_files.txt"), part)
    return names


def family_batcher(data_dir, names, arch, task, batch, dev, shuffle=True):
    """The batcher ``train`` builds for ``arch`` on the card: windowed
    artifacts for attention/gru, whole clouds resampled to WHOLE_POINTS for
    the others, served from the device cache."""
    from ampnet_tpu_torch.data.datasets import CloudDataset, WindowedCloudDataset
    from ampnet_tpu_torch.data.device_cache import DeviceCachedBatcher
    from ampnet_tpu_torch.data.pipeline import PaddedBatcher, SingleCloudBatcher

    if arch in ("attention", "gru"):
        b = PaddedBatcher(WindowedCloudDataset(data_dir, names, task=task), batch,
                          n_points=TRAIN_POINTS, max_windows=TRAIN_WINDOWS, shuffle=shuffle)
    else:
        b = SingleCloudBatcher(CloudDataset(data_dir, names, task=task,
                                            number_of_points=WHOLE_POINTS), batch,
                               n_points=WHOLE_POINTS, shuffle=shuffle)
    return DeviceCachedBatcher(b, dev)


def first_batch(cache):
    """The first batch of a device cache, its tensors only."""
    return {k: v for k, v in next(iter(cache)).items() if isinstance(v, torch.Tensor)}


def family_cfg(arch, dropout=0.3):
    from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig

    windowed = arch in ("attention", "gru")
    return AMPNetConfig(data=DataConfig(n_points=TRAIN_POINTS if windowed else WHOLE_POINTS,
                                        max_windows=TRAIN_WINDOWS),
                        model=ModelConfig(context=arch, dropout=dropout))


def family_steps(data_dir, names, dev) -> dict:
    """(b): one train step of the GRU and classic segmenters and of the
    attention classifier on the card against the same step on a CPU copy,
    phase 6's tolerances (float64 strict, float32 loose)."""
    from ampnet_tpu_torch.train.cls_step import make_cls_step_fns

    out = {}
    # 8 clouds where a BatchNorm takes one row a cloud (the T-Net FC and the
    # classifier's bn_2): at 4 rows float32 statistics are ill-conditioned
    for arch, task, b in (("gru", "segmentation", STEP_BATCH), ("classic", "segmentation", 8),
                          ("attention", "classification", 8)):
        cfg = family_cfg(arch, dropout=0.0)
        batch = first_batch(family_batcher(data_dir, names[:b], arch, task, b, dev,
                                           shuffle=False))
        step = (make_cls_step_fns(cfg, np.asarray(CLS_WEIGHTS, np.float32), augment=False)[0]
                if task == "classification" else None)
        r = card_against_cpu_step(cfg, batch, dev, model=seeded_model(cfg, arch, task),
                                  step=step, what=f"{arch} {task}: ")
        out[f"{arch}_{task}"] = {k: r[k]["loss_rel_err"] for k in r}
    return out


# FPS and ball-query kernel launches a PointNet++ forward: one each a set
# abstraction
PN2_FPS_PER_FORWARD = 3
PN2_BALL_QUERY_PER_FORWARD = 3


@contextlib.contextmanager
def no_kernel_launches(run, pn2_runs=None):
    """Both MLP-chain kernels' counters, and the FPS and ball-query kernels',
    set to 0 before ``run`` and read after: the families run only plain
    torch products, as the JAX package runs them only under ``xla``, but for
    PointNet++'s sampling and grouping, which launch ``csrc/fps.cu`` exactly
    ``PN2_FPS_PER_FORWARD`` and ``csrc/ball_query.cu`` exactly
    ``PN2_BALL_QUERY_PER_FORWARD`` times a ``PointNet2Segmenter`` forward that
    the card runs. Those forwards are counted as the kernels count launches
    (``count_launch``: an eager forward, or a bucket graph's replay of the
    forward it captured). Where ``pn2_runs`` is given, ``run`` is a PointNet++
    run: it must run a forward, and ``pn2_runs[run]`` gets both kernels'
    launches and the forwards."""
    from ampnet_tpu_torch.models.pointnet2 import PointNet2Segmenter
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain
    from ampnet_tpu_torch.ops.launch_count import count_launch
    from ampnet_tpu_torch.ops.quantized_mlp import quantized_mlp_chain
    from ampnet_tpu_torch.ops.sampling import ball_query_members, batched_farthest_point_sampling

    def pointnet2_forwards():
        """The counter of the PointNet++ forwards the card runs."""

    forward = PointNet2Segmenter.forward

    def counted_forward(self, *args, **kw):
        count_launch(pointnet2_forwards)
        return forward(self, *args, **kw)

    counters = {"fused_mlp_chain": fused_mlp_chain, "quantized_mlp_chain": quantized_mlp_chain}
    for fn in (*counters.values(), batched_farthest_point_sampling, ball_query_members,
               pointnet2_forwards):
        fn.launches = 0
    PointNet2Segmenter.forward = counted_forward
    try:
        yield
    finally:
        PointNet2Segmenter.forward = forward
    launched = {name: fn.launches for name, fn in counters.items()}
    if any(launched.values()):
        raise RuntimeError(f"{run}: kernels launched {launched}; the families run none")
    pn2 = {"launches": batched_farthest_point_sampling.launches,
           "ball_query_launches": ball_query_members.launches,
           "pointnet2_forwards": pointnet2_forwards.launches}
    forwards = pn2["pointnet2_forwards"]
    for name, key, per in (("FPS", "launches", PN2_FPS_PER_FORWARD),
                           ("ball-query", "ball_query_launches", PN2_BALL_QUERY_PER_FORWARD)):
        if pn2[key] != per * forwards or (pn2_runs is not None and not forwards):
            raise RuntimeError(f"{run}: the {name} kernel launched {pn2[key]} times in "
                               f"{forwards} PointNet++ forwards; want {per} each, in at "
                               f"least one forward")
    if pn2_runs is not None:
        pn2_runs[run] = pn2


def family_cli(run, argv, expect=0, pn2_runs=None):
    """One command line through ``cli.main.main`` on the card with 0
    MLP-chain kernel launches and the FPS and ball-query kernels' three each a
    PointNet++ forward (``no_kernel_launches``, which ``pn2_runs`` is passed
    to) → (stdout, stderr, probe record, wall s); the exit code must be
    ``expect``."""
    from ampnet_tpu_torch.cli.main import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with no_kernel_launches(run, pn2_runs), eval_probe() as rec:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != expect:
        raise RuntimeError(f"{run}: exited {rc}, want {expect}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue(), rec, wall


def warm_step(data_dir, names, arch, task, dev) -> dict:
    """ms per warm train step (default recipe, 2 warm + 3 timed on one batch
    of TRAIN_BATCH from the device cache, host clock ending in a sync),
    windows (windowed) or clouds per second, and peak GiB."""
    from ampnet_tpu_torch.core.metrics import get_class_weights
    from ampnet_tpu_torch.train.cls_step import make_cls_step_fns
    from ampnet_tpu_torch.train.state import create_train_state
    from ampnet_tpu_torch.train.step import make_step_fns

    cfg = family_cfg(arch)
    batch = first_batch(family_batcher(data_dir, names[:TRAIN_BATCH], arch, task, TRAIN_BATCH,
                                       dev))
    state = create_train_state(cfg, seeded_model(cfg, arch, task).train(), 1, dev)
    step = (make_cls_step_fns(cfg, get_class_weights("EFS", [1, 1]))[0]
            if task == "classification" else make_step_fns(cfg)[0])
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    b, w = batch["points"].shape[:2]
    unit = "windows_per_sec" if arch in ("attention", "gru") else "clouds_per_sec"
    return {"batch": list(batch["points"].shape), "step_ms": ms,
            unit: (b * w if unit == "windows_per_sec" else b) / (ms / 1e3),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def recount_classification(csv_path, labels, targets) -> dict:
    """The classification CSV's row against a recount from ``labels``."""
    from ampnet_tpu_torch.train.cls_step import binary_metrics_from_confusion

    cm = np.zeros((2, 2))
    for t, p in zip(targets, labels):
        cm[int(t), int(p)] += 1
    want = {**binary_metrics_from_confusion(cm), "n_samples": len(labels)}
    with open(csv_path) as f:
        header, row = f.read().splitlines()[:2]
    got = dict(zip(header.split(","), row.split(",")))
    for k, v in want.items():
        if abs(float(got[k]) - v) > 1e-12:
            raise RuntimeError(f"{csv_path}: {k} = {got[k]}, recounted {v}")
    if not np.isfinite(float(got["pr_auc"])):
        raise RuntimeError(f"{csv_path}: pr_auc {got['pr_auc']}")
    return {k: float(got[k]) for k in ("accuracy", "f1", "pr_auc")}


def families_phase(attention_ckpt, dev, card, work) -> dict:
    """Phase 9: (a) a seeded half-landscape dataset; (b) card-against-CPU
    steps (``family_steps``); (c) ``train --epochs 2`` of every run of
    FAM_RUNS; (d) ``test`` of each checkpoint against ``predict_many`` (the
    whole-cloud families as k = 1 buckets) or, for classification, against a
    recount of ``CloudClassifier.predict_many`` (baseline: the same resampled
    points) or of the module on the test batches (attention: its windows);
    (e) ``serve --task classification`` and ``serve`` of the GRU under the
    default backend (the printed ``folded`` → ``xla`` fallback), answers =
    ``predict_many``; ``test`` of an ``attention,gru`` ensemble; GRU
    ``export`` → ``.pth`` → ``test``, labels equal; ``demo --arch pointnet2``;
    (f) ``--backend fused`` with the GRU checkpoint exits 1. Every run
    launches neither MLP-chain kernel, and the FPS and ball-query kernels
    three times each a PointNet++ forward (``no_kernel_launches``). Prints
    the ``families:`` line, whose ``pn2_launches`` holds each PointNet++
    run's FPS and ball-query launches and forwards, and returns it."""
    from ampnet_tpu_torch.core.checkpoint import load_model
    from ampnet_tpu_torch.data.datasets import (
        CloudDataset,
        EvalCloudDataset,
        WindowedCloudDataset,
    )
    from ampnet_tpu_torch.data.pipeline import PaddedBatcher, to_device_batch
    from ampnet_tpu_torch.infer.classify import CloudClassifier
    from ampnet_tpu_torch.infer.tiled import TiledInferencer

    t_phase = time.perf_counter()
    data = os.path.join(work, "families")
    os.makedirs(data)
    t0 = time.perf_counter()
    names = write_family_dataset(data)
    test_names = names[FAM_TRAIN + FAM_VAL:]
    _say(f"  (a) wrote {len(names)} clouds ({TRAIN_WINDOWS} x {TRAIN_POINTS} windows and "
         f"{FAM_CLOUD_POINTS}-point wholes, half landscape) in {time.perf_counter() - t0:.2f} s")
    line = {"card": card, "steps_loss_rel_err": family_steps(data, names, dev), "runs": {}}
    dev_arg = ["--device", str(dev)]
    test_base = ["test", data, "--path_list_files", data, *dev_arg]
    test_ds = EvalCloudDataset(data, test_names)
    samples = [test_ds[i] for i in range(len(test_ds))]
    ckpts, all_pn2_runs = {}, {}
    for arch, task in FAM_RUNS:
        run = f"{arch}_{task}"
        out_dir = os.path.join(work, f"fam_{run}")
        windowed = arch in ("attention", "gru")
        points = TRAIN_POINTS if windowed else WHOLE_POINTS
        pn2_runs = all_pn2_runs if arch == "pointnet2" else None
        stdout, _, _, wall = family_cli(f"train {run}", [
            "train", data, "--path_list_files", data, "--out_path", out_dir, "--arch", arch,
            "--task", task, "--epochs", "2", "--batch_size", str(TRAIN_BATCH),
            "--number_of_points", str(points), "--number_of_windows", str(TRAIN_WINDOWS),
            "--seed", str(SEED), *dev_arg], pn2_runs=pn2_runs)
        last = last_json(stdout[:stdout.rindex("}") + 1])
        if not np.isfinite(last["loss"]):
            raise RuntimeError(f"train {run}: {last}")
        ckpt = ckpts[run] = os.path.join(out_dir, "checkpoints", f"{run}_best")
        with no_kernel_launches(f"warm step {run}", pn2_runs):
            warm = warm_step(data, names[:FAM_TRAIN], arch, task, dev)
        rec_line = {"train_wall_s": wall, "val_loss": last["loss"], **warm}
        cfg, model = load_model(ckpt, dev)
        if task == "segmentation":
            stdout, _, rec, wall = family_cli(f"test {run}", [*test_base, "--model_checkpoint",
                                                              ckpt, "--out_path", out_dir],
                                              pn2_runs=pn2_runs)
            direct = TiledInferencer(model, cfg, max_clusters=18 if windowed else 1, device=dev)
            labels = direct.predict_many([s["points"] for s in samples],
                                         seeds=list(range(len(samples))))
            if len(rec["labels"]) != len(samples) or not all(
                    np.array_equal(a, b) for a, b in zip(labels, rec["labels"])):
                raise RuntimeError(f"test {run}: labels differ from predict_many")
            want = summary_of(labels, samples, cfg.model.num_classes)
            with open(os.path.join(out_dir, "IoU-results.csv")) as f:
                header, row = f.read().splitlines()[:2]
            same_summary(f"{run} IoU-results.csv", dict(zip(header.split(","), row.split(","))),
                         want)
            summary = last_json(stdout)
            same_summary(f"{run} summary", summary, want)
            rec_line.update(test_points_per_sec=summary["points_per_sec"], miou=summary["miou"],
                            test_wall_s=wall, bucket_forwards=rec["forwards"])
        else:
            _, _, _, wall = family_cli(f"test {run}", [*test_base, "--task", task,
                                                       "--model_checkpoint", ckpt,
                                                       "--out_path", out_dir])
            if windowed:  # the module on test's own batches (all the windows)
                b = PaddedBatcher(WindowedCloudDataset(data, test_names, task=task), 4,
                                  n_points=cfg.data.n_points, max_windows=cfg.data.max_windows,
                                  shuffle=False, drop_last=False)
                batches = [to_device_batch(x, dev) for x in b]
                with torch.no_grad():
                    labels = torch.cat([model(x["points"], x.get("centroids"),
                                              (x["labels"] == -1).all(-1))[0].argmax(-1)
                                        for x in batches]).cpu().numpy()
                targets = torch.cat([x["cls_label"] for x in batches]).cpu().numpy()
            else:  # CloudClassifier on the points test resampled (no second draw)
                ds = CloudDataset(data, test_names, task=task, number_of_points=WHOLE_POINTS)
                items = [ds[i] for i in range(len(ds))]
                labels = np.concatenate(CloudClassifier(model, cfg, device=dev).predict_many(
                    [s["points"] for s in items]))
                targets = np.asarray([s["cls_label"] for s in items])
            rec_line.update(recount_classification(
                os.path.join(out_dir, "classification-results.csv"), labels, targets),
                test_wall_s=wall, test_clouds_per_sec=len(test_names) / wall)
        line["runs"][run] = rec_line
        _say(f"  (c-d) {run}: " + json.dumps(rec_line))
    line.update(family_serving(ckpts, attention_ckpt, data, test_base, samples, dev, work,
                               all_pn2_runs))
    line["pn2_launches"] = all_pn2_runs
    line["phase_s"] = time.perf_counter() - t_phase
    _say("families: " + json.dumps(line))
    _say(f"  families phase: {line['phase_s']:.2f} s")
    return line


def family_serving(ckpts, attention_ckpt, data, test_base, samples, dev, work,
                   pn2_runs) -> dict:
    """(e)-(f) of phase 9 (the PointNet++ demo's FPS and ball-query launches
    into ``pn2_runs``)."""
    from ampnet_tpu_torch.cli.main import NON_XLA, build_parser, make_server
    from ampnet_tpu_torch.core.checkpoint import load_model
    from ampnet_tpu_torch.infer.classify import CloudClassifier
    from ampnet_tpu_torch.infer.tiled import EnsembleInferencer, TiledInferencer

    out = {}
    rng = np.random.default_rng(SEED + 13)
    clouds = [samples[i]["points"][rng.permutation(FAM_CLOUD_POINTS)[:n]]
              for i, n in ((0, 3_000), (1, 6_000), (2, 4_500), (3, 6_000))]

    def served(run, argv, requests):
        err = io.StringIO()
        with no_kernel_launches(run), contextlib.redirect_stderr(err):
            server = make_server(build_parser().parse_args(
                ["serve", *argv, "--device", str(dev), "--host", "127.0.0.1", "--port", "0"]))
            thread = threading.Thread(target=server.httpd.serve_forever, daemon=True)
            thread.start()
            try:
                host, port = server.address
                answers = [json.loads(_post(f"http://{host}:{port}/v1/predict",
                                            json.dumps({"clouds": [c.tolist() for c in r]})
                                            .encode(), "application/json"))["labels"]
                           for r in requests]
                inf = server.service.inferencer
                for r, a in zip(requests, answers):  # each request is one micro-batch
                    want = inf.predict_many(r, seeds=[0] * len(r))
                    if [list(x) for x in a] != [w.tolist() for w in want]:
                        raise RuntimeError(f"{run}: served labels differ from predict_many")
            finally:
                server.close()
                thread.join(timeout=60)
        return err.getvalue(), inf

    requests = [clouds[:2], clouds[2:]]
    err, inf = served("serve classification", ["--model_checkpoint",
                                               ckpts["attention_classification"],
                                               "--task", "classification"], requests)
    if not isinstance(inf, CloudClassifier):
        raise RuntimeError(f"serve --task classification built {type(inf).__name__}")
    err, inf = served("serve gru", ["--model_checkpoint", ckpts["gru_segmentation"]],
                      [[c] for c in clouds[:2]])
    if "backend 'folded' is attention-only; serving with 'xla'" not in err or inf.backend != "xla":
        raise RuntimeError(f"serve of the GRU checkpoint: no folded -> xla fallback: {err}")
    out["served"] = {"classification_requests": 2, "gru_requests": 2, "folded_to_xla": True}
    # an attention,gru ensemble: phase 6's attention checkpoint and the GRU's
    gru = ckpts["gru_segmentation"]
    stdout, _, _, wall = family_cli("test attention,gru", [
        *test_base, "--model_checkpoint", f"{attention_ckpt},{gru}",
        "--out_path", os.path.join(work, "fam_ensemble")])
    members = []
    for ckpt in (attention_ckpt, gru):
        cfg, model = load_model(ckpt, dev)
        members.append(TiledInferencer(model, cfg, max_clusters=18, device=dev))
    labels = EnsembleInferencer(members).predict_many([s["points"] for s in samples],
                                                      seeds=list(range(len(samples))))
    summary = last_json(stdout)
    same_summary("attention,gru ensemble", summary,
                 summary_of(labels, samples, members[0].cfg.model.num_classes))
    out["ensemble"] = {"miou": summary["miou"], "wall_s": wall}
    # the GRU through its reference .pth: the same labels
    pth = os.path.join(work, "fam_gru.pth")
    family_cli("export gru", ["export", "--model_checkpoint", gru, "--out", pth,
                              "--device", str(dev)])
    _, _, rec_dir, _ = family_cli("test gru", [*test_base, "--model_checkpoint", gru,
                                               "--out_path", os.path.join(work, "fam_g1")])
    _, _, rec_pth, _ = family_cli("test gru.pth", [*test_base, "--model_checkpoint", pth,
                                                   "--arch", "gru",
                                                   "--out_path", os.path.join(work, "fam_g2")])
    if not all(np.array_equal(a, b) for a, b in zip(rec_dir["labels"], rec_pth["labels"])) \
            or len(rec_pth["labels"]) != len(samples):
        raise RuntimeError("the GRU's exported .pth labels differently from its checkpoint")
    # (f) the backend gate
    _, err, _, _ = family_cli("test gru --backend fused",
                              [*test_base, "--model_checkpoint", gru, "--backend", "fused"],
                              expect=1)
    if NON_XLA not in err:
        raise RuntimeError(f"test --backend fused of the GRU: {err}")
    # demo --arch pointnet2 at the verify recipe, on the card
    stdout, _, _, wall = family_cli("demo pointnet2", [
        "demo", "--out_path", os.path.join(work, "fam_demo"), "--arch", "pointnet2",
        *DEMO_ARGS, "--device", str(dev)], pn2_runs=pn2_runs)
    summary = last_json(stdout)
    if not np.isfinite(summary["miou"]):
        raise RuntimeError(f"demo --arch pointnet2: {summary}")
    out["demo_pointnet2"] = {"wall_s": wall, "miou": summary["miou"]}
    return out


# phase 10: geometry and distillation at full published width. GEOM_EXTRA
# eigenfeature columns after the 9 model features; mlp_a then reads 3 + 15
GEOM_EXTRA = 6
GEOM_MLP_A = (18, 64, 64)
# kernel launches per bucket forward of each phase 10 run that launches one
GEOM_RUNS = {
    "geom_test_fused": LAUNCHES_PER_FORWARD["fused"],
    "geom_test_int8": LAUNCHES_PER_FORWARD["int8"],
    "geom_tile_infer_fused": LAUNCHES_PER_FORWARD["fused"],
    "geom_tile_infer_int8": LAUNCHES_PER_FORWARD["int8"],
    "geom_demo_test": LAUNCHES_PER_FORWARD["fused"],
}


def geom_cfg(dropout=0.3, **model_kw):
    from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig

    return AMPNetConfig(data=DataConfig(extra_features=GEOM_EXTRA),
                        model=ModelConfig(dropout=dropout, **model_kw))


def write_geom_dataset(folder, seed=SEED):
    """Phase 6's learnable dataset with the 6 eigenfeature columns after the
    13 (``kmeans_<name>.pt`` artifacts ``[2048, 19, 9]``): seeded values in
    [0, 1], verticality and linearity raised where the raw class is a tower
    or a line, so the columns carry the label too."""
    from ampnet_tpu_torch.data.io_utils import load_cloud, save_cloud

    names = write_learnable_dataset(folder, seed)
    rng = np.random.default_rng(seed + 17)
    for name in names:
        path = os.path.join(folder, "kmeans_" + name.replace(".pkl", ".pt"))
        pc = load_cloud(path)
        geo = rng.uniform(0.0, 0.6, size=(pc.shape[0], GEOM_EXTRA, pc.shape[2]))
        geo[:, 3] += 0.4 * (pc[:, 3] == 15)  # verticality of towers
        geo[:, 0] += 0.4 * (pc[:, 3] == 14)  # linearity of lines
        save_cloud(path, np.concatenate([pc, geo.astype(np.float32)], axis=1))
    return names


def geom_kernel_rows(model, dev) -> dict:
    """(b): both kernels against their plain versions at ``serve_geom:mlp_a``,
    [18 windows, 4096 points, (18, 64, 64)] with activations out (Cin 18:
    the scalar x-load path, padded to 32 in both kernels), timed as phase 3
    times them (``fused_case_row``, ``int8_case_row``) → {kernel: row}."""
    from ampnet_tpu_torch.models.folded_infer import folded_chain_params
    from ampnet_tpu_torch.models.quantized_infer import quantize_encoder_chains

    case, (m, n) = "serve_geom:mlp_a", SERVE_GEOM
    ws, bs = folded_chain_params(model.encoder.mlp_a)
    ws = [w.detach().contiguous() for w in ws]
    bs = [b.detach().contiguous() for b in bs]
    dims = (ws[0].shape[0], *(w.shape[1] for w in ws))
    if dims != GEOM_MLP_A:
        raise RuntimeError(f"the geometry model's mlp_a is {list(dims)}, want {list(GEOM_MLP_A)}")
    x = torch.randn(m, n, dims[0], generator=torch.Generator(device=dev).manual_seed(SEED + 7),
                    device=dev)
    fused = fused_case_row(case, ws, bs, x, False, True, True)
    # quantized as the forward holds it: prepared on the card, plain on the CPU
    int8, _ = int8_case_row(case, quantize_encoder_chains(model)[0], x, False, True, True, 0)
    return {"fused_mlp_chain": fused, "quantized_mlp_chain": int8}


def knn_ms(cfg, batch, dev) -> float:
    """Device ms of the edge block's kNN (distances and the pick of k) over
    one batch's windows, from CUDA events, warm."""
    from ampnet_tpu_torch.models.amp import knn_indices

    b, w, n, _ = batch["points"].shape
    coords = batch["points"][..., :cfg.model.point_dim].reshape(b * w, n, -1)
    knn_indices(coords, None, cfg.model.local_agg_k)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        knn_indices(coords, None, cfg.model.local_agg_k)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 3


def geom_warm_step(cfg, batch, dev, teacher=None) -> dict:
    """ms per warm train step of ``cfg`` (default recipe; 2 warm + 3 timed on
    one batch, host clock ending in a sync), windows/s and peak GiB."""
    from ampnet_tpu_torch.train.state import create_train_state
    from ampnet_tpu_torch.train.step import make_step_fns

    gc_cuda()
    state = create_train_state(cfg, seeded_model(cfg).train(), 1, dev)
    step = make_step_fns(cfg, teacher=teacher)[0]
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        m = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    b, w = batch["points"].shape[:2]
    out = {"batch": list(batch["points"].shape), "step_ms": ms,
           "windows_per_sec": b * w / (ms / 1e3),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "loss": float(m["loss"])}
    if "distill_loss" in m:
        out["distill_loss"] = float(m["distill_loss"])
    del state
    gc_cuda()
    return out


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def geom_train_cli(run, data_dir, out_dir, dev, flags, epochs=2):
    """``train`` at batch TRAIN_BATCH x 9 x 2048 through ``cli.main.main``
    with ``flags``, 0 kernel launches → (checkpoint directory, the epoch rows
    of its CSV, wall s)."""
    stdout, err, _, wall = family_cli(run, [
        "train", data_dir, "--path_list_files", data_dir, "--out_path", out_dir,
        "--device", str(dev), "--epochs", str(epochs), "--batch_size", str(TRAIN_BATCH),
        "--seed", str(SEED), *flags])
    rows = train_csv_rows(out_dir)
    losses = [r["loss"] for _, r in sorted(rows.items()) if "loss" in r]
    if len(losses) != epochs or not all(np.isfinite(losses)):
        raise RuntimeError(f"{run}: train losses {losses}")
    return os.path.join(out_dir, "checkpoints", "attention_segmentation_best"), rows, err, wall


def geometry_phase(tiles_dir, tiles_data, dev, card, work) -> dict:
    """Phase 10: geometry and distillation at full published width. (a)
    ``preprocess --geom_features`` of phase 8's tiles (``--geom_k 24``, then
    ``--geom_radius_norm median``): columns 13..18 in [0, 1], the first 13
    equal to phase 8's plain artifacts bit for bit; (b) both kernels at
    ``serve_geom:mlp_a`` (``geom_kernel_rows``); (c) a 15-column learnable
    dataset, the geometry model's card step against the CPU's, ``train
    --geom_features`` 2 epochs, its warm step; (d) that checkpoint served over
    HTTP under ``fused`` and ``int8`` with 15-column bodies (answers =
    ``predict_many``, labels against ``xla``, 4 and 2 + 2 launches a bucket
    forward), then ``test`` of (a)'s clouds and whole-tile ``infer`` of phase
    8's tiles under both; (e) ``train --geom_features --local_agg edge
    --att_geom_tokens`` at 32 x 9 x 2048, its card step against the CPU's,
    warm step and kNN ms, ``test`` under ``xla``, ``--backend fused`` exits
    1 with the JAX message, 0 launches; (f) ``train --distill_from (c),(e)``
    of a plain student with ``--grad_accum`` 1 and 2, its card step against
    the CPU's, 0 launches in the teachers; (g) ``demo --geom_features`` →
    (each run's launches of each kernel, the kernel rows of (b)). Prints the
    ``geometry:`` line."""
    from ampnet_tpu_torch.core.checkpoint import load_model
    from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig, TrainConfig
    from ampnet_tpu_torch.data.datasets import EvalCloudDataset
    from ampnet_tpu_torch.data.io_utils import load_cloud, read_split_list
    from ampnet_tpu_torch.infer.tiled import TiledInferencer
    from ampnet_tpu_torch.train.step import make_step_fns

    t_phase = time.perf_counter()
    root = os.path.join(work, "geometry")
    os.makedirs(root)
    line = {"card": card}
    las_dir = os.path.join(tiles_dir, "las")
    tiles = sorted(os.path.join(las_dir, f) for f in os.listdir(las_dir))
    # (a) preprocess with the eigenfeature columns, both radius normalisations
    pre = {}
    for tag, flags in (("absolute", ["--geom_k", "24"]), ("median", ["--geom_radius_norm",
                                                                     "median"])):
        pre[tag] = os.path.join(root, f"pre_{tag}")
        line[f"preprocess_{tag}_s_per_tile"] = quiet_cli(
            ["preprocess", "--in_path", las_dir, "--out_path", pre[tag], "--geom_features",
             *flags]) / len(tiles)
        plain_dir = os.path.join(tiles_dir, "pre_w1")
        files = sorted(os.listdir(pre[tag]))
        if files != sorted(os.listdir(plain_dir)):
            raise RuntimeError(f"preprocess --geom_features ({tag}) wrote other files")
        for f in files:
            if f.endswith(".txt"):
                continue
            a, b = load_cloud(os.path.join(pre[tag], f)), load_cloud(os.path.join(plain_dir, f))
            if a.shape[1] != 19 or not np.array_equal(a[:, :13], b):
                raise RuntimeError(f"{tag} {f}: {a.shape}, its first 13 columns differ from "
                                   "the plain preprocess's")
            if not ((a[:, 13:] >= 0).all() and (a[:, 13:] <= 1).all()):
                raise RuntimeError(f"{tag} {f}: geometric columns outside [0, 1]")
    line["plain_preprocess_s_per_tile"] = tiles_data["preprocess_s_per_tile"]
    _say(f"  (a) preprocess --geom_features: {line['preprocess_absolute_s_per_tile']:.2f} s a "
         f"tile (median {line['preprocess_median_s_per_tile']:.2f}) against "
         f"{line['plain_preprocess_s_per_tile']:.2f} plain; 19 columns, the first 13 equal")
    # (b) the kernels at the geometry shape
    gcfg = geom_cfg()
    rows = geom_kernel_rows(seeded_model(gcfg).to(dev), dev)
    # (c) a 15-column dataset; the geometry model's step, train command, warm step
    data = os.path.join(root, "data")
    os.makedirs(data)
    names = write_geom_dataset(data)
    batch = step_batch(data, names, dev, extra=GEOM_EXTRA)
    if batch["points"].shape[-1] != 15:
        raise RuntimeError(f"geometry batch {list(batch['points'].shape)}")
    card_against_cpu_step(geom_cfg(dropout=0.0), batch, dev, what="geometry: ")
    geom_ckpt, _, _, wall = geom_train_cli("train geom", data, os.path.join(root, "geom"), dev,
                                           ["--geom_features"])
    big = step_batch(data, names, dev, TRAIN_BATCH, GEOM_EXTRA)
    line["geom_train"] = {"cli_wall_s": wall, **geom_warm_step(gcfg, big, dev)}
    _say("  (c) geom train: " + json.dumps(line["geom_train"]))
    # (d) serve, test and whole-tile infer of the geometry checkpoint
    cfg, model = load_model(geom_ckpt, dev)
    launches, served = {}, {}
    for backend in ("fused", "int8"):
        counts, _, served[backend], clouds = serve_phase(
            model, cfg, backend, str(dev), ckpt=geom_ckpt)
        launches[f"geom_serve_{backend}"] = counts
    xla = TiledInferencer(model, cfg, backend="xla", device=dev).predict_many(
        clouds, seeds=[0] * len(clouds))
    agree = {b: float(np.mean(np.concatenate([served[b][i] == xla[i] for i in served[b]])))
             for b in served}
    line["geom_serve_label_agreement_with_xla"] = agree
    _say(f"  (d) served 15-column bodies: labels against xla fused {agree['fused']:.6f} "
         f"(>= 0.999), int8 {agree['int8']:.6f} (> 0.97)")
    if not (agree["fused"] >= 0.999 and agree["int8"] > 0.97):
        raise RuntimeError("the geometry checkpoint's served labels do not track xla")
    test_dir = pre["absolute"]
    files = (read_split_list(os.path.join(test_dir, "test_seg_files.txt"))
             or read_split_list(os.path.join(test_dir, "val_seg_files.txt")))
    ds = EvalCloudDataset(test_dir, files, extra_features=GEOM_EXTRA)
    samples = [ds[i] for i in range(len(ds))]
    n_test = sum(len(s["labels"]) for s in samples)
    for backend in ("fused", "int8"):
        run = f"geom_test_{backend}"
        summary, launches[run], rec, wall = eval_cli(run, [
            "test", test_dir, "--path_list_files", test_dir, "--model_checkpoint", geom_ckpt,
            "--backend", backend, "--device", str(dev), "--out_path",
            os.path.join(root, run)])
        same_summary(run, summary, summary_of(rec["labels"], samples, cfg.model.num_classes))
        line[run] = {"points": n_test, "wall_s": wall, "points_per_sec": n_test / wall,
                     "miou": summary["miou"], "bucket_forwards": rec["forwards"]}
        run = f"geom_tile_infer_{backend}"
        out = os.path.join(root, run)
        _, launches[run], rec, wall = eval_cli(run, [
            "infer", las_dir, "--model_checkpoint", geom_ckpt, "--backend", backend,
            "--device", str(dev), "--out_path", out])
        check_tile_run(run, tiles, out, rec, geom_ckpt, backend, dev)
        line[run] = {"wall_s": wall, "points_per_sec": tiles_data["las_points"] / wall,
                     "bucket_forwards": rec["forwards"]}
    _say("  (d) test and whole-tile infer: " + json.dumps(
        {k: v for k, v in line.items() if k.startswith(("geom_test", "geom_tile"))}))
    # (e) the edge block and the geometry tokens at full width
    ecfg = geom_cfg(local_agg="edge", att_geom_tokens=True)
    edge_flags = ["--geom_features", "--local_agg", "edge", "--att_geom_tokens"]
    # the edge block max-pools 16 neighbours per point and channel, 16 times
    # the pools of the trunks, so float32 near-ties move more entries: 348 of
    # 1,215,316 determined (2.9e-4) on an H100 80GB HBM3 at 700 W, where
    # float64 held every gradient to 1.1e-13 of its max (PERF.md §6); float32
    # is held to 5e-4 here
    with no_kernel_launches("edge step"):
        card_against_cpu_step(geom_cfg(dropout=0.0, local_agg="edge", att_geom_tokens=True),
                              batch, dev, what="edge + tokens: ", off_share=5e-4)
    edge_ckpt, _, _, wall = geom_train_cli("train edge", data, os.path.join(root, "edge"), dev,
                                           edge_flags)
    with no_kernel_launches("edge warm step"):
        line["edge_train"] = {"cli_wall_s": wall, **geom_warm_step(ecfg, big, dev),
                              "knn_ms": knn_ms(ecfg, big, dev)}
    _say("  (e) edge + tokens train: " + json.dumps(line["edge_train"]))
    stdout, _, rec, wall = family_cli("test edge", [
        "test", test_dir, "--path_list_files", test_dir, "--model_checkpoint", edge_ckpt,
        "--device", str(dev), "--out_path", os.path.join(root, "edge_test")])
    same_summary("edge test", last_json(stdout), summary_of(
        rec["labels"], samples, cfg.model.num_classes))
    line["edge_test"] = {"wall_s": wall, "points_per_sec": n_test / wall,
                         "miou": last_json(stdout)["miou"]}
    _, err, _, _ = family_cli("test edge --backend fused", [
        "test", test_dir, "--path_list_files", test_dir, "--model_checkpoint", edge_ckpt,
        "--backend", "fused", "--device", str(dev)], expect=1)
    if ("backend 'fused' reassembles the reference encoder layout and does not know the "
            "local_agg='edge' edge block") not in err:
        raise RuntimeError(f"test --backend fused of the edge checkpoint: {err}")
    # (f) distillation from (c) and (e) into a plain 9-column student
    teacher = []
    for c in (geom_ckpt, edge_ckpt):
        t_cfg, t_model = load_model(c, dev)
        teacher.append((t_cfg, [t_model]))
    student = AMPNetConfig(model=ModelConfig(dropout=0.0), train=TrainConfig(distill_alpha=0.5))

    def distill_step(device, dtype):
        """The student's step with copies of the teachers on ``device``."""
        groups = [(c, [copy.deepcopy(m[0]).to(device, dtype)]) for c, m in teacher]
        return make_step_fns(student, augment=False, teacher=groups)[0]

    with no_kernel_launches("distillation step"):
        card_against_cpu_step(student, batch, dev, what="distillation: ", step_for=distill_step)
    line["distill"] = {}
    for accum in (1, 2):
        run = f"train distill grad_accum {accum}"
        _, rows_, err, wall = geom_train_cli(run, data, os.path.join(root, f"distill{accum}"),
                                             dev, ["--distill_from", f"{geom_ckpt},{edge_ckpt}",
                                                   "--grad_accum", str(accum)], epochs=1)
        if "teacher reads 6 extra geom columns" not in err:
            raise RuntimeError(f"{run}: the batch did not widen to the teacher's columns: {err}")
        line["distill"][f"grad_accum_{accum}"] = {
            "cli_wall_s": wall, "distill_loss": rows_[0]["distill_loss"],
            "epoch_seconds": rows_[0]["epoch_seconds"]}
    with no_kernel_launches("distillation warm step"):
        line["distill"]["warm"] = geom_warm_step(
            AMPNetConfig(train=TrainConfig(distill_alpha=0.5)), big, dev, teacher=teacher)
    _say("  (f) distillation: " + json.dumps(line["distill"]))
    # (g) demo --geom_features on the card
    summary, launches["geom_demo_test"], _, line["demo_s"] = eval_cli("geom_demo_test", [
        "demo", "--out_path", os.path.join(root, "demo"), *DEMO_ARGS, "--geom_features",
        "--backend", "fused", "--device", str(dev)])
    if not np.isfinite(summary["miou"]) or summary["n_clouds"] < 1:
        raise RuntimeError(f"demo --geom_features: summary {summary}")
    line["phase_s"] = time.perf_counter() - t_phase
    _say("geometry: " + json.dumps(line))
    _say(f"  geometry phase: {line['phase_s']:.2f} s")
    return launches, rows


# phase 11: data parallelism at full width. The training runs take phase 6's
# dataset (32 x 9 x 2048 a global batch); the sharded serve runs take 4
# clouds of 50,000 points and 2 of 20,000 over two replicas on cuda:0.
PAR_STEPS = 3
PAR_SERVE_POINTS = (50_000, 50_000, 50_000, 50_000, 20_000, 20_000)
PAR_DEVICES = ("cuda:0", "cuda:0")  # two replicas on the one card


def par_state(cfg, dev, dtype=torch.float32):
    """A train state of the seeded flagship in ``dtype`` on ``dev``: the same
    weights in every process."""
    from ampnet_tpu_torch.train.state import create_train_state

    return create_train_state(cfg, seeded_model(cfg).train().to(dev, dtype), 1, dev)


def cast_batch(batch, dtype):
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}


def par_grads(state) -> dict:
    return {n: p.grad.detach().cpu().double() for n, p in state.model.named_parameters()}


def grad_err_of_max(ref, got, cancelled) -> float:
    """The largest |g − g_ref| over each parameter's largest |g_ref|, over
    the parameters whose gradient is determined (``step_on_card_and_cpu``)."""
    err = 0.0
    for name, g_ref in ref.items():
        scale = g_ref.abs().max().item()
        if name in cancelled or scale < GRAD_NOISE:
            continue
        err = max(err, (got[name] - g_ref).abs().max().item() / scale)
    return err


def kernel_launches() -> int:
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain
    from ampnet_tpu_torch.ops.quantized_mlp import quantized_mlp_chain

    return fused_mlp_chain.launches + quantized_mlp_chain.launches


def reset_launches() -> None:
    from ampnet_tpu_torch.ops.device_stamp import device_stamp
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain
    from ampnet_tpu_torch.ops.kmeans import sinkhorn_iterations
    from ampnet_tpu_torch.ops.quantized_mlp import quantized_mlp_chain

    fused_mlp_chain.launches = quantized_mlp_chain.launches = device_stamp.launches = 0
    sinkhorn_iterations.launches = 0


def timed_steps(step, state, batch, n) -> tuple:
    """(losses, host ms of each step, each ending in a sync)."""
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(state, batch)["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def sharded_runs(step_for, batch, cfg, dev, shard) -> dict:
    """(b)'s runs of one side: in float64 PAR_STEPS steps (grad_accum 1; the
    gradients of step 1, every loss) and one grad_accum 2 step (its
    gradients); in float32 PAR_STEPS steps (the losses, each step's host
    ms). ``step_for(accum)`` is the side's train step, ``shard(batch,
    accum)`` its rows of the global batch."""
    out = {}
    for dtype, name in ((torch.float64, "64"), (torch.float32, "32")):
        for accum in ((1, 2) if dtype == torch.float64 else (1,)):
            state = par_state(cfg, dev, dtype)
            step, rows = step_for(accum), cast_batch(shard(batch, accum), dtype)
            losses, ms = timed_steps(step, state, rows, 1)
            if dtype == torch.float64:
                out[f"grads64_{accum}"] = par_grads(state)
            if accum == 1:
                more = timed_steps(step, state, rows, PAR_STEPS - 1)
                losses, ms = losses + more[0], ms + more[1]
            out[f"losses{name}_{accum}"], out[f"step_ms{name}"] = losses, ms
            del state, rows
            torch.cuda.empty_cache()
    return out


def parallel_rank(dp, data_dir, names, out_dir):
    """Phase 11 (b), one of two gloo ranks that share cuda:0: its rows of the
    global batch through the sharded step (``sharded_runs``); saved as
    ``rank<r>.pt``."""
    from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig
    from ampnet_tpu_torch.parallel.mesh import make_sharded_step_fns, shard_batch

    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0))
    batch = step_batch(data_dir, names, dp.device, batch=TRAIN_BATCH)
    reset_launches()
    out = sharded_runs(lambda accum: make_sharded_step_fns(cfg, dp, augment=False,
                                                           grad_accum=accum)[0],
                       batch, cfg, dp.device, lambda b, accum: shard_batch(b, dp, accum))
    out["launches"] = kernel_launches()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.save(out, os.path.join(out_dir, f"rank{dp.rank}.pt"))


def parallel_world_one(cfg, batch, dev, cancelled, work) -> dict:
    """(a): one NCCL rank through the sharded step against the plain step on
    the same weights and batch; then warm steps of each, timed."""
    from ampnet_tpu_torch.parallel.mesh import (
        close_data_parallel,
        init_data_parallel,
        make_sharded_step_fns,
    )
    from ampnet_tpu_torch.train.step import make_step_fns

    dp = init_data_parallel(0, 1, dev, init_method="file://" + os.path.join(work, "store_a"))
    try:
        plain, sharded = make_step_fns(cfg, augment=False)[0], make_sharded_step_fns(
            cfg, dp, augment=False)[0]
        states = {"plain": par_state(cfg, dev), "sharded": par_state(cfg, dev)}
        loss = {k: float((plain if k == "plain" else sharded)(s, batch)["loss"])
                for k, s in states.items()}
        grads = {k: par_grads(s) for k, s in states.items()}
        stats = max((a - b).abs().max().item() for a, b in zip(
            states["plain"].model.buffers(), states["sharded"].model.buffers()))
        out = {"loss_rel_err": abs(loss["sharded"] - loss["plain"]) / abs(loss["plain"]),
               "grad_err_of_max": grad_err_of_max(grads["plain"], grads["sharded"], cancelled),
               "bn_stats_err": stats}
        windows = batch["points"].shape[0] * batch["points"].shape[1]
        for _ in range(2):  # the other order: each side warm before its timing
            for name, step in (("sharded", sharded), ("plain", plain)):
                _, ms = timed_steps(step, states[name], batch, PAR_STEPS)
                out[f"{name}_step_ms"] = sum(ms) / len(ms)
        for name in ("sharded", "plain"):
            out[f"{name}_windows_per_sec"] = windows / (out[f"{name}_step_ms"] / 1e3)
    finally:
        close_data_parallel()
    _say("  (a) one NCCL rank against the plain step: " + json.dumps(out))
    if not (out["loss_rel_err"] <= 1e-5 and out["grad_err_of_max"] <= 1e-4
            and out["bn_stats_err"] <= 1e-6):
        raise RuntimeError("the sharded step at world size 1 differs from the plain step")
    return out


def parallel_two_ranks(cfg, data_dir, names, dev, cancelled, work) -> dict:
    """(b): two gloo ranks on cuda:0 against one process on the global batch
    (``sharded_runs`` on both sides). float64 holds the arithmetic: the
    summed gradients to 1e-4 of each parameter's largest (grad_accum 1 and
    2), the losses of PAR_STEPS steps to 3e-3 (step 1 to 1e-5). float32, the
    path training runs: every loss bit-identical across the ranks and step 1
    to 1e-5; its later steps are printed beside one process against itself
    on the same clouds in another order (the float32 noise floor: Adam's
    first updates are about lr · sign(g), so rounding-level gradients move
    parameters by lr either way)."""
    import gc

    from ampnet_tpu_torch.parallel.mesh import spawn_ranks
    from ampnet_tpu_torch.train.step import make_step_fns

    batch = step_batch(data_dir, names, dev, batch=TRAIN_BATCH)
    plain = lambda accum: make_step_fns(cfg, augment=False, grad_accum=accum)[0]
    one = sharded_runs(plain, batch, cfg, dev, lambda b, accum: b)
    flipped = {k: v.flip(0) for k, v in batch.items()}  # the same clouds, reversed
    state = par_state(cfg, dev)
    one["losses32_flipped"], _ = timed_steps(plain(1), state, flipped, PAR_STEPS)
    del state, batch, flipped
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join(work, "ranks")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    spawn_ranks(parallel_rank, 2, device=PAR_DEVICES[0], backend="gloo",
                args=(data_dir, names, out_dir))
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(2)]
    rel = lambda a, b: [abs(x - y) / abs(y) for x, y in zip(a, b)]
    out = {"ranks_s": spawn_s,
           "two_rank_step_ms": sum(ranks[0]["step_ms32"][1:]) / (PAR_STEPS - 1),
           "one_process_step_ms": sum(one["step_ms32"][1:]) / (PAR_STEPS - 1),
           "rank_peak_gib": [r["peak_gib"] for r in ranks],
           "rank_launches": [r["launches"] for r in ranks],
           "losses_bit_identical": all(ranks[0][k] == ranks[1][k]
                                       for k in ("losses64_1", "losses64_2", "losses32_1")),
           "float64_loss_rel_err": rel(ranks[0]["losses64_1"], one["losses64_1"]),
           "float64_accum2_loss_rel_err": rel(ranks[0]["losses64_2"], one["losses64_2"])[0],
           "float32_losses": {"ranks": ranks[0]["losses32_1"], "one": one["losses32_1"],
                              "one_reversed": one["losses32_flipped"]},
           "float32_loss_rel_err": rel(ranks[0]["losses32_1"], one["losses32_1"]),
           "float32_noise_floor_rel_err": rel(one["losses32_flipped"], one["losses32_1"])}
    for accum in (1, 2):
        out[f"float64_grad_err_of_max_accum{accum}"] = max(
            grad_err_of_max(one[f"grads64_{accum}"], r[f"grads64_{accum}"], cancelled)
            for r in ranks)
    _say("  (b) two gloo ranks on one card against one process: " + json.dumps(out))
    f64 = out["float64_loss_rel_err"]
    if not (out["losses_bit_identical"] and out["rank_launches"] == [0, 0]
            and f64[0] <= 1e-5 and max(f64) <= 3e-3
            and out["float64_accum2_loss_rel_err"] <= 1e-5
            and all(out[f"float64_grad_err_of_max_accum{a}"] <= 1e-4 for a in (1, 2))
            and out["float32_loss_rel_err"][0] <= 1e-5):
        raise RuntimeError("two ranks do not give the one-process step on the global batch")
    return out


def parallel_train_cli(data_dir, work) -> dict:
    """(c): ``train --num_devices 2 --device cuda``: with one card it exits 1
    naming the counts; with two or more it trains 1 epoch and rank 0 alone
    writes."""
    from ampnet_tpu_torch.cli.main import main as cli_main

    cards = torch.cuda.device_count()
    out_dir = os.path.join(work, "par_out")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli_main(["train", data_dir, "--path_list_files", data_dir, "--out_path", out_dir,
                       "--device", "cuda", "--num_devices", "2", "--epochs", "1",
                       "--batch_size", str(TRAIN_BATCH), "--seed", str(SEED)])
    if cards < 2:
        case = "one card: refused"
        ok = rc == 1 and "needs 2 CUDA devices; 1 visible" in err.getvalue()
    else:
        case = f"{cards} cards: trained"
        with open(os.path.join(out_dir, "logs", "attention_segmentation_train",
                               "scalars.csv")) as f:
            loss_rows = [r for r in f.read().splitlines() if r.split(",")[2] == "loss"]
        ok = (rc == 0 and os.listdir(os.path.join(out_dir, "checkpoints"))
              == ["attention_segmentation_best"] and len(loss_rows) == 1)
    out = {"case": case, "rc": rc, "stderr": err.getvalue().strip()[-300:]}
    _say("  (c) train --num_devices 2 --device cuda: " + json.dumps(out))
    if not ok:
        raise RuntimeError("train --num_devices 2 did not behave for this card count")
    return out


def parallel_serve(model, cfg) -> tuple:
    """(d): TiledInferencer over two replicas on cuda:0 under fused and int8:
    every answer equals predict_many on one device over its shard's clouds
    and seeds, and each shard bucket forward launches the kernels as a
    bucket forward does. Returns (launches by backend, the numbers)."""
    from ampnet_tpu_torch.cli.main import main as cli_main
    from ampnet_tpu_torch.core.weights import flax_variables, save_reference_pth
    from ampnet_tpu_torch.infer.tiled import TiledInferencer
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain
    from ampnet_tpu_torch.ops.quantized_mlp import quantized_mlp_chain

    rng = np.random.default_rng(SEED + 11)
    clouds = []
    for n in PAR_SERVE_POINTS:
        c = rng.normal(size=(n, 9)).astype(np.float32) * 0.5
        c[:, :2] = rng.uniform(-1.0, 1.0, size=(n, 2))
        clouds.append(c)
    seeds = list(range(len(clouds)))
    launches, out = {}, {}
    for backend, per in LAUNCHES_PER_FORWARD.items():
        one = TiledInferencer(copy.deepcopy(model), cfg, backend=backend, device=PAR_DEVICES[0])
        two = TiledInferencer(copy.deepcopy(model), cfg, backend=backend, devices=PAR_DEVICES)
        two.predict_many(clouds, seeds=seeds)  # warm: every shape once
        reset_launches()  # the main path's run starts here
        t0 = time.perf_counter()
        handle = two.dispatch_many(clouds, seeds=seeds)
        got = two.fetch_many(handle)
        wall = time.perf_counter() - t0
        counts = {"fused_mlp_chain": fused_mlp_chain.launches,
                  "quantized_mlp_chain": quantized_mlp_chain.launches}  # ... and ends here
        forwards = len(handle["pending"])
        if any(counts[k] != per[k] * forwards for k in counts):
            raise RuntimeError(f"{backend}: {counts} over {forwards} shard bucket forwards")
        for idxs, _ in handle["pending"]:
            want = one.predict_many([clouds[i] for i in idxs], seeds=[seeds[i] for i in idxs])
            for i, w in zip(idxs, want):
                if not np.array_equal(got[i], w):
                    raise RuntimeError(f"{backend}: cloud {i} differs from its shard on one "
                                       "device")
        t0 = time.perf_counter()
        one.predict_many(clouds, seeds=seeds)
        launches[backend] = counts
        out[backend] = {"shard_bucket_forwards": forwards, "launches": counts,
                        "shards": [len(idxs) for idxs, _ in handle["pending"]],
                        "sharded_wall_ms": wall * 1e3,
                        "one_device_wall_ms": (time.perf_counter() - t0) * 1e3}
        del one, two
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "m.pth")
        save_reference_pth(flax_variables(model), pth, meta={"number_of_points": 2048})
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = (cli_main(["serve", "--model_checkpoint", pth, "--num_devices", "2"])
                  if torch.cuda.device_count() < 2 else None)
    out["serve_num_devices_2"] = {"rc": rc, "stderr": err.getvalue().strip()[-200:]}
    _say("  (d) sharded serving on two replicas: " + json.dumps(out))
    if rc is not None and (rc != 1 or "needs 2 CUDA devices" not in err.getvalue()):
        raise RuntimeError("serve --num_devices 2 on one card did not exit 1")
    return launches, out


def parallel_windows(model, dev) -> dict:
    """(e): the window-axis forward on [cuda:0] grids 1 x 2 and 2 x 1 against
    the single forward at MODEL_SHAPE; neither kernel launches."""
    from ampnet_tpu_torch.parallel.window_shard import make_grid, make_window_sharded_forward

    b, w, n = MODEL_SHAPE
    g = torch.Generator().manual_seed(SEED + 12)
    points = (torch.randn(b, w, n, 9, generator=g) * 0.5).to(dev)
    cent = torch.rand(b, w, 2, generator=g).to(dev)
    pad = torch.zeros(b, w, dtype=torch.bool, device=dev)
    pad[:, -1] = True
    with torch.inference_mode():
        single = model(points, cent, pad)[0]
    reset_launches()
    out = {}
    for nd, nw in ((1, 2), (2, 1)):
        fwd = make_window_sharded_forward(model, make_grid(nd, nw, [dev, dev]))
        out[f"{nd}x{nw}_max_abs_err"] = (fwd(points, cent, pad) - single).abs().max().item()
    out["launches"] = kernel_launches()
    _say("  (e) window-axis forward: " + json.dumps(out))
    if out["launches"] or max(v for k, v in out.items() if k.endswith("err")) > 2e-5:
        raise RuntimeError("the window-axis forward differs from the single forward")
    return out


def parallel_phase(model, cfg, dev, card, work) -> dict:
    """Phase 11: (a)-(e) on phase 6's dataset in ``work/data`` → the sharded
    serve runs' launches by backend."""
    from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig
    from ampnet_tpu_torch.data.io_utils import read_split_list

    t_phase = time.perf_counter()
    gc_cuda()  # (a) and (b) hold 37 GB of float64 steps: start from an empty cache
    data_dir = os.path.join(work, "data")
    names = read_split_list(os.path.join(data_dir, "train_seg_files.txt"))
    no_drop = AMPNetConfig(model=ModelConfig(dropout=0.0))
    cancelled = biases_before_batch_norm(seeded_model(no_drop))
    reset_launches()
    line = {"card": card, "batch": [TRAIN_BATCH, TRAIN_WINDOWS, TRAIN_POINTS]}
    line["a"] = parallel_world_one(no_drop, step_batch(data_dir, names, dev, batch=TRAIN_BATCH),
                                   dev, cancelled, work)
    line["a"]["launches"] = kernel_launches()
    torch.cuda.empty_cache()
    line["b"] = parallel_two_ranks(no_drop, data_dir, names, dev, cancelled, work)
    line["c"] = parallel_train_cli(data_dir, work)
    launches, line["d"] = parallel_serve(model, cfg)
    line["e"] = parallel_windows(model, dev)
    line["phase_s"] = time.perf_counter() - t_phase
    _say("parallel: " + json.dumps(line))
    if line["a"]["launches"]:
        raise RuntimeError("a kernel launched on the sharded training step")
    _say(f"  parallel phase: {line['phase_s']:.2f} s")
    return launches


# phase 12 (training options). The CPU test's bfloat16 floor of the loss:
# JAX's bfloat16 step against its float32 step, 9.2e-3 of a 1.81 loss
# (tests/test_torch_train_options.py), as a share of the float32 loss
BF16_LOSS_FLOOR_REL = 5.1e-3
OPTION_RUNS = {"options_test_fused": LAUNCHES_PER_FORWARD["fused"],
               "options_test_xla": {"fused_mlp_chain": 0, "quantized_mlp_chain": 0}}


def options_steps(cfgs, batch, dev) -> dict:
    """One seeded step of each config on ``batch`` (augmentation off), from
    the same weights, then 2 warm and 3 timed steps: {name: loss, the
    gradients and buffers of the first step, step ms (host clock ending in a
    sync), windows/s, peak GiB}. No kernel launches."""
    from ampnet_tpu_torch.train.state import create_train_state
    from ampnet_tpu_torch.train.step import make_step_fns

    out = {}
    for name, cfg in cfgs.items():
        with no_kernel_launches(f"options_{name}"):
            state = create_train_state(cfg, seeded_model(cfg).train(), 1, dev)
            step = make_step_fns(cfg, augment=False)[0]
            gc_cuda()
            torch.cuda.reset_peak_memory_stats()
            loss = float(step(state, batch)["loss"])
            first = {"loss": loss,
                     "grads": {n: p.grad.detach().clone() for n, p in
                               state.model.named_parameters()},
                     "buffers": {n: b.detach().clone() for n, b in state.model.named_buffers()}}
            for _ in range(2):
                step(state, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 3 * 1e3
        b, w = batch["points"].shape[:2]
        out[name] = {**first, "step_ms": ms, "windows_per_sec": b * w / (ms / 1e3),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del state, step
    return out


def largest_gap(a: dict, b: dict) -> float:
    """The largest |a − b| over every tensor of two {name: tensor} maps."""
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in a)


def options_cli(run, data_dir, out_dir, dev, flags) -> tuple:
    """``train --epochs 1`` at batch TRAIN_BATCH on phase 6's data with
    ``flags``, 0 kernel launches → (stderr, the epoch's CSV row, the printed
    summary, checkpoint directory, wall s)."""
    stdout, err, _, wall = family_cli(run, [
        "train", data_dir, "--path_list_files", data_dir, "--out_path", out_dir,
        "--device", str(dev), "--epochs", "1", "--batch_size", str(TRAIN_BATCH),
        "--seed", str(SEED), *flags])
    rows = train_csv_rows(out_dir)
    return (err, rows[0], json.loads(stdout[stdout.index("{"): stdout.rindex("}") + 1]),
            os.path.join(out_dir, "checkpoints", "attention_segmentation_best"), wall)


def host_batches(batcher) -> tuple:
    """One epoch of a host batcher: (the batches, host seconds)."""
    t0 = time.perf_counter()
    batches = list(batcher)
    return batches, time.perf_counter() - t0


def options_phase(dev, card, work) -> dict:
    """Phase 12: the training options at full width (attention, 256-d, 8
    heads, 32 x 9 x 2048, phase 6's data). (a) a bfloat16 step against the
    float32 step on one batch (the loss within the CPU test's bfloat16 floor
    of the float32 loss), each timed, and ``train --dtype bfloat16`` for 1
    epoch (its checkpoint records the dtype); (b) the remat step against the
    plain step (loss, gradients, running statistics), each timed; (c)
    ``train --oversample_factor 3 --oversample_classes auto --seg_weighing
    EFS``: the printed weights and oversampled cloud count equal the port's
    functions on the host, the epoch's steps ``len(repeated pool) //
    batch``; (d) ``--epoch_dispatch off`` against ``auto``, 1 epoch: the same
    epoch metrics; (e) ``--device_cache off`` with prefetch 2 and 2 workers
    against prefetch 0: the same batches in the same order, and each epoch's
    seconds through the trainer; (f) ``test --backend fused`` and ``--backend
    xla`` of (a)'s checkpoint on phase 7's clouds: 4 ``fused_mlp_chain``
    launches per bucket forward under fused, none under xla, where the
    restored model computes in bfloat16. (a)-(e) launch neither kernel.
    Returns (f)'s launches by run."""
    from ampnet_tpu_torch.cli.main import rare_class_repeats, seg_class_weights
    from ampnet_tpu_torch.core.checkpoint import load_model, read_meta, read_payload
    from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig, TrainConfig
    from ampnet_tpu_torch.data.datasets import WindowedCloudDataset
    from ampnet_tpu_torch.data.pipeline import PaddedBatcher
    from ampnet_tpu_torch.models.backends import make_forward
    from ampnet_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    data_dir = os.path.join(work, "data")  # phase 6's
    names = [f"cloud{i:03d}.pkl" for i in range(TRAIN_CLOUDS)]
    out = {"card": card}
    batch = step_batch(data_dir, names, dev, batch=TRAIN_BATCH)

    # (a) bfloat16 against float32
    steps = options_steps({"float32": AMPNetConfig(model=ModelConfig(dropout=0.0)),
                           "bfloat16": AMPNetConfig(model=ModelConfig(dropout=0.0,
                                                                      dtype="bfloat16"))},
                          batch, dev)
    f32, bf16 = steps["float32"], steps["bfloat16"]
    rel = abs(bf16["loss"] - f32["loss"]) / abs(f32["loss"])
    out["a_bf16"] = {k: {m: v[m] for m in ("loss", "step_ms", "windows_per_sec", "peak_gib")}
                     for k, v in steps.items()}
    out["a_bf16"]["loss_rel_gap"] = rel
    if not rel <= BF16_LOSS_FLOOR_REL:
        raise RuntimeError(f"(a) the bfloat16 loss is {rel:.3g} of the float32 loss away; "
                           f"the CPU test's floor is {BF16_LOSS_FLOOR_REL}")
    del steps
    err, row, _, bf16_ckpt, wall = options_cli("options_train_bf16", data_dir,
                                               os.path.join(work, "opt_bf16"), dev,
                                               ["--dtype", "bfloat16"])
    if read_meta(bf16_ckpt)["config"]["model"]["dtype"] != "bfloat16":
        raise RuntimeError("(a) the bfloat16 checkpoint does not record its dtype")
    out["a_bf16"]["train_cli"] = {"loss": row["loss"], "epoch_seconds": row["epoch_seconds"],
                                  "wall_s": wall}
    _say("  (a) " + json.dumps(out["a_bf16"]))

    # (b) remat against the plain step, and the plain step against itself
    steps = options_steps({"plain": AMPNetConfig(model=ModelConfig(dropout=0.0)),
                           "plain_again": AMPNetConfig(model=ModelConfig(dropout=0.0)),
                           "remat": AMPNetConfig(model=ModelConfig(dropout=0.0, remat=True))},
                          batch, dev)
    plain, again, remat = steps["plain"], steps["plain_again"], steps["remat"]
    gaps = {k: (largest_gap(remat[k], plain[k]), largest_gap(again[k], plain[k]))
            for k in ("grads", "buffers")}
    out["b_remat"] = {
        "loss": {"plain": plain["loss"], "remat": remat["loss"]},
        "grad_gap": gaps["grads"][0], "buffer_gap": gaps["buffers"][0],
        "plain_to_itself": {"grads": gaps["grads"][1], "buffers": gaps["buffers"][1]},
        **{f"{k}_{m}": steps[k][m] for k in ("plain", "remat")
           for m in ("step_ms", "windows_per_sec", "peak_gib")}}
    _say("  (b) " + json.dumps(out["b_remat"]))
    if remat["loss"] != plain["loss"] or any(r > p for r, p in gaps.values()):
        raise RuntimeError("(b) the remat step differs from the plain step by more than the "
                           "plain step differs from itself")
    del steps, plain, again, remat
    gc_cuda()

    # (c) oversampling and data-driven weights, against the port's functions
    ds = WindowedCloudDataset(data_dir, names)
    reps, rare, n_over = rare_class_repeats(ds, 3, "auto", 5)
    cw, counts = seg_class_weights(ds, "EFS", 5, TrainConfig().beta)
    err, row, _, ckpt, wall = options_cli(
        "options_train_oversample", data_dir, os.path.join(work, "opt_over"), dev,
        ["--oversample_factor", "3", "--oversample_classes", "auto", "--seg_weighing", "EFS"])
    pool = int(reps.sum()) if reps is not None else len(names)
    want_over = (f"oversampling x3: {n_over}/{len(names)} train clouds contain rare classes "
                 f"{rare}" if reps is not None else "oversampling: no rare classes found")
    want_w = f"seg class weights (EFS, counts {counts.tolist()}): {[round(float(x), 5) for x in cw]}"
    steps_run = int(read_payload(ckpt)["step"])
    out["c_oversample"] = {"rare_classes": rare, "oversampled_clouds": n_over,
                           "pool": pool, "steps": steps_run, "weights": [float(x) for x in cw],
                           "counts": counts.tolist(), "loss": row["loss"],
                           "epoch_seconds": row["epoch_seconds"], "wall_s": wall}
    _say("  (c) " + json.dumps(out["c_oversample"]))
    if want_over not in err or want_w not in err or steps_run != pool // TRAIN_BATCH:
        raise RuntimeError(f"(c) printed {err[-1500:]!r}; want {want_over!r}, {want_w!r} and "
                           f"{pool // TRAIN_BATCH} steps (ran {steps_run})")

    # (d) --epoch_dispatch off against auto
    epochs = {}
    for mode in ("auto", "off"):
        _, row, summary, _, wall = options_cli(f"options_dispatch_{mode}", data_dir,
                                               os.path.join(work, f"opt_{mode}"), dev,
                                               ["--epoch_dispatch", mode])
        epochs[mode] = (row, summary, wall)
    keys = [k for k in epochs["auto"][0]  # the epoch's metrics, not its clocks
            if k not in ("epoch_seconds", "windows_per_sec", "total_hours")]
    gap = max(max(abs(epochs["auto"][0][k] - epochs["off"][0][k]) for k in keys
                  if np.isfinite(epochs["auto"][0][k])),
              max(abs(epochs["auto"][1][k] - epochs["off"][1][k]) for k in epochs["auto"][1]))
    out["d_dispatch"] = {mode: {"loss": r["loss"], "val_loss": sm["loss"],
                                "epoch_seconds": r["epoch_seconds"], "wall_s": w}
                         for mode, (r, sm, w) in epochs.items()}
    out["d_dispatch"]["largest_metric_gap"] = gap
    _say("  (d) " + json.dumps(out["d_dispatch"]))
    if not gap <= 1e-5:
        raise RuntimeError(f"(d) epoch_dispatch off and auto part by {gap:.3g}")

    # (e) the host batcher: prefetch 2 and 2 forked workers against synchronous
    cfg = AMPNetConfig(train=TrainConfig(batch_size=TRAIN_BATCH, seed=SEED))
    kw = dict(n_points=TRAIN_POINTS, max_windows=TRAIN_WINDOWS, seed=SEED)
    sync = PaddedBatcher(ds, TRAIN_BATCH, prefetch=0, **kw)
    pooled = PaddedBatcher(ds, TRAIN_BATCH, prefetch=2, workers=2, **kw)
    try:
        (want, t_sync), (got, t_pooled) = host_batches(sync), host_batches(pooled)
        same = len(want) == len(got) and all(
            a["names"] == b["names"] and all(np.array_equal(a[k], b[k])
                                             for k in ("points", "labels", "centroids"))
            for a, b in zip(want, got))
        seconds = {}
        for name, batcher in (("prefetch0", sync), ("prefetch2_workers2", pooled)):
            with no_kernel_launches(f"options_host_{name}"), \
                    contextlib.redirect_stdout(io.StringIO()):
                trainer = Trainer(cfg, seeded_model(cfg).train(), batcher, None,
                                  os.path.join(work, f"opt_{name}"), device=dev)
                hist = trainer.fit(1)
                trainer.close()
            seconds[name] = {"epoch_seconds": hist["train"][0]["epoch_seconds"],
                             "loss": hist["train"][0]["loss"]}
    finally:
        pooled.close()
    out["e_host_batcher"] = {"same_batches": same, "batches": len(got),
                             "host_epoch_s": {"prefetch0": t_sync,
                                              "prefetch2_workers2": t_pooled},
                             "trainer": seconds}
    _say("  (e) " + json.dumps(out["e_host_batcher"]))
    loss_gap = abs(seconds["prefetch0"]["loss"] - seconds["prefetch2_workers2"]["loss"])
    if not same or loss_gap > 1e-5 * abs(seconds["prefetch0"]["loss"]):
        raise RuntimeError("(e) prefetch 2 and workers 2 changed the batches or the epoch")

    # (f) the bfloat16 checkpoint under fused and xla
    bf16_cfg, model = load_model(bf16_ckpt, dev)
    probe = step_batch(data_dir, names, dev, batch=1)
    pad = (probe["labels"] == -1).all(-1)
    with no_kernel_launches("options_xla_dtype"):
        logits = make_forward(model, bf16_cfg, "xla", dev)(
            probe["points"], probe["centroids"], pad)
    if logits.dtype != torch.bfloat16:
        raise RuntimeError(f"(f) the bfloat16 checkpoint evaluates in {logits.dtype} under xla")
    del model
    eval_dir = os.path.join(work, "eval")  # phase 7's clouds
    launches = {}
    out["f_test"] = {}
    for backend in ("fused", "xla"):
        run = f"options_test_{backend}"
        summary, counts, rec, wall = eval_cli(run, [
            "test", eval_dir, "--path_list_files", eval_dir, "--model_checkpoint", bf16_ckpt,
            "--backend", backend, "--device", str(dev), "--out_path",
            os.path.join(work, run)])
        launches[run] = counts
        out["f_test"][backend] = {"miou": summary["miou"], "wall_s": wall,
                                  "bucket_forwards": rec["forwards"], "launches": counts}
    out["phase_s"] = time.perf_counter() - t_phase
    _say("train_options: " + json.dumps(out))
    return launches


# phase 13: the bench subcommand and observability. One bench forward pass
# at 32 x 9 x 2048 per call: 1 first call, 3 warm, 3 reps of 30 chained and
# 30 independent (ampnet_tpu_torch/bench.py)
BENCH_FORWARDS = 1 + 3 + 3 * (30 + 30)
BENCH_RUNS = {"bench_fused": LAUNCHES_PER_FORWARD["fused"],
              "bench_int8": LAUNCHES_PER_FORWARD["int8"],
              "bench_xla": {"fused_mlp_chain": 0, "quantized_mlp_chain": 0}}
BENCH_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "compile_s",
                   "reps_windows_per_sec", "rep_spread_pct"}
TILING_CLOUDS, TILING_POINTS, TILING_N_POINTS = 32, 20_000, 2048
TRACE_FORWARDS = 4  # traced fused forwards in (d): a spare first, then 3


@contextlib.contextmanager
def bench_backend(backend):
    """AMPNET_BACKEND set for one call, and restored after."""
    before = os.environ.get("AMPNET_BACKEND")
    os.environ["AMPNET_BACKEND"] = backend
    try:
        yield
    finally:
        if before is None:
            del os.environ["AMPNET_BACKEND"]
        else:
            os.environ["AMPNET_BACKEND"] = before


def launch_counts() -> dict:
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain
    from ampnet_tpu_torch.ops.quantized_mlp import quantized_mlp_chain

    return {"fused_mlp_chain": fused_mlp_chain.launches,
            "quantized_mlp_chain": quantized_mlp_chain.launches}


def check_bench_launches(run, counts):
    want = {k: v * BENCH_FORWARDS for k, v in BENCH_RUNS[run].items()}
    if counts != want:
        raise RuntimeError(f"{run}: launches {counts}, want {want} ({BENCH_FORWARDS} forwards)")


def bench_cli(dev) -> tuple:
    """(a): ``bench --device`` through ``cli.main.main`` under fused →
    (the stdout line, the stderr detail, launches)."""
    from ampnet_tpu_torch.cli.main import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    reset_launches()
    with bench_backend("fused"), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = cli_main(["bench", "--device", str(dev)])
    counts = launch_counts()
    err = err.getvalue()
    if rc != 0:
        raise RuntimeError(f"(a) bench exited {rc}: {err[-2000:]}")
    lines = out.getvalue().strip().splitlines()
    if len(lines) != 1:
        raise RuntimeError(f"(a) bench printed {len(lines)} stdout lines, want 1: {lines}")
    line = json.loads(lines[0])
    start = 0 if err.startswith("{\n") else err.rindex("\n{\n") + 1
    detail = json.JSONDecoder().raw_decode(err[start:])[0]
    return line, detail, counts


def bench_trace(call, trace_dir, forwards=TRACE_FORWARDS) -> tuple:
    """``core/profiling.py``'s ``trace`` around ``forwards`` calls of a fused
    bench forward → (trace files, the trace's ``fused_mlp_chain`` kernel
    names, the launches counted meanwhile, attempts). The counters must show
    4 launches a forward. The profiler may miss the first kernels of a trace
    (phase 5's breakdown sees whole short traces come back empty), so
    the first call is a spare: a trace that holds fewer than the other calls'
    kernels is taken again, up to 3 times."""
    import glob

    from ampnet_tpu_torch.core.profiling import trace

    per = LAUNCHES_PER_FORWARD["fused"]["fused_mlp_chain"]
    for attempt in range(1, 4):
        logdir = os.path.join(trace_dir, str(attempt))
        torch.cuda.synchronize()
        reset_launches()
        with trace(logdir):
            for _ in range(forwards):
                call()
            torch.cuda.synchronize()
        launched = launch_counts()
        if launched != {"fused_mlp_chain": per * forwards, "quantized_mlp_chain": 0}:
            raise RuntimeError(f"(d) {forwards} traced forwards launched {launched}")
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        chain = []
        for path in files:
            with open(path) as f:
                # the kernel of csrc/fused_mlp.cu takes a Chain; quantized_mlp.cu's a Params
                chain += [e["name"] for e in json.load(f)["traceEvents"]
                          if e.get("cat") == "kernel" and "chain_kernel" in e["name"]
                          and "Chain" in e["name"]]
        if len(chain) > per * forwards:
            raise RuntimeError(f"(d) the trace holds {len(chain)} fused_mlp_chain kernels, "
                               f"more than the {per * forwards} launched")
        if len(chain) >= per * (forwards - 1):
            break
    return files, chain, launched, attempt


def forward_device_ms(call, forwards=3) -> dict:
    """Device ms of one call by kernel (torch.profiler over ``forwards``
    recorded calls after a warm-up one, read when the recorded steps end):
    every kernel, the ``chain_kernel``s, and the six largest; "not
    measured" when the profiler returns no device event."""
    from torch.profiler import ProfilerActivity, profile, schedule

    top = {}

    def ready(prof):
        for e in prof.key_averages():
            # device events but the steps' own spans; names sharing 60 characters are summed
            if e.device_type.name == "CUDA" and not e.key.startswith("ProfilerStep"):
                top[e.key[:60]] = (top.get(e.key[:60], 0.0)
                                   + e.self_device_time_total / 1e3 / forwards)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=forwards),
                 on_trace_ready=ready) as prof:
        for _ in range(1 + forwards):
            call()
            torch.cuda.synchronize()
            prof.step()
    if not top:
        return {"all": "not measured"}
    return {"all": sum(top.values()),
            "chain_kernel": sum(ms for k, ms in top.items() if "chain_kernel" in k),
            "top": dict(sorted(top.items(), key=lambda kv: -kv[1])[:6])}


def bench_phase(dev, card, work) -> dict:
    """Phase 13: (a) ``python -m ampnet_tpu_torch bench --device cuda`` under
    ``AMPNET_BACKEND=fused``: one stdout line with the JAX bench's keys,
    ``value`` > 0, ``vs_baseline`` from the pin, fp32 and bf16 train arms
    without an error, 4 ``fused_mlp_chain`` launches per forward; (b)
    ``measure_forward`` under int8 (2 + 2 a forward) and xla (none); (c)
    the bench forward's logits at [32, 9, 2048, 9] under fused and int8
    against xla on the bench's model and draws (fused 5e-3 and agreement >
    0.999; int8 agreement > 0.97); (d) ``trace`` of 4 fused forwards names
    ``fused_mlp_chain``'s kernel (``bench_trace``), their device ms by
    kernel, ``StepTimer`` over 10 forwards (each time
    at least the CUDA-event time of its call), the phase's
    ``EnergyTracker`` report, a ``MetricsLogger`` scalar and histogram; (e)
    ``sequential_tiling`` on the card against the CPU, and
    ``scan_for_towers`` on phase 8's first tile. Returns the bench runs'
    launches."""
    import glob

    from ampnet_tpu_torch import bench
    from ampnet_tpu_torch.core.config import AMPNetConfig
    from ampnet_tpu_torch.core.logging import MetricsLogger
    from ampnet_tpu_torch.core.plotting import log_histogram_to_tensorboard
    from ampnet_tpu_torch.core.profiling import EnergyTracker, StepTimer
    from ampnet_tpu_torch.data.las_io import read_las
    from ampnet_tpu_torch.ops.sequential_tiling import sequential_tiling, sequential_tiling_from
    from ampnet_tpu_torch.ops.sliding_window import scan_for_towers

    gc_cuda()
    t_phase = time.perf_counter()
    out = {"card": card}
    launches = {}
    energy = EnergyTracker()
    with energy:
        # (a) the bench command under fused
        line, detail, launches["bench_fused"] = bench_cli(dev)
        check_bench_launches("bench_fused", launches["bench_fused"])
        with open(bench.BASELINE_PIN) as f:
            pin = json.load(f)["windows_per_sec"]
        train = detail["train"]
        out["a_cli"] = {"line": line, "train": train,
                        "forward_ms": {k: detail["forward"][k]
                                       for k in ("throughput_step_ms", "latency_step_ms")},
                        "device": detail["forward"]["device"],
                        "launches": launches["bench_fused"]}
        _say("  (a) " + json.dumps(out["a_cli"]))
        if set(line) != BENCH_LINE_KEYS or not line["value"] > 0 \
                or line["vs_baseline"] != round(line["value"] / pin, 2):
            raise RuntimeError(f"(a) the bench line {line} lacks the JAX keys, a value or the "
                               f"pinned baseline's ratio ({pin} windows/s)")
        if "error" in train or any(not train[arm]["step_ms"] > 0 for arm in ("fp32", "bf16")):
            raise RuntimeError(f"(a) a train arm failed: {train}")

        # (b) measure_forward under int8 and xla
        out["b_forward"] = {}
        for backend in ("int8", "xla"):
            run = f"bench_{backend}"
            reset_launches()
            with bench_backend(backend):
                res = bench.measure_forward(device=dev)
            launches[run] = launch_counts()
            check_bench_launches(run, launches[run])
            out["b_forward"][backend] = {k: res[k] for k in (
                "windows_per_sec", "throughput_step_ms", "latency_step_ms",
                "windows_per_sec_reps", "compile_s")}
        _say("  (b) " + json.dumps(out["b_forward"]))

        # (c) the bench forward's logits against xla
        cfg = AMPNetConfig()
        model = bench.bench_model(cfg)
        pts, cent = (torch.from_numpy(a).to(dev) for a in bench.forward_inputs())
        pad = torch.zeros(pts.shape[:2], dtype=torch.bool, device=dev)
        zero = torch.zeros((), device=dev)
        logits = {b: bench.make_bench_forward(model, cfg, b, dev)(pts, cent, pad, zero)[0]
                  for b in ("xla", "fused", "int8")}
        torch.cuda.synchronize()
        want = (*pts.shape[:3], cfg.model.num_classes)
        ref = logits["xla"]
        out["c_against_xla"] = {}
        for b in ("fused", "int8"):
            got = logits[b]
            if tuple(got.shape) != want or not torch.isfinite(got).all():
                raise RuntimeError(f"(c) {b} logits {tuple(got.shape)}, want {want}, finite")
            out["c_against_xla"][b] = {
                "max_abs_diff": (got - ref).abs().max().item(),
                "agreement": (got.argmax(-1) == ref.argmax(-1)).float().mean().item()}
        out["c_against_xla"]["max_abs_logit"] = ref.abs().max().item()
        _say("  (c) " + json.dumps(out["c_against_xla"]))
        fused, int8 = out["c_against_xla"]["fused"], out["c_against_xla"]["int8"]
        if not (fused["max_abs_diff"] <= 5e-3 and fused["agreement"] > 0.999
                and int8["agreement"] > 0.97):
            raise RuntimeError("(c) the bench forward under fused or int8 does not track xla")
        del logits, ref

        # (d) observability: the trace, the step timer, the logger
        fwd = bench.make_bench_forward(model, cfg, "fused", dev)
        call = lambda: fwd(pts, cent, pad, zero)
        files, chain, traced, attempts = bench_trace(call, os.path.join(work, "bench_trace"))
        per_forward = forward_device_ms(call)
        timer, rows = StepTimer(), []
        for _ in range(10):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timer.start()
            start.record()
            res = fwd(pts, cent, pad, zero)
            end.record()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            host_ms = timer.stop(res) * 1e3
            rows.append((host_ms, start.elapsed_time(end), enqueue_ms))
        logger = MetricsLogger(os.path.join(work, "bench_logs"), "bench")
        logger.scalar("bench/windows_per_sec", line["value"], 0)
        log_histogram_to_tensorboard(logger, "bench/forward_ms", np.asarray(timer.times) * 1e3, 0)
        logger.close()
        events = glob.glob(os.path.join(logger.logdir, "events*"))
        out["d_observability"] = {
            "trace_files": len(files), "trace_attempts": attempts,
            "traced_launches": traced, "trace_chain_kernels": len(chain),
            "chain_kernel_name": chain[0] if chain else None,
            "device_ms_per_forward": per_forward,
            "step_timer": timer.summary(), "host_ms": [r[0] for r in rows],
            "cuda_event_ms": [r[1] for r in rows], "enqueue_ms": [r[2] for r in rows],
            "sinks": {"csv": os.path.exists(os.path.join(logger.logdir, "scalars.csv")),
                      "tensorboard": logger._tb is not None, "events_files": len(events)}}
        _say("  (d) " + json.dumps(out["d_observability"]))
        want = LAUNCHES_PER_FORWARD["fused"]["fused_mlp_chain"] * (TRACE_FORWARDS - 1)
        if len(files) != 1 or len(chain) < want:
            raise RuntimeError(f"(d) after {attempts} traces: {len(files)} files and "
                               f"{len(chain)} fused_mlp_chain kernels, want 1 and >= {want}")
        if any(host < dev_ms for host, dev_ms, _ in rows):
            raise RuntimeError("(d) a StepTimer time is under its call's CUDA-event time")
        if (logger._tb is not None) != bool(events):
            raise RuntimeError("(d) MetricsLogger's events files do not match its writer")
        del model, fwd, res, pts, cent
        gc_cuda()

        # (e) sequential tiling on the card against the CPU; the tower scanner
        rng = np.random.default_rng(SEED)
        pts = rng.normal(size=(TILING_CLOUDS, TILING_POINTS, 9)).astype(np.float32)
        tgt = rng.integers(0, 5, size=(TILING_CLOUDS, TILING_POINTS)).astype(np.int32)
        for i, n_pad in enumerate(rng.integers(0, 6000, size=TILING_CLOUDS)):
            if n_pad:
                pts[i, -n_pad:], tgt[i, -n_pad:] = 0.0, -1
        pts_c, tgt_c = torch.from_numpy(pts), torch.from_numpy(tgt)
        pts_d, tgt_d = pts_c.to(dev), tgt_c.to(dev)
        m = (TILING_POINTS // TILING_N_POINTS) * TILING_N_POINTS
        rand = torch.randint(0, TILING_POINTS, (TILING_CLOUDS, m),
                             generator=torch.Generator().manual_seed(SEED))
        tiling = {}
        for fill, r in (("zero", None), ("duplicate", rand)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = sequential_tiling_from(pts_d, tgt_d, TILING_N_POINTS, fill, r)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            want_t = sequential_tiling_from(pts_c, tgt_c, TILING_N_POINTS, fill, r)
            equal = all(torch.equal(g.cpu(), w) for g, w in zip(got, want_t))
            tiling[fill] = {"card_ms": ms, "equal_to_cpu": equal,
                            "shape": list(got[0].shape)}
        drawn = sequential_tiling(pts_d, tgt_d, TILING_N_POINTS)
        tiling["duplicate_card_generator"] = {
            "device": str(drawn[0].device), "padded_left": int((drawn[1] == -1).sum())}
        las = read_las(sorted(glob.glob(os.path.join(work, "tiles", "las", "*.las")))[0])
        cloud = np.stack([las.x, las.y, las.z, las.classification]).astype(np.float64)
        t0 = time.perf_counter()
        windows, centers = scan_for_towers(cloud)
        scan_s = time.perf_counter() - t0
        out["e_tiling_scanner"] = {
            "tiling": tiling, "tile_points": int(cloud.shape[1]),
            "tower_points": int(np.isin(cloud[3], (15,)).sum()), "scan_s": scan_s,
            "windows": None if windows is None else len(windows),
            "window_points": None if windows is None else [int(w.shape[1])
                                                           for w in windows.values()],
            "centers": None if centers is None else [[round(c, 2) for c in xy]
                                                     for xy in centers.values()]}
        _say("  (e) " + json.dumps(out["e_tiling_scanner"]))
        if not all(tiling[f]["equal_to_cpu"] for f in ("zero", "duplicate")) \
                or tiling["duplicate_card_generator"]["padded_left"] \
                or drawn[0].device.type != "cuda":
            raise RuntimeError("(e) sequential_tiling on the card differs from the CPU")
        if not windows:
            raise RuntimeError("(e) scan_for_towers found no tower window in a synthetic tile")
    out["energy"] = energy.report()
    out["phase_s"] = time.perf_counter() - t_phase
    _say("bench: " + json.dumps(out))
    return launches


# phase 14: the bucket graphs, at the serving path's bucket shapes (k = 18
# and k = 9 of cap 4096 at n_points 2048) and a whole-cloud one (k = 1)
GRAPH_CLOUD_POINTS = (50_000, 20_000, 3_000)
# (a)'s inferencers: backend, stacked members, devices
GRAPH_RUNS = {
    "fused": ("fused", 1, ("cuda:0",)),
    "int8": ("int8", 1, ("cuda:0",)),
    "xla": ("xla", 1, ("cuda:0",)),
    "stacked_fused": ("fused", 2, ("cuda:0",)),
    "shards_fused": ("fused", 1, ("cuda:0", "cuda:0")),
}
GRAPH_REPLAYS = 3  # replayed bucket forwards counted in (c)
STAMPS_PER_REPLAY = 3  # device_stamp launches in a bucket graph
SINKHORN_PER_REPLAY = 3 * 30 * 10  # sinkhorn_iterations launches in a k > 1 bucket graph
# (e): replays of the k = 18 bucket whose stamps are read, and of each graph
# the CUDA events time; how far a stamp interval's median may lie from its
# events' median (the stamps and the events bracket the same nodes)
STAMP_REPLAYS = 10
STAMP_TOLERANCE = 0.10
MAX_REQUEST_ENQUEUES = 50  # kernel and copy enqueues of a warm 1-cloud request
# the CUDA runtime calls that put work on a stream
ENQUEUE_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                    "cuMemset", "cudaGraphLaunch", "cuGraphLaunch")


@contextlib.contextmanager
def graph_check():
    """While on: every bucket-graph call is held against the eager body on
    the inputs that call was given (copied to the card afresh): its labels
    and float16 probabilities element for element. Yields the record of
    calls (replayed or capturing, equal, shape)."""
    from ampnet_tpu_torch.infer.tiled import _BucketGraph

    calls, lock = [], threading.Lock()
    call = _BucketGraph.__call__

    def checked(self, *args):
        with lock:  # no other call of a graph between this one and its check
            replay = self.graph is not None
            flat, pflat, stamps, event = call(self, *args)
            event.synchronize()
            with torch.inference_mode(), torch.cuda.device(self.device):
                # the body's inputs: points, scale, offset, init (then the spans)
                want = self.body(*(None if t is None else t.to(self.device)
                                   for t in args[:4]))
                want = [None if t is None else t.cpu() for t in want]
            equal = torch.equal(flat, want[0]) and (
                pflat is None if want[1] is None else torch.equal(pflat, want[1]))
            calls.append({"replay": replay, "equal": equal, "shape": list(flat.shape),
                          "probs": pflat is not None})
            return flat, pflat, stamps, event

    _BucketGraph.__call__ = checked
    try:
        yield calls
    finally:
        _BucketGraph.__call__ = call


def traced_calls(call, steps=2) -> tuple:
    """torch.profiler over ``steps`` calls after a warm-up one (read when the
    recorded steps end: a later trace in a process loses its first kernel
    records) → (CUDA runtime calls by name, device operations by name), each
    a count per call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    host, device = {}, {}

    def ready(prof):
        for e in prof.key_averages():
            if e.key.startswith("ProfilerStep"):
                continue
            if e.device_type.name == "CUDA":
                device[e.key] = device.get(e.key, 0) + e.count / steps
            elif e.key.startswith("cu"):
                host[e.key] = host.get(e.key, 0) + e.count / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps), on_trace_ready=ready) as prof:
        for _ in range(1 + steps):
            call()
            torch.cuda.synchronize()
            prof.step()
    return host, device


def enqueues(host: dict) -> float:
    return sum(n for name, n in host.items() if name.startswith(ENQUEUE_PREFIXES))


def graph_clouds(rng, sizes=GRAPH_CLOUD_POINTS):
    out = []
    for n in sizes:
        c = rng.normal(size=(n, 9)).astype(np.float32) * 0.5
        c[:, :2] = rng.uniform(-1.0, 1.0, size=(n, 2))
        out.append(c)
    return out


def captured(fn, device):
    """``fn`` captured in a CUDA graph, after a warm-up run on a side stream."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def replay_ms(graph, device, reps=STAMP_REPLAYS) -> list:
    """Device ms of each of ``reps`` replays of ``graph``: CUDA events
    recorded around each on the current stream, which the replay runs on."""
    stream = torch.cuda.current_stream(device)
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        graph.replay()
        end.record(stream)
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def stamp_check(tt) -> dict:
    """(e): the warm (18, 4096) bucket of ``tt`` replayed ``STAMP_REPLAYS``
    times through its runner. Each replay's three stamps rise, the stamp
    kernel's counter grows by 3 a replay, and the medians of the whole
    interval (stamps[2] - stamps[0]) and of the tiling interval
    (stamps[1] - stamps[0]) lie within ``STAMP_TOLERANCE`` of CUDA events
    around replays of the same graph, and around replays of a graph of the
    body's tiling alone (the k-means features, ``balanced_kmeans``, the
    argsort and the reorder gather, as ``_run_bucket`` runs them on the
    float32 wire) on the same static inputs. A stamp in the wrong place or
    slot, or of another clock or unit, fails one of them."""
    from ampnet_tpu_torch.infer.tiled import KMEANS_FEATURE_IDX
    from ampnet_tpu_torch.ops.device_stamp import device_stamp
    from ampnet_tpu_torch.ops.kmeans import balanced_kmeans

    k, cap, dev = 18, 4096, tt.devices[0]
    runner = tt._runners[(dev, k, cap, False, 1)]
    given = tuple(None if t is None else t.clone() for t in runner.inputs)
    stamps = []
    device_stamp.launches = 0
    for _ in range(STAMP_REPLAYS):
        _, _, s, event = runner(*given)
        event.synchronize()
        stamps.append(s.tolist())
    launches = device_stamp.launches
    points, _, _, init = runner.inputs
    b, n, f = points.shape

    def tiling():
        feats = torch.stack([points[..., c] for c in KMEANS_FEATURE_IDX], dim=-1).float()
        assign, _ = balanced_kmeans(
            feats, k, capacities=(cap,) * k,
            lloyd_mode="argmin" if tt.tiler == "fast" else "sinkhorn", init_idx=init)
        order = torch.argsort(assign, dim=-1, stable=True)
        return torch.gather(points, 1, order[..., None].expand(b, n, f))

    with runner.lock, torch.cuda.device(dev), torch.inference_mode():
        whole_ms = replay_ms(runner.graph, dev)
        graph = captured(tiling, dev)
        tiling_ms = replay_ms(graph, dev)
        del graph
    out = {"bucket": [k, cap], "replays": STAMP_REPLAYS, "launches": launches,
           "stamp_whole_ms": float(np.median([(c - a) * 1e-6 for a, _, c in stamps])),
           "event_whole_ms": float(np.median(whole_ms)),
           "stamp_tiling_ms": float(np.median([(m - a) * 1e-6 for a, m, _ in stamps])),
           "event_tiling_ms": float(np.median(tiling_ms)),
           "tolerance": STAMP_TOLERANCE, "stamps_ns_first_replay": stamps[0]}
    if launches != STAMPS_PER_REPLAY * STAMP_REPLAYS:
        raise RuntimeError(f"(e) {STAMP_REPLAYS} replays launched device_stamp {launches} "
                           f"times, want {STAMPS_PER_REPLAY * STAMP_REPLAYS}")
    if not all(a < m < c for a, m, c in stamps):
        raise RuntimeError(f"(e) stamps that do not rise: {stamps}")
    for part in ("whole", "tiling"):
        got, want = out[f"stamp_{part}_ms"], out[f"event_{part}_ms"]
        if abs(got / want - 1.0) > STAMP_TOLERANCE:
            raise RuntimeError(f"(e) the stamps' {part} interval {got:.4f} ms against CUDA "
                               f"events' {want:.4f} ms, past {STAMP_TOLERANCE:.0%}")
    return out


def graph_phase(model, cfg, dev, card) -> tuple:
    """Phase 14: (a)-(e) of the module docstring → (the kernels' launches
    in (c)'s replayed bucket forwards and in (e) by run, (e)'s readings)."""
    from ampnet_tpu_torch.core.profiling import SpanGroup, Spans
    from ampnet_tpu_torch.infer.tiled import TiledInferencer
    from ampnet_tpu_torch.ops.device_stamp import device_stamp
    from ampnet_tpu_torch.ops.kmeans import sinkhorn_iterations

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    first, other = graph_clouds(rng), graph_clouds(rng)
    # the stacked pair's second member: the model, every weight perturbed
    second = copy.deepcopy(model)
    g = torch.Generator().manual_seed(SEED + 14)
    with torch.no_grad():
        for p in second.parameters():
            p.add_(torch.randn(p.shape, generator=g).to(p.device) * 1e-3)
    out = {"card": card, "a_replay_vs_eager": {}, "d_cache": {}}
    inferencers = {}
    mem0 = torch.cuda.memory_reserved()

    # (a) every call against the eager body on its own inputs
    with graph_check() as calls:
        for run, (backend, members, devices) in GRAPH_RUNS.items():
            tt = TiledInferencer(model if members == 1 else [model, second], cfg,
                                 backend=backend, devices=list(devices))
            inferencers[run] = tt
            # two shards: three 50,000-point clouds in one bucket, padded to 4;
            # the stacked pair: the 50,000-point bucket alone
            if len(devices) > 1:
                sets = [[first[0], other[0], first[0]], [other[0], first[0], other[0]]]
            elif members > 1:
                sets = [first[:1], other[:1]]
            else:
                sets = [first, other]
            start = len(calls)
            spans = Spans(SpanGroup("batch"))  # each capture's graph.capture span
            for probs in (False, True):
                for clouds in (sets[0], sets[0], sets[1]):
                    tt.predict_many(clouds, seeds=list(range(len(clouds))), return_probs=probs,
                                    spans=spans)
            mine = calls[start:]
            replays = sum(c["replay"] for c in mine)
            out["a_replay_vs_eager"][run] = {
                "calls": len(mine), "replays": replays,
                "equal": sum(c["equal"] for c in mine),
                "shapes": sorted({str(c["shape"]) for c in mine})}
            graphs = [r for r in tt._runners.values() if r.graph is not None]
            if not all(c["equal"] for c in mine):
                raise RuntimeError(f"(a) {run}: a bucket graph differs from the eager body: "
                                   + json.dumps([c for c in mine if not c["equal"]]))
            if replays != len(mine) - len(graphs) or replays < 2 * len(graphs):
                raise RuntimeError(f"(a) {run}: {replays} replays of {len(mine)} calls and "
                                   f"{len(graphs)} graphs")
            out["d_cache"][run] = {
                "graphs": len(graphs), "cold_programs_seen": tt.cold_programs_seen,
                "capture_ms": [round((t1 - t0) * 1e-6, 1)
                               for name, t0, t1, *_ in spans.group.spans
                               if name == "graph.capture"]}
            if len(graphs) != tt.cold_programs_seen:
                raise RuntimeError(f"(d) {run}: {len(graphs)} graphs captured, "
                                   f"{tt.cold_programs_seen} cold program shapes")
    _say("  (a) " + json.dumps(out["a_replay_vs_eager"]))

    # (b) what a warm dispatch enqueues from the host
    fused = inferencers["fused"]
    host3, _ = traced_calls(lambda: fused.predict_many(first, seeds=[0, 1, 2]))
    host1, _ = traced_calls(lambda: fused.predict_many(first[:1], seeds=[0]))
    runner = fused._runners[(fused.devices[0], 18, 4096, False, 1)]

    def eager_body():
        with torch.inference_mode():
            runner.body(*runner.inputs)

    host_eager, _ = traced_calls(eager_body)
    out["b_enqueues"] = {
        "dispatch_3_buckets": {"graph_launches": host3.get("cudaGraphLaunch", 0),
                               "enqueues": enqueues(host3)},
        "request_1_cloud": {"enqueues": enqueues(host1), "by_call": host1},
        "eager_body_1_cloud": {"enqueues": enqueues(host_eager),
                               "by_call": {k: v for k, v in host_eager.items()
                                           if k.startswith(ENQUEUE_PREFIXES)}}}
    _say("  (b) " + json.dumps(out["b_enqueues"]))
    if host3.get("cudaGraphLaunch", 0) != 3 or host1.get("cudaGraphLaunch", 0) != 1:
        raise RuntimeError("(b) a warm dispatch did not launch one graph per bucket")
    if not 0 < enqueues(host1) < MAX_REQUEST_ENQUEUES:
        raise RuntimeError(f"(b) a warm 1-cloud request enqueued {enqueues(host1)} kernels "
                           f"and copies, want fewer than {MAX_REQUEST_ENQUEUES}")

    # (c) the kernels inside a replay, and the counters per replayed forward
    launches = {}
    for run in ("fused", "int8"):
        tt = inferencers[run]
        _, device = traced_calls(lambda: tt.predict_many(first[:1], seeds=[0]))
        chains = {k: n for k, n in device.items() if "chain_kernel" in k}
        want = LAUNCHES_PER_FORWARD[run]
        # csrc/fused_mlp.cu's kernel takes a Chain, one a call; a call of
        # csrc/quantized_mlp.cu runs one absmax_kernel, then its passes
        fused_k = sum(n for k, n in chains.items() if "Chain" in k)
        int8_k = sum(n for k, n in chains.items() if "Params" in k)
        absmax = sum(n for k, n in device.items() if "absmax_kernel" in k)
        reset_launches()  # the main path's run starts here
        for _ in range(GRAPH_REPLAYS):
            tt.predict_many(first[:1], seeds=[0])
        counts = {**launch_counts(), "device_stamp": device_stamp.launches,
                  "sinkhorn_iterations": sinkhorn_iterations.launches}  # ... and ends here
        launches[f"graph_replays_{run}"] = counts
        out[f"c_{run}"] = {"traced_per_replay": {"fused_chain_kernel": fused_k,
                                                 "int8_chain_kernel_passes": int8_k,
                                                 "absmax_kernel": absmax},
                           "kernel_names": sorted(k[:80] for k in chains),
                           "launches": counts, "replays": GRAPH_REPLAYS}
        if fused_k != want["fused_mlp_chain"] or absmax != want["quantized_mlp_chain"] or (
                int8_k < absmax or (int8_k > 0) != (absmax > 0)):
            raise RuntimeError(f"(c) {run}: a traced replay ran {chains} and {absmax} absmax "
                               f"kernels, want {want}")
        if counts != {**{k: v * GRAPH_REPLAYS for k, v in want.items()},
                      "device_stamp": STAMPS_PER_REPLAY * GRAPH_REPLAYS,
                      "sinkhorn_iterations": SINKHORN_PER_REPLAY * GRAPH_REPLAYS}:
            raise RuntimeError(f"(c) {run}: {GRAPH_REPLAYS} replays counted {counts}")
    _say("  (c) " + json.dumps({k: v for k, v in out.items() if k.startswith("c_")}))

    out["d_cache"]["memory_reserved_gib"] = {"before": mem0 / 2**30,
                                             "after": torch.cuda.memory_reserved() / 2**30}
    _say("  (d) " + json.dumps(out["d_cache"]))

    # (e) the device stamps of a replay against CUDA events
    out["e_stamps"] = stamp_check(fused)
    launches["stamps_fused"] = {"device_stamp": out["e_stamps"]["launches"]}
    _say("  (e) " + json.dumps(out["e_stamps"]))
    out["phase_s"] = time.perf_counter() - t_phase
    _say("graphs: " + json.dumps(out))
    del inferencers
    return launches, out["e_stamps"]


SINKHORN_CASES = {  # name → (clouds, or None for one unbatched [N, F] cloud; k; cap)
    "serve_x1": (1, 18, 4096),
    "serve_x4": (4, 18, 4096),
    "preprocess": (None, 9, 2048),
}


def sinkhorn_phase(dev) -> list:
    """Phase 3d: ``sinkhorn_iterations`` (``sinkhorn_plan``'s iterations) at
    SINKHORN_CASES, on clouds drawn as the served ones (x, y uniform on
    [-1, 1], NDVI normal x 0.5): ``balanced_kmeans`` through the kernels
    must give the plain loop's assignment and centroids, and
    ``sinkhorn_plan`` its plan, bit for bit. ``balanced_kmeans`` timed on both
    clocks beside the plain loop's device time and the bound of the
    log-domain loop's exps (``kernel_timing.py``)."""
    from kernel_timing import SFU_EXPS_PER_S, device_ms, host_ms

    from ampnet_tpu_torch.ops import kmeans

    take = kmeans._kernels_take

    def plain(call):
        kmeans._kernels_take = lambda *args: False
        try:
            return call()
        finally:
            kmeans._kernels_take = take

    rows = []
    for case, (b, k, cap) in SINKHORN_CASES.items():
        n = k * cap
        rng = np.random.default_rng(SEED + 3)
        x = rng.normal(size=(b or 1, n, 3)).astype(np.float32) * 0.5
        x[..., :2] = rng.uniform(-1.0, 1.0, size=(b or 1, n, 2))
        init = np.stack([rng.permutation(n)[:k] for _ in range(b or 1)])
        feats, init = torch.from_numpy(x).to(dev), torch.from_numpy(init).to(dev)
        if b is None:
            feats, init = feats[0], init[0]
        call = lambda: kmeans.balanced_kmeans(feats, k, capacities=(cap,) * k, init_idx=init)
        with torch.inference_mode():
            got, cent = call()
            want, want_cent = plain(call)
            cost = kmeans._sqdist(feats, cent)
            caps = torch.full((k,), float(cap), device=dev)
            plan = kmeans.sinkhorn_plan(cost, caps, 0.05)
            same_plan = torch.equal(plan, plain(lambda: kmeans.sinkhorn_plan(cost, caps, 0.05)))
            row = {"name": f"sinkhorn_iterations:{case}", "case": case,
                   "shape": list(feats.shape), "k": k, "route": "cuda",
                   "source": "ampnet_tpu_torch/csrc/sinkhorn.cu", "replaces": None,
                   "moved_vs_plain": int((got != want).sum()),
                   "centroids_equal": torch.equal(cent, want_cent), "plan_equal": same_plan,
                   "ms": (host_ms(call, 3) + host_ms(call, 3)) / 2,
                   "device_ms": (device_ms(call, 3) + device_ms(call, 3)) / 2,
                   "plain_device_ms": plain(lambda: device_ms(call, 2))}
        # the log-domain loop's 2·N·k exps a Sinkhorn iteration, 300 iterations
        row["bound_ms"] = 2 * n * k * 300 * (b or 1) / SFU_EXPS_PER_S * 1e3
        _say(f"  sinkhorn {case}: " + json.dumps(row))
        if row["moved_vs_plain"] or not (row["centroids_equal"] and same_plan):
            raise RuntimeError(f"sinkhorn {case}: not the plain loop's bits: " + json.dumps(row))
        rows.append(row)
    return rows


def fps_phase(dev) -> list:
    """Phase 3e: ``batched_farthest_point_sampling`` on its kernel
    (``csrc/fps.cu``) at the whole-cloud PointNet++ step's levels, xyz
    uniform in the unit cube as ``pn2_fp32.train_b32`` draws it: the kernel
    must pick the plain loop's indices on the same card, as integers, with
    one launch a call. Timed on both clocks beside the plain loop
    (``kernel_timing.py``)."""
    from kernel_timing import FPS_LEVELS, device_ms, host_ms

    from ampnet_tpu_torch.ops.sampling import (
        batched_farthest_point_sampling,
        batched_farthest_point_sampling_plain,
    )

    rows = []
    for b, n, s in FPS_LEVELS:
        gen = torch.Generator(device=dev).manual_seed(SEED + n)
        same, masked = True, None
        with torch.inference_mode():
            for _ in range(2):  # two draws
                xyz = torch.rand((b, n, 3), generator=gen, device=dev)
                before = batched_farthest_point_sampling.launches
                got = batched_farthest_point_sampling(xyz, s)
                launched = batched_farthest_point_sampling.launches - before
                same &= torch.equal(got, batched_farthest_point_sampling_plain(xyz, s))
            if n == FPS_LEVELS[0][1]:  # a tenth of the points masked out
                mask = torch.rand((b, n), generator=gen, device=dev) >= 0.1
                masked = torch.equal(batched_farthest_point_sampling(xyz, s, mask),
                                     batched_farthest_point_sampling_plain(xyz, s, mask))
            call = lambda: batched_farthest_point_sampling(xyz, s)
            plain = lambda: batched_farthest_point_sampling_plain(xyz, s)
            row = {"name": f"batched_farthest_point_sampling:{n}", "shape": [b, n, 3],
                   "samples": s, "route": "cuda", "source": "ampnet_tpu_torch/csrc/fps.cu",
                   "replaces": None, "indices_equal": same, "masked_indices_equal": masked,
                   "launches_a_call": launched,
                   "ms": host_ms(call, 10), "device_ms": device_ms(call, 10),
                   "plain_ms": host_ms(plain, 2), "plain_device_ms": device_ms(plain, 2)}
        _say(f"  fps {n}: " + json.dumps(row))
        if not same or masked is False or launched != 1:
            raise RuntimeError(f"fps at [{b}, {n}] -> {s}: not the plain loop's indices or not "
                               f"one launch: " + json.dumps(row))
        rows.append(row)
    return rows


def ball_query_phase(dev) -> list:
    """Phase 3f: ``ball_query_members`` on its kernel (``csrc/ball_query.cu``)
    at the whole-cloud PointNet++ step's levels (``BALL_QUERY_LEVELS``), on
    the model's own squared distances: xyz uniform in the unit cube as
    ``pn2_fp32.train_b32`` draws it, centres from farthest-point sampling, d2
    from ``_sqdist``. The kernel must give the plain body's integers on the
    same block, with one launch a call. Timed on both clocks beside the plain
    body (``kernel_timing.py``), with the bound: the bytes of d2 a scan that
    stops at each row's last member reads, and the int64 output."""
    from kernel_timing import (
        BALL_QUERY_LEVELS,
        BALL_QUERY_MEMBERS,
        ball_query_bound,
        device_ms,
        host_ms,
    )

    from ampnet_tpu_torch.models.pointnet2 import _sqdist, gather_points
    from ampnet_tpu_torch.ops.sampling import (
        ball_query_members,
        ball_query_members_plain,
        batched_farthest_point_sampling,
    )

    k, rows = BALL_QUERY_MEMBERS, []
    for b, s, n, radius in BALL_QUERY_LEVELS:
        gen = torch.Generator(device=dev).manual_seed(SEED + n)
        same = True
        with torch.inference_mode():
            for _ in range(2):  # two draws
                xyz = torch.rand((b, n, 3), generator=gen, device=dev)
                d2 = _sqdist(gather_points(xyz, batched_farthest_point_sampling(xyz, s)), xyz)
                before = ball_query_members.launches
                got = ball_query_members(d2, radius, k)
                launched = ball_query_members.launches - before
                same &= torch.equal(got, ball_query_members_plain(d2, radius, k))
            call = lambda: ball_query_members(d2, radius, k)
            plain = lambda: ball_query_members_plain(d2, radius, k)
            row = {"name": f"ball_query_members:{n}", "shape": [b, s, n], "radius": radius,
                   "members": k, "route": "cuda", "source": "ampnet_tpu_torch/csrc/ball_query.cu",
                   "replaces": None, "indices_equal": same, "launches_a_call": launched,
                   "ms": host_ms(call, 10), "device_ms": device_ms(call, 10),
                   "plain_ms": host_ms(plain, 2), "plain_device_ms": device_ms(plain, 2),
                   **ball_query_bound(d2, radius, k)}
        del got, d2
        _say(f"  ball query {n}: " + json.dumps(row))
        if not same or launched != 1:
            raise RuntimeError(f"ball query at [{b}, {s}, {n}]: not the plain body's indices or "
                               f"not one launch: " + json.dumps(row))
        rows.append(row)
    return rows


def signature_table(source: str) -> dict:
    """The C signatures ``SOURCES`` names for ``csrc/<source>``."""
    import importlib

    module, table = SOURCES[source]
    return getattr(importlib.import_module(f"ampnet_tpu_torch.{module}"), table)


def build_phase():
    """Phase 2: each kernel source built by its own ``nvcc``, and the host
    solver by ``g++``, all started together, and loaded."""
    from ampnet_tpu_torch.ops import cuda_build

    tables = {name: signature_table(name) for name in SOURCES}

    def build(name):
        t0 = time.perf_counter()
        cuda_build.load(name, tables[name])
        return time.perf_counter() - t0

    sources = tuple(SOURCES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        took = dict(zip(sources, pool.map(build, sources)))
    _say("  built and loaded " + ", ".join(f"{n} in {t:.2f} s" for n, t in took.items())
         + f" ({time.perf_counter() - t0:.2f} s in all, in parallel)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run needs a CUDA card",
              file=sys.stderr)
        return 1
    from ampnet_tpu_torch.core.config import AMPNetConfig
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.ops import cuda_build

    dev = resolve_device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    _say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    _say("[1/15] card")
    card = card_line()
    _say(card)

    _say("[2/15] build")
    build_phase()

    cfg = AMPNetConfig()
    model = seeded_model(cfg).to(dev)

    _say("[3/15] kernels against their plain versions")
    fused_total, fused_cases = kernel_phase(model, dev)
    int8_total, int8_cases = quantized_phase(model, dev)
    edge_phase(dev)
    sinkhorn_cases = sinkhorn_phase(dev)
    fps_cases = fps_phase(dev)
    ball_query_cases = ball_query_phase(dev)

    _say("[4/15] model: fused and int8 against the module forward")
    model_phase(model, cfg, dev)

    _say("[5/15] serve")
    runs = {backend: serve_phase(model, cfg, backend) for backend in LAUNCHES_PER_FORWARD}

    cuda_build.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD) as work:
        _say("[6/15] train")
        train_launches, ckpt = train_phase(dev, card, work)

        _say("[7/15] evaluate")
        eval_launches = evaluate_phase(ckpt, dev, card, work)
        # the bucket graphs of phases 5-7 hold their static outputs in the pool
        _say(f"  memory reserved after evaluate: {torch.cuda.memory_reserved() / 2**30:.3f} "
             f"GiB (largest so far {torch.cuda.max_memory_reserved() / 2**30:.3f} GiB)")

        _say("[8/15] tiles: host data stages, whole-tile infer, demo")
        tile_launches, tiles_data = tiles_phase(ckpt, dev, card, work)
        eval_launches.update(tile_launches)

        _say("[9/15] families: gru, classification, baseline, classic, pointnet2")
        families = families_phase(ckpt, dev, card, work)

        _say("[10/15] geometry: eigenfeature columns, edge block, geom tokens, distillation")
        geom_launches, geom_rows = geometry_phase(os.path.join(work, "tiles"), tiles_data,
                                                     dev, card, work)

        _say("[11/15] parallel: sharded steps, two ranks, sharded serving, window axis")
        par_launches = parallel_phase(model, cfg, dev, card, work)

        _say("[12/15] training options: bf16, remat, oversampling, weights, dispatch, "
             "host batcher")
        option_launches = options_phase(dev, card, work)

        _say("[13/15] bench and observability: bench, profiling, logging, tiling, scanner")
        bench_launches = bench_phase(dev, card, work)

    _say("[14/15] bucket graphs: replay against the eager body, enqueues, kernels, cache")
    graph_launches, stamps = graph_phase(model, cfg, dev, card)

    _say("[15/15] results")
    # launches only where the serving runs counted them: each kernel in both
    # runs, and each serving chain once per bucket forward that ran it (its M
    # there is 18 x clouds in the bucket); the other cases are shapes the
    # main path did not run
    fwd = {backend: forwards for backend, (_, forwards, *_) in runs.items()}
    per_forward = {**GEOM_RUNS, "geom_serve_fused": LAUNCHES_PER_FORWARD["fused"],
                   "geom_serve_int8": LAUNCHES_PER_FORWARD["int8"]}
    for total, name in ((fused_total, "fused_mlp_chain"), (int8_total, "quantized_mlp_chain")):
        total["launches_by_run"] = {backend: counts[name]
                                    for backend, (counts, *_) in runs.items()}
        if name == "fused_mlp_chain":  # the trained checkpoint, served under fused
            total["launches_by_run"]["train_serve"] = train_launches
        for run, counts in eval_launches.items():  # the phase 7-8 runs that launch it
            if {**EVAL_RUNS, **TILE_RUNS}[run][name]:
                total["launches_by_run"][run] = counts[name]
        total["launches_by_run"]["families"] = 0  # phase 9 checked 0 on every run
        for run, counts in geom_launches.items():  # phase 10's runs that launch it
            if per_forward[run][name]:
                total["launches_by_run"][run] = counts[name]
        # phase 10 checked 0 on the edge + token runs and in the teachers
        total["launches_by_run"]["geometry_edge_tokens_distill"] = 0
        for backend, counts in par_launches.items():  # phase 11's sharded serve runs
            if LAUNCHES_PER_FORWARD[backend][name]:
                total["launches_by_run"][f"parallel_serve_{backend}"] = counts[name]
        # phase 11 checked 0 on the sharded steps (both ranks) and the window axis
        total["launches_by_run"]["parallel_train_window_axis"] = 0
        for run, counts in option_launches.items():  # phase 12 (f): test of the bf16 checkpoint
            if OPTION_RUNS[run][name]:
                total["launches_by_run"][run] = counts[name]
        # phase 12 checked 0 on its training runs (a)-(e) and under xla
        total["launches_by_run"]["options_train"] = 0
        for run, counts in bench_launches.items():  # phase 13 (a), (b): the bench forwards
            if BENCH_RUNS[run][name]:
                total["launches_by_run"][run] = counts[name]
        # phase 13 checked 0 on the bench's train arms and under xla
        total["launches_by_run"]["bench_train_xla"] = 0
        for run, counts in graph_launches.items():  # phase 14 (c): replayed bucket forwards
            if counts.get(name):
                total["launches_by_run"][run] = counts[name]
        total["launches"] = sum(total["launches_by_run"].values())
    # the serve: chains ran once a bucket forward of phase 5, the bench: chains
    # once a bench forward of phase 13; the T-Nets run under both backends
    fwd_by = {"serve": fwd, "bench": {b: bench_launches[f"bench_{b}"]["fused_mlp_chain"]
                                      // LAUNCHES_PER_FORWARD[b]["fused_mlp_chain"]
                                      for b in LAUNCHES_PER_FORWARD}}
    tnets = ("input_tnet", "feature_tnet")
    for row in fused_cases:
        path, _, chain = row["case"].partition(":")
        row["launches"] = (fwd_by[path]["fused"] + (fwd_by[path]["int8"] if chain in tnets else 0)
                           if path in fwd_by else None)
    for row in int8_cases:
        path = row["case"].partition(":")[0]
        row["launches"] = fwd_by[path]["int8"] if path in fwd_by else None
    # serve_geom:mlp_a runs once a bucket forward of phase 10's fused runs
    # (fused_mlp_chain) and int8 runs (quantized_mlp_chain)
    for cases, name, backend in ((fused_cases, "fused_mlp_chain", "fused"),
                                 (int8_cases, "quantized_mlp_chain", "int8")):
        per = LAUNCHES_PER_FORWARD[backend][name]
        cases.append({**geom_rows[name], "launches": sum(
            counts[name] // per for run, counts in geom_launches.items()
            if (per_forward[run] == LAUNCHES_PER_FORWARD[backend]))})
    # device_stamp: three launches in every bucket graph replay; counted
    # where phase 14 counted them, held against CUDA events in (e)
    stamp_runs = {run: counts["device_stamp"] for run, counts in graph_launches.items()}
    stamp_total = {"name": "device_stamp", "case": "three stamps a bucket graph replay",
                   "route": "cuda", "source": "ampnet_tpu_torch/csrc/device_stamp.cu",
                   "replaces": None, "launches_by_run": stamp_runs,
                   "launches": sum(stamp_runs.values()), "against_cuda_events": stamps}
    # sinkhorn_iterations: 900 launches in every k > 1 bucket graph replay;
    # counted where phase 14 counted them, held against the plain loop in phase 3
    sinkhorn_runs = {run: counts["sinkhorn_iterations"]
                     for run, counts in graph_launches.items() if "sinkhorn_iterations" in counts}
    sinkhorn_total = {"name": "sinkhorn_iterations",
                      "case": "900 a k > 1 bucket graph replay (3 an iteration)",
                      "route": "cuda", "source": "ampnet_tpu_torch/csrc/sinkhorn.cu",
                      "replaces": None, "launches_by_run": sinkhorn_runs,
                      "launches": sum(sinkhorn_runs.values()), "cases": sinkhorn_cases}
    # batched_farthest_point_sampling: one launch a call, three a PointNet++
    # forward; counted in phase 8's windows and phase 9's PointNet++ runs,
    # held against the plain loop in phase 3
    fps_runs = {"tiles_window_fps": tiles_data["host_solver"]["fps_launches"],
                **{f"families_{run.replace(' ', '_')}": counts["launches"]
                   for run, counts in families["pn2_launches"].items()}}
    fps_total = {"name": "batched_farthest_point_sampling",
                 "case": "one launch a call, one call a set abstraction", "route": "cuda",
                 "source": "ampnet_tpu_torch/csrc/fps.cu", "replaces": None,
                 "launches_by_run": fps_runs, "launches": sum(fps_runs.values()),
                 "cases": fps_cases}
    # ball_query_members: one launch a set abstraction, three a PointNet++
    # forward; counted in phase 9's PointNet++ runs, held against the plain
    # body in phase 3
    ball_query_runs = {f"families_{run.replace(' ', '_')}": counts["ball_query_launches"]
                       for run, counts in families["pn2_launches"].items()}
    ball_query_total = {"name": "ball_query_members",
                        "case": "one launch a call, one call a set abstraction",
                        "route": "cuda", "source": "ampnet_tpu_torch/csrc/ball_query.cu",
                        "replaces": None, "launches_by_run": ball_query_runs,
                        "launches": sum(ball_query_runs.values()), "cases": ball_query_cases}
    _say(json.dumps({"kernels": [{**fused_total, "cases": fused_cases},
                                 {**int8_total, "cases": int8_cases}, stamp_total,
                                 sinkhorn_total, fps_total, ball_query_total]}))
    _say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
