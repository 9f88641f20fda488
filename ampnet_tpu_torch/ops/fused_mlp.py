"""Fused shared-MLP chain over point windows: the CUDA kernel, its plain
PyTorch version and the BatchNorm fold.

Replaces the Pallas TPU kernel ``ampnet_tpu/ops/pallas/fused_mlp.py``
(``fused_mlp_chain``, ``pl.pallas_call`` at :144). The kernel itself is
``ampnet_tpu_torch/csrc/fused_mlp.cu``; its source note says what bounds it on
an H100 (operations: fp32 FMA) and what the design does about it (a row tile
of one window stays in shared memory across all layers; weights stream
through a shared k-slab; per-tile maxima reduced by a second launch).

``fused_mlp_chain`` chooses by the tensor's device: a CPU tensor takes the
plain version (``fused_mlp_chain_reference``), a CUDA tensor launches the
kernel or raises — there is no fallback. ``fused_mlp_chain.launches`` counts
kernel launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import torch

from ampnet_tpu_torch.ops import cuda_build

MAX_LAYERS = 4
# launches come from the serving worker and the dispatch pool's threads
_count_lock = threading.Lock()


def fold_bn(
    kernel: torch.Tensor,  # [Cin, Cout] dense kernel
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float = 1e-5,
    dense_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into the preceding dense layer → (W', b'):
    y = ((x@W) − μ)·γ/√(σ²+ε) + β  ≡  x@(W·diag(s)) + t, s = γ/√(σ²+ε),
    t = β − μ·s (+ dense bias·s)."""
    s = bn_scale / torch.sqrt(bn_var + eps)
    w = kernel * s[None, :]
    b = bn_bias - bn_mean * s
    if dense_bias is not None:
        b = b + dense_bias * s
    return w, b


def fused_mlp_chain_reference(x, weights, biases, pool=False, relu_last=True,
                              return_acts=True):
    """Plain PyTorch version: ``relu(h @ W + b)`` per layer, ``amax`` over points."""
    h = x
    n_layers = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = h @ w + b
        if i < n_layers - 1 or relu_last:
            h = torch.relu(h)
    if pool and return_acts:
        return h, h.amax(dim=1)
    if pool:
        return h.amax(dim=1)
    return h


def _check(x, weights, biases, pool, return_acts):
    if not (pool or return_acts):
        raise ValueError("fused_mlp_chain needs pool or return_acts")
    if x.dim() != 3:
        raise ValueError(f"x must be [M, N, Cin], got shape {tuple(x.shape)}")
    if not 1 <= len(weights) <= MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"need 1..{MAX_LAYERS} layers with one bias each, got "
                         f"{len(weights)} weights and {len(biases)} biases")
    cin = x.shape[2]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.dim() != 2 or w.shape[0] != cin or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} / bias {tuple(b.shape)} "
                             f"do not chain from {cin} input channels")
        cin = w.shape[1]
    for t in (x, *weights, *biases):
        if t.device != x.device:
            raise ValueError("x, weights and biases must share one device")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mlp_chain takes float32, got {t.dtype}")


def _lib() -> ctypes.CDLL:
    """The built kernel library, with every C signature declared."""
    lib = cuda_build.load("fused_mlp")
    if lib.fused_mlp_chain_f32.argtypes is None:  # declared last, below
        for fn in (lib.fused_mlp_chain_tile_rows, lib.fused_mlp_chain_max_width):
            fn.restype, fn.argtypes = ctypes.c_int, []
        lib.fused_mlp_chain_f32.restype = ctypes.c_int
        lib.fused_mlp_chain_f32.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)
    return lib


def _launch(x, weights, biases, pool, relu_last, return_acts):
    lib = _lib()
    width = lib.fused_mlp_chain_max_width()
    if max(x.shape[2], *(w.shape[1] for w in weights)) > width:
        raise ValueError(f"fused_mlp_chain kernel takes widths up to {width}")
    m, n, _ = x.shape
    cout = weights[-1].shape[1]
    x = x.contiguous()
    weights = [w.contiguous() for w in weights]
    biases = [b.contiguous() for b in biases]
    acts = torch.empty((m, n, cout), dtype=x.dtype, device=x.device) if return_acts else None
    pooled = partial = None
    if pool:
        tiles = -(-n // lib.fused_mlp_chain_tile_rows())
        pooled = torch.empty((m, cout), dtype=x.dtype, device=x.device)
        partial = torch.empty((m, tiles, cout), dtype=x.dtype, device=x.device)
    if m == 0:
        return acts, pooled
    pad = MAX_LAYERS - len(weights)
    ptr = lambda t: t.data_ptr() if t is not None else None
    couts = [w.shape[1] for w in weights] + [0] * pad
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_mlp_chain_f32(
            x.data_ptr(), m, n, x.shape[2], len(weights),
            *[w.data_ptr() for w in weights], *[None] * pad,
            *[b.data_ptr() for b in biases], *[None] * pad,
            *couts, int(relu_last), ptr(acts), ptr(pooled), ptr(partial), stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_chain kernel launch failed: CUDA error {err}")
    with _count_lock:
        fused_mlp_chain.launches += 1
    return acts, pooled


def fused_mlp_chain(
    x: torch.Tensor,  # [M, N, Cin] — M windows of N points
    weights: Sequence[torch.Tensor],  # [Cin_i, Cout_i] folded kernels
    biases: Sequence[torch.Tensor],  # [Cout_i]
    pool: bool = False,
    relu_last: bool = True,
    return_acts: bool = True,
):
    """Activations [M, N, Cout_last] (``return_acts``) and/or the per-window
    max [M, Cout_last] (``pool``); ``pool=True, return_acts=False`` writes only
    the pooled vector. fp32 only; up to 4 layers, widths up to 256."""
    _check(x, weights, biases, pool, return_acts)
    if x.device.type == "cpu":
        return fused_mlp_chain_reference(x, weights, biases, pool, relu_last, return_acts)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_chain runs on cuda or cpu tensors, got {x.device}")
    if x.shape[1] == 0:
        raise ValueError("fused_mlp_chain needs at least one point per window")
    acts, pooled = _launch(x, weights, biases, pool, relu_last, return_acts)
    if pool and return_acts:
        return acts, pooled
    return pooled if pool else acts


fused_mlp_chain.launches = 0
