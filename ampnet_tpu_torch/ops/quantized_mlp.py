"""int8 shared-MLP chain over point windows: the CUDA kernel, its plain
PyTorch version and the weight quantization.

Replaces the Pallas TPU kernel ``ampnet_tpu/ops/pallas/quantized_mlp.py``
(``quantized_mlp_chain``, ``pl.pallas_call`` at :121). The kernel itself is
``ampnet_tpu_torch/csrc/quantized_mlp.cu``; its source note says what bounds
it on an H100 and what the design does about it.

The scheme, as in the JAX package:

* weights: symmetric int8 per output channel, scale = max(absmax, 1e-12)/127,
  computed from the BatchNorm-folded fp32 kernels (``quantize_chain``);
* activations: one dynamic scale per block of g windows and per layer,
  s_x = max(absmax, 1e-12)/127 over every row of the block, quantized as
  ``clip(round(h / s_x), ±127)`` (round half to even);
* an int8 × int8 → int32 dot, then ``acc·(s_x·s_w) + b`` and ReLU.

g is ``block_windows``, or ``max(1, _pick_block_windows(m, n, cmax) // 2)``
when that is 0, and M is padded up to a multiple of g with zero windows. From
the first layer on those windows hold ``relu(b)`` and count toward their
block's scale, so the padding is part of the result.

``quantized_mlp_chain`` chooses by the tensor's device: a CPU tensor takes
the plain version (``quantized_mlp_chain_reference``), a CUDA tensor launches
the kernel or raises — there is no fallback. ``quantized_mlp_chain.launches``
counts calls that went through the kernel.

Rounding is pinned so that kernel and plain version agree bit for bit: both
divide (never multiply by a reciprocal), round half to even, and dequantize
with a separately rounded product and sum (no fused multiply-add).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch

from ampnet_tpu_torch.ops import cuda_build

MAX_LAYERS = 4
QMAX = 127.0
# an fp32 matmul of integer-valued operands is exact in any summation order
# while every partial sum stays below 2**24
EXACT_INT_SUM = 1 << 24
# launches come from the serving worker and the dispatch pool's threads
_count_lock = threading.Lock()


def _pick_block_windows(m: int, n: int, cmax: int, dtype_bytes: int = 4) -> int:
    """Windows per block, the port's copy of ``ampnet_tpu/ops/pallas/
    fused_mlp.py::_pick_block_windows``: an 8 MiB budget for ``n`` rows of
    ``max(cmax, 128)`` lanes, twice, capped at 8 and at ``m``. The int8 chain
    halves it, so its activation-scale blocks are the JAX package's."""
    budget = 8 * 1024 * 1024
    per_window = n * max(cmax, 128) * dtype_bytes * 2
    return min(8, m, max(1, budget // max(per_window, 1)))


def block_windows_for(m: int, n: int, cmax: int, block_windows: int = 0) -> int:
    """g, the windows that share one activation scale (``block_windows`` or
    the JAX package's choice when that is 0)."""
    return block_windows or max(1, _pick_block_windows(m, n, cmax) // 2)


def _div_qmax(t: torch.Tensor) -> torch.Tensor:
    # a tensor divisor: PyTorch's CUDA division by a CPU scalar multiplies by
    # its reciprocal, which moves values that lie on a rounding boundary
    return t / torch.full_like(t, QMAX)


def quantize_weights_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax per output channel of ``w`` [Cin, Cout] (BatchNorm
    already folded) → (int8 weights, fp32 scales [Cout])."""
    scale = _div_qmax(torch.clamp(w.abs().amax(dim=0), min=1e-12))
    wq = torch.clamp(torch.round(w / scale[None, :]), -QMAX, QMAX).to(torch.int8)
    # row-major, as the kernel reads it (a folded kernel is often a transposed view)
    return wq.contiguous(), scale.float()


def quantize_chain(weights: Sequence[torch.Tensor]):
    """Quantize a list of folded fp32 kernels → (int8 list, scale list)."""
    qs, ss = [], []
    for w in weights:
        q, s = quantize_weights_per_channel(w)
        qs.append(q)
        ss.append(s)
    return qs, ss


def quantized_mlp_chain_reference(x, wq, w_scale, biases, pool=False, relu_last=True,
                                  return_acts=True, block_windows=0):
    """Plain PyTorch version, step by step as the JAX kernel body: pad M to a
    multiple of g with zero windows, then per layer take the block's absmax,
    quantize, multiply the integer-valued tensors in fp32 (exact, see
    ``EXACT_INT_SUM``), dequantize, add the bias, ReLU."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("quantized_mlp_chain_reference needs TF32 off: its integer "
                           "dot is exact only in full fp32")
    m, n, cin = x.shape
    cout = wq[-1].shape[1]
    g = block_windows_for(m, n, max(q.shape[1] for q in wq), block_windows)
    pad = -m % g
    if pad:
        x = torch.cat([x, x.new_zeros((pad, n, cin))], dim=0)
    h = x.reshape((m + pad) // g, g * n, cin)
    n_layers = len(wq)
    for i, (q, s_w, b) in enumerate(zip(wq, w_scale, biases)):
        if q.shape[0] * QMAX * QMAX >= EXACT_INT_SUM:
            raise ValueError(f"layer {i}: {q.shape[0]} input channels would round the "
                             "integer dot in fp32")
        s_x = _div_qmax(torch.clamp(h.abs().amax(dim=(1, 2), keepdim=True), min=1e-12))
        hq = torch.clamp(torch.round(h / s_x), -QMAX, QMAX)
        acc = hq @ q.float()
        h = acc * (s_x * s_w) + b
        if i < n_layers - 1 or relu_last:
            h = torch.relu(h)
    h = h.reshape(m + pad, n, cout)[:m]
    if pool and return_acts:
        return h, h.amax(dim=1)
    if pool:
        return h.amax(dim=1)
    return h


def _check(x, wq, w_scale, biases, pool, return_acts, block_windows):
    if not (pool or return_acts):
        raise ValueError("quantized_mlp_chain needs pool or return_acts")
    if x.dim() != 3:
        raise ValueError(f"x must be [M, N, Cin], got shape {tuple(x.shape)}")
    if (not 1 <= len(wq) <= MAX_LAYERS or len(w_scale) != len(wq)
            or len(biases) != len(wq)):
        raise ValueError(f"need 1..{MAX_LAYERS} layers with one scale and one bias each, "
                         f"got {len(wq)} weights, {len(w_scale)} scales, {len(biases)} biases")
    if block_windows < 0:
        raise ValueError(f"block_windows must be >= 0, got {block_windows}")
    cin = x.shape[2]
    for i, (q, s, b) in enumerate(zip(wq, w_scale, biases)):
        if q.dim() != 2 or q.shape[0] != cin or s.shape != (q.shape[1],) \
                or b.shape != (q.shape[1],):
            raise ValueError(f"layer {i}: weight {tuple(q.shape)} / scale {tuple(s.shape)} / "
                             f"bias {tuple(b.shape)} do not chain from {cin} input channels")
        if q.dtype != torch.int8:
            raise TypeError(f"layer {i}: quantized weights must be int8, got {q.dtype}")
        cin = q.shape[1]
    for t in (x, *wq, *w_scale, *biases):
        if t.device != x.device:
            raise ValueError("x, weights, scales and biases must share one device")
    for t in (x, *w_scale, *biases):
        if t.dtype != torch.float32:
            raise TypeError(f"quantized_mlp_chain takes float32 x, scales and biases, "
                            f"got {t.dtype}")


def _lib() -> ctypes.CDLL:
    """The built kernel library, with every C signature declared."""
    lib = cuda_build.load("quantized_mlp")
    if lib.quantized_mlp_chain_s8.argtypes is None:  # declared last, below
        for fn in (lib.quantized_mlp_chain_tile_rows, lib.quantized_mlp_chain_max_width):
            fn.restype, fn.argtypes = ctypes.c_int, []
        lib.quantized_mlp_chain_s8.restype = ctypes.c_int
        lib.quantized_mlp_chain_s8.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int]
            + [ctypes.c_void_p] * (3 * MAX_LAYERS) + [ctypes.c_int] * (MAX_LAYERS + 1)
            + [ctypes.c_void_p] * 7)
    return lib


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on ``nbytes``."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def _launch(x, wq, w_scale, biases, pool, relu_last, return_acts, g):
    lib = _lib()
    width = lib.quantized_mlp_chain_max_width()
    if max(x.shape[2], *(q.shape[1] for q in wq)) > width:
        raise ValueError(f"quantized_mlp_chain kernel takes widths up to {width}")
    m, n, cin = x.shape
    pad = -m % g
    x = _aligned(x.contiguous(), 16)  # float4 loads
    if pad:  # zero windows: they count toward their block's scale
        x = torch.cat([x, x.new_zeros((pad, n, cin))], dim=0)
    mp = m + pad
    wq = [_aligned(q.contiguous(), 4) for q in wq]  # 4-byte loads
    w_scale = [s.contiguous() for s in w_scale]
    biases = [b.contiguous() for b in biases]
    couts = [q.shape[1] for q in wq]
    cout = couts[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    acts = torch.empty((mp, n, cout), **f32) if return_acts else None
    pooled = partial = None
    if pool:
        tiles = -(-n // lib.quantized_mlp_chain_tile_rows())
        pooled = torch.empty((mp, cout), **f32)
        partial = torch.empty((mp, tiles, cout), **f32)
    # fp32 activations between layers, and one absmax word per block and layer
    hidden = max(couts[:-1], default=0)
    scratch = torch.empty((2, mp * n * hidden), **f32) if hidden else None
    amax = torch.empty((len(wq), mp // g), dtype=torch.int32, device=x.device)
    nil = MAX_LAYERS - len(wq)
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantized_mlp_chain_s8(
            x.data_ptr(), mp, n, cin, g, len(wq),
            *[q.data_ptr() for q in wq], *[None] * nil,
            *[s.data_ptr() for s in w_scale], *[None] * nil,
            *[b.data_ptr() for b in biases], *[None] * nil,
            *couts, *[0] * nil, int(relu_last),
            ptr(acts), ptr(pooled), ptr(partial),
            ptr(scratch), ptr(scratch[1]) if scratch is not None else None,
            amax.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"quantized_mlp_chain kernel launch failed: CUDA error {err}")
    with _count_lock:
        quantized_mlp_chain.launches += 1
    return (acts[:m] if acts is not None else None,
            pooled[:m] if pooled is not None else None)


def quantized_mlp_chain(
    x: torch.Tensor,  # [M, N, Cin] fp32 — M windows of N points
    wq: Sequence[torch.Tensor],  # int8 [Cin_i, Cout_i]
    w_scale: Sequence[torch.Tensor],  # fp32 [Cout_i]
    biases: Sequence[torch.Tensor],  # fp32 [Cout_i]
    pool: bool = False,
    relu_last: bool = True,
    return_acts: bool = True,
    block_windows: int = 0,
):
    """int8 version of ``fused_mlp_chain``: activations [M, N, Cout_last]
    (``return_acts``) and/or the per-window max [M, Cout_last] (``pool``).
    Up to 4 layers, widths up to 256; ``block_windows`` = 0 picks g as the
    JAX package does."""
    _check(x, wq, w_scale, biases, pool, return_acts, block_windows)
    if x.device.type == "cpu":
        return quantized_mlp_chain_reference(x, wq, w_scale, biases, pool, relu_last,
                                             return_acts, block_windows)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_mlp_chain runs on cuda or cpu tensors, got {x.device}")
    m, n, _ = x.shape
    if n == 0 or m == 0:
        raise ValueError("quantized_mlp_chain needs at least one window of one point")
    g = block_windows_for(m, n, max(q.shape[1] for q in wq), block_windows)
    acts, pooled = _launch(x, wq, w_scale, biases, pool, relu_last, return_acts, g)
    if pool and return_acts:
        return acts, pooled
    return pooled if pool else acts


quantized_mlp_chain.launches = 0
