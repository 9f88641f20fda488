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

``prepare_quantized_chain`` lays a chain out for the kernel once: int8
weights K-major, zero-padded, in the kernel's shared-memory order, scales and
biases padded to the same widths, and the C arguments built. The padding is
decided there only. On a CUDA tensor ``quantized_mlp_chain`` takes such a
prepared chain, the one way into the kernel; the int8 forward prepares its
chains once per ``make_forward``. On a CPU tensor it also takes the plain
int8 weights.

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
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import torch

from ampnet_tpu_torch.ops import cuda_build

MAX_LAYERS = 4
MAX_WIDTH = 256
K_STEP = 32  # int8 values of one wgmma k-step
QMAX = 127.0
# an fp32 matmul of integer-valued operands is exact in any summation order
# while every partial sum stays below 2**24
EXACT_INT_SUM = 1 << 24


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


def pad_depth(c: int) -> int:
    """The first layer's Cin padded to whole ``wgmma`` k-steps of 32 int8
    values; later layers take the padded width before them."""
    return -(-c // K_STEP) * K_STEP


def pad_width(c: int) -> int:
    """A layer's Cout padded to the kernel's ``wgmma`` N (64, 128 or 256)."""
    return 64 if c <= 64 else 128 if c <= 128 else 256


def pack_weight_s8(q: torch.Tensor, kpad: int, npad: int) -> torch.Tensor:
    """One layer's int8 ``[Cin, Cout]`` weight in the kernel's shared-memory
    order, ``[npad/8, kpad/16, 8, 16]``: K-major, zero-padded, the 8-row ×
    16-byte core matrix (n // 8, k // 16) holding rows n % 8 of bytes k % 16
    (``wgmma``'s no-swizzle K-major layout)."""
    wt = torch.zeros(npad, kpad, dtype=torch.int8, device=q.device)
    wt[: q.shape[1], : q.shape[0]] = q.t()
    return wt.reshape(npad // 8, 8, kpad // 16, 16).permute(0, 2, 1, 3).contiguous()


def unpack_weight_s8(packed: torch.Tensor) -> torch.Tensor:
    """The K-major ``[npad, kpad]`` int8 weight back from ``pack_weight_s8``."""
    ng, kg, _, _ = packed.shape
    return packed.permute(0, 2, 1, 3).reshape(ng * 8, kg * 16)


@dataclass(frozen=True)
class PreparedQuantizedChain:
    """An int8 chain laid out for the kernel once (``prepare_quantized_chain``),
    with the int8 weights, scales and biases kept for the plain version."""

    wq: Tuple[torch.Tensor, ...]  # int8 [Cin_i, Cout_i]
    w_scale: Tuple[torch.Tensor, ...]  # fp32 [Cout_i]
    biases: Tuple[torch.Tensor, ...]  # fp32 [Cout_i]
    packed: Tuple[torch.Tensor, ...]  # pack_weight_s8 per layer
    scale_pad: Tuple[torch.Tensor, ...]  # [pad_width(Cout_i)], zero past Cout_i
    bias_pad: Tuple[torch.Tensor, ...]
    # the kernel's per-layer arguments as C arrays (weight, scale and bias
    # pointers, Cout, padded depth and width), built once: the call's host
    # time counts
    c_args: tuple = field(compare=False, repr=False)


def _check_chain(wq, w_scale, biases):
    if (not 1 <= len(wq) <= MAX_LAYERS or len(w_scale) != len(wq)
            or len(biases) != len(wq)):
        raise ValueError(f"need 1..{MAX_LAYERS} layers with one scale and one bias each, "
                         f"got {len(wq)} weights, {len(w_scale)} scales, {len(biases)} biases")
    cin = wq[0].shape[0] if wq[0].dim() == 2 else None
    for i, (q, s, b) in enumerate(zip(wq, w_scale, biases)):
        if q.dim() != 2 or q.shape[0] != cin or s.shape != (q.shape[1],) \
                or b.shape != (q.shape[1],):
            raise ValueError(f"layer {i}: weight {tuple(q.shape)} / scale {tuple(s.shape)} / "
                             f"bias {tuple(b.shape)} do not chain from {cin} input channels")
        if q.dtype != torch.int8:
            raise TypeError(f"layer {i}: quantized weights must be int8, got {q.dtype}")
        cin = q.shape[1]
    for t in (*wq, *w_scale, *biases):
        if t.device != wq[0].device:
            raise ValueError("x, weights, scales and biases must share one device")
    for t in (*w_scale, *biases):
        if t.dtype != torch.float32:
            raise TypeError(f"quantized_mlp_chain takes float32 x, scales and biases, "
                            f"got {t.dtype}")


def prepare_quantized_chain(wq: Sequence[torch.Tensor], w_scale: Sequence[torch.Tensor],
                            biases: Sequence[torch.Tensor]) -> PreparedQuantizedChain:
    """Lay out an int8 chain for the kernel: each layer's weights K-major,
    zero-padded (Cin of the first layer to ``pad_depth``, every Cout to
    ``pad_width``) in core-matrix order, scales and biases zero-padded to
    the same width. The padding is decided here only: the kernel reads it
    from the arguments and checks it. Call it once per set of weights."""
    _check_chain(wq, w_scale, biases)
    widest = max(wq[0].shape[0], *(q.shape[1] for q in wq))
    if widest > MAX_WIDTH:
        raise ValueError(f"quantized_mlp_chain kernel takes widths up to {MAX_WIDTH}, "
                         f"got {widest}")
    pad = lambda t, n: torch.nn.functional.pad(t, (0, n - t.shape[0])).contiguous()
    with torch.no_grad():
        packed, scale_pad, bias_pad = [], [], []
        kpad = pad_depth(wq[0].shape[0])
        for q, s, b in zip(wq, w_scale, biases):
            npad = pad_width(q.shape[1])
            packed.append(pack_weight_s8(q, kpad, npad))
            scale_pad.append(pad(s, npad))
            bias_pad.append(pad(b, npad))
            kpad = npad
    layers = len(packed)
    ptrs = lambda ts: (ctypes.c_void_p * layers)(*[t.data_ptr() for t in ts])
    ints = lambda vs: (ctypes.c_int * layers)(*vs)
    # the padding chosen here, read back from each packed layer's shape
    c_args = (ptrs(packed), ptrs(scale_pad), ptrs(bias_pad), ints([q.shape[1] for q in wq]),
              ints([p.shape[1] * 16 for p in packed]), ints([p.shape[0] * 8 for p in packed]))
    return PreparedQuantizedChain(tuple(wq), tuple(w_scale), tuple(biases), tuple(packed),
                                  tuple(scale_pad), tuple(bias_pad), c_args)


def _check(x, wq, pool, return_acts, block_windows):
    if not (pool or return_acts):
        raise ValueError("quantized_mlp_chain needs pool or return_acts")
    if x.dim() != 3:
        raise ValueError(f"x must be [M, N, Cin], got shape {tuple(x.shape)}")
    if block_windows < 0:
        raise ValueError(f"block_windows must be >= 0, got {block_windows}")
    if x.shape[2] != wq[0].shape[0]:
        raise ValueError(f"x has {x.shape[2]} channels; the chain takes {wq[0].shape[0]}")
    if wq[0].device != x.device:
        raise ValueError("x, weights, scales and biases must share one device")
    if x.dtype != torch.float32:
        raise TypeError(f"quantized_mlp_chain takes float32 x, scales and biases, got {x.dtype}")


SIGNATURES = {
    "quantized_mlp_chain_tile_rows": (ctypes.c_int, []),
    "quantized_mlp_chain_s8": (ctypes.c_int, [ctypes.c_void_p] + [ctypes.c_int] * 6
                               + [ctypes.POINTER(ctypes.c_void_p)] * 3
                               + [ctypes.POINTER(ctypes.c_int)] * 3
                               + [ctypes.c_int] + [ctypes.c_void_p] * 5),
}


def _launch(x, chain: PreparedQuantizedChain, pool, relu_last, return_acts, g, lib=None):
    """One launch of the kernel (``lib``: another build of
    ``csrc/quantized_mlp.cu``'s C interface, declared by
    ``cuda_build.declare(lib, SIGNATURES)``, in place of the package's own,
    as ``kernel_timing.py --variants`` times them) → (acts, pooled)."""
    lib = lib or cuda_build.load("quantized_mlp", SIGNATURES)
    m, n, cin = x.shape
    mp = m + (-m % g)  # the zero windows past m count toward their block's scale
    x = x.contiguous()
    cout = chain.wq[-1].shape[1]
    layers = len(chain.packed)
    f32 = dict(dtype=torch.float32, device=x.device)
    acts = torch.empty((m, n, cout), **f32) if return_acts else None
    pooled = torch.empty((m, cout), **f32) if pool else None
    rows = lib.quantized_mlp_chain_tile_rows()
    # x quantized once with its block's scale, as the kernel's tile images
    xq = (torch.empty(mp * -(-n // rows) * rows * chain.packed[0].shape[1] * 16,
                      dtype=torch.int8, device=x.device) if layers > 1 else None)
    # absmax words per layer and block; when pooling, tiles done and the
    # pooled maxima as order keys per window
    scratch = torch.empty(layers * (mp // g) + (m * (cout + 1) if pool else 0),
                          dtype=torch.int32, device=x.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    cuda_build.launch(quantized_mlp_chain, lib.quantized_mlp_chain_s8, x.device,
                      x.data_ptr(), m, mp, n, cin, g, layers, *chain.c_args, int(relu_last),
                      ptr(acts), ptr(pooled), ptr(xq), scratch.data_ptr())
    return acts, pooled


def quantized_mlp_chain(
    x: torch.Tensor,  # [M, N, Cin] fp32 — M windows of N points
    wq: Union[PreparedQuantizedChain, Sequence[torch.Tensor]],  # int8 [Cin_i, Cout_i]
    w_scale: Optional[Sequence[torch.Tensor]] = None,  # fp32 [Cout_i]; None when prepared
    biases: Optional[Sequence[torch.Tensor]] = None,  # fp32 [Cout_i]; None when prepared
    pool: bool = False,
    relu_last: bool = True,
    return_acts: bool = True,
    block_windows: int = 0,
):
    """int8 version of ``fused_mlp_chain``: activations [M, N, Cout_last]
    (``return_acts``) and/or the per-window max [M, Cout_last] (``pool``).
    ``wq`` is a ``prepare_quantized_chain`` result (``w_scale`` and
    ``biases`` then None) or, on a CPU tensor only, the int8 weights. Up to
    4 layers, widths up to 256; ``block_windows`` = 0 picks g as the JAX
    package does."""
    chain = None
    if isinstance(wq, PreparedQuantizedChain):
        if w_scale is not None or biases is not None:
            raise ValueError("a PreparedQuantizedChain carries its own scales and biases")
        chain, wq, w_scale, biases = wq, wq.wq, wq.w_scale, wq.biases
    else:
        _check_chain(wq, w_scale, biases)
    _check(x, wq, pool, return_acts, block_windows)
    if x.device.type == "cpu":
        return quantized_mlp_chain_reference(x, wq, w_scale, biases, pool, relu_last,
                                             return_acts, block_windows)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_mlp_chain runs on cuda or cpu tensors, got {x.device}")
    m, n, _ = x.shape
    if n == 0 or m == 0:
        raise ValueError("quantized_mlp_chain needs at least one window of one point")
    if chain is None:
        raise ValueError("on a CUDA tensor quantized_mlp_chain takes a PreparedQuantizedChain: "
                         "call prepare_quantized_chain once per set of weights")
    g = block_windows_for(m, n, max(q.shape[1] for q in wq), block_windows)
    acts, pooled = _launch(x, chain, pool, relu_last, return_acts, g)
    if pool and return_acts:
        return acts, pooled
    return pooled if pool else acts


quantized_mlp_chain.launches = 0
