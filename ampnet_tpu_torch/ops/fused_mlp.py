"""Fused shared-MLP chain over point windows: the CUDA kernel, its plain
PyTorch version, the BatchNorm fold and the weight preparation.

Replaces the Pallas TPU kernel ``ampnet_tpu/ops/pallas/fused_mlp.py``
(``fused_mlp_chain``, ``pl.pallas_call`` at :144). The kernel itself is
``ampnet_tpu_torch/csrc/fused_mlp.cu``; its source note says what bounds it on
an H100 (operations at the 3xTF32 tensor-core rate; bytes for mlp_a) and
what the design does about it (``wgmma`` on tf32 hi/lo splits with fp32
accuracy; a row tile of one window stays in shared memory across all
layers; weight slabs staged by ``cp.async.bulk`` through an mbarrier ring;
per-tile maxima reduced by a second launch).

``prepare_chain`` lays a chain's weights out for the kernel once: K-major,
zero-padded, split into tf32 ``hi`` and ``lo`` (``tf32_split``), in the
kernel's shared-memory order. The forward prepares its chains once per
``make_forward``; ``fused_mlp_chain`` also takes plain ``[Cin, Cout]``
weights and prepares them itself on a CUDA tensor.

``fused_mlp_chain`` chooses by the tensor's device: a CPU tensor takes the
plain version (``fused_mlp_chain_reference``), a CUDA tensor launches the
kernel or raises — there is no fallback. ``fused_mlp_chain.launches`` counts
kernel launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import torch

from ampnet_tpu_torch.ops import cuda_build

MAX_LAYERS = 4
MAX_WIDTH = 256
SLAB_K = 16  # K of one weight slab: two wgmma k8 steps


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


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 ``x``: ``hi`` rounded to tf32 (10 mantissa bits) to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32`` does; ``lo`` the
    same rounding of ``x − hi``, so |x − hi − lo| ≤ 2⁻²¹·|x|. Finite x."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        # +half an ulp of tf32 on the magnitude, then clear the 13 low bits
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def pad_width(c: int) -> int:
    """A layer's Cout padded to the kernel's wgmma N (64, 128 or 256)."""
    return 64 if c <= 64 else 128 if c <= 128 else 256


def pad_depth(c: int) -> int:
    """The first layer's Cin padded to whole slabs; later layers take the
    padded width before them. The kernel reads both paddings from the
    packed layers' shapes."""
    return -(-c // SLAB_K) * SLAB_K


def pack_weight(w: torch.Tensor, kpad: int, npad: int) -> torch.Tensor:
    """One layer's ``[Cin, Cout]`` weight in the kernel's order:
    ``[kpad/16 slabs, (hi, lo), npad/8, 4, 8, 4]``. Within a slab's plane,
    the 8-row × 4-deep core matrix (n // 8, k // 4) holds rows n % 8 of
    16 bytes (k % 4), which is wgmma's no-swizzle K-major layout."""
    wt = torch.zeros(npad, kpad, dtype=torch.float32, device=w.device)
    wt[: w.shape[1], : w.shape[0]] = w.t()

    def cores(t):  # [npad, kpad] → [slab, n // 8, k // 4 in slab, n % 8, k % 4]
        return t.reshape(npad // 8, 8, kpad // SLAB_K, SLAB_K // 4, 4).permute(2, 0, 3, 1, 4)

    hi, lo = tf32_split(wt)
    return torch.stack([cores(hi), cores(lo)], dim=1).contiguous()


def unpack_weight(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K-major ``[npad, kpad]`` (hi, lo) planes back from ``pack_weight``."""
    slabs, _, ng, _, _, _ = packed.shape

    def plane(p):  # [slab, ng, kc, r, q] → [ng, r, slab, kc, q]
        return p.permute(1, 3, 0, 2, 4).reshape(ng * 8, slabs * SLAB_K)

    return plane(packed[:, 0]), plane(packed[:, 1])


@dataclass(frozen=True)
class PreparedChain:
    """A chain laid out for the kernel once (``prepare_chain``), with the
    fp32 weights and biases kept for the plain version."""

    weights: Tuple[torch.Tensor, ...]  # [Cin_i, Cout_i] fp32
    biases: Tuple[torch.Tensor, ...]  # [Cout_i]
    packed: Tuple[torch.Tensor, ...]  # pack_weight per layer
    bias_pad: Tuple[torch.Tensor, ...]  # [pad_width(Cout_i)], zero past Cout_i
    # the kernel's per-layer arguments as C arrays (packed and bias pointers,
    # Cout, padded depth and width), built once: the call's host time counts
    c_args: tuple = field(compare=False, repr=False)


def _check_chain(weights, biases):
    if not 1 <= len(weights) <= MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"need 1..{MAX_LAYERS} layers with one bias each, got "
                         f"{len(weights)} weights and {len(biases)} biases")
    cin = weights[0].shape[0]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.dim() != 2 or w.shape[0] != cin or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} / bias {tuple(b.shape)} "
                             f"do not chain from {cin} input channels")
        cin = w.shape[1]
    for t in (*weights, *biases):
        if t.device != weights[0].device:
            raise ValueError("weights and biases must share one device")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mlp_chain takes float32, got {t.dtype}")


def prepare_chain(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]) -> PreparedChain:
    """Lay out a chain of ``[Cin_i, Cout_i]`` weights and ``[Cout_i]`` biases
    for the kernel: each layer K-major, zero-padded (Cin of the first layer
    to ``pad_depth``, every Cout to ``pad_width``), split into tf32 hi and lo
    and packed in slab order. Call it once per set of weights."""
    _check_chain(weights, biases)
    widest = max(weights[0].shape[0], *(w.shape[1] for w in weights))
    if widest > MAX_WIDTH:
        raise ValueError(f"fused_mlp_chain kernel takes widths up to {MAX_WIDTH}, got {widest}")
    with torch.no_grad():
        packed, bias_pad = [], []
        kpad = pad_depth(weights[0].shape[0])
        for w, b in zip(weights, biases):
            npad = pad_width(w.shape[1])
            packed.append(pack_weight(w, kpad, npad))
            bias_pad.append(torch.nn.functional.pad(b, (0, npad - b.shape[0])).contiguous())
            kpad = npad
    layers = len(packed)
    ptrs = lambda ts: (ctypes.c_void_p * layers)(*[t.data_ptr() for t in ts])
    ints = lambda vs: (ctypes.c_int * layers)(*vs)
    # the padding chosen here, read back from each packed layer's shape
    c_args = (ptrs(packed), ptrs(bias_pad), ints([w.shape[1] for w in weights]),
              ints([p.shape[0] * SLAB_K for p in packed]), ints([p.shape[2] * 8 for p in packed]))
    return PreparedChain(tuple(weights), tuple(biases), tuple(packed), tuple(bias_pad), c_args)


def _check(x, weights, pool, return_acts):
    if not (pool or return_acts):
        raise ValueError("fused_mlp_chain needs pool or return_acts")
    if x.dim() != 3:
        raise ValueError(f"x must be [M, N, Cin], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"fused_mlp_chain takes float32, got {x.dtype}")
    if x.shape[2] != weights[0].shape[0]:
        raise ValueError(f"x has {x.shape[2]} channels; the chain takes {weights[0].shape[0]}")
    if weights[0].device != x.device:
        raise ValueError("x, weights and biases must share one device")


SIGNATURES = {
    "fused_mlp_chain_tile_rows": (ctypes.c_int, []),
    "fused_mlp_chain_f32": (ctypes.c_int, [ctypes.c_void_p] + [ctypes.c_int] * 4
                            + [ctypes.POINTER(ctypes.c_void_p)] * 2
                            + [ctypes.POINTER(ctypes.c_int)] * 3
                            + [ctypes.c_int] + [ctypes.c_void_p] * 4),
}


def _launch(x, chain: PreparedChain, pool, relu_last, return_acts, lib):
    lib = lib or cuda_build.load("fused_mlp", SIGNATURES)
    m, n, _ = x.shape
    cout = chain.weights[-1].shape[1]
    x = x.contiguous()
    acts = torch.empty((m, n, cout), dtype=x.dtype, device=x.device) if return_acts else None
    pooled = partial = None
    if pool:
        tiles = -(-n // lib.fused_mlp_chain_tile_rows())
        pooled = torch.empty((m, cout), dtype=x.dtype, device=x.device)
        partial = torch.empty((m, tiles, cout), dtype=x.dtype, device=x.device)
    if m == 0:
        return acts, pooled
    ptr = lambda t: t.data_ptr() if t is not None else None
    cuda_build.launch(fused_mlp_chain, lib.fused_mlp_chain_f32, x.device,
                      x.data_ptr(), m, n, x.shape[2], len(chain.packed), *chain.c_args,
                      int(relu_last), ptr(acts), ptr(pooled), ptr(partial))
    return acts, pooled


def fused_mlp_chain(
    x: torch.Tensor,  # [M, N, Cin] — M windows of N points
    weights: Union[PreparedChain, Sequence[torch.Tensor]],  # [Cin_i, Cout_i] folded kernels
    biases: Optional[Sequence[torch.Tensor]] = None,  # [Cout_i]; None with a PreparedChain
    pool: bool = False,
    relu_last: bool = True,
    return_acts: bool = True,
    library: Optional[ctypes.CDLL] = None,
):
    """Activations [M, N, Cout_last] (``return_acts``) and/or the per-window
    max [M, Cout_last] (``pool``); ``pool=True, return_acts=False`` writes only
    the pooled vector. ``weights`` is a ``prepare_chain`` result (``biases``
    then None) or plain weights, which a CUDA call prepares itself. fp32 only;
    up to 4 layers, widths up to 256. ``library``: another build of
    ``csrc/fused_mlp.cu``'s C interface, declared by
    ``cuda_build.declare(lib, SIGNATURES)``, to launch in place of the
    package's own (``kernel_timing.py --variants`` times variants of the
    source)."""
    chain = None
    if isinstance(weights, PreparedChain):
        if biases is not None:
            raise ValueError("a PreparedChain carries its own biases")
        chain, weights, biases = weights, weights.weights, weights.biases
    else:
        _check_chain(weights, biases)
    _check(x, weights, pool, return_acts)
    if x.device.type == "cpu":
        return fused_mlp_chain_reference(x, weights, biases, pool, relu_last, return_acts)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_chain runs on cuda or cpu tensors, got {x.device}")
    if x.shape[1] == 0:
        raise ValueError("fused_mlp_chain needs at least one point per window")
    acts, pooled = _launch(x, chain or prepare_chain(weights, biases), pool, relu_last,
                           return_acts, library)
    if pool and return_acts:
        return acts, pooled
    return pooled if pool else acts


fused_mlp_chain.launches = 0
