"""Operations, bytes and peaks: the yardstick of every roofline and ``mfu``.

Everything here prices the work, never one implementation's design, so a
share stays comparable whatever computes it:

* operations are 2 × the multiply-adds of the published widths;
* float32-accurate work is priced at the H100's dense TF32 tensor-core peak
  (one product per multiply-add, whatever an implementation spends), int8
  work at the dense int8 peak;
* bytes count each input read once and each output written once, float32
  activations and parameters (int8 weights as one byte, with a float32
  scale and bias per channel);
* a bound is the larger of operations / peak and bytes / bandwidth.

Peaks: NVIDIA's H100 SXM data sheet, dense (no sparsity), at the 700 W limit.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

TF32_PEAK_FLOPS = 495e12  # dense TF32 tensor-core FLOP/s
INT8_PEAK_OPS = 1979e12  # dense int8 tensor-core OP/s
HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth

# the window encoder's per-point chains at the published widths
# (pointnetAtt.py:7-112 of the AMP-Net code): (input dims → ...), pooled or not
CHAINS: Dict[str, Tuple[Tuple[int, ...], bool]] = {
    "input_tnet": ((3, 64, 128, 256), True),
    "mlp_a": ((12, 64, 64), False),
    "feature_tnet": ((64, 64, 128, 256), True),
    "mlp_b": ((64, 64, 128, 128, 256), True),
}


def chain_macs(dims: Sequence[int]) -> int:
    """Multiply-adds a point of one chain."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def chain_work(m: int, n: int, dims: Sequence[int], pool: bool, int8: bool = False):
    """(operations, bytes) of one chain call over x [m, n, dims[0]]: x read
    once; the pooled [m, Cout] or the activations [m, n, Cout] written once;
    parameters read once (float32 weight and bias, or int8 weight and a
    float32 scale and bias per channel)."""
    ops = 2.0 * m * n * chain_macs(dims)
    layers = list(zip(dims[:-1], dims[1:]))
    params = sum(a * b + 8 * b for a, b in layers) if int8 else 4 * sum(a * b + b for a, b in layers)
    out = m * dims[-1] if pool else m * n * dims[-1]
    return ops, 4.0 * (m * n * dims[0] + out) + params


def bound_s(ops: float, nbytes: float, int8: bool = False) -> float:
    """The least time of that work on one H100: the larger of its
    operations at the peak of its precision and its bytes at the bandwidth."""
    return max(ops / (INT8_PEAK_OPS if int8 else TF32_PEAK_FLOPS), nbytes / HBM_BYTES_PER_S)


def kernel_bound_s(m: int, n: int, chains: Sequence[str], int8: bool = False) -> float:
    """Summed bounds of the named chains, one call each over m windows of n
    points."""
    return sum(bound_s(*chain_work(m, n, *CHAINS[c], int8=int8), int8=int8) for c in chains)


def model_ops(windows: int, points: int, classes: int = 5, global_feat: int = 256,
              heads: int = 8, clouds: int = 1, quantized: Sequence[str] = ()) -> Dict[str, float]:
    """Operations of one eval forward of AMP-Net over ``clouds`` clouds of
    ``windows`` windows × ``points`` points, by precision: {'tf32': ...,
    'int8': ...}. ``quantized`` names the chains run in int8. Counted: the
    four chains, the two transforms (xyz · T_in, h · T_feat), the T-Net FC
    heads, the positional encoding, the attention (projections, scores,
    weighted sum) and the per-point head."""
    m = clouds * windows
    p = m * points
    ops = {"tf32": 0.0, "int8": 0.0}
    for name, (dims, _) in CHAINS.items():
        ops["int8" if name in quantized else "tf32"] += 2.0 * p * chain_macs(dims)
    tf = 2.0 * p * (3 * 3 + 64 * 64)  # the transforms
    tf += 2.0 * m * ((256 * 256 + 256 * 128 + 128 * 9) + (256 * 256 + 256 * 128 + 128 * 4096))
    tf += 2.0 * m * (2 * 16 + 16 * global_feat)  # positional encoding
    tf += 2.0 * m * (global_feat * 3 * global_feat + global_feat * global_feat)  # projections
    tf += 2.0 * clouds * 2 * windows * windows * global_feat  # scores and weighted sum
    tf += 2.0 * p * ((64 + global_feat) * 128 + 128 * 64 + 64 * classes)  # the head
    ops["tf32"] += tf
    return ops


def least_time_s(ops: Dict[str, float]) -> float:
    """Least time of that work, each part at the peak of its precision."""
    return ops["tf32"] / TF32_PEAK_FLOPS + ops["int8"] / INT8_PEAK_OPS
