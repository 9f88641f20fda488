#!/usr/bin/env python3
"""Kernel timing on one CUDA card, two ways, and where ``fused_mlp_chain``'s
time goes.

Run from the root of a checkout, on a machine with the card::

    python3 kernel_timing.py             # fused_mlp_chain at the served and bench chains
    python3 kernel_timing.py --variants  # ... and variants of its source

Two clocks, both CUDA events:

- ``host_ms``: back-to-back calls, as a caller makes them. When the
  wrapper's host work per call (argument checks, allocations, the ctypes
  call) takes longer than the kernel, this is the host's time, not the
  card's. ``chip_smoke.py`` reports it as ``ms``.
- ``device_ms``: the same calls captured in one CUDA graph and replayed,
  so no host work lies between the launches: the card's own time.
  ``chip_smoke.py`` reports it as ``device_ms``.

The script imports ``ampnet_tpu_torch`` from the directory it lies in. A
copy placed at the root of another checkout (an earlier commit, unpacked
with ``git archive``) therefore times that checkout's kernel with the same
clocks; run the two in turns in one call to compare them on one card.

``--variants`` builds ``csrc/fused_mlp.cu`` as it is and variants of it,
each with one more part of the work dropped or changed, and times them in
turns (the kernel, every variant, every variant again in reverse order,
the kernel) at the four served chains. Variants that drop work give wrong
answers: they exist to be timed, and the printed error says how wrong.
``cvt_rna`` rounds to tf32 with the ``cvt.rna.tf32.f32`` instruction in
place of the integer formula, which gives the same bits.

Prints one JSON line per chain and, last, the card's ``nvidia-smi`` name
and power limit. Weights are seeded random (variance 1/fan_in): a dense
chain's time does not depend on their values.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

# the chains of one served forward: (widths, pool); pool-only or acts-only
CHAINS = {
    "input_tnet": ((3, 64, 128, 256), True),
    "mlp_a": ((12, 64, 64), False),
    "feature_tnet": ((64, 64, 128, 256), True),
    "mlp_b": ((64, 64, 128, 128, 256), True),
}
GEOMS = {"serve": (18, 4096), "bench": (288, 2048)}  # (M windows, N points)


def host_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls between two
    CUDA events, after one warm-up call: the host's enqueue when it is the
    slower side, else the card's."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn``: ``iters`` calls captured in one CUDA
    graph (after a warm-up call on a side stream, as capture needs), then
    replayed once untimed and once between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def chain_inputs(dims, m, n, gen):
    ws = [torch.randn(a, b, generator=gen, device="cuda") / a ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(b, generator=gen, device="cuda") for b in dims[1:]]
    return torch.randn(m, n, dims[0], generator=gen, device="cuda"), ws, bs


def time_chains() -> None:
    """The checkout's ``fused_mlp_chain`` (on a prepared chain where the
    checkout has ``prepare_chain``, as its forward calls it) and its plain
    version (the cuBLAS fp32 layer chain) at every chain and geometry, on
    both clocks, in turns: plain, kernel, kernel, plain."""
    from ampnet_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator(device="cuda").manual_seed(0)
    for geom, (m, n) in GEOMS.items():
        for name, (dims, pool) in CHAINS.items():
            x, ws, bs = chain_inputs(dims, m, n, gen)
            kw = dict(pool=pool, return_acts=not pool)
            prepare = getattr(fm, "prepare_chain", None)
            chain = (prepare(ws, bs),) if prepare else (ws, bs)
            kern = lambda: fm.fused_mlp_chain(x, *chain, **kw)
            plain = lambda: fm.fused_mlp_chain_reference(x, ws, bs, **kw)
            ref = plain()
            err = (kern() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            iters = 20 if m * n >= 1 << 16 else 100
            row = {"chain": name, "geom": geom, "shape": [m, n, list(dims)], "err_of_max_ref": err}
            for clock in (host_ms, device_ms):
                p1, k1, k2, p2 = (clock(f, iters) for f in (plain, kern, kern, plain))
                row[clock.__name__] = {"kernel": (k1 + k2) / 2, "plain": (p1 + p2) / 2}
            print(json.dumps(row), flush=True)
            del x, ref


_TF32_INT = "  return __uint_as_float((__float_as_uint(x) + 0x1000u) & ~0x1FFFu);"
_TF32_CVT = ('  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
             "  return __uint_as_float(r);")
_TWO_PRODUCTS = "        Mma<N>::run(acc, alo, bhi);\n        Mma<N>::run(acc, ahi, blo);\n"
_PRODUCTS = _TWO_PRODUCTS + "        Mma<N>::run(acc, ahi, bhi);\n"
_COPY = """          mbar_expect_tx(full_addr + 8 * st, bytes);
          bulk_load(smem_addr(ring) + st * chain.stage_bytes, src + (size_t)s * bytes, bytes,
                    full_addr + 8 * st);"""
_LOAD_VEC = "      for (int q = tid; q < kWgRows * groups; q += kWgThreads) {"
_LOAD_SCALAR = "      for (int i = tid; i < kWgRows * k0; i += kWgThreads) {"
_STORES = """          *reinterpret_cast<float2*>(a_hi + off) = make_float2(h0, h1);
          *reinterpret_cast<float2*>(a_lo + off) = make_float2(tf32_rna(v0 - h0), tf32_rna(v1 - h1));"""
_POOL = "    if (partial != nullptr) {"

_NO_MMA = [(_PRODUCTS, "")]
_NO_LOAD = [(_LOAD_VEC, _LOAD_VEC.replace("q < kWgRows", "q < 0 * kWgRows")),
            (_LOAD_SCALAR, _LOAD_SCALAR.replace("i < kWgRows", "i < 0 * kWgRows"))]
_NO_STORES = [(_STORES, "")]
# (old text, new text) replacements of csrc/fused_mlp.cu
VARIANTS = {
    "cvt_rna": [(_TF32_INT, _TF32_CVT)],
    "one_product": [(_TWO_PRODUCTS, "")],
    "no_weight_copies": [(_COPY, "if (g < stages) {" + _COPY
                          + "} else { mbar_arrive(full_addr + 8 * st); }")],
    "no_mma": _NO_MMA,
    "no_mma_no_load": _NO_MMA + _NO_LOAD,
    "no_mma_no_load_no_stores": _NO_MMA + _NO_LOAD + _NO_STORES,
    "no_mma_no_load_no_stores_no_pool": _NO_MMA + _NO_LOAD + _NO_STORES
    + [(_POOL, "    if (partial != nullptr && n < 0) {")],
}


def variant_source(name: str, source: str) -> str:
    """``source`` (``csrc/fused_mlp.cu``) with the variant's replacements."""
    for old, new in VARIANTS[name]:
        if old not in source:
            raise RuntimeError(f"variant {name}: csrc/fused_mlp.cu no longer holds {old!r}")
        source = source.replace(old, new)
    return source


def time_variants() -> None:
    """Each variant's device time at the four served chains, beside the
    kernel's, and its error against the plain version."""
    from ampnet_tpu_torch.ops import cuda_build
    from ampnet_tpu_torch.ops import fused_mlp as fm

    source = (cuda_build.CSRC / "fused_mlp.cu").read_text()
    out = cuda_build.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)

    def build(name):
        path = out / f"fused_mlp_{name}.cu"
        path.write_text(variant_source(name, source))
        return ctypes.CDLL(str(cuda_build.build(path)))

    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        kernel = pool.submit(cuda_build.load, "fused_mlp")
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
        libs = {"kernel": kernel.result(), **libs}
    gen = torch.Generator(device="cuda").manual_seed(1)
    m, n = GEOMS["serve"]
    for name, (dims, pool_) in CHAINS.items():
        x, ws, bs = chain_inputs(dims, m, n, gen)
        chain = fm.prepare_chain(ws, bs)
        kw = dict(pool=pool_, return_acts=not pool_)
        ref = fm.fused_mlp_chain_reference(x, ws, bs, **kw)
        scale = max(1.0, ref.abs().max().item())
        times, errs = {}, {}
        for v in ["kernel", *VARIANTS, *reversed(VARIANTS), "kernel"]:
            run = lambda: fm.fused_mlp_chain(x, chain, library=libs[v], **kw)
            errs[v] = (run() - ref).abs().max().item() / scale
            times.setdefault(v, []).append(device_ms(run, 20))
        print(json.dumps({"variants": name, "shape": [m, n, list(dims)],
                          "device_ms": {k: sum(t) / len(t) for k, t in times.items()},
                          "err_of_max_ref": errs}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", action="store_true",
                        help="also time variants of csrc/fused_mlp.cu at the served chains")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_timing: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version is fp32
    time_chains()
    if args.variants:
        time_variants()
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
