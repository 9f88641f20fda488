#!/usr/bin/env python3
"""Kernel timing on one CUDA card, two ways, and where the kernels' time goes.

Run from the root of a checkout, on a machine with the card::

    python3 kernel_timing.py                     # both kernels at the served and bench chains
    python3 kernel_timing.py --kernels int8      # quantized_mlp_chain only (or: fused)
    python3 kernel_timing.py --variants          # ... and variants of their sources
    python3 kernel_timing.py --kernels int8 --passes  # ... and each launch of one int8 call
    python3 kernel_timing.py --kernels sinkhorn  # the k-means at 1 and 4 served clouds
    python3 kernel_timing.py --kernels fps       # farthest-point sampling at PointNet++'s levels
    python3 kernel_timing.py --kernels fps --variants  # ... and its one-layout variants
    python3 kernel_timing.py --kernels ball_query  # PointNet++'s ball query at its levels

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
with ``git archive``) therefore times that checkout's kernels with the same
clocks; run the two in turns in one call to compare them on one card. Where
that checkout has no ``prepare_chain`` / ``prepare_quantized_chain``, its
wrapper takes the plain weights.

``--variants`` builds ``csrc/fused_mlp.cu`` and ``csrc/quantized_mlp.cu`` as
they are and variants of them, each with one part of the work dropped or
changed, and times them in turns (the kernel, every variant, every variant
again in reverse order, the kernel) at the served chains. Variants that
drop work give wrong answers: they exist to be timed, and the printed error
says how wrong. ``cvt_rna`` rounds to tf32 with the ``cvt.rna.tf32.f32``
instruction in place of the integer formula, which gives the same bits.

``--passes`` traces calls of ``quantized_mlp_chain`` with torch.profiler and
prints each device operation of one call (memset, absmax pass, one launch
per layer pass) with its mean device time, in launch order.

``--kernels sinkhorn`` times ``balanced_kmeans`` with its Sinkhorn iterations
on ``sinkhorn_iterations`` (``csrc/sinkhorn.cu`` and torch's column sum) at the
served bucket, B clouds of 73,728 points in k = 18 clusters of 4,096 (B = 1
and 4), beside the plain loop (device clock only) and the bound of the
log-domain loop's 2·N·k exps a Sinkhorn iteration, 300 iterations, at the
card's special-function rate; it raises unless both give the same
assignment and centroids bit for bit.

``--kernels fps`` times ``batched_farthest_point_sampling`` on its kernel
(``csrc/fps.cu``, one launch a call) at the three levels of the whole-cloud
PointNet++ step, 32 clouds of 16,384 points to 1,024 samples, of 1,024 to
256 and of 256 to 64, xyz uniform in the unit cube, beside the plain loop
(both clocks), the time a dependent step takes, and the bound of its
arithmetic (8 float32 operations a point and step at the card's float32
rate; the kernel is bound by the steps' latency, not by it); it raises
unless both pick the same indices. With ``--variants`` it also times, at the
same levels, builds of ``csrc/fps.cu`` that keep the running minima of every
size in the scratch layout (``FPS_VARIANTS``), against the kernel's
registers.

``--kernels ball_query`` times ``ball_query_members`` on its kernel
(``csrc/ball_query.cu``, one launch a call) at the three levels of the
whole-cloud PointNet++ step, on the model's own squared distances (xyz
uniform in the unit cube, centres from farthest-point sampling, d2 from
``_sqdist``): 32 x 1,024 centres over 16,384 points at radius 0.1, 32 x 256
over 1,024 at 0.2 and 32 x 64 over 256 at 0.4, 32 members a centre. Beside
it: the plain body (both clocks), the whole ``pointnet2.ball_query`` with its
distances (device clock), and the bound, the bytes the kernel has to touch
at 3.35 TB/s: each row of d2 up to its 32nd member (all of it where the ball
holds fewer) and the int64 output, with the share of the block so scanned.
It raises unless kernel and plain body give the same integers.

Prints one JSON line per chain (or clouds) and, last, the card's ``nvidia-smi`` name
and power limit. Weights are seeded random (variance 1/fan_in; the int8
chains quantized per channel from them): a dense chain's time does not
depend on their values.
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
# the int8 forward's chains: mlp_a keeps activations, mlp_b pools
QUANTIZED_CHAINS = {
    "mlp_a": ((12, 64, 64), False),
    "mlp_b": ((64, 64, 128, 128, 256), True),
}
GEOMS = {"serve": (18, 4096), "bench": (288, 2048)}  # (M windows, N points)
# the NVIDIA H100 SXM data sheet's HBM3 rate (chip_smoke.py prices bytes at it too)
HBM_BYTES_PER_S = 3.35e12


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


def time_quantized() -> None:
    """The checkout's ``quantized_mlp_chain`` (on a prepared chain where the
    checkout has ``prepare_quantized_chain``, as its forward calls it) and
    its plain version at the int8 forward's chains and both geometries, on
    both clocks, in turns: plain, kernel, kernel, plain. The kernel must
    agree with the plain version in every element."""
    from ampnet_tpu_torch.ops import quantized_mlp as qm

    gen = torch.Generator(device="cuda").manual_seed(2)
    for geom, (m, n) in GEOMS.items():
        for name, (dims, pool) in QUANTIZED_CHAINS.items():
            x, ws, bs = chain_inputs(dims, m, n, gen)
            qs, ss = qm.quantize_chain(ws)
            kw = dict(pool=pool, return_acts=not pool)
            prepare = getattr(qm, "prepare_quantized_chain", None)
            chain = (prepare(qs, ss, bs),) if prepare else (qs, ss, bs)
            kern = lambda: qm.quantized_mlp_chain(x, *chain, **kw)
            plain = lambda: qm.quantized_mlp_chain_reference(x, qs, ss, bs, **kw)
            ref = plain()
            differ = int((kern() != ref).sum().item())
            if differ:
                raise RuntimeError(f"quantized_mlp_chain {name} {geom}: {differ} elements "
                                   "differ from the plain version")
            iters = 20
            row = {"chain": f"int8:{name}", "geom": geom, "shape": [m, n, list(dims)],
                   "elements_differ": differ}
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

_S8_MMA = ("      Mma<N>::run(acc, make_desc(a_addr + off, 128, a_kst * 8), "
           "make_desc(b_addr + off, 128, kpad * 8));\n")
_S8_PASSES = "  for (int pass = 1; pass <= n_layers; ++pass) {"
_S8_DIVIDE = ("  float y = __fmul_rn(v, r_x);\n  y = __fmaf_rn(r_x, __fmaf_rn(-s_x, y, v), y);\n"
              "  return __fmaf_rn(r_x, __fmaf_rn(-s_x, y, v), y);")
# (old text, new text) replacements of csrc/quantized_mlp.cu: each drops or
# changes one part of the work
QUANTIZED_VARIANTS = {
    "no_mma": [(_S8_MMA, "")],
    # the final pass alone: no scale passes (x_q and the scales are left
    # as they happen to be)
    "no_scale_passes": [(_S8_PASSES, _S8_PASSES.replace("pass = 1", "pass = n_layers"))],
    # a product in place of each quantizing division
    "multiply_not_divide": [(_S8_DIVIDE, "  return __fmul_rn(v, r_x);")],
    # CUDA's own division (range check and slow path) in place of div_rn
    "fdiv_rn": [(_S8_DIVIDE, "  return __fdiv_rn(v, s_x);")],
}

_FPS_SCRATCH = ("  if (per > kMaxRegPoints) return 0;", "  if (per > 0) return 0;")
# (old text, new text) replacements of csrc/fps.cu: the one layout of every
# size in place of the register layout up to 16,384 points
FPS_VARIANTS = {
    # running minima in the [B, N] scratch, coordinates from global memory
    "scratch": [_FPS_SCRATCH],
    # ... coordinates in shared memory (clouds of at most 16,384 points only)
    "scratch_smem_xyz": [
        _FPS_SCRATCH,
        ("      minima[i] = ok ? INFINITY : -INFINITY;\n",
         "      minima[i] = ok ? INFINITY : -INFINITY;\n"
         "      xs[i] = g[3 * i];\n      ys[i] = g[3 * i + 1];\n      zs[i] = g[3 * i + 2];\n"),
        ("sqdist(__ldg(g + 3 * i), __ldg(g + 3 * i + 1),\n"
         "                                                  __ldg(g + 3 * i + 2), lx, ly, lz)",
         "sqdist(xs[i], ys[i], zs[i], lx, ly, lz)"),
        ("(const void*)fps_kernel<16>};", "(const void*)fps_kernel<16>, (const void*)fps_kernel<0>};"),
        ("fps_kernel<0><<<batch, threads, 0, st>>>",
         "fps_kernel<0><<<batch, threads, 3 * sizeof(float) * (size_t)n, st>>>"),
    ],
}

# kernel source -> its variants
SOURCE_VARIANTS = {"fused_mlp": VARIANTS, "quantized_mlp": QUANTIZED_VARIANTS,
                   "fps": FPS_VARIANTS}


def variant_source(name: str, source: str, kernel: str = "fused_mlp") -> str:
    """``source`` (``csrc/<kernel>.cu``) with the variant's replacements."""
    for old, new in SOURCE_VARIANTS[kernel][name]:
        if old not in source:
            raise RuntimeError(f"variant {name}: csrc/{kernel}.cu no longer holds {old!r}")
        source = source.replace(old, new)
    return source


def build_variants(kernel: str, signatures: dict) -> dict:
    """{"kernel": the package's build, variant: its build} of csrc/<kernel>.cu,
    one nvcc each, all started together, each with the C ``signatures`` of
    the module that launches it declared."""
    from ampnet_tpu_torch.ops import cuda_build

    source = (cuda_build.CSRC / f"{kernel}.cu").read_text()
    out = cuda_build.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    variants = SOURCE_VARIANTS[kernel]

    def build(name):
        path = out / f"{kernel}_{name}.cu"
        path.write_text(variant_source(name, source, kernel))
        return cuda_build.declare(ctypes.CDLL(str(cuda_build.build(path))), signatures)

    with ThreadPoolExecutor(len(variants) + 1) as pool:
        own = pool.submit(cuda_build.load, kernel, signatures)
        libs = dict(zip(variants, pool.map(build, variants)))
        return {"kernel": own.result(), **libs}


def time_in_turns(run, names) -> dict:
    """Device ms of ``run(name)`` for each name, timed in turns: every name,
    then every name again in reverse order; the mean of the two."""
    times = {}
    for v in [*names, *reversed(names)]:
        times.setdefault(v, []).append(device_ms(lambda: run(v), 20))
    return {k: sum(t) / len(t) for k, t in times.items()}


def time_variants(kernels) -> None:
    """Each variant's device time at the served chains, beside the kernel's,
    and its error against the plain version."""
    m, n = GEOMS["serve"]
    if "fused" in kernels:
        from ampnet_tpu_torch.ops import fused_mlp as fm

        libs = build_variants("fused_mlp", fm.SIGNATURES)
        gen = torch.Generator(device="cuda").manual_seed(1)
        for name, (dims, pool_) in CHAINS.items():
            x, ws, bs = chain_inputs(dims, m, n, gen)
            chain = fm.prepare_chain(ws, bs)
            kw = dict(pool=pool_, return_acts=not pool_)
            ref = fm.fused_mlp_chain_reference(x, ws, bs, **kw)
            scale = max(1.0, ref.abs().max().item())
            run = lambda v: fm.fused_mlp_chain(x, chain, library=libs[v], **kw)
            errs = {v: (run(v) - ref).abs().max().item() / scale for v in libs}
            print(json.dumps({"variants": name, "shape": [m, n, list(dims)],
                              "device_ms": time_in_turns(run, ["kernel", *VARIANTS, "kernel"]),
                              "err_of_max_ref": errs}), flush=True)
    if "int8" in kernels:
        from ampnet_tpu_torch.ops import quantized_mlp as qm

        libs = build_variants("quantized_mlp", qm.SIGNATURES)
        gen = torch.Generator(device="cuda").manual_seed(3)
        for name, (dims, pool_) in QUANTIZED_CHAINS.items():
            x, ws, bs = chain_inputs(dims, m, n, gen)
            qs, ss = qm.quantize_chain(ws)
            chain = qm.prepare_quantized_chain(qs, ss, bs)
            kw = dict(pool=pool_, return_acts=not pool_)
            ref = qm.quantized_mlp_chain_reference(x, qs, ss, bs, **kw)
            g = qm.block_windows_for(m, n, max(dims[1:]))
            # the wrapper's launch with another build: (acts, pooled)
            run = lambda v: qm._launch(x, chain, pool_, True, not pool_, g, libs[v])[int(pool_)]
            differ = {v: int((run(v) != ref).sum().item()) for v in libs}
            print(json.dumps({"variants": f"int8:{name}", "shape": [m, n, list(dims)],
                              "device_ms": time_in_turns(
                                  run, ["kernel", *QUANTIZED_VARIANTS, "kernel"]),
                              "elements_differ": differ}), flush=True)
    if "fps" in kernels:
        from ampnet_tpu_torch.ops import sampling

        libs = build_variants("fps", sampling.FPS_SIGNATURES)
        gen = torch.Generator(device="cuda").manual_seed(37)
        for b, n, s in FPS_LEVELS:
            xyz = torch.rand((b, n, 3), generator=gen, device="cuda")
            run = lambda v: fps_launch(libs[v], xyz, s)
            with torch.inference_mode():
                plain = sampling.batched_farthest_point_sampling_plain(xyz, s)
                equal = {v: torch.equal(run(v), plain) for v in libs}
                ms = time_in_turns(run, ["kernel", *FPS_VARIANTS, "kernel"])
            if not all(equal.values()):
                raise RuntimeError(f"fps variants at [{b}, {n}] -> {s}: indices differ from "
                                   f"the plain loop's: {equal}")
            print(json.dumps({"variants": "fps", "shape": [b, n, 3], "samples": s,
                              "device_ms": ms, "indices_equal": equal}), flush=True)


def fps_launch(lib, xyz, s):
    """``csrc/fps.cu``'s launch from the declared build ``lib`` on contiguous
    float32 ``xyz`` [B, N, 3], no mask → [B, s] int64."""
    from ampnet_tpu_torch.ops import cuda_build, sampling

    b, n = xyz.shape[:2]
    selected = torch.empty((b, s), dtype=torch.int64, device=xyz.device)
    minima = torch.empty((b, lib.fps_scratch_points(n)), dtype=torch.float32, device=xyz.device)
    cuda_build.launch(sampling.batched_farthest_point_sampling, lib.fps_sample, xyz.device,
                      xyz.data_ptr(), None, minima.data_ptr() if minima.numel() else None,
                      selected.data_ptr(), b, n, s)
    return selected


def time_passes() -> None:
    """Each device operation of one ``quantized_mlp_chain`` call at the int8
    chains and both geometries, in launch order, with its device time in
    microseconds: the mean over 10 traced calls."""
    from torch.profiler import ProfilerActivity, profile

    from ampnet_tpu_torch.ops import quantized_mlp as qm

    calls = 10
    gen = torch.Generator(device="cuda").manual_seed(4)
    for geom, (m, n) in GEOMS.items():
        for name, (dims, pool) in QUANTIZED_CHAINS.items():
            x, ws, bs = chain_inputs(dims, m, n, gen)
            qs, ss = qm.quantize_chain(ws)
            chain = qm.prepare_quantized_chain(qs, ss, bs)
            run = lambda: qm.quantized_mlp_chain(x, chain, pool=pool, return_acts=not pool)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    run()
                torch.cuda.synchronize()
            ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
            per = len(ops) // calls
            if per == 0 or len(ops) != per * calls:
                print(json.dumps({"passes": f"int8:{name}", "geom": geom,
                                  "device_us": "not measured: the trace held "
                                               f"{len(ops)} device operations"}), flush=True)
                continue
            times = [sum(ops[c * per + i].device_time_total for c in range(calls)) / calls
                     for i in range(per)]
            print(json.dumps({"passes": f"int8:{name}", "geom": geom, "shape": [m, n, list(dims)],
                              "device_us": [[ops[i].name[:48], t] for i, t in enumerate(times)],
                              "sum_us": sum(times)}), flush=True)


# exps a second: 16 a clock on each of the H100 SXM's 132 SMs at 1.755 GHz
SFU_EXPS_PER_S = 16 * 132 * 1.755e9
SINKHORN_SERVED = (18, 4096)  # k, cap of the served bucket


def time_sinkhorn(batches=(1, 4)) -> None:
    """``balanced_kmeans`` on the kernels against the plain loop at the
    served bucket."""
    from ampnet_tpu_torch.ops import kmeans

    k, cap = SINKHORN_SERVED
    n = k * cap
    gen = torch.Generator(device="cuda").manual_seed(29)
    take = kmeans._kernels_take
    for b in batches:
        feats = torch.rand((b, n, 3), generator=gen, device="cuda")
        init = torch.stack([torch.randperm(n, generator=gen, device="cuda")[:k]
                            for _ in range(b)])
        call = lambda: kmeans.balanced_kmeans(feats, k, capacities=(cap,) * k, init_idx=init)
        with torch.inference_mode():
            got = call()
            kmeans._kernels_take = lambda *args: False
            try:
                want = call()
                plain_ms = device_ms(call, 2)
            finally:
                kmeans._kernels_take = take
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"sinkhorn at B = {b}: not the plain loop's tiling")
            row = {"kernel": "sinkhorn_iterations", "shape": [b, n, 3], "k": k,
                   "host_ms": host_ms(call, 5), "device_ms": device_ms(call, 5),
                   "plain_device_ms": plain_ms}
        row["bound_ms"] = 2 * n * k * 300 * b / SFU_EXPS_PER_S * 1e3
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        print(json.dumps(row), flush=True)


# float32 operations a second outside the tensor cores: the H100 SXM's 67 TFLOP/s
FP32_PEAK_FLOPS = 67e12
FPS_LEVELS = ((32, 16384, 1024), (32, 1024, 256), (32, 256, 64))  # B, N, samples


def time_fps() -> None:
    """``batched_farthest_point_sampling`` on the kernel against the plain
    loop at the whole-cloud PointNet++ step's levels."""
    from ampnet_tpu_torch.ops.sampling import (
        batched_farthest_point_sampling,
        batched_farthest_point_sampling_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(31)
    for b, n, s in FPS_LEVELS:
        xyz = torch.rand((b, n, 3), generator=gen, device="cuda")
        call = lambda: batched_farthest_point_sampling(xyz, s)
        plain = lambda: batched_farthest_point_sampling_plain(xyz, s)
        with torch.inference_mode():
            if not torch.equal(call(), plain()):
                raise RuntimeError(f"fps at [{b}, {n}] -> {s}: not the plain loop's indices")
            row = {"kernel": "batched_farthest_point_sampling", "shape": [b, n, 3],
                   "samples": s, "host_ms": host_ms(call, 20), "device_ms": device_ms(call, 20),
                   "plain_host_ms": host_ms(plain, 2), "plain_device_ms": device_ms(plain, 2)}
        row["us_per_step"] = row["device_ms"] / max(s - 1, 1) * 1e3
        row["flops_bound_ms"] = 8 * b * n * (s - 1) / FP32_PEAK_FLOPS * 1e3
        print(json.dumps(row), flush=True)


# B, centres, points, radius; 32 members a centre
BALL_QUERY_LEVELS = ((32, 1024, 16384, 0.1), (32, 256, 1024, 0.2), (32, 64, 256, 0.4))
BALL_QUERY_MEMBERS = 32


def scanned_entries(d2: torch.Tensor, radius: float, k: int) -> int:
    """The entries of ``d2 [B, S, N]`` that a scan stopping at each row's
    k-th member reads: up to that member, the whole row where it has fewer."""
    n, total = d2.shape[-1], 0
    for block in d2:  # one cloud at a time: the counts are int64
        count = torch.cumsum(block <= radius * radius, dim=-1)
        full = count[:, -1] >= k
        stop = torch.where(full, torch.argmax((count >= k).to(torch.uint8), dim=-1) + 1, n)
        total += int(stop.sum())
    return total


def ball_query_bound(d2: torch.Tensor, radius: float, k: int) -> dict:
    """The share of ``d2 [B, S, N]`` a scan stopping at each row's k-th
    member reads (``scanned_entries``), and the bound: those float32 bytes
    and the int64 output at the HBM rate."""
    scanned = scanned_entries(d2, radius, k)
    b, s, _ = d2.shape
    return {"scanned_share": scanned / d2.numel(),
            "bound_ms": (4 * scanned + 8 * b * s * k) / HBM_BYTES_PER_S * 1e3}


def time_ball_query() -> None:
    """``ball_query_members`` on the kernel against the plain body at the
    whole-cloud PointNet++ step's levels."""
    from ampnet_tpu_torch.models import pointnet2
    from ampnet_tpu_torch.ops.sampling import (
        ball_query_members,
        ball_query_members_plain,
        batched_farthest_point_sampling,
    )

    k = BALL_QUERY_MEMBERS
    gen = torch.Generator(device="cuda").manual_seed(41)
    for b, s, n, radius in BALL_QUERY_LEVELS:
        xyz = torch.rand((b, n, 3), generator=gen, device="cuda")
        with torch.inference_mode():
            centers = pointnet2.gather_points(xyz, batched_farthest_point_sampling(xyz, s))
            d2 = pointnet2._sqdist(centers, xyz)
            call = lambda: ball_query_members(d2, radius, k)
            plain = lambda: ball_query_members_plain(d2, radius, k)
            whole = lambda: pointnet2.ball_query(centers, xyz, radius, k)
            if not torch.equal(call(), plain()):
                raise RuntimeError(f"ball query at [{b}, {s}, {n}]: not the plain body's "
                                   f"indices")
            row = {"kernel": "ball_query_members", "shape": [b, s, n], "radius": radius,
                   "members": k, "host_ms": host_ms(call, 20), "device_ms": device_ms(call, 20),
                   "plain_host_ms": host_ms(plain, 2), "plain_device_ms": device_ms(plain, 2),
                   "with_distances_device_ms": device_ms(whole, 5),
                   **ball_query_bound(d2, radius, k)}
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        print(json.dumps(row), flush=True)
        del d2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels",
                        choices=("all", "fused", "int8", "sinkhorn", "fps", "ball_query"),
                        default="all",
                        help="which kernels to time (default: the two chains)")
    parser.add_argument("--variants", action="store_true",
                        help="also time variants of the kernels' sources at the served chains")
    parser.add_argument("--passes", action="store_true",
                        help="also trace each launch of one quantized_mlp_chain call")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_timing: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are fp32
    kernels = ("fused", "int8") if args.kernels == "all" else (args.kernels,)
    if "fused" in kernels:
        time_chains()
    if "int8" in kernels:
        time_quantized()
    if "sinkhorn" in kernels:
        time_sinkhorn()
    if "fps" in kernels:
        time_fps()
    if "ball_query" in kernels:
        time_ball_query()
    if args.variants:
        time_variants(kernels)
    if args.passes:
        time_passes()
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
