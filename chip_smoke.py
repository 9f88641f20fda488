#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ampnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports nothing of JAX or of ``ampnet_tpu``. Phases, each of which fails
the run (non-zero exit, no result line) when it does not hold:

1. card   -- the ``nvidia-smi`` name and power limit line;
2. build  -- ``nvcc`` builds the serving path's kernel from
   ``ampnet_tpu_torch/csrc`` for ``sm_90a``;
3. kernels -- each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it (and at the bench geometry, a prime
   window count and ``relu_last=False``), timed with CUDA events beside its
   bound and the plain version's time; then, untimed, at ragged shapes
   (``EDGE_CASES``);
4. model  -- backend ``fused`` against the module forward (``xla``) at
   ``[2, 18, 4096, 9]``, from seeded random weights and BatchNorm statistics;
5. serve  -- the ``serve`` entry point (``--backend fused --device cuda``) on
   127.0.0.1 answers binary and JSON requests for 50,000- and 20,000-point
   clouds (two bucket shapes, one micro-batch holding both) from concurrent
   clients; every answer equals a direct ``TiledInferencer.predict_many`` on
   the same clouds and seeds as the micro-batch it was served in, and the
   kernel's launch counter shows that every bucket forward went through it;
6. results -- one ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 0
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, and HBM3
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# fp32 rounding of sums of up to 256 products, taken in another order than
# cuBLAS takes them: about K * 2^-24 relative, 1.5e-5 at K = 256
KERNEL_RTOL = 1e-4
# k = 18 windows of cap 4096, and k = 9 of cap 4096, at n_points 2048
SERVE_CLOUD_POINTS = (50_000, 50_000, 50_000, 50_000, 50_000, 20_000, 20_000)
SERVE_GEOM = (18, 4096)  # (M, N) of one served cloud's chains: 18 windows of 4096 points
BENCH_GEOM = (288, 2048)  # (M, N) at the bench geometry, 32 clouds x 9 windows
MODEL_SHAPE = (2, 18, 4096)  # [B, W, N] of the fused-against-xla check


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


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def chain_bound(m, n, dims, pool, return_acts):
    """(bound_ms, bound_by, flops, bytes) of one chain call: each input read
    once, each output written once, fp32."""
    flops = 2.0 * m * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = 4.0 * (m * n * dims[0] + params
                    + (m * n * dims[-1] if return_acts else 0) + (m * dims[-1] if pool else 0))
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def seeded_model(cfg):
    """The flagship segmenter with seeded random weights, BatchNorm
    statistics and T-Net output layers (Flax init leaves those zero)."""
    from ampnet_tpu_torch.models.amp import AMPNetSegmenter
    from ampnet_tpu_torch.models.layers import MaskedBatchNorm, TNet

    g = torch.Generator().manual_seed(SEED)
    model = AMPNetSegmenter(cfg.model, num_features=cfg.data.num_features, generator=g)
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


def kernel_err(case, x, ws, bs, kw) -> float:
    """fused_mlp_chain's kernel against its plain version on the same inputs:
    the largest absolute difference, which must stay within KERNEL_RTOL of
    the reference's largest magnitude (at least 1)."""
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain, fused_mlp_chain_reference

    out = fused_mlp_chain(x, ws, bs, **kw)
    ref = fused_mlp_chain_reference(x, ws, bs, **kw)
    torch.cuda.synchronize()
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err, scale = 0.0, 1.0
    for o, r in zip(out, ref):
        if o.shape != r.shape or not torch.isfinite(o).all():
            raise RuntimeError(f"{case}: kernel output {tuple(o.shape)} is not finite "
                               f"or not of shape {tuple(r.shape)}")
        err = max(err, (o - r).abs().max().item())
        scale = max(scale, r.abs().max().item())
    if err > KERNEL_RTOL * scale:
        raise RuntimeError(f"{case}: kernel disagrees with its plain version: "
                           f"max_abs_err {err} > {KERNEL_RTOL} * {scale}")
    return err


# ragged shapes the serving path does not give the kernel, checked untimed:
# (M, N, widths, pool, return_acts, relu_last)
EDGE_CASES = [
    (1, 1, (3, 64, 128, 256), True, False, True),  # one point
    (7, 65, (12, 64, 64), True, True, True),  # a row past one tile
    (3, 129, (5, 33, 70), True, True, False),  # widths off the 32-column grid
    (2, 200, (256, 256, 256, 256, 256), True, True, True),  # four layers, widest
    (4, 64, (128, 1), True, True, False),  # one output channel
]


def edge_phase(dev):
    """Phase 3b: the kernel against its plain version at EDGE_CASES, with
    seeded random weights (variance 1/fan_in)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for m, n, dims, pool, acts, relu_last in EDGE_CASES:
        ws = [torch.randn(a, b, generator=gen, device=dev) / a ** 0.5
              for a, b in zip(dims[:-1], dims[1:])]
        bs = [0.1 * torch.randn(b, generator=gen, device=dev) for b in dims[1:]]
        x = torch.randn(m, n, dims[0], generator=gen, device=dev)
        kw = dict(pool=pool, return_acts=acts, relu_last=relu_last)
        err = kernel_err(f"edge {m}x{n} {list(dims)}", x, ws, bs, kw)
        _say(f"  edge M={m} N={n} dims={list(dims)} {kw}: err={err:.3g}")


def kernel_phase(model, dev):
    """Phase 3: fused_mlp_chain against its plain version → (the per-forward
    row, the four serving chains summed; one row per case)."""
    from ampnet_tpu_torch.models.folded_infer import folded_chain_params
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain, fused_mlp_chain_reference

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
        dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
        x = torch.randn(m, n, dims[0], generator=gen, device=dev)
        kw = dict(pool=pool, return_acts=acts, relu_last=relu_last)
        err = kernel_err(case, x, ws, bs, kw)
        iters = 20 if m * n >= 1 << 16 else 100
        kern = lambda: fused_mlp_chain(x, ws, bs, **kw)
        plain = lambda: fused_mlp_chain_reference(x, ws, bs, **kw)
        # in turns, plain kernel kernel plain, within one card and one call
        p1, k1, k2, p2 = (time_ms(f, iters) for f in (plain, kern, kern, plain))
        bound_ms, bound_by, flops, nbytes = chain_bound(m, n, dims, pool, acts)
        row = {
            "name": f"fused_mlp_chain:{case}", "case": case, "shape": [m, n, dims],
            "route": "cuda", "source": "ampnet_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "ampnet_tpu/ops/pallas/fused_mlp.py:69",
            "max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            # the plain version IS the cuBLAS layer chain PyTorch offers for it
            "library_ms": (p1 + p2) / 2,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes,
        }
        _say(f"  {case:24s} M={m:4d} N={n:5d} dims={dims} err={err:.3g} "
             f"kernel={row['ms']:.4f} ms plain={row['plain_ms']:.4f} ms "
             f"bound={bound_ms:.4f} ms ({bound_by})")
        rows.append(row)
        del x
    serve = [r for r in rows if r["case"].startswith("serve:")]
    t_ops = sum(r["flops"] for r in serve) / FP32_PEAK_FLOPS * 1e3
    t_bytes = sum(r["bytes"] for r in serve) / HBM_BYTES_PER_S * 1e3
    total = {
        "name": "fused_mlp_chain", "case": "serve: the four chains of one forward, summed",
        "route": "cuda", "source": "ampnet_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "ampnet_tpu/ops/pallas/fused_mlp.py:69",
        "max_abs_err": max(r["max_abs_err"] for r in serve),
        "ms": sum(r["ms"] for r in serve), "plain_ms": sum(r["plain_ms"] for r in serve),
        "library_ms": sum(r["library_ms"] for r in serve),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    return total, rows


def model_phase(model, cfg, dev):
    """Phase 4: fused against the module forward at [*MODEL_SHAPE, 9]."""
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


def _post(url, body: bytes, ctype: str, timeout: float = 600.0) -> bytes:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise RuntimeError(f"HTTP {r.status} from {url}")
        return r.read()


def serve_phase(model, cfg, device: str = "cuda"):
    """Phase 5: the serve entry point answers concurrent clients. Returns
    (launches counted while serving, bucket forwards dispatched)."""
    from ampnet_tpu_torch.cli.main import build_parser, make_server
    from ampnet_tpu_torch.core.weights import flax_variables, save_reference_pth
    from ampnet_tpu_torch.ops import cuda_build
    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain

    rng = np.random.default_rng(SEED)
    clouds = []
    for n in SERVE_CLOUD_POINTS:
        c = rng.normal(size=(n, cfg.data.num_features)).astype(np.float32) * 0.5
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
        ckpt = os.path.join(tmp, "smoke_attention.pth")
        save_reference_pth(flax_variables(model), ckpt,
                           meta={"number_of_points": cfg.data.n_points})
        args = build_parser().parse_args([
            "serve", "--model_checkpoint", ckpt, "--backend", "fused",
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

        def record_dispatch(batch, seeds=None, return_probs=False, init_idx=None):
            handle = dispatch(batch, seeds, return_probs, init_idx)
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

            fused_mlp_chain.launches = 0  # the main path's run starts here
            served, wall = run_clients()
            launches = fused_mlp_chain.launches  # ... and ends here
            inferencer.dispatch_many, inferencer.fetch_many = dispatch, fetch
            with urllib.request.urlopen(url + "/v1/stats", timeout=60) as r:
                stats = json.loads(r.read())
            _say(f"  served {len(plan)} requests ({sum(SERVE_CLOUD_POINTS)} points in "
                 f"{len(clouds)} clouds) from 3 clients in {wall:.3f} s")
            _say("  stats: " + json.dumps(stats))

            # one forward per bucket of each dispatched micro-batch
            forwards = sum(len(h["pending"]) for *_, h in calls)
            _say("  micro-batches (clouds per bucket): "
                 + json.dumps([[len(idxs) for idxs, _ in h["pending"]] for *_, h in calls]))
            if launches != 4 * forwards:
                raise RuntimeError(f"fused_mlp_chain launched {launches} times while "
                                   f"serving {forwards} bucket forwards; want {4 * forwards}")
            if not any(len(h["pending"]) > 1 for *_, h in calls):
                raise RuntimeError("no micro-batch held two bucket shapes")
            check_served(inferencer, cfg, clouds, served, calls, fetched)
            _say(f"  fused_mlp_chain launches while serving: {launches} "
                 f"(= 4 x {forwards} bucket forwards)")
            warm_round(run_clients, served)
            _say("  breakdown: " + json.dumps(request_breakdown(inferencer, clouds[:4])))
        finally:
            inferencer.dispatch_many, inferencer.fetch_many = dispatch, fetch
            server.close()
            thread.join(timeout=60)
    return launches, forwards


def warm_round(run_clients, served):
    """The same traffic again, every shape now warm, with the card traced
    (kernel activity only): the share of the round's wall time in which no
    kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again, wall = run_clients()
        torch.cuda.synchronize()
    if sorted(again) != sorted(served) or any(again[c].shape != served[c].shape for c in served):
        raise RuntimeError("the warm round's answers do not cover the same clouds")
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    idle = f"{1.0 - busy / (wall * 1e3):.4f}" if busy > 0 else "not measured"
    _say(f"  warm round, traced: {sum(SERVE_CLOUD_POINTS)} points from 3 clients in "
         f"{wall * 1e3:.2f} ms; device busy {busy:.2f} ms; idle share {idle}; "
         f"{sum(e.count for e in kernels)} kernels")


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


def request_breakdown(inferencer, clouds) -> dict:
    """Where a warm served request's time goes, in ms: ``dispatch_many``
    must return without a host sync (CUDA sync debug mode raises on one), so
    its host time is the enqueue cost; the tiling and the forward of one
    cloud are then timed alone, and a request of one cloud beside one of
    ``len(clouds)`` clouds in one bucket: host enqueue beside device span
    (CUDA events), and the kernels' summed device time from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from ampnet_tpu_torch.infer.tiled import KMEANS_FEATURE_IDX
    from ampnet_tpu_torch.ops.kmeans import balanced_kmeans, num_tiles_test

    dev = inferencer.device
    cloud = clouds[0]
    n = cloud.shape[0]
    k = num_tiles_test(n, inferencer.n_points, inferencer.max_clusters)
    cap = inferencer._cap_for(n, k)
    out = {"points": n, "k": k, "cap": cap}

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

    rows = np.concatenate([cloud, cloud[np.random.default_rng(0).integers(0, n, k * cap - n)]])
    feats = torch.from_numpy(rows[:, list(KMEANS_FEATURE_IDX)]).to(dev)
    windows = torch.from_numpy(rows).to(dev).reshape(1, k, cap, -1)
    cent = windows[..., :2].mean(dim=2)
    requests = {
        "request_x1": lambda: inferencer.predict_many([cloud], seeds=[0]),
        f"request_x{len(clouds)}": lambda: inferencer.predict_many(
            list(clouds), seeds=[0] * len(clouds)),
    }
    parts = {
        "tiling": lambda: balanced_kmeans(
            feats, k, generator=torch.Generator(device=dev).manual_seed(0),
            capacities=(cap,) * k),
        "forward": lambda: inferencer._forward(windows, cent, None),
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
    for name, fn in requests.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        out[name]["kernel_launches"] = sum(e.count for e in kernels)
        out[name]["device_busy_ms"] = busy if busy > 0 else "not measured"
        top = {}
        for e in kernels:  # kernels whose names share 60 characters are summed
            top[e.key[:60]] = top.get(e.key[:60], 0.0) + e.self_device_time_total / 1e3
        out[name]["top_kernels_ms"] = dict(sorted(top.items(), key=lambda kv: -kv[1])[:8])
    return out


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

    _say("[1/6] card")
    _say(card_line())

    _say("[2/6] build")
    t0 = time.perf_counter()
    cuda_build.load("fused_mlp")
    _say(f"  built and loaded fused_mlp in {time.perf_counter() - t0:.2f} s")

    cfg = AMPNetConfig()
    model = seeded_model(cfg).to(dev)

    _say("[3/6] kernels against their plain versions")
    rows = kernel_phase(model, dev)
    edge_phase(dev)

    _say("[4/6] model: fused against the module forward")
    model_phase(model, cfg, dev)

    _say("[5/6] serve")
    launches, forwards = serve_phase(model, cfg)

    _say("[6/6] results")
    total, cases = rows
    # launches only where the serving run counted them: the whole kernel, and
    # each serving chain once per bucket forward (its M there is 18 x clouds
    # in the bucket); the other cases are shapes the main path did not run
    total["launches"] = launches
    for row in cases:
        row["launches"] = forwards if row["case"].startswith("serve:") else None
    _say(json.dumps({"kernels": [{**total, "cases": cases}]}))
    _say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
