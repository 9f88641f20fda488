"""``python -m ampnet_tpu_torch bench``: steady-state inference throughput of
the flagship AMP-Net segmenter on one card, counterpart of the repo's
``bench.py`` (the JAX package's ``bench`` subcommand).

Stdout gets ONE JSON line, with the JAX bench's keys::

    {"metric": "ampnet_inference_throughput", "value", "unit": "windows/sec",
     "vs_baseline", "compile_s", "reps_windows_per_sec", "rep_spread_pct"}

* ``value``: windows/s of the forward at batch 32 clouds × 9 windows × 2048
  points × 9 features (the reference train/test geometry, BASELINE.md), under
  the backend ``AMPNET_BACKEND`` names (``xla`` by default; ``fused`` runs
  the encoder's four chains through ``fused_mlp_chain``, ``int8`` mlp_a and
  mlp_b through ``quantized_mlp_chain`` and the T-Net trunks through
  ``fused_mlp_chain``).
* ``vs_baseline``: ``value`` over the CPU-PyTorch reference-style eager loop
  (per-window encoder passes + attention, ``test_pointnet_att_segmen.py:160-177``
  shapes) pinned in ``benchmarks/bench_baseline_pinned.json``.

Stderr gets the detail: the baseline, the forward's reps and the train arms
(fp32 and bf16 steps: augmentation, forward, backward, Adam).

The JAX bench also reports XLA's persistent compilation cache (which
programs hit or missed it, and when it is switched on). torch has no such
cache: eager PyTorch compiles nothing, and the port's kernels are built by
``nvcc`` at their first call (``ops/cuda_build.py``), which ``compile_s``
includes. So this module has no counterpart of those diagnostics.

The timing rules are the JAX bench's: each latency iteration feeds the
previous one's output back as a float carry (``points + carry``, then
``carry = max(logits) · 1e-12``: a data dependency nothing can fold away), and
every timed region ends by reading a value back to the host. The bench runs
on the card unless asked for the CPU (``device="cpu"``, small sizes, as the
tests run it).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the committed pin of the CPU-torch denominator, read as a data file;
# AMPNET_BENCH_REMEASURE=1 measures it live instead
BASELINE_PIN = os.path.join(REPO, "benchmarks", "bench_baseline_pinned.json")
BASELINE_CACHE = os.path.join(REPO, ".bench_baseline_torch.json")

BATCH = 32
WINDOWS = 9
POINTS = 2048
FEATS = 9

# the JAX bench's recorded value of the eager loop (1 CPU thread), used only
# when a live measurement fails
FALLBACK_BASELINE = {
    "windows_per_sec": 43.68,
    "points_per_sec": 89455.0,
    "note": "recorded 2026-08-16",
}


# -- the CPU baseline: the reference-style eager loop -------------------------


def build_reference_ampnet(global_feat=256, heads=8, num_classes=5, point_dim=3):
    """(encoder, attention head) of an eager AMP-Net built from the
    architecture spec, as ``benchmarks/torch_baseline.py`` builds it (the
    same modules in the same order, so one seed gives the same weights).
    Weights come from torch's global generator; callers fork it."""
    import torch.nn as nn
    import torch.nn.functional as F

    class TNet(nn.Module):
        def __init__(self, d):
            super().__init__()
            chans = [d, 64, 128, 256]
            self.convs = nn.ModuleList(
                nn.Conv1d(a, b, 1, bias=False) for a, b in zip(chans[:-1], chans[1:])
            )
            self.cbns = nn.ModuleList(nn.BatchNorm1d(c) for c in chans[1:])
            dims = [256, 256, 128]
            self.fcs = nn.ModuleList(
                nn.Linear(a, b, bias=False) for a, b in zip(dims[:-1], dims[1:])
            )
            self.fbns = nn.ModuleList(nn.BatchNorm1d(d_) for d_ in dims[1:])
            self.out = nn.Linear(dims[-1], d * d)
            self.d = d

        def forward(self, x):  # [B, N, d]
            h = x.transpose(2, 1)
            for c, b in zip(self.convs, self.cbns):
                h = F.relu(b(c(h)))
            h = h.max(dim=2).values
            for f, b in zip(self.fcs, self.fbns):
                h = F.relu(b(f(h)))
            m = self.out(h).view(-1, self.d, self.d)
            return m + torch.eye(self.d)

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.t_in = TNet(point_dim)
            self.t_feat = TNet(64)
            ca = [9 + point_dim, 64, 64]
            cb = [64, 64, 128, 128, global_feat]
            self.mlp_a = nn.ModuleList(
                nn.Conv1d(a, b, 1, bias=False) for a, b in zip(ca[:-1], ca[1:])
            )
            self.bn_a = nn.ModuleList(nn.BatchNorm1d(c) for c in ca[1:])
            self.mlp_b = nn.ModuleList(
                nn.Conv1d(a, b, 1, bias=False) for a, b in zip(cb[:-1], cb[1:])
            )
            self.bn_b = nn.ModuleList(nn.BatchNorm1d(c) for c in cb[1:])

        def forward(self, x):  # [B, N, 9]
            coords = torch.bmm(x[:, :, :point_dim], self.t_in(x[:, :, :point_dim]))
            h = torch.cat([coords, x], dim=2).transpose(2, 1)
            for c, b in zip(self.mlp_a, self.bn_a):
                h = F.relu(b(c(h)))
            h = torch.bmm(h.transpose(2, 1), self.t_feat(h.transpose(2, 1)))
            local = h
            h = h.transpose(2, 1)
            for c, b in zip(self.mlp_b, self.bn_b):
                h = F.relu(b(c(h)))
            return local, h.max(dim=2).values

    class AttHead(nn.Module):
        def __init__(self):
            super().__init__()
            self.pe1 = nn.Linear(2, 16)
            self.pe2 = nn.Linear(16, global_feat)
            self.att = nn.MultiheadAttention(global_feat, heads, dropout=0.0)
            dims = [64 + global_feat, global_feat // 2, 64]
            self.head = nn.ModuleList(nn.Conv1d(a, b, 1) for a, b in zip(dims[:-1], dims[1:]))
            self.hbns = nn.ModuleList(nn.BatchNorm1d(c) for c in dims[1:])
            self.out = nn.Conv1d(64, num_classes, 1)

        def forward(self, tokens, locals_, centroids, np_cluster):
            # tokens [W, B, G], sequence first like the reference
            pe = self.pe2(F.leaky_relu(self.pe1(centroids))).transpose(0, 1)
            tokens, _ = self.att(tokens + pe, tokens + pe, tokens + pe)
            reps = []
            for i in range(tokens.shape[0]):
                reps.append(tokens[i].unsqueeze(1).expand(-1, np_cluster[i], -1))
            glob = torch.cat(reps, dim=1)
            h = torch.cat([locals_, glob], dim=2).transpose(2, 1)
            for c, b in zip(self.head, self.hbns):
                h = F.relu(b(c(h)))
            return self.out(h)

    return Encoder(), AttHead()


def reference_cloud(enc, head, windows: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """One cloud the reference's way: a sequential loop over its windows
    through the encoder at batch 1, ``torch.cat`` accumulation, then one
    attention pass → logits [1, classes, W · N]."""
    locals_, tokens, np_cluster = [], [], []
    with torch.no_grad():
        for w in range(windows.shape[0]):
            lo, gl = enc(windows[w: w + 1])
            locals_.append(lo)
            tokens.append(gl.unsqueeze(0))
            np_cluster.append(windows.shape[1])
        return head(torch.cat(tokens, dim=0), torch.cat(locals_, dim=1), cent, np_cluster)


def measure_reference_inference(n_clouds=4, n_windows=WINDOWS, n_points=POINTS, warmup=1,
                                threads=1, repeats=3) -> dict:
    """The reference-style eager loop on the CPU with ``threads`` threads
    (the pin's protocol: 1), best of ``repeats`` sweeps over ``n_clouds``
    clouds (a slowed-down baseline would inflate the speedup). Leaves the
    process's thread count and global generator as it found them."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            enc, head = build_reference_ampnet()
        enc.eval()
        head.eval()
        rng = np.random.default_rng(0)
        clouds = [torch.from_numpy(rng.normal(size=(n_windows, n_points, 9)).astype(np.float32))
                  for _ in range(n_clouds + warmup)]
        cents = [torch.from_numpy(rng.normal(size=(1, n_windows, 2)).astype(np.float32))
                 for _ in range(n_clouds + warmup)]
        for i in range(warmup):
            reference_cloud(enc, head, clouds[i], cents[i])
        dt = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for i in range(warmup, warmup + n_clouds):
                reference_cloud(enc, head, clouds[i], cents[i])
            dt = min(dt, time.perf_counter() - t0)
        measured_threads = torch.get_num_threads()
    finally:
        torch.set_num_threads(before)
    total_windows = n_clouds * n_windows
    return {
        "windows_per_sec": total_windows / dt,
        "points_per_sec": total_windows * n_points / dt,
        "seconds": dt,
        "n_clouds": n_clouds,
        "n_windows": n_windows,
        "n_points": n_points,
        "torch_threads": measured_threads,
    }


def get_baseline() -> dict:
    """The pin, unless ``AMPNET_BENCH_REMEASURE`` is set; then the cache of
    an earlier live measurement; else a live measurement, cached. A failed
    measurement gives the recorded value, as in JAX: this is a host
    yardstick, not the device path."""
    if os.path.exists(BASELINE_PIN) and not os.environ.get("AMPNET_BENCH_REMEASURE"):
        with open(BASELINE_PIN) as f:
            return json.load(f)
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as f:
            return json.load(f)
    sys.stderr.write("measuring CPU torch baseline (one-time)...\n")
    try:
        result = measure_reference_inference(n_clouds=4, n_windows=WINDOWS, n_points=POINTS)
    except Exception as e:  # never let the baseline path break the bench
        sys.stderr.write(f"baseline measurement failed ({e!r}); using recorded value\n")
        return dict(FALLBACK_BASELINE)
    with open(BASELINE_CACHE, "w") as f:
        json.dump(result, f, indent=2)
    return result


# -- the card --------------------------------------------------------------------


def forward_inputs(batch=BATCH, windows=WINDOWS, points=POINTS, feats=FEATS):
    """(points [B, W, N, F], centroids [B, W, 2]) float32, the JAX bench's
    draws in its order (bench.py:207-209)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(batch, windows, points, feats)).astype(np.float32)
    cent = rng.normal(size=(batch, windows, 2)).astype(np.float32)
    return pts, cent


def train_inputs(batch=BATCH, windows=WINDOWS, points=POINTS, feats=FEATS) -> dict:
    """The train arms' batch, the JAX bench's draws in its order
    (bench.py:298-303): points, labels in [−1, 5), centroids."""
    rng = np.random.default_rng(0)
    return {
        "points": rng.normal(size=(batch, windows, points, feats)).astype(np.float32),
        "labels": rng.integers(-1, 5, size=(batch, windows, points)).astype(np.int32),
        "centroids": rng.normal(size=(batch, windows, 2)).astype(np.float32),
    }


def bench_model(cfg):
    """The flagship segmenter with Flax-style initial weights from seed 0
    (the JAX bench measures ``model.init(PRNGKey(0), ...)``'s)."""
    from ampnet_tpu_torch.models.amp import AMPNetSegmenter

    return AMPNetSegmenter(cfg.model, generator=torch.Generator().manual_seed(0))


def make_bench_forward(model, cfg, backend: str, device):
    """forward(points, centroids, pad, carry) → (logits, new carry): the
    backend's forward of ``points + carry``, and ``max(logits) · 1e-12``, a
    float scalar the next call can depend on."""
    from ampnet_tpu_torch.models.backends import make_forward

    fwd = make_forward(model, cfg, backend, device)

    def forward(points, centroids, pad, carry):
        logits = fwd(points + carry, centroids, pad)
        return logits, logits.max() * 1e-12

    return forward


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "power limit unread"
    return f"{torch.cuda.get_device_name(dev)}, {limit}"


def measure_forward(iters: int = 30, device="cuda", batch=BATCH, windows=WINDOWS,
                    points=POINTS, feats=FEATS) -> dict:
    """Steady-state forward throughput and latency, as the JAX bench's
    ``measure_tpu``: one first call (``compile_s``: its seconds, kernel builds
    included), 3 warm calls, then 3 reps each of ``iters`` chained calls
    closed by one read-back (latency) and ``iters`` independent calls closed
    by reading the last (throughput: one stream runs them in order)."""
    from ampnet_tpu_torch.core.config import AMPNetConfig
    from ampnet_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    backend = os.environ.get("AMPNET_BACKEND", "xla")
    cfg = AMPNetConfig()
    pts_np, cent_np = forward_inputs(batch, windows, points, feats)
    pts, cent = torch.from_numpy(pts_np).to(dev), torch.from_numpy(cent_np).to(dev)
    pad = torch.zeros((batch, windows), dtype=torch.bool, device=dev)
    forward = make_bench_forward(bench_model(cfg), cfg, backend, dev)
    zero = torch.zeros((), dtype=pts.dtype, device=dev)

    t0 = time.perf_counter()
    float(forward(pts, cent, pad, zero)[1])
    compile_s = time.perf_counter() - t0

    carry = zero
    for _ in range(3):
        carry = forward(pts, cent, pad, carry)[1]
    float(carry)

    lat_reps, thr_reps = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        carry = zero
        for _ in range(iters):
            carry = forward(pts, cent, pad, carry)[1]
        float(carry)
        lat_reps.append((time.perf_counter() - t0) / iters)

        t0 = time.perf_counter()
        outs = [forward(pts, cent, pad, zero)[1] for _ in range(iters)]
        float(outs[-1])
        thr_reps.append((time.perf_counter() - t0) / iters)

    thr_dt = float(np.median(thr_reps))
    lat_dt = float(np.median(lat_reps))
    per_step_windows = batch * windows
    return {
        "windows_per_sec": per_step_windows / thr_dt,
        "points_per_sec": per_step_windows * points / thr_dt,
        "throughput_step_ms": thr_dt * 1e3,
        "latency_step_ms": lat_dt * 1e3,
        "throughput_rep_ms": [round(d * 1e3, 4) for d in thr_reps],
        "latency_rep_ms": [round(d * 1e3, 4) for d in lat_reps],
        "windows_per_sec_reps": [round(per_step_windows / d, 1) for d in thr_reps],
        "compile_s": compile_s,
        "backend": backend,
        "device": device_name(dev),
    }


def measure_train(iters: int = 12, device="cuda", batch=BATCH, windows=WINDOWS,
                  points=POINTS, feats=FEATS) -> dict:
    """Steady-state train-step throughput (augmentation, forward, backward,
    Adam) in float32 and in bfloat16 compute, as the JAX bench's
    ``measure_train``: the state chains from step to step, 1 first call and 2
    warm calls, then ``iters`` timed calls closed by reading the last loss."""
    from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.data.pipeline import to_device_batch
    from ampnet_tpu_torch.train.state import create_train_state
    from ampnet_tpu_torch.train.step import make_step_fns

    dev = resolve_device(device)
    data = to_device_batch(train_inputs(batch, windows, points, feats), dev)
    out = {}
    for name, dtype in (("fp32", None), ("bf16", "bfloat16")):
        cfg = AMPNetConfig(model=ModelConfig(dtype=dtype))
        state = create_train_state(cfg, bench_model(cfg), steps_per_epoch=100, device=dev)
        train_step = make_step_fns(cfg, augment=True)[0]
        t0 = time.perf_counter()
        float(train_step(state, data)["loss"])
        compile_s = time.perf_counter() - t0
        for _ in range(2):
            metrics = train_step(state, data)
        float(metrics["loss"])
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics = train_step(state, data)
        float(metrics["loss"])
        dt = (time.perf_counter() - t0) / iters
        out[name] = {
            "step_ms": dt * 1e3,
            "windows_per_sec": batch * windows / dt,
            "compile_s": compile_s,
            "batch": batch,
        }
        del state, train_step, metrics
    return out


def main(device="cuda") -> int:
    """The bench: stderr detail, then the one stdout line."""
    from ampnet_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)  # before any work: the card unless asked for the CPU
    baseline = get_baseline()
    fwd = measure_forward(device=dev)
    try:
        train = measure_train(device=dev)
    except Exception as e:  # the train detail never breaks the one-line contract
        traceback.print_exc()
        train = {"error": repr(e)}
    value = fwd["windows_per_sec"]
    vs = value / baseline["windows_per_sec"]
    sys.stderr.write(json.dumps({"baseline_cpu_torch": baseline, "train": train,
                                 "forward": fwd}, indent=2) + "\n")
    reps = fwd["windows_per_sec_reps"]
    spread = 100.0 * (max(reps) - min(reps)) / value
    print(json.dumps({
        "metric": "ampnet_inference_throughput",
        "value": round(value, 2),
        "unit": "windows/sec",
        "vs_baseline": round(vs, 2),
        "compile_s": round(fwd["compile_s"], 1),
        "reps_windows_per_sec": reps,
        "rep_spread_pct": round(spread, 1),
    }), flush=True)
    return 0
