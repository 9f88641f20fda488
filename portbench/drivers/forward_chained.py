"""Driver of the pre-tiled forward cells: the backend's forward
(``models/backends.py::make_forward``) on windows [B, W, N, 9], each call's
input depending on the last call's output (``points + carry``, then
``carry = max(logits) · 1e-12``), for the window's seconds; the window
closes on a device sync.

Set-up draws ``inputs`` distinct batches from the seed, builds the model
from the seed's weights and warms the forward (its shapes are the cell's
only ones). Correctness: once the window has closed, calls drawn from the
seed (among the first ``seconds · min_calls_per_s``, plus the last) are
computed again by the plain reference on the same inputs and compared by
the relative RMS of their logits' difference, the worst call."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import counts, inputs, program
from portbench.reference import ampnet as ref
from portbench.trace import Profiler

CHAINS_BY_BACKEND = {  # which of the encoder's chains each kernel runs
    "fused": {"fused_mlp_chain": ("input_tnet", "mlp_a", "feature_tnet", "mlp_b"),
              "quantized_mlp_chain": ()},
    "int8": {"fused_mlp_chain": ("input_tnet", "feature_tnet"),
             "quantized_mlp_chain": ("mlp_a", "mlp_b")},
}


def run(r) -> dict:
    from ampnet_tpu_torch.models.backends import make_forward

    w, m, dev = r.workload, r.config["model"], r.device
    b, nw, npts = w["batch"], m["windows"], m["n_points"]
    backend = r.config["backend"]
    weights = ref.make_weights(r.seed, dev, m["global_feat"], m["num_classes"])
    cfg, model = program.port_model(weights, r.config, dev)
    fwd = make_forward(model, cfg, backend, dev)
    bases, cents = [], []
    for i in range(w["inputs"]):
        p, c = inputs.windows(r.seed, 100 + i, b, nw, npts, dev)
        bases.append(p)
        cents.append(c)
    pad = torch.zeros((b, nw), dtype=torch.bool, device=dev)
    zero = torch.zeros((), device=dev)

    def call(i, carry):
        logits = fwd(bases[i % len(bases)] + carry, cents[i % len(cents)], pad)
        return logits, logits.max() * 1e-12

    carry = zero
    for i in range(w["warm_calls"]):
        _, carry = call(i, carry)
    program.sync(dev)

    rng = np.random.default_rng((r.seed, 23))
    floor = max(2, int(r.seconds * w["min_calls_per_s"]))
    keep = set(rng.choice(floor, size=min(w["check_calls"], floor), replace=False).tolist())
    kept, prof, traced = {}, None, None
    start_at, step_at = w["trace_at_call"], w["trace_at_call"] + w["trace_warm_calls"]
    stop_at = step_at + w["trace_calls"]
    r.window_opens()
    t0 = time.perf_counter()
    carry, calls = zero, 0
    while True:
        if r.trace and calls == start_at:
            prof = Profiler()
            prof.start()
        if prof is not None and calls == step_at:
            prof.step()
        logits, nxt = call(calls, carry)
        last = (carry, logits)
        if calls in keep:
            kept[calls] = last
        calls += 1
        if prof is not None and calls == stop_at:
            prof.stop()
            traced = w["trace_calls"]
        carry = nxt
        if time.perf_counter() - t0 >= r.seconds and (not r.trace or traced):
            break
    program.sync(dev)
    elapsed = time.perf_counter() - t0
    kept[calls - 1] = last
    peak = program.peak_bytes(dev)
    windows_done = calls * b * nw

    quantized = CHAINS_BY_BACKEND[backend]["quantized_mlp_chain"]
    least = counts.least_time_s(counts.model_ops(nw, npts, m["num_classes"], m["global_feat"],
                                                 m["att_heads"], clouds=b, quantized=quantized))
    layers = {"calls": calls, "window_s": elapsed, "backend": backend, "chains": CHAINS_BY_BACKEND[backend],
              "m": b * nw, "n": npts}
    out = {"e2e": {"windows_per_s": windows_done / elapsed}, "attempted": calls, "failed": 0,
           "memory_peak_bytes": peak, "layers": layers}
    if prof is not None:
        layers.update(trace=prof.trace, trace_window_s=prof.window_s, trace_calls=traced,
                      trace_model_least_s=least * traced)
        out.update(busy_s=prof.trace.busy_s(), window_s=prof.window_s,
                   breakdown={"device_ops": prof.trace.top_ops(10),
                              "idle_gaps": prof.trace.idle_gaps(10)})

    del fwd, model
    program.release(dev)
    bits = 8 if quantized else 0
    worst = 0.0
    for i, (c_in, logits) in sorted(kept.items()):
        x = bases[i % len(bases)] + c_in
        want = ref.eval_logits(x, cents[i % len(cents)], pad, weights, quant_bits=bits)
        worst = max(worst, rel_rms(logits, want))
    out["checks"] = {"logit_rel_rms": {"value": worst, "limit": w["limits"]["logit_rel_rms"]}}
    return out


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    """RMS of the difference over the RMS of ``want``."""
    d = (got.double() - want.double()).square().mean().sqrt()
    return float(d / want.double().square().mean().sqrt().clamp_min(1e-30))


def control(seed: int, files: dict, device, faults: bool = False) -> dict:
    """The control of ``logit_rel_rms`` on one batch of the cell's inputs:
    the reference with TF32 products (a float32 configuration) or with
    4-bit chains (the int8 one) put in the program's place."""
    w, m = files["workload"], files["config"]["model"]
    weights = ref.make_weights(seed, device, m["global_feat"], m["num_classes"])
    x, cent = inputs.windows(seed, 100, w["batch"], m["windows"], m["n_points"], device)
    pad = torch.zeros(x.shape[:2], dtype=torch.bool, device=device)
    if files["config"]["backend"] == "int8":
        want = ref.eval_logits(x, cent, pad, weights, quant_bits=8)
        got = ref.eval_logits(x, cent, pad, weights, quant_bits=4)
    else:
        want = ref.eval_logits(x, cent, pad, weights)
        got = ref.eval_logits(x, cent, pad, weights, ref.Precision("tf32"))
    return {"control": {"logit_rel_rms": rel_rms(got, want)}}
