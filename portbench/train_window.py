"""The timed window of the whole-cloud training driver (``train_cloud``):
epochs of ``train_epoch`` back to back until the window closes on a device
sync, a traced stretch inside it, and the ``layers`` its readers take.

The window is ``train_epoch.py``'s: it opens after the first three steps,
runs ``steps_per_call`` steps a call, starts the profiler's warm-up step at
``trace_at_step`` and traces the next ``trace_steps`` steps, and closes on
the first call that ends after ``seconds`` (and after the traced stretch)."""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch

from portbench import program
from portbench.trace import Profiler

SPLIT = {"backward": ["autograd::engine::evaluate_function"], "optimizer": ["Optimizer.step"]}


def run_window(r, w: dict, run_calls: Callable, rows: Callable, device) -> dict:
    """Opens the window (``r.window_opens()``) and runs ``run_calls(idxs,
    pads)`` over epoch rows ``rows(epoch) -> (idxs [S, B], pads [S, B])``,
    from row 3 of epoch 0 (the first three steps are the checks'), until it
    closes. Returns {steps, window_s, peak_bytes, prof, traced}, the peak
    over the window."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    idxs, pads = rows(0)
    chunk, row, epoch, steps = w["steps_per_call"], 3, 0, 0
    prof, traced, warm_until, traced_from = None, None, None, None
    r.window_opens()
    t0 = time.perf_counter()
    while True:
        if row >= len(idxs):
            epoch += 1
            idxs, pads = rows(epoch)
            row = 0
        n = min(chunk, len(idxs) - row)
        if r.trace and prof is None and steps >= w["trace_at_step"]:
            prof = Profiler()
            prof.start()
            warm_until = steps + n
        run_calls(idxs[row:row + n], pads[row:row + n])
        row, steps = row + n, steps + n
        if prof is not None and traced is None:
            if steps == warm_until:
                prof.step()
                traced_from = steps
            elif steps >= traced_from + w["trace_steps"]:
                prof.stop()
                traced = steps - traced_from
        if time.perf_counter() - t0 >= r.seconds and (not r.trace or bool(traced)):
            break
    program.sync(device)
    return {"steps": steps, "window_s": time.perf_counter() - t0,
            "peak_bytes": program.peak_bytes(device), "prof": prof, "traced": traced}


def seen_ranges(trace, ranges: Dict[str, Sequence[str]]) -> Dict[str, float]:
    """Device seconds launched inside each named host range
    (``Trace.split_by_host_range``), for the ranges the trace holds at
    least once: a program without a range gives no entry, not 0."""
    held = {o.name for o in trace.host}
    present = {k: v for k, v in ranges.items() if any(n in held for n in v)}
    if not present:
        return {}
    split = trace.split_by_host_range(present, default="_rest")
    return {k: split[k] for k in present}


def window_out(win: dict, e2e: Dict[str, float], peak_setup: int, least_s: float,
               ranges: Optional[Dict[str, Sequence[str]]] = None) -> dict:
    """The driver's result from a window: end-to-end metrics, the peak, and
    with a trace the ``layers`` of the training readers (``split``,
    ``trace_steps``, ``trace_model_least_s`` from one step's least time
    ``least_s``, ``peak_bytes``), the device ms under each of ``ranges``
    (``ranges``) and the breakdown."""
    layers = {"steps": win["steps"], "window_s": win["window_s"],
              "peak_bytes": win["peak_bytes"]}
    out = {"e2e": e2e, "attempted": win["steps"], "failed": 0,
           "memory_peak_bytes": max(peak_setup, win["peak_bytes"]), "layers": layers}
    prof, traced = win["prof"], win["traced"]
    if prof is not None:
        trace = prof.trace
        split = trace.split_by_host_range(SPLIT, default="forward")
        layers.update(trace=trace, trace_window_s=prof.window_s, trace_steps=traced,
                      split=split, trace_model_least_s=least_s * traced,
                      ranges=seen_ranges(trace, ranges or {}))
        phases = [[f"phase:{k}", v] for k, v in split.items()]
        phases += [[f"range:{k}", v] for k, v in layers["ranges"].items()]
        out.update(busy_s=trace.busy_s(), window_s=prof.window_s,
                   breakdown={"device_ops": phases + trace.top_ops(max(0, 10 - len(phases))),
                              "idle_gaps": trace.idle_gaps(10)})
    return out
