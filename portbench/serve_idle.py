"""The serving cell's idle time by the server's own spans: one run of
``att_fp32.serve_c4`` through ``portbench/run.py`` with the server's span
recorder (``ServingStats``, a ``SpanRecorder`` of
``ampnet_tpu_torch/core/profiling.py``) recording raw spans, and what they
say about the card.

    python3 -m portbench.serve_idle --seed N [--seconds S] \\
        [--recorder traced|window|off] [--out DIR]

``--seconds`` defaults to ``BENCHMARK.json``'s ``run_seconds``.

``traced`` (the default): a ``--trace 1`` run with the recorder on from the
profiler's start to the run's end (the driver gives the server fresh
counters a second after the profiler stops, so the recorder then takes only
the groups still open at the stretch's end, which cover its tail). The
tool's line gives the traced stretch's
idle seconds by the finest span open in each (each idle second given once,
to the first name of ``FINEST_FIRST`` whose span covers it; ``no span`` for
the rest), the idle seconds inside some span, ``batch.dispatch``'s share of
the stretch idle (what a reader of the raw spans would give as
``serve.idle_in_dispatch_share``), the ``graph.replay`` spans inside the
stretch that hold a ``cudaGraphLaunch`` by time and on the span's own
thread, and the stamp kernels' share of the busy time. ``window``: a
``--trace 0`` run with raw recording on for the whole window, whose
``points_per_s`` beside an ``off`` run's (``--trace 0`` as the driver makes
it) is the recorder's cost.

The harness's own JSON line comes first, the tool's ``{"serve_idle": ...}``
line last; ``--out DIR`` also writes the tool's line and the raw records to
``DIR/serve_idle_<recorder>_<seed>.json``. The driver
(``portbench/drivers/serve_http.py``) is not edited: its ``Profiler`` and
the server ``make_server`` builds are wrapped while the run lasts. A program
whose server keeps no recorder runs as it is, and its line holds no split.
Nothing here imports torch when the module is imported: the clients'
process, which must not load it, imports the main module again.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from portbench import run as R

CELL = "att_fp32.serve_c4"
# the serving path's spans, finest first (PERF.md §3): an idle second goes to
# the first whose span covers it
FINEST_FIRST = (
    "graph.lock_wait", "graph.replay", "graph.capture", "dispatch.pad", "dispatch.encode",
    "dispatch.init", "dispatch.pin", "dispatch.launch", "batch.dispatch", "batch.fetch_wait",
    "batch.unpack", "batch.fetch_queue", "batch.drain", "http.read", "http.decode",
    "http.encode", "http.write", "batch.queue", "service.predict", "http.request", "batch.exec")

Intervals = List[Tuple[float, float]]


def merged(spans: Sequence[Tuple[float, float]]) -> Intervals:
    """The union of ``spans`` (any order) as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_s(intervals: Intervals, spans) -> float:
    """Seconds of ``intervals`` (sorted, disjoint) that ``spans`` cover."""
    cover, total, j = merged(spans), 0.0, 0
    for a, b in intervals:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            total += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return total


def minus(intervals: Intervals, spans) -> Intervals:
    """``intervals`` (sorted, disjoint) less what ``spans`` cover."""
    cover, out = merged(spans), []
    for a, b in intervals:
        at = a
        for s, e in cover:
            if e <= at or s >= b:
                continue
            if s > at:
                out.append((at, s))
            at = max(at, e)
            if at >= b:
                break
        if at < b:
            out.append((at, b))
    return out


def idle_intervals(trace) -> Intervals:
    """The traced stretch less the device's busy intervals."""
    out, at = [], trace.t0
    for a, b in trace.busy_intervals():
        if a > at:
            out.append((at, a))
        at = b
    if trace.t1 > at:
        out.append((at, trace.t1))
    return out


def host_spans(records: List[dict]) -> Dict[str, Intervals]:
    """The raw records on the host's clock, in seconds, by span name."""
    by: Dict[str, Intervals] = {}
    for r in records:
        if r.get("clock") != "device":
            by.setdefault(r["name"], []).append((r["start_ns"] * 1e-9, r["end_ns"] * 1e-9))
    return by


def dispatch_idle_share(trace, records: List[dict], window_s: float) -> float:
    """% of a ``window_s`` stretch in which no device operation ran while
    the serving worker was inside ``batch.dispatch``."""
    return 100.0 * overlap_s(idle_intervals(trace), host_spans(records).get(
        "batch.dispatch", [])) / window_s


def split(trace, records: List[dict], window_s: float,
          launches: Optional[List[Tuple[int, int, int]]] = None,
          idents: Optional[Dict[int, int]] = None) -> dict:
    """What a traced stretch's raw records say about its idle time (module
    docstring). ``launches``: CUPTI's ``cudaGraphLaunch`` records as
    (``device_resource_id``, start ns, end ns), where CUPTI names a thread
    the profiler does not record by its pthread id cut to 32 bits;
    ``idents``: native thread id → ``threading`` ident, to match them."""
    by = host_spans(records)
    idle = idle_intervals(trace)
    out = {"stretch_s": [trace.t0, trace.t1], "window_s": window_s, "busy_s": trace.busy_s(),
           "idle_s": sum(b - a for a, b in idle),
           "idle_in_some_span_s": overlap_s(idle, [iv for v in by.values() for iv in v]),
           "dispatch_idle_share": dispatch_idle_share(trace, records, window_s)}
    rest, finest = idle, {}
    for name in FINEST_FIRST:
        if name in by:
            finest[name] = overlap_s(rest, by[name])
            rest = minus(rest, by[name])
    finest["no span"] = sum(b - a for a, b in rest)
    out["idle_s_by_finest_span"] = dict(sorted(finest.items(), key=lambda kv: -kv[1]))
    graph_launches = [o for o in trace.host if o.name == "cudaGraphLaunch"]
    replays = [r for r in records if r["name"] == "graph.replay"
               and trace.t0 <= r["start_ns"] * 1e-9 and r["end_ns"] * 1e-9 <= trace.t1]
    held = same = 0
    for r in replays:
        a, b = r["start_ns"] * 1e-9, r["end_ns"] * 1e-9
        held += any(a <= o.start and o.end <= b for o in graph_launches)
        ident = (idents or {}).get(r["thread"])
        same += ident is not None and any(
            tid & 0xFFFFFFFF == ident & 0xFFFFFFFF and r["start_ns"] <= s and e <= r["end_ns"]
            for tid, s, e in launches or [])
    out["graph_replays"] = {"in_stretch": len(replays), "holding_a_launch": held,
                            "holding_one_of_their_thread": same}
    stamp_s = trace.device_s("device_stamp")
    out["stamp_kernels_s"] = stamp_s
    out["stamp_share_of_busy"] = 100.0 * stamp_s / out["busy_s"] if out["busy_s"] else None
    return out


def run(seed: int, seconds: float, recorder: str = "traced", out_dir: Optional[str] = None,
        files: Optional[dict] = None, device: str = "cuda", require_chip: bool = True) -> int:
    """One run of the serving cell (module docstring); its exit code. The
    tests pass small ``files`` with ``device='cpu'``."""
    import ampnet_tpu_torch.cli.main as cli
    from portbench.trace import Profiler

    state: dict = {"stats": None, "launches": [], "idents": {}, "profiler": None}
    make, load = cli.make_server, R.load_module

    def make_server(args):
        server = make(args)
        stats = server.service.stats
        if recorder == "window" and hasattr(stats, "start"):
            class Recording(type(stats)):  # the driver's fresh counters record too
                def __init__(self):
                    super().__init__()
                    self.start()

            server.service.stats = Recording()
        state["server"] = server
        return server

    class SpanProfiler(Profiler):
        def start(self) -> None:
            super().start()
            ready = self._prof.on_trace_ready

            def keep(p):
                state["launches"] = [
                    (e.device_resource_id(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in p.profiler.kineto_results.events() if e.name() == "cudaGraphLaunch"]
                ready(p)

            self._prof.on_trace_ready = keep
            state["stats"] = state["server"].service.stats
            getattr(state["stats"], "start", lambda: None)()

        def stop(self) -> None:
            super().stop()
            state["idents"] = {t.native_id: t.ident for t in threading.enumerate()}
            state["profiler"] = self

    def load_module(path, name):
        mod = load(path, name)
        if name.startswith("portbench_driver_"):
            mod.Profiler = SpanProfiler
        return mod

    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", "1" if recorder == "traced" else "0"]
    cli.make_server, R.load_module = make_server, load_module
    try:
        rc = R.main(argv, require_chip=require_chip, files=files, device=device)
    finally:
        cli.make_server, R.load_module = make, load
    line = {"recorder": recorder, "seed": seed, "rc": rc}
    prof = state["profiler"]
    records = getattr(state["stats"], "stop", lambda: None)()
    if prof is not None and records is not None:
        line.update(split(prof.trace, records, prof.window_s, state["launches"],
                          state["idents"]), records=len(records))
    elif recorder == "traced":
        line["split"] = "none: the server keeps no span recorder"
    print(json.dumps({"serve_idle": line}), flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"serve_idle_{recorder}_{seed}.json"), "w") as f:
            json.dump({"serve_idle": line, "records": records or []}, f)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--recorder", choices=("traced", "window", "off"), default="traced")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    seconds = a.seconds or R.read_json(os.path.join(R.ROOT, "BENCHMARK.json"))["run_seconds"]
    return run(a.seed, seconds, a.recorder, a.out)


if __name__ == "__main__":
    sys.exit(main())
