"""torch.profiler over a steady stretch of a run, reduced to what the
per-layer readers need: device operations with their times, the host-side
ranges that launched them, the device's busy time and its idle gaps.

A trace starts with one warm-up step of the profiler (a trace taken in a
process loses its first kernel records otherwise) and then records one
active step. Nothing here knows the program: the readers select operations
by name patterns of their own.
"""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclass
class Op:
    name: str
    start: float  # seconds on the trace's clock
    end: float
    corr: int = 0  # device op: the correlation id of the host call that launched it
    thread: int = 0  # host op: its thread


@dataclass
class Trace:
    """One active profiler step: device ops, host ops, the step's span."""

    device: List[Op] = field(default_factory=list)
    host: List[Op] = field(default_factory=list)
    launches: Dict[int, Op] = field(default_factory=dict)  # correlation id → runtime call
    t0: float = 0.0
    t1: float = 0.0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device ops' intervals, clipped to the step."""
        spans = sorted((max(o.start, self.t0), min(o.end, self.t1)) for o in self.device)
        merged: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_s(self, pattern: Optional[str] = None) -> float:
        """Summed time of the device ops whose name matches ``pattern``."""
        rx = re.compile(pattern) if pattern else None
        return sum(o.end - o.start for o in self.device if rx is None or rx.search(o.name))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for o in self.device:
            by[o.name] = by.get(o.name, 0.0) + (o.end - o.start)
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time between device ops, summed by the innermost host op
        running when each gap began (the host's work that left it idle)."""
        busy = self.busy_intervals()
        gaps, prev = [], self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        host = sorted(self.host, key=lambda o: o.start)
        starts = [o.start for o in host]
        by: Dict[str, float] = {}
        for a, b in gaps:
            i = bisect.bisect_right(starts, a)
            best = None
            for o in reversed(host[max(0, i - 2000):i]):  # recent ranges that may cover a
                if o.end >= a and (best is None or o.end - o.start < best.end - best.start):
                    best = o
            name = best.name if best is not None else "no host op"
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def split_by_host_range(self, prefixes: Dict[str, Sequence[str]],
                            default: str) -> Dict[str, float]:
        """Device seconds by the host range that launched each op: an op
        whose launching call falls inside a host op named with one of
        ``prefixes[label]`` (on the launching thread) counts for that label,
        the first label that matches; the rest for ``default``."""
        ranges: Dict[str, Dict[int, List[Tuple[float, float]]]] = {}
        for label, pres in prefixes.items():
            per: Dict[int, List[Tuple[float, float]]] = {}
            for o in self.host:
                if o.name.startswith(tuple(pres)):
                    per.setdefault(o.thread, []).append((o.start, o.end))
            for t, iv in per.items():
                iv.sort()
                merged: List[List[float]] = []
                for a, b in iv:
                    if merged and a <= merged[-1][1]:
                        merged[-1][1] = max(merged[-1][1], b)
                    else:
                        merged.append([a, b])
                per[t] = [(a, b) for a, b in merged]
            ranges[label] = per
        out = {label: 0.0 for label in prefixes}
        out[default] = 0.0
        for o in self.device:
            call = self.launches.get(o.corr)
            label = default
            if call is not None:
                for lab, per in ranges.items():
                    iv = per.get(call.thread, [])
                    i = bisect.bisect_right(iv, (call.start, float("inf"))) - 1
                    if i >= 0 and iv[i][0] <= call.start <= iv[i][1]:
                        label = lab
                        break
            out[label] += o.end - o.start
        return out


def _ns(ev, what: str) -> float:
    f = getattr(ev, f"{what}_ns", None)
    return f() * 1e-9 if f is not None else getattr(ev, f"{what}_us")() * 1e-6


def _annotation(ev) -> bool:
    user = getattr(ev, "is_user_annotation", None)
    return bool(user and user()) or ev.name().startswith("ProfilerStep#")


def from_kineto(result) -> Trace:
    """A ``Trace`` of a profiler result's events: device ops (kernels,
    copies, sets) with the correlation id of their launch, host ops with
    their thread; the span is the events' own."""
    from torch.autograd import DeviceType

    trace = Trace()
    lo, hi = float("inf"), float("-inf")
    for ev in result.events():
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        lo, hi = min(lo, start), max(hi, end)
        if ev.device_type() == DeviceType.CUDA:
            if _annotation(ev):  # the profiler's own step range on the device's timeline
                continue
            trace.device.append(Op(ev.name(), start, end, corr=ev.linked_correlation_id()))
        else:
            op = Op(ev.name(), start, end, thread=ev.start_thread_id())
            trace.host.append(op)
            if ev.correlation_id():
                trace.launches[ev.correlation_id()] = op
    trace.t0, trace.t1 = (lo, hi) if lo <= hi else (0.0, 0.0)
    return trace


class Profiler:
    """``start()``, then ``step()`` ends the profiler's warm-up step and
    starts the active one, ``stop()`` ends it: ``self.trace`` holds the
    active step and ``self.window_s`` its length on the host clock, the
    card synchronised at both ends."""

    def __init__(self):
        self.trace: Optional[Trace] = None
        self.window_s = self.t_begin = self.t_end = 0.0
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                             on_trace_ready=lambda p: setattr(
                                 self, "trace", from_kineto(p.profiler.kineto_results)))
        self._prof.start()

    def step(self) -> None:
        _sync()
        self.t_begin = time.perf_counter()
        self._prof.step()

    def stop(self) -> None:
        _sync()
        self.t_end = time.perf_counter()
        self.window_s = self.t_end - self.t_begin
        self._prof.step()
        self._prof.stop()


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def prime_tracer() -> None:
    """A short profiler session with device activity: CUPTI traces the
    kernels of a CUDA graph only when it was tracing once before the graph
    was instantiated."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
