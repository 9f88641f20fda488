"""Tracing, step timing and energy accounting, counterpart of
``ampnet_tpu/core/profiling.py`` (the reference's wall-clock prints and
optional codecarbon ``@track_emissions``, ``baseline/test_segmentation.py:25``):

* ``trace(logdir)``: a ``torch.profiler`` context over the CPU and, where a
  card is present, CUDA activity, written by
  ``torch.profiler.tensorboard_trace_handler`` as a ``.pt.trace.json``
  (Chrome trace format, readable by TensorBoard's profile plugin and by
  ``chrome://tracing``; writing it needs no tensorboard package);
* ``StepTimer``: per-step wall times whose ``stop(result)`` waits for every
  card that holds a tensor of ``result``, as ``jax.block_until_ready`` does;
* ``EnergyTracker``: codecarbon-style energy and CO₂ from wall time ×
  an assumed power draw per device (``codecarbon`` and ``pynvml`` are not
  used);
* ``SpanRecorder``, ``SpanGroup``, ``Spans``: the program's own spans (name,
  start, end, thread, id, the id of the span that caused it), timed on the
  monotonic clock and exported on the epoch clock that ``torch.profiler``
  stamps its host events with, so they lie over a device trace. The serving
  path records them on every thread it runs (``infer/server.py``), which
  ``torch.profiler`` does not see.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace context writing ``<logdir>/*.pt.trace.json``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


def _cuda_devices(result, found: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of every tensor in ``result`` (tensors, and tuples,
    lists and dicts of them, nested)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            found.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _cuda_devices(v, found)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Per-step wall times with a blocking sync on each boundary."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        for dev in _cuda_devices(result, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self, skip_warmup: int = 1) -> Dict[str, float]:
        if not self.times:  # zero-step (aborted) runs report, not crash
            return {"steps": 0}
        ts = np.asarray(self.times[skip_warmup:] or self.times)
        return {
            "steps": len(self.times),
            "mean_ms": float(ts.mean() * 1e3),
            "median_ms": float(np.median(ts) * 1e3),
            "p95_ms": float(np.percentile(ts, 95) * 1e3),
            "min_ms": float(ts.min() * 1e3),
        }


@dataclass
class EnergyTracker:
    """Estimated energy and CO₂ of a run (codecarbon's output schema).

    ``device_watts`` defaults to 700 W, the power limit ``nvidia-smi``
    reports for the NVIDIA H100 80GB HBM3 the port is measured on (700.00 W):
    an upper bound of the card's draw, not a reading. Pass a measured figure
    for real accounting. ``carbon_intensity`` in kgCO₂/kWh.
    """

    device_watts: float = 700.0
    n_devices: int = 1
    host_watts: float = 40.0
    carbon_intensity: float = 0.4
    _start: float = field(default=0.0, repr=False)
    elapsed_s: float = 0.0

    def __enter__(self) -> "EnergyTracker":
        self._start = time.time()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed_s += time.time() - self._start

    @property
    def energy_kwh(self) -> float:
        watts = self.device_watts * self.n_devices + self.host_watts
        return watts * self.elapsed_s / 3600.0 / 1000.0

    @property
    def emissions_kg(self) -> float:
        return self.energy_kwh * self.carbon_intensity

    def report(self) -> Dict[str, float]:
        return {
            "duration_s": round(self.elapsed_s, 3),
            "energy_kwh": self.energy_kwh,
            "emissions_kgco2": self.emissions_kg,
            "device_watts_assumed": self.device_watts,
            "n_devices": self.n_devices,
        }

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


# span ids, unique in the process: a group may outlive the recorder it was
# started under (the server's counters can be replaced while requests run)
_span_ids = itertools.count(1)


class SpanGroup:
    """The spans of one request or one micro-batch (``kind``), kept by the
    threads that make them and committed to a ``SpanRecorder`` at once, when
    the request or batch is over. ``id`` is the group's id and the parent of
    its top-level spans (a request's root span, ``http.request``, takes it as
    its own id). A span is (name, start ns, end ns, thread, id, parent,
    attributes), times on ``time.perf_counter_ns``; a span with the attribute
    ``clock="device"`` holds a device's own clock instead."""

    __slots__ = ("kind", "id", "spans")

    def __init__(self, kind: str):
        self.kind, self.id, self.spans = kind, next(_span_ids), []

    def add(self, name: str, start_ns: int, end_ns: int, parent: Optional[int] = None,
            span_id: Optional[int] = None, **attrs) -> int:
        """Appends a finished span (list appends hold across threads); returns its id."""
        sid = span_id or next(_span_ids)
        self.spans.append((name, start_ns, end_ns, threading.get_native_id(), sid,
                           self.id if parent is None else parent, attrs))
        return sid


class Spans:
    """Where a stage records its spans: a group and the span they hang
    under. ``NO_SPANS`` (no group) records nothing, for callers that trace
    nothing."""

    __slots__ = ("group", "parent")

    def __init__(self, group: Optional[SpanGroup] = None, parent: Optional[int] = None):
        self.group = group
        self.parent = group.id if parent is None and group is not None else parent

    @property
    def top(self) -> "Spans":
        """The group's top level."""
        return Spans(self.group)

    def add(self, name: str, start_ns: int, end_ns: int, span_id: Optional[int] = None,
            **attrs) -> int:
        if self.group is None:
            return 0
        return self.group.add(name, start_ns, end_ns, self.parent, span_id, **attrs)

    @contextlib.contextmanager
    def span(self, name: str, start_ns: Optional[int] = None, **attrs):
        """A span around the block (from ``start_ns`` when given), named
        ``name``; yields the ``Spans`` of its children."""
        if self.group is None:
            yield self
            return
        sid, t0 = next(_span_ids), start_ns or time.perf_counter_ns()
        try:
            yield Spans(self.group, sid)
        finally:
            self.group.add(name, t0, time.perf_counter_ns(), self.parent, sid, **attrs)


NO_SPANS = Spans()


class SpanRecorder:
    """Committed span groups, always as totals by span name, and as raw
    records between ``start()`` and ``stop()``.

    A warm group (a request or batch that ran no bucket shape for the first
    time and did not fail) adds, for each span name in it, one to the name's
    count and its spans' summed duration to the name's total; other groups
    add to totals of their own, kept out of the summary. While recording,
    each committed span is also appended as a dict: ``name``, ``start_ns`` and
    ``end_ns`` on the epoch clock (``time.time_ns``, which ``torch.profiler``
    stamps host events with: ``perf_counter_ns`` plus the offset read at
    ``start()``; a device-clock span keeps its device's values), ``thread``
    (``threading.get_native_id``), ``id``, ``parent``, the group's kind with
    its id, ``warm`` and the span's attributes. Off, a commit checks one
    field for the records. Nothing is written anywhere."""

    def __init__(self):
        self._lock = threading.Lock()
        self._warm: Dict[str, List[int]] = {}  # name -> [groups, ns]
        self._other: Dict[str, List[int]] = {}
        self._records: Optional[List[dict]] = None
        self._offset_ns = 0

    def start(self) -> None:
        """Records raw spans from now on (earlier records are dropped)."""
        with self._lock:
            self._offset_ns = time.time_ns() - time.perf_counter_ns()
            self._records = []

    def stop(self) -> List[dict]:
        """Stops recording; returns the records committed since ``start()``."""
        with self._lock:
            out, self._records = self._records or [], None
        return out

    def commit(self, group: SpanGroup, warm: bool = True) -> None:
        with self._lock:
            self._commit(group, warm)

    def _commit(self, group: SpanGroup, warm: bool) -> None:
        """``commit`` for a caller that holds ``self._lock``."""
        per: Dict[str, int] = {}
        for name, t0, t1, *_ in group.spans:
            per[name] = per.get(name, 0) + (t1 - t0)
        totals = self._warm if warm else self._other
        for name, ns in per.items():
            entry = totals.setdefault(name, [0, 0])
            entry[0] += 1
            entry[1] += ns
        if self._records is not None:
            for name, t0, t1, thread, sid, parent, attrs in group.spans:
                off = 0 if attrs.get("clock") == "device" else self._offset_ns
                self._records.append({"name": name, "start_ns": t0 + off, "end_ns": t1 + off,
                                      "thread": thread, "id": sid, "parent": parent,
                                      group.kind: group.id, "warm": warm, **attrs})

    def _total_ns(self, name: str) -> int:
        """Summed ns of the spans named ``name`` over every committed group,
        warm or not (the caller holds ``self._lock``)."""
        return sum(t.get(name, (0, 0))[1] for t in (self._warm, self._other))

    def _summary(self) -> Dict[str, dict]:
        """{name: {count, total_s, mean_ms}} over warm groups: ``count`` is the
        groups that hold the name, ``mean_ms`` the mean of a group's summed
        spans of that name (the caller holds ``self._lock``)."""
        return {name: {"count": n, "total_s": round(ns * 1e-9, 6),
                       "mean_ms": round(ns * 1e-6 / n, 4)}
                for name, (n, ns) in sorted(self._warm.items())}
