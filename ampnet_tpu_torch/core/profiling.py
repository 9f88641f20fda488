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
  used).
"""

from __future__ import annotations

import contextlib
import json
import os
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
