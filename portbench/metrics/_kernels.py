"""Shared by the kernel readers: a kernel's share of its roofline in a
traced stretch of forwards (Σ bound / Σ device time of its operations), and
the name pattern a kernel's reader file holds."""

import glob
import importlib.util
import os

from portbench import counts


def pattern(reader: str) -> str:
    """``PATTERN`` of ``portbench/metrics/<reader>.py``."""
    path = os.path.join(os.path.dirname(__file__), f"{reader}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_pattern_{reader}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PATTERN


def all_patterns() -> list:
    """``PATTERN`` of every kernel reader, ``metrics/*_roofline.py``."""
    here = os.path.dirname(__file__)
    return [pattern(os.path.basename(p)[: -len(".py")])
            for p in sorted(glob.glob(os.path.join(here, "*_roofline.py")))]


def roofline(layers, kernel: str, pattern_: str, int8: bool):
    trace, calls = layers.get("trace"), layers.get("trace_calls")
    chains = (layers.get("chains") or {}).get(kernel)
    if trace is None or not calls or not chains:
        return None
    seconds = trace.device_s(pattern_)
    if seconds <= 0:
        return None
    bound = calls * counts.kernel_bound_s(layers["m"], layers["n"], chains, int8=int8)
    return 100.0 * bound / seconds
