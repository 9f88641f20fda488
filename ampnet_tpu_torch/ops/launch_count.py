"""Launch counters of the hand-written kernels.

Each kernel wrapper (``fused_mlp_chain``, ``quantized_mlp_chain``,
``sinkhorn_iterations``, ``batched_farthest_point_sampling``,
``device_stamp``) keeps a ``launches`` attribute, which ``cuda_build.launch``
counts on at each launch of its kernel, so a run can show that its main path
went through the kernel.

A launch made while this thread captures a CUDA graph goes into the graph,
not to the device. Inside ``recording()`` it is recorded instead of counted,
and the graph's owner calls ``add_launches`` with the record on every replay,
which is when the device runs those kernels. A counter so keeps meaning
"device launches", whether a bucket forward ran eagerly or from its graph.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

# launches come from the serving worker and the dispatch pool's threads
_lock = threading.Lock()
_local = threading.local()


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: counted, or recorded while this
    thread is inside ``recording()``."""
    recorded = getattr(_local, "recorded", None)
    if recorded is not None:
        recorded[wrapper] = recorded.get(wrapper, 0) + 1
        return
    with _lock:
        wrapper.launches += 1


@contextlib.contextmanager
def recording():
    """Yields a dict {wrapper: launches} that collects this thread's launches
    inside the block; other threads go on counting theirs."""
    recorded: Dict[object, int] = {}
    _local.recorded = recorded
    try:
        yield recorded
    finally:
        _local.recorded = None


def add_launches(recorded: Dict[object, int]) -> None:
    """Adds a record of ``recording()`` to the counters (a graph replay)."""
    with _lock:
        for wrapper, n in recorded.items():
            wrapper.launches += n
