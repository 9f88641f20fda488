"""Timestamps of the device's clock, taken in stream order.

``device_stamp(out, i)`` writes a nanosecond reading into ``out[i]`` (an int64
tensor) once all the work enqueued before it has ended. On a CUDA tensor it
launches ``csrc/device_stamp.cu``, one thread that reads ``%globaltimer``, on
the current stream, so a CUDA graph that captures it stamps every replay. On
a CPU tensor it reads ``time.perf_counter_ns()``: the CPU runs the work before
it synchronously. Two stamps of one device subtract to the device time of
the work between them; stamps of different clocks do not compare.

``device_stamp.launches`` counts kernel launches (``ops/launch_count.py``).
"""

from __future__ import annotations

import ctypes
import time

import torch

from ampnet_tpu_torch.ops import cuda_build

SIGNATURES = {"device_stamp": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p])}


def device_stamp(out: torch.Tensor, i: int) -> None:
    """The device's clock in ns into ``out[i]`` (int64, contiguous), after the
    work enqueued before this call."""
    if out.dtype != torch.int64 or not out.is_contiguous() or not 0 <= i < out.numel():
        raise ValueError(f"device_stamp takes a contiguous int64 tensor and an index into "
                         f"it, got {out.dtype} of {out.numel()} and {i}")
    if out.device.type != "cuda":
        out[i] = time.perf_counter_ns()
        return
    lib = cuda_build.load("device_stamp", SIGNATURES)
    cuda_build.launch(device_stamp, lib.device_stamp, out.device,
                      out.data_ptr() + i * out.element_size())


device_stamp.launches = 0
