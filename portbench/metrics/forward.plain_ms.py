"""Forward outside the hand-written kernels (``models/backends.py``: the
folded T-Net heads, transforms, attention and head, the concatenation and
elementwise passes): device ms a forward of every operation that no
kernel reader's pattern (``metrics/*_roofline.py``) selects, from a traced
stretch of forwards."""

import re

from portbench.metrics import _kernels


def read(layers):
    trace, calls = layers.get("trace"), layers.get("trace_calls")
    if trace is None or not calls or not trace.device:
        return None
    kernels = re.compile("|".join(f"(?:{p})" for p in _kernels.all_patterns()))
    plain = sum(o.end - o.start for o in trace.device if not kernels.search(o.name))
    return plain / calls * 1e3
