"""Forward (``models/backends.py``, the served backend): device ms of one
cloud's forward at [1, 18, 4096, 9], captured in a CUDA graph of its own and
timed over replays with CUDA events, after the window."""


def read(layers):
    return layers.get("forward_ms")
