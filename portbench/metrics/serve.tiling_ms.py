"""Tiling (``ops/kmeans.py::balanced_kmeans``): device ms of one cloud's
balanced k-means at the bucket's [1, k · cap, 3], k 18, cap 4,096, captured
in a CUDA graph of its own and timed over replays with CUDA events, after
the window."""


def read(layers):
    return layers.get("tiling_ms")
