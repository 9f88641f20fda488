"""The native (C++) host solver, loaded with ctypes: the port's counterpart of
``ampnet_tpu/native/__init__.py``.

``csrc/balanced_assign.cc`` (the port's own copy of the JAX package's source)
holds the exact min-cost-flow balanced assignment (parity with the
reference's ``KMeansConstrained`` solver), a balanced k-means driver, and
O(N·S) farthest point sampling, naive and grid-pruned. ``g++`` builds it at
first use (``ops/cuda_build.py``).

No fallback: where the library cannot be built or loaded, every entry point
raises with the compiler's message. The JAX wrapper degrades to NumPy
instead, and its NumPy assignment is greedy plus 2-opt, not exact, so a
silent fallback would change the windows without a word. Those NumPy
versions are kept here as the plain versions (``assign_plain``,
``kmeans_plain``): tests and ``chip_smoke.py`` call them by name, the main
path never does. The plain version of the FPS is ``ops/sampling.py``'s.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np


_f32p, _i32p, _i32 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32
_FPS_ARGS = [_f32p, _i32, _i32, _i32, _i32p]
SIGNATURES = {
    "ampnet_balanced_assign": (ctypes.c_int, [_f32p, _i32, _i32, _i32p, _i32p]),
    "ampnet_balanced_kmeans": (ctypes.c_int, [_f32p, _i32, _i32, _i32, _i32p, _i32,
                                              ctypes.c_uint64, _i32p, _f32p]),
    "ampnet_fps": (None, _FPS_ARGS),
    "ampnet_fps_grid": (None, _FPS_ARGS),
}


def load_native() -> ctypes.CDLL:
    """The built solver library, its C signatures declared (built on first
    call; raises with the build's message when it cannot be built)."""
    from ampnet_tpu_torch.ops import cuda_build

    return cuda_build.load("balanced_assign", SIGNATURES)


def native_available() -> bool:
    """Whether the solver library builds and loads here. Nothing in the port
    falls back when it does not: callers of the solver get the error."""
    try:
        load_native()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def balanced_assign(cost: np.ndarray, capacities: np.ndarray) -> np.ndarray:
    """Exact min-cost assignment of N points to k capacitated clusters.
    cost: [N, k] float32; capacities: [k] with sum >= N. Returns [N] int32."""
    cost = np.ascontiguousarray(cost, np.float32)
    caps = np.ascontiguousarray(capacities, np.int32)
    n, k = cost.shape
    lib = load_native()
    out = np.empty(n, np.int32)
    rc = lib.ampnet_balanced_assign(
        _ptr(cost, ctypes.c_float), n, k, _ptr(caps, ctypes.c_int32),
        _ptr(out, ctypes.c_int32),
    )
    if rc != 0:
        raise RuntimeError(f"balanced_assign failed rc={rc}")
    return out


def balanced_kmeans_native(
    points: np.ndarray, k: int, capacities: np.ndarray, iters: int = 10, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd + exact balanced assignment, fully in C++. Returns (assign, centroids)."""
    pts = np.ascontiguousarray(points, np.float32)
    caps = np.ascontiguousarray(capacities, np.int32)
    n, d = pts.shape
    lib = load_native()
    assign = np.empty(n, np.int32)
    cents = np.empty((k, d), np.float32)
    rc = lib.ampnet_balanced_kmeans(
        _ptr(pts, ctypes.c_float), n, d, k, _ptr(caps, ctypes.c_int32), iters,
        seed, _ptr(assign, ctypes.c_int32), _ptr(cents, ctypes.c_float),
    )
    if rc != 0:
        raise RuntimeError(f"balanced_kmeans failed rc={rc}")
    return assign, cents


def mcf_balanced_assign(points: np.ndarray, k: int, size: int, seed: int = 0) -> np.ndarray:
    """Tiling entry point used by preproc/tiling.py: equal clusters of ``size``."""
    caps = np.full(k, size, np.int32)
    assign, _ = balanced_kmeans_native(points, k, caps, iters=10, seed=seed)
    return assign


def fps_native(points: np.ndarray, n_samples: int, method: str = "auto") -> np.ndarray:
    """Farthest-point-sampling indices (reference utils/utils.py:889-933 semantics).

    ``method``: 'naive' = O(N·S) scan; 'grid' = bbox-pruned bucketed scan with
    bit-identical results (FlashFPS-style pruning, PAPERS.md); 'auto' picks 'grid'
    for large offline tiles where pruning pays for its bucketing."""
    if method not in ("auto", "naive", "grid"):
        raise ValueError(f"unknown fps method {method!r} (auto | naive | grid)")
    pts = np.ascontiguousarray(points, np.float32)
    n, d = pts.shape
    lib = load_native()
    out = np.empty(n_samples, np.int32)
    if method == "auto":
        method = "grid" if n >= 16384 else "naive"
    fn = lib.ampnet_fps_grid if method == "grid" else lib.ampnet_fps
    fn(_ptr(pts, ctypes.c_float), n, d, n_samples, _ptr(out, ctypes.c_int32))
    return out


# ------------------- plain versions (NumPy), called by name -------------------


def assign_plain(cost: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """Greedy regret-ordered feasible assignment + pairwise-swap refinement
    (near-optimal, not exact): the JAX package's ``_assign_fallback``."""
    n, k = cost.shape
    if k == 1:  # np.partition(cost, 1) needs >= 2 columns; k=1 is trivial
        return np.zeros(n, np.int32)
    order = np.argsort(np.partition(cost, 1, axis=1)[:, 1] - cost.min(axis=1))[::-1]
    load = np.zeros(k, np.int64)
    assign = np.full(n, -1, np.int32)
    for i in order:
        for c in np.argsort(cost[i]):
            if load[c] < caps[c]:
                assign[i] = c
                load[c] += 1
                break
    for _ in range(20):  # 2-opt refinement
        improved = False
        for c1 in range(k):
            for c2 in range(c1 + 1, k):
                i1 = np.flatnonzero(assign == c1)
                i2 = np.flatnonzero(assign == c2)
                if not len(i1) or not len(i2):
                    continue
                gain1 = cost[i1, c2] - cost[i1, c1]
                gain2 = cost[i2, c1] - cost[i2, c2]
                a, b = np.argmin(gain1), np.argmin(gain2)
                if gain1[a] + gain2[b] < -1e-9:
                    assign[i1[a]], assign[i2[b]] = c2, c1
                    improved = True
        if not improved:
            break
    return assign


def kmeans_plain(pts, k, caps, iters, seed):
    """Lloyd iterations over ``assign_plain``, started from the first k of
    ``default_rng(seed).permutation``: the JAX package's ``_kmeans_fallback``."""
    rng = np.random.default_rng(seed)
    cents = pts[rng.permutation(len(pts))[:k]].copy()
    assign = None
    for _ in range(iters):
        cost = ((pts[:, None, :] - cents[None]) ** 2).sum(-1).astype(np.float32)
        assign = assign_plain(cost, caps)
        for c in range(k):
            m = assign == c
            if m.any():
                cents[c] = pts[m].mean(axis=0)
    return assign, cents
