"""Per-point local geometric (eigen) features at full density, the port's own
copy of ``ampnet_tpu/preproc/geomfeat.py`` (numpy and scipy only).

Classic ALS covariance eigenfeatures (Weinmann et al. 2015) over each point's
k nearest neighbours, computed before the tiler subsamples a window, so every
surviving point carries a descriptor of the fine structure around it (wires
are linear, tower lattices vertical and scattered, canopy 3-D). Appended to
the canonical 13-column schema as columns 13..18, each bounded to [0, 1].
"""

from __future__ import annotations

import numpy as np

GEOM_FEATURE_NAMES = (
    "linearity", "planarity", "scatter", "verticality", "axis_z", "radius"
)
N_GEOM_FEATURES = len(GEOM_FEATURE_NAMES)


def geometric_features(xyz: np.ndarray, k: int = 24,
                       radius_norm: str = "absolute") -> np.ndarray:
    """Per-point eigenfeatures over the k-NN neighbourhood of ``xyz`` [N, 3],
    METRIC coordinates (metres: neighbourhoods must be isotropic in space).

    Returns [N, 6] float32, each in [0, 1]: linearity (λ1−λ2)/λ1, planarity
    (λ2−λ3)/λ1, scatter λ3/λ1, verticality 1−|n_z| (n the smallest-λ
    eigenvector), axis_z |e1_z| (the principal axis's z) and radius, from
    r_k = the distance to the k-th neighbour: ``"absolute"`` 1/(1+r_k), or
    ``"median"`` 1/(1+r_k/m) with m the cloud's median r_k (invariant to a
    uniform density change). A neighbourhood of coincident points gives
    zeros, not NaN; fewer than 3 points give zeros and radius 1. scipy's
    ``cKDTree`` in float64 and ``np.linalg.eigh``, as in the JAX package."""
    if radius_norm not in ("absolute", "median"):
        raise ValueError(f"radius_norm must be 'absolute' or 'median', "
                         f"got {radius_norm!r}")
    xyz = np.asarray(xyz, np.float64)
    n = xyz.shape[0]
    if n == 0:
        return np.zeros((0, N_GEOM_FEATURES), np.float32)
    kk = int(min(k, n - 1))
    if kk < 2:
        out = np.zeros((n, N_GEOM_FEATURES), np.float32)
        out[:, -1] = 1.0
        return out

    from scipy.spatial import cKDTree

    # +1: the query point comes back as its own first neighbour
    dist, idx = cKDTree(xyz).query(xyz, k=kk + 1)
    nbrs = xyz[idx]  # [N, kk+1, 3]
    d = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nkd,nke->nde", d, d) / (kk + 1)  # [N, 3, 3]
    evals, evecs = np.linalg.eigh(cov)  # ascending: λ3 ≤ λ2 ≤ λ1
    l3, l2, l1 = evals[:, 0], evals[:, 1], evals[:, 2]
    l1s = np.maximum(l1, 1e-12)

    linearity = np.clip((l1 - l2) / l1s, 0.0, 1.0)
    planarity = np.clip((l2 - l3) / l1s, 0.0, 1.0)
    scatter = np.clip(l3 / l1s, 0.0, 1.0)
    verticality = 1.0 - np.abs(evecs[:, 2, 0])  # the normal: smallest-λ eigenvector
    axis_z = np.abs(evecs[:, 2, 2])  # z of the principal axis
    r_k = dist[:, -1]
    if radius_norm == "median":
        r_k = r_k / max(float(np.median(r_k)), 1e-9)
    radius = 1.0 / (1.0 + r_k)

    flat = l1 <= 1e-12  # every neighbour coincident
    for a in (linearity, planarity, scatter, verticality, axis_z):
        a[flat] = 0.0

    return np.stack(
        [linearity, planarity, scatter, verticality, axis_z, radius], axis=1
    ).astype(np.float32)
