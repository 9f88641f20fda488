"""The port's sequential tiler (``ops/sequential_tiling.py``) and four small
helpers (``ops/kmeans.py::cluster_sizes``, ``ops/augment.py::shuffle_points``,
``core/metrics.py::iou_per_class`` and ``weights_for_samples``) against the
JAX package's on the same inputs; JAX's random draws are injected. CPU only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.metrics import iou_per_class as j_iou_per_class
from ampnet_tpu.core.metrics import weights_for_samples as j_weights_for_samples
from ampnet_tpu.ops.augment import shuffle_points as j_shuffle_points
from ampnet_tpu.ops.kmeans import cluster_sizes as j_cluster_sizes
from ampnet_tpu.ops.sequential_tiling import sequential_tiling as j_sequential_tiling
from ampnet_tpu_torch.core.metrics import iou_per_class, weights_for_samples
from ampnet_tpu_torch.ops.augment import shuffle_points
from ampnet_tpu_torch.ops.kmeans import cluster_sizes
from ampnet_tpu_torch.ops.sequential_tiling import sequential_tiling, sequential_tiling_from


def make(b=2, n=100, f=4, n_pad=0, seed=0):
    """tests/test_sequential_tiling.py's clouds: the last ``n_pad`` slots
    zero with target −1; ``n_pad`` may differ per cloud."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, f)).astype(np.float32)
    tgt = rng.integers(0, 5, size=(b, n)).astype(np.int32)
    for i, p in enumerate(np.broadcast_to(n_pad, (b,))):
        if p:
            pts[i, -p:] = 0
            tgt[i, -p:] = -1
    return pts, tgt


CASES = [dict(n=96), dict(n=100), dict(n=96, n_pad=40), dict(b=3, n=130, f=9, n_pad=(0, 5, 129))]


@pytest.mark.parametrize("case", CASES)
def test_zero_fill_equals_jax(case):
    pts, tgt = make(**case)
    jp, jt = j_sequential_tiling(jnp.asarray(pts), jnp.asarray(tgt), 32, fill="zero")
    p, t = sequential_tiling(torch.from_numpy(pts), torch.from_numpy(tgt), 32, fill="zero")
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


@pytest.mark.parametrize("case", CASES)
def test_duplicate_fill_equals_jax_from_its_draw(case):
    """JAX's ``randint(key, (b, m), 0, n)`` given to the gather: every window
    and target equal."""
    pts, tgt = make(**case)
    key = jax.random.PRNGKey(1)
    jp, jt = j_sequential_tiling(jnp.asarray(pts), jnp.asarray(tgt), 32, key=key)
    b, n, _ = pts.shape
    rand = np.array(jax.random.randint(key, (b, (n // 32) * 32), 0, n))
    p, t = sequential_tiling_from(torch.from_numpy(pts), torch.from_numpy(tgt), 32,
                                  "duplicate", torch.from_numpy(rand))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


def test_duplicate_fill_from_a_generator():
    """The port's own draw: seeded, on the input's device, every padded slot
    a real point of its cloud."""
    pts, tgt = make(n=96, n_pad=40)
    p, t = sequential_tiling(torch.from_numpy(pts), torch.from_numpy(tgt), 32)
    again, _ = sequential_tiling(torch.from_numpy(pts), torch.from_numpy(tgt), 32,
                                 generator=torch.Generator().manual_seed(0))
    assert torch.equal(p, again) and p.shape == (2, 3, 32, 4)
    assert (t != -1).all()
    flat = p.numpy().reshape(2, 96, 4)
    for b in range(2):
        np.testing.assert_array_equal(flat[b, :56], pts[b, :56])
        assert all((np.abs(pts[b, :56] - flat[b, i]).sum(axis=1) == 0).any()
                   for i in range(56, 96))


def test_errors_equal_jax():
    pts, tgt = make(n=10)
    for fill in ("duplicate", "zero", "bogus"):  # too small first, as in JAX
        with pytest.raises(ValueError, match="smaller than one 32 window"):
            j_sequential_tiling(jnp.asarray(pts), jnp.asarray(tgt), 32, fill=fill)
        with pytest.raises(ValueError, match="smaller than one 32 window"):
            sequential_tiling(torch.from_numpy(pts), torch.from_numpy(tgt), 32, fill=fill)
    pts, tgt = make(n=64)
    with pytest.raises(ValueError, match="unknown fill 'bogus'"):
        j_sequential_tiling(jnp.asarray(pts), jnp.asarray(tgt), 32, fill="bogus")
    with pytest.raises(ValueError, match="unknown fill 'bogus'"):
        sequential_tiling(torch.from_numpy(pts), torch.from_numpy(tgt), 32, fill="bogus")


# -- helpers ------------------------------------------------------------------------


@pytest.mark.parametrize("assign", [[0, 1, 1, -1, 3, 2, 2, 2], [[0, 1, 4], [1, -1, 1]], [[]]])
def test_cluster_sizes_equal_jax(assign):
    a = np.asarray(assign, dtype=np.int32)
    got = cluster_sizes(torch.from_numpy(a), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_cluster_sizes(jnp.asarray(a), 3)))


@pytest.mark.parametrize("shape", [(50, 4), (2, 3, 17, 9)])
def test_shuffle_points_equals_jax_from_its_permutation(shape, rng):
    pts = rng.normal(size=shape).astype(np.float32)
    labels = rng.integers(0, 5, size=shape[:-1]).astype(np.int32)
    key = jax.random.PRNGKey(3)
    jp, jl = j_shuffle_points(jnp.asarray(pts), jnp.asarray(labels), key)
    perm = np.array(jax.random.permutation(key, shape[-2]))
    p, l = shuffle_points(torch.from_numpy(pts), torch.from_numpy(labels), perm=perm)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    # the port's own draw: one permutation shared by points and labels
    p, l = shuffle_points(torch.from_numpy(pts), torch.from_numpy(labels),
                          generator=torch.Generator().manual_seed(0))
    order = torch.randperm(shape[-2], generator=torch.Generator().manual_seed(0))
    assert torch.equal(p, torch.from_numpy(pts)[..., order, :])
    assert torch.equal(l, torch.from_numpy(labels)[..., order])


@pytest.mark.parametrize("masked", [False, True])
def test_iou_per_class_equals_jax(masked, rng):
    preds = rng.integers(0, 5, size=(4, 300)).astype(np.int32)
    targets = rng.integers(-1, 5, size=(4, 300)).astype(np.int32)
    mask = (rng.uniform(size=(4, 300)) < 0.8) & (targets >= 0) if masked else None
    jiou, jvalid = j_iou_per_class(jnp.asarray(preds), jnp.asarray(targets), 5,
                                   None if mask is None else jnp.asarray(mask))
    iou, valid = iou_per_class(torch.from_numpy(preds), torch.from_numpy(targets), 5,
                               None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), rtol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_weights_for_samples_equals_jax():
    weights = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    labels = np.asarray([[0, 3, 1], [-1, 2, -4], [4, -5, 2]], np.int32)  # JAX's take: wrap, NaN
    got = weights_for_samples(torch.from_numpy(weights), torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_weights_for_samples(jnp.asarray(weights), jnp.asarray(labels))))
    assert got.shape == (9,) and np.isnan(got.numpy()).sum() == 2
