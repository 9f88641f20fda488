"""The port's balanced k-means and TiledInferencer against the JAX package.

torch's generators give other bits than jax.random, so the k-means tests feed
the JAX permutation through ``init_idx``; k=1 clouds (n < 2·n_points) need no
k-means and get identical replicate padding in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import DataConfig as JDataConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.infer.tiled import TiledInferencer as JTiled
from ampnet_tpu.models.amp import AMPNetSegmenter as JSegmenter
from ampnet_tpu.ops.kmeans import balanced_kmeans as j_balanced_kmeans
from ampnet_tpu.ops.kmeans import num_tiles_test
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig
from ampnet_tpu_torch.core.weights import load_flax_variables
from ampnet_tpu_torch.infer.tiled import TiledInferencer, dihedral_xy, tta_ensemble
from ampnet_tpu_torch.models.amp import AMPNetSegmenter
from ampnet_tpu_torch.ops.kmeans import balanced_kmeans, round_balanced

N_POINTS, MAX_CLUSTERS = 64, 3


@pytest.mark.parametrize("mode", ["sinkhorn", "argmin"])
@pytest.mark.parametrize("seed", [0, 1])
def test_balanced_kmeans_matches_jax_with_injected_init(mode, seed):
    rng = np.random.default_rng(seed)
    n, k = 384, 3
    feats = rng.normal(size=(n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    caps = (n // k,) * k
    ja, jc = j_balanced_kmeans(jnp.asarray(feats), k, key, capacities=caps, lloyd_mode=mode)
    init = np.array(jax.random.permutation(key, n)[:k])
    ta, tc = balanced_kmeans(torch.from_numpy(feats), k, capacities=caps, lloyd_mode=mode,
                             init_idx=torch.from_numpy(init))
    assert ta.dtype == torch.int32
    assert (ta.numpy() == np.asarray(ja)).mean() >= 0.999
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-3)
    assert np.bincount(ta.numpy(), minlength=k).tolist() == list(caps)


@pytest.mark.parametrize("mode", ["sinkhorn", "argmin"])
def test_balanced_kmeans_batch_tiles_each_cloud_as_alone(mode):
    """A batch of clouds (the bucket program's k-means, vmapped in the JAX
    package) tiles every cloud as it would be tiled alone."""
    rng = np.random.default_rng(3)
    b, n, k = 3, 256, 4
    feats = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32))
    init = torch.stack([torch.randperm(n, generator=torch.Generator().manual_seed(s))[:k]
                        for s in range(b)])
    caps = (n // k,) * k
    ba, bc = balanced_kmeans(feats, k, capacities=caps, lloyd_mode=mode, init_idx=init)
    assert ba.shape == (b, n) and bc.shape == (b, k, 3)
    for i in range(b):
        a, c = balanced_kmeans(feats[i], k, capacities=caps, lloyd_mode=mode, init_idx=init[i])
        np.testing.assert_array_equal(ba[i].numpy(), a.numpy())
        np.testing.assert_allclose(bc[i].numpy(), c.numpy(), atol=1e-6)
        assert np.bincount(ba[i].numpy(), minlength=k).tolist() == list(caps)
    with pytest.raises(ValueError, match="init_idx"):
        balanced_kmeans(feats, k)


def test_round_balanced_breaks_ties_toward_lower_index():
    """Equal scores go to the lower index, as jax.lax.top_k orders them."""
    scores = torch.zeros(6, 2)
    assign = round_balanced(scores, (3, 3))
    assert assign.tolist() == [0, 0, 0, 1, 1, 1]


@pytest.fixture(scope="module")
def pair():
    cfg = JConfig(data=JDataConfig(n_points=N_POINTS, max_clusters_test=MAX_CLUSTERS),
                  model=JModelConfig(dropout=0.0))
    jm = JSegmenter(cfg.model)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(1, 2, N_POINTS, 9)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), pts, pts[..., :2].mean(axis=2), np.zeros((1, 2), bool))
    leaves, treedef = jax.tree.flatten(v)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    v = jax.tree.unflatten(treedef, [l + jax.random.normal(k, l.shape, l.dtype) * 0.05
                                     for k, l in zip(keys, leaves)])
    pcfg = AMPNetConfig(data=DataConfig(n_points=N_POINTS, max_clusters_test=MAX_CLUSTERS),
                        model=ModelConfig(dropout=0.0))
    model = load_flax_variables(AMPNetSegmenter(pcfg.model), jax.tree.map(np.asarray, v))
    return (jm, v, cfg), (model, pcfg)


def _jax_init(n, seed):
    k = num_tiles_test(n, N_POINTS, MAX_CLUSTERS)
    if k == 1:
        return None
    cap = N_POINTS
    while cap * k < n:
        cap *= 2
    return np.array(jax.random.permutation(jax.random.PRNGKey(seed), k * cap)[:k])


@pytest.mark.parametrize("backend", ["xla", "fused"])
@pytest.mark.parametrize("wire", [None, "int8"])
def test_tiled_inferencer_matches_jax(pair, backend, wire):
    (jm, v, jcfg), (model, pcfg) = pair
    jt = JTiled(jm, v, jcfg, backend=backend, transfer_dtype=wire)
    tt = TiledInferencer(model, pcfg, backend=backend, transfer_dtype=wire, device="cpu")
    rng = np.random.default_rng(11)
    sizes = (70, 127, 128, 200, 333)  # k = 1, 1, 2, 3, 3 (cap 64 and 128)
    clouds = [rng.normal(size=(n, 9)).astype(np.float32) for n in sizes]
    seeds = [3, 0, 1, 2, 4]
    ref = jt.predict_many(clouds, seeds, return_probs=True)
    out = tt.predict_many(clouds, seeds, return_probs=True,
                          init_idx=[_jax_init(n, s) for n, s in zip(sizes, seeds)])
    for (jl, jp), (tl, tp), n in zip(ref, out, sizes):
        assert tl.shape == (n,) and tl.dtype == np.int32
        assert tp.shape == (n, 5) and tp.dtype == np.float16
        assert (tl == jl).mean() >= 0.999
        np.testing.assert_allclose(tp.astype(np.float32), jp.astype(np.float32), atol=2e-3)


def test_tiled_inferencer_paths(pair):
    """predict == predict_many; the fast tiler and the mega-cloud halving
    cover every point; a k>1 cloud's labels do not depend on its co-batched
    clouds; predict_tta with one transform is predict."""
    (_, _, _), (model, pcfg) = pair
    tt = TiledInferencer(model, pcfg, backend="fused", device="cpu", max_points_per_call=300)
    rng = np.random.default_rng(12)
    a, b = (rng.normal(size=(n, 9)).astype(np.float32) for n in (250, 260))
    alone = tt.predict(a, seed=7)
    together = tt.predict_many([a, b], seeds=[7, 9])
    np.testing.assert_array_equal(alone, together[0])
    big = rng.normal(size=(700, 9)).astype(np.float32)  # > max_points_per_call
    preds, probs = tt.predict(big, return_probs=True)
    assert preds.shape == (700,) and probs.shape == (700, 5)
    np.testing.assert_array_equal(preds, probs.argmax(-1))
    fast = TiledInferencer(model, pcfg, tiler="fast", device="cpu")
    assert fast.predict(a).shape == (250,)
    np.testing.assert_array_equal(tt.predict_tta(a, seed=7, transforms=1), alone)
    assert tt.cold_programs_seen >= 2


def test_tta_matches_jax(pair):
    (jm, v, jcfg), (model, pcfg) = pair
    jt = JTiled(jm, v, jcfg)
    tt = TiledInferencer(model, pcfg, device="cpu")
    rng = np.random.default_rng(13)
    cloud = rng.normal(size=(100, 9)).astype(np.float32)  # k = 1 in every view
    jl, jp = jt.predict_tta(cloud, transforms=4, return_probs=True)
    tl, tp = tt.predict_tta(cloud, transforms=4, return_probs=True)
    assert (tl == jl).mean() >= 0.999
    np.testing.assert_allclose(tp.astype(np.float32), jp.astype(np.float32), atol=2e-3)
    for t in range(8):
        assert np.array_equal(dihedral_xy(cloud, t)[:, 2:], cloud[:, 2:])
    with pytest.raises(ValueError):
        tta_ensemble(lambda c, s: None, [cloud], 9)
