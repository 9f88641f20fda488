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


@pytest.mark.parametrize("case", ["min_size", "point_mask_sinkhorn", "point_mask_argmin"])
def test_balanced_kmeans_exact_and_point_mask_match_jax(case):
    """``exact=False`` (the plan's argmax) and ``point_mask`` (no mass, −1)
    on the cases of JAX's own tests (tests/test_ops.py), from JAX's start."""
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    if case == "min_size":
        feats = rng.normal(size=(700, 3)).astype(np.float32)
        kw, k, mask = dict(exact=False), 3, None
    else:
        feats = np.zeros((128, 2), np.float32)
        feats[:100] = rng.normal(size=(100, 2))
        feats[100:] = 1e6
        mask = np.arange(128) < 100
        kw = dict(capacities=(50, 50), lloyd_mode=case.rpartition("_")[2])
        k = 2
    jmask = None if mask is None else jnp.asarray(mask)
    ja, jc = j_balanced_kmeans(jnp.asarray(feats), k, key, point_mask=jmask, **kw)
    init = np.array(jax.random.permutation(key, feats.shape[0])[:k])
    ta, tc = balanced_kmeans(torch.from_numpy(feats), k, init_idx=torch.from_numpy(init),
                             point_mask=None if mask is None else torch.from_numpy(mask), **kw)
    ja, ta = np.asarray(ja), ta.numpy()
    assert ta.dtype == np.int32 and (ta == ja).mean() >= 0.999
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-3)
    if mask is None:
        sizes = np.bincount(ta, minlength=k)
        assert sizes.sum() == 700 and (sizes > 0.5 * 700 / 3).all()
    else:
        assert (ta[100:] == -1).all()
        assert sorted(np.bincount(ta[:100]).tolist()) == [50, 50]
    with pytest.raises(ValueError, match="explicit capacities"):
        balanced_kmeans(torch.from_numpy(feats), k, point_mask=torch.ones(feats.shape[0], dtype=bool))


def test_batch_padding_and_cold_programs_match_jax(pair):
    """Micro-batches of 3, 4, 2 and 1 clouds of one bucket pad to JAX's power
    of two: the same program shapes run, and are counted cold, as in JAX;
    the 3-cloud batch (padded with a copy of its first cloud) keeps JAX's
    labels."""
    (jm, v, jcfg), (model, pcfg) = pair
    jt = JTiled(jm, v, jcfg)
    tt = TiledInferencer(model, pcfg, device="cpu")
    rng = np.random.default_rng(14)
    sizes = (200, 210, 220, 230)  # k = 3, cap 128: one bucket
    clouds = [rng.normal(size=(n, 9)).astype(np.float32) for n in sizes]
    for b in (3, 4, 2, 1):
        seeds = list(range(b))
        ref = jt.predict_many(clouds[:b], seeds)
        out = tt.predict_many(clouds[:b], seeds,
                              init_idx=[_jax_init(n, s) for n, s in zip(sizes, seeds)])
        if b == 3:
            for jl, tl in zip(ref, out):
                assert (tl == jl).mean() >= 0.999
        assert tt._warm_shapes == jt._warm_shapes
        assert tt.cold_programs_seen == jt.cold_programs_seen
    assert tt._warm_shapes == {(3, 128, False, b) for b in (4, 2, 1)}


@pytest.mark.parametrize("b", [1, 3, 5])
def test_sharded_batch_pads_as_jax(pair, b):
    """Over two devices a bucket of b clouds pads to JAX's
    ceil(pow2(b) / nd) · nd rows in contiguous shards, and its labels equal
    one device's."""
    (_, _, _), (model, pcfg) = pair
    nd = 2
    b_pad = -(-(1 << (b - 1).bit_length()) // nd) * nd  # ampnet_tpu/infer/tiled.py:459-465
    sharded = TiledInferencer(model, pcfg, device="cpu", devices=["cpu", "cpu"])
    rng = np.random.default_rng(15)
    clouds = [rng.normal(size=(100, 9)).astype(np.float32) for _ in range(b)]  # k = 1
    handle = sharded.dispatch_many(clouds)
    per = b_pad // nd
    assert [idxs for idxs, _ in handle["pending"]] == [list(range(b))[:per],
                                                       list(range(b))[per:]]
    assert [out[0].shape[0] for _, out in handle["pending"]] == [per, per]
    assert sharded._warm_shapes == {(1, 128, False, b_pad)}
    got = sharded.fetch_many(handle)
    want = TiledInferencer(model, pcfg, device="cpu").predict_many(clouds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("probs", [False, True])
@pytest.mark.parametrize("case", ["tiled", "k1", "stacked"])
def test_bucket_fn_on_cpu_is_the_eager_body(pair, case, probs):
    """On the CPU a bucket's runner is the eager body: its outputs equal
    ``_run_bucket``'s bit for bit, and no graph is made."""
    (_, _, _), (model, pcfg) = pair
    members = [model, model] if case == "stacked" else model
    tt = TiledInferencer(members, pcfg, device="cpu")
    k, cap, b = (1, 128, 2) if case == "k1" else (3, 64, 2)
    rng = np.random.default_rng(16)
    points = torch.from_numpy(rng.normal(size=(b, k * cap, 9)).astype(np.float32))
    scale, offset = torch.ones(b, 9), torch.zeros(b, 9)
    init = None if k == 1 else torch.stack(
        [torch.randperm(k * cap, generator=torch.Generator().manual_seed(s))[:k]
         for s in range(b)])
    run = tt._bucket_fn(k, cap, probs, torch.device("cpu"), b)
    with torch.inference_mode():
        got = run(points, scale, offset, init)
        want = tt._run_bucket(k, cap, probs, points, scale, offset, init)
    assert torch.equal(got[0], want[0]) and got[0].shape == (b, k * cap)
    assert (got[1] is None) == (not probs)
    if probs:
        assert torch.equal(got[1], want[1])
    assert tt._runners == {}


def test_replayed_launches_add_what_the_capture_recorded():
    """A capture records its kernel launches instead of counting them (other
    threads go on counting theirs); each replay adds the record."""
    import threading

    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain
    from ampnet_tpu_torch.ops.launch_count import add_launches, count_launch, recording
    from ampnet_tpu_torch.ops.quantized_mlp import quantized_mlp_chain

    before = fused_mlp_chain.launches, quantized_mlp_chain.launches
    try:
        with recording() as recorded:  # a fake capture of an int8 bucket forward
            for w in (fused_mlp_chain, fused_mlp_chain, quantized_mlp_chain, quantized_mlp_chain):
                count_launch(w)
            other = threading.Thread(target=count_launch, args=(fused_mlp_chain,))
            other.start()
            other.join()
        assert recorded == {fused_mlp_chain: 2, quantized_mlp_chain: 2}
        assert (fused_mlp_chain.launches, quantized_mlp_chain.launches) == (before[0] + 1,
                                                                            before[1])
        for _ in range(3):  # three replays
            add_launches(recorded)
        assert (fused_mlp_chain.launches, quantized_mlp_chain.launches) == (before[0] + 7,
                                                                            before[1] + 6)
        count_launch(fused_mlp_chain)  # outside a capture: counted
        assert fused_mlp_chain.launches == before[0] + 8
    finally:
        fused_mlp_chain.launches, quantized_mlp_chain.launches = before


def test_launch_counts_hold_under_concurrent_threads():
    """More counting threads than cores, switching often: every launch
    counted outside a capture is counted once, and none recorded inside one
    reaches the counter."""
    import sys
    import threading

    from ampnet_tpu_torch.ops.fused_mlp import fused_mlp_chain
    from ampnet_tpu_torch.ops.launch_count import count_launch, recording

    before, interval = fused_mlp_chain.launches, sys.getswitchinterval()
    threads, per, records = 16, 500, []

    def work(i):
        if i % 4 == 0:  # a capturing thread
            with recording() as rec:
                for _ in range(per):
                    count_launch(fused_mlp_chain)
            records.append(rec[fused_mlp_chain])
        else:
            for _ in range(per):
                count_launch(fused_mlp_chain)

    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
        assert records == [per] * (threads // 4)
        assert fused_mlp_chain.launches - before == per * (threads - threads // 4)
    finally:
        sys.setswitchinterval(interval)
        fused_mlp_chain.launches = before


@pytest.mark.parametrize("kind", ["tiled", "sharded", "ensemble", "classifier"])
def test_every_inferencer_records_its_stages(pair, kind):
    """Each inferencer the server can hold records its dispatch stages under
    the dispatch's span and its fetch at the group's top: one bucket call a
    bucket (a shard, a member), none of a stage it does not have (no pin or
    fetch wait on the CPU, no tiling stamps in the classifier)."""
    from ampnet_tpu_torch.core.profiling import SpanGroup, Spans
    from ampnet_tpu_torch.infer.classify import CloudClassifier
    from ampnet_tpu_torch.infer.tiled import EnsembleInferencer
    from ampnet_tpu_torch.models.factory import build_model

    (_, _, _), (model, pcfg) = pair
    one = lambda: TiledInferencer(model, pcfg, device="cpu")
    inferencer, calls = {
        "tiled": lambda: (one(), 2),
        "sharded": lambda: (TiledInferencer(model, pcfg, device="cpu",
                                            devices=["cpu", "cpu"]), 4),
        "ensemble": lambda: (EnsembleInferencer([one(), one()]), 4),
        "classifier": lambda: (CloudClassifier(
            build_model(pcfg, "attention", "classification").eval(), pcfg, device="cpu"), 1),
    }[kind]()
    rng = np.random.default_rng(17)
    clouds = [rng.normal(size=(n, 9)).astype(np.float32) for n in (100, 200, 210)]  # k 1, 3, 3
    group = SpanGroup("batch")
    with Spans(group).span("batch.dispatch") as under:
        handle = inferencer.dispatch_many(clouds, seeds=[0, 0, 0], spans=under)
    assert len(inferencer.fetch_many(handle)) == 3
    (dispatch,) = [s for s in group.spans if s[0] == "batch.dispatch"]
    count = lambda name: sum(s[0] == name for s in group.spans)
    tiled = kind != "classifier"
    members = 2 if kind == "ensemble" else 1
    want = {"dispatch.pad": members, "dispatch.encode": calls if tiled else 0,
            "dispatch.init": calls // 2 if tiled else 0, "dispatch.launch": calls,
            "dispatch.pin": 0, "batch.fetch_wait": 0, "batch.unpack": calls,
            "device.tiling": calls if tiled else 0, "device.forward": calls if tiled else 0}
    assert {name: count(name) for name in want} == want
    for name, t0, t1, _, _, parent, attrs in group.spans:
        if name.startswith("dispatch."):
            assert parent == dispatch[4] and dispatch[1] <= t0 <= t1 <= dispatch[2]
        elif name != "batch.dispatch":
            assert parent == group.id and (attrs.get("clock") == "device") == (
                name.startswith("device."))


@pytest.mark.parametrize("n", [100, 200])  # k = 1, k = 3
def test_cpu_stamps_split_the_bucket_call(pair, n):
    """On the CPU the body's stamps (``perf_counter_ns``) lie inside the
    call that ran it: tiling ≥ 0, forward > 0, their sum at most the call;
    without k-means (k = 1) the tiling interval is a small part of it."""
    from ampnet_tpu_torch.core.profiling import SpanGroup, Spans

    (_, _, _), (model, pcfg) = pair
    tt = TiledInferencer(model, pcfg, device="cpu")
    cloud = np.random.default_rng(18).normal(size=(n, 9)).astype(np.float32)
    group = SpanGroup("batch")
    tt.predict_many([cloud], spans=Spans(group))
    spans = {s[0]: s for s in group.spans}
    launch, tiling, forward = (spans[k] for k in ("dispatch.launch", "device.tiling",
                                                  "device.forward"))
    assert launch[1] <= tiling[1] <= tiling[2] == forward[1] < forward[2] <= launch[2]
    if n == 100:
        assert tiling[2] - tiling[1] < 0.25 * (forward[2] - forward[1])


def test_dispatch_counts_real_and_device_points(pair):
    """A bucket of 3 clouds (k 3 × cap 128) padded to 4: the handle counts
    the 630 real points and the 4 · 3 · 128 the device runs."""
    (_, _, _), (model, pcfg) = pair
    tt = TiledInferencer(model, pcfg, device="cpu")
    rng = np.random.default_rng(19)
    handle = tt.dispatch_many([rng.normal(size=(n, 9)).astype(np.float32)
                               for n in (200, 210, 220)])
    assert handle["points"] == (630, 4 * 3 * 128)
    tt.fetch_many(handle)
