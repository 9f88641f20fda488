"""The port's training options against the JAX package on the same data and
weights: the bfloat16 compute dtype, encoder rematerialisation, rare-class
oversampling (``rare_class_repeats`` and the batchers' ``repeats``), the
data-driven segmentation weights (``seg_class_weights``), the trainer's
first-epoch peek and ``epoch_dispatch``, the host batcher's prefetch thread
and worker pool, and the ``train`` command with them.

The bfloat16 bound is measured, not chosen: no JAX test pins one. On this
file's batch (4 clouds x 3 windows x 64 points, a perturbed Flax init,
dropout 0), JAX's bfloat16 step lies this far from JAX's float32 step: the
loss 9.2e-3 apart (1.8214 against 1.8122), the whole gradient 0.82 of its
norm apart, and the worst parameter's gradient 1.39 of its own norm apart
(the cancelled head biases left out, as ``tests/test_torch_train.py`` leaves
them). That is the bfloat16 floor: rounding every activation to 8 bits moves
the first step's gradient by O(1) through the batch-statistics BatchNorms.
The port's bfloat16 step must lie no further from JAX's bfloat16 step than
the floor, on each of the three (measured: 2.7e-3, 0.63 and 0.95), and its
eval predictions agree with JAX's bfloat16 ones on >= 0.99 of the points
(the ``bf16`` serving bound of ``tests/test_backends.py``; measured 0.9948).
The norm of each parameter's gradient is used, not its largest entry: with
O(1) noise the largest entry's gap is a worst-of-thousands statistic (1.76
for the port against 1.42 for the floor on one weight). The float32 step's
bounds do not change (``tests/test_torch_train.py``)."""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.cli import main as jcli
from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.data.datasets import WindowedCloudDataset as JWindowedCloudDataset
from ampnet_tpu.data.device_cache import DeviceCachedBatcher as JDeviceCachedBatcher
from ampnet_tpu.data.pipeline import HostShardedBatcher as JHostShardedBatcher
from ampnet_tpu.data.pipeline import PaddedBatcher as JPaddedBatcher
from ampnet_tpu.models.amp import AMPNetSegmenter as JSegmenter
from ampnet_tpu.train.state import clone_state
from ampnet_tpu.train.step import make_step_fns as j_make_step_fns
from ampnet_tpu_torch.cli.main import main, rare_class_repeats, seg_class_weights
from ampnet_tpu_torch.core.checkpoint import load_model, read_meta, read_payload
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig, TrainConfig
from ampnet_tpu_torch.core.config import compute_dtype
from ampnet_tpu_torch.core.weights import _get, _leaves, flax_variables, load_flax_variables
from ampnet_tpu_torch.data.datasets import WindowedCloudDataset
from ampnet_tpu_torch.data.device_cache import DeviceCachedBatcher
from ampnet_tpu_torch.data.io_utils import save_cloud, write_split_list
from ampnet_tpu_torch.data.pipeline import HostShardedBatcher, PaddedBatcher
from ampnet_tpu_torch.models.amp import AMPNetClassifier, AMPNetSegmenter
from ampnet_tpu_torch.models.backends import make_forward
from ampnet_tpu_torch.models.layers import Dense
from ampnet_tpu_torch.train.cls_step import make_cls_step_fns
from ampnet_tpu_torch.train.state import create_train_state
from ampnet_tpu_torch.train.step import make_step_fns
from ampnet_tpu_torch.train.trainer import Trainer
from test_torch_train import (
    _perturbed,
    assert_params_after_step,
    assert_stats_close,
    jax_state,
    make_batch,
    param_grads,
    port_state,
    tensors,
)

SHAPE = (4, 3, 64)  # clouds, windows, points
CANCELLED = 10.0  # a gradient gap above this: a leaf that is zero in exact arithmetic


@pytest.fixture(scope="module")
def setup():
    """(batch, a perturbed Flax init of the float32 segmenter, dropout 0)."""
    batch = make_batch(shape=SHAPE)
    jm = JSegmenter(JModelConfig(dropout=0.0))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["points"]),
                jnp.asarray(batch["centroids"]), jnp.asarray((batch["labels"] == -1).all(-1)),
                train=False)
    return batch, _perturbed(v, 5, 0.02)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """JAX's train step (augment off) and eval step from the same weights
    under each model option: {name: (loss, grads, new params, new stats,
    eval predictions)}, as numpy."""
    batch, v = setup
    dev = {k: jnp.asarray(a) for k, a in batch.items()}
    out = {}
    for name, kw in (("f32", {}), ("bf16", {"dtype": "bfloat16"}), ("remat", {"remat": True})):
        jcfg = JConfig(model=JModelConfig(dropout=0.0, **kw))
        jm = JSegmenter(jcfg.model)
        step, evaluate = j_make_step_fns(jcfg, augment=False)
        new, m = step(clone_state(jax_state(jm, v)), dev)
        _, preds = evaluate(jax_state(jm, v), dev)
        grads = jax.tree.map(lambda mu: np.asarray(mu) / 0.1, new.opt_state[0].mu)
        out[name] = (float(m["loss"]), grads, jax.tree.map(np.asarray, new.params),
                     jax.tree.map(np.asarray, new.batch_stats), np.asarray(preds))
    return out


def port_step(setup, **model_kw):
    """The port's train step and, from the same weights, its eval
    predictions: (loss, grads as a Flax tree, state, predictions)."""
    batch, v = setup
    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0, **model_kw))
    state = port_state(v, cfg)
    train_step, eval_step = make_step_fns(cfg, augment=False)
    loss = float(train_step(state, tensors(batch))["loss"])
    _, preds = eval_step(port_state(v, cfg), tensors(batch))
    return loss, param_grads(state.model), state, preds.numpy()


def gradient_gaps(got, ref):
    """({leaf: ‖got − ref‖ / ‖ref‖}, the same over the whole gradient)."""
    gaps, num, den = {}, 0.0, 0.0
    for path, g_ref in _leaves(ref):
        diff = np.linalg.norm(_get(got, path) - g_ref)
        gaps["/".join(path)] = diff / max(np.linalg.norm(g_ref), 1e-12)
        num, den = num + diff ** 2, den + np.linalg.norm(g_ref) ** 2
    return gaps, float(np.sqrt(num / den))


# -- the compute dtype ---------------------------------------------------------


@pytest.mark.parametrize("name, want", [(None, None), ("float32", None),
                                        ("bfloat16", torch.bfloat16), ("float16", ValueError)])
def test_compute_dtype_names(name, want):
    if want is ValueError:
        with pytest.raises(ValueError, match="unknown compute dtype"):
            compute_dtype(name)
    else:
        assert compute_dtype(name) is want


def test_bfloat16_model_keeps_float32_parameters_and_gradients():
    """Every dense layer computes in bfloat16 over float32 parameters; the
    logits and transforms come out in bfloat16 and autograd returns float32
    gradients, as the gradient of JAX's cast does."""
    model = AMPNetSegmenter(ModelConfig(dtype="bfloat16", dropout=0.0))
    assert all(m.compute_dtype is torch.bfloat16 for m in model.modules() if isinstance(m, Dense))
    b = tensors(make_batch(shape=(2, 3, 16)))
    logits, t_feat, weights = model(b["points"], b["centroids"], (b["labels"] == -1).all(-1))
    assert logits.dtype == t_feat.dtype == torch.bfloat16 and weights.dtype == torch.float32
    logits.float().sum().backward()
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())
    cls = AMPNetClassifier(ModelConfig(dtype="bfloat16", dropout=0.0), num_windows=3)
    assert cls(b["points"])[0].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["attention", "gru", "baseline", "classic", "pointnet2"])
def test_bfloat16_forward_of_each_family_matches_jax(arch):
    """Each family's eval forward with ``dtype="bfloat16"`` against the JAX
    module with the same dtype and weights: logits within 2^-5 of their
    largest (bfloat16 keeps 8 bits; XLA may fuse ops without rounding
    between them, torch rounds after each), and the same argmax wherever
    JAX's top two logits lie further apart than twice that (at a random
    init many points are near-ties, which either rounding may flip)."""
    from ampnet_tpu.core.config import DataConfig as JDataConfig
    from ampnet_tpu.models import pointnet2 as jpn2
    from ampnet_tpu.models.factory import build_model as j_build_model
    from ampnet_tpu_torch.models.factory import build_model

    shape = (2, 1, 64) if arch == "pointnet2" else (4, 3, 64)
    batch = make_batch(seed=1, shape=(shape[0], max(shape[1], 2), shape[2]))
    batch = {k: np.ascontiguousarray(a[:, :shape[1]]) for k, a in batch.items()}
    jcfg = JConfig(data=JDataConfig(max_windows=shape[1]),
                   model=JModelConfig(dropout=0.0, dtype="bfloat16"))
    jm = (jpn2.PointNet2Segmenter(5, dropout=0.0, dtype="bfloat16") if arch == "pointnet2"
          else j_build_model(jcfg, arch, "segmentation"))
    args = (jnp.asarray(batch["points"]), jnp.asarray(batch["centroids"]),
            jnp.asarray((batch["labels"] == -1).all(-1)))
    v = _perturbed(jm.init(jax.random.PRNGKey(0), *args, train=False), 5, 0.02)
    ref = np.asarray(jm.apply(v, *args, train=False)[0].astype(jnp.float32))
    cfg = AMPNetConfig(data=DataConfig(max_windows=shape[1]),
                       model=ModelConfig(dropout=0.0, dtype="bfloat16"))
    model = load_flax_variables(build_model(cfg, arch), jax.tree.map(np.asarray, v)).eval()
    with torch.no_grad():
        got = model(*(torch.from_numpy(np.asarray(a)) for a in args))[0]
    assert got.dtype == torch.bfloat16
    got, atol = got.float().numpy(), 2 ** -5 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    determined = top2[..., 1] - top2[..., 0] > 2 * atol
    print(f"{arch}: argmax agreement {(got.argmax(-1) == ref.argmax(-1)).mean():.4f}, "
          f"{determined.mean():.3f} of the points determined")
    assert determined.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[determined], ref.argmax(-1)[determined])


def test_bfloat16_batchnorm_matches_jax():
    """``MaskedBatchNorm`` on a bfloat16 input in training: statistics in
    float32 (the running ones equal JAX's to 1e-6), the normalisation in
    bfloat16 (within 2 bfloat16 steps of JAX's)."""
    from ampnet_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
    from ampnet_tpu_torch.models.layers import MaskedBatchNorm

    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 40, 8)) * 2 + 1).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y_j, upd = JMaskedBatchNorm(dtype=jnp.bfloat16).apply(
        {"params": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)},
         "batch_stats": {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}},
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), mutable=["batch_stats"])
    bn = MaskedBatchNorm(8).train()
    y = bn(xb).detach()
    assert y.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_j.astype(jnp.float32)),
                               atol=2 * 2 ** -8 * 4, rtol=0)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=1e-6)


def test_bfloat16_step_lies_within_the_bfloat16_floor(setup, jax_steps):
    """The port's bfloat16 step against JAX's, held to how far JAX's own
    bfloat16 step lies from its float32 step (the module docstring)."""
    j32, jbf = jax_steps["f32"], jax_steps["bf16"]
    loss, grads, _, preds = port_step(setup, dtype="bfloat16")
    floor, floor_all = gradient_gaps(jbf[1], j32[1])
    gaps, gap_all = gradient_gaps(grads, jbf[1])
    kept = [k for k, f in floor.items() if f < CANCELLED]
    print(f"bf16 floor: loss {abs(jbf[0] - j32[0]):.3g}, gradient {floor_all:.3g}, worst leaf "
          f"{max(floor[k] for k in kept):.3g}; port: loss {abs(loss - jbf[0]):.3g}, gradient "
          f"{gap_all:.3g}, worst leaf {max(gaps[k] for k in kept):.3g}; eval agreement "
          f"{(preds == jbf[4]).mean():.4f}")
    assert abs(loss - jbf[0]) <= abs(jbf[0] - j32[0])
    assert gap_all <= floor_all
    assert max(gaps[k] for k in kept) <= max(floor[k] for k in kept)
    assert (preds == jbf[4]).mean() >= 0.99


# -- remat ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["seg", "cls", "edge"])
def test_remat_step_equals_the_plain_step_bit_for_bit(kind):
    """The encoder under ``torch.utils.checkpoint``: the loss, every
    gradient, the running statistics (updated once, not again in the
    recompute) and the parameters after the step equal the plain step's.
    On one thread: on several, the backward of the edge block's neighbour
    gather adds in an order that varies, and two plain steps part too."""
    b = make_batch(shape=(2, 3, 32))
    runs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for remat in (False, True):
            runs.append(remat_case(kind, remat, b))
    finally:
        torch.set_num_threads(threads)
    (m0, g0, s0), (m1, g1, s1) = runs
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for n in s0:
        assert torch.equal(s0[n], s1[n]), n


def remat_case(kind, remat, b):
    """One seeded train step of a ``kind`` model: (metrics, gradients,
    parameters and buffers after it)."""
    mcfg = ModelConfig(dropout=0.0, remat=remat, local_agg="edge" if kind == "edge" else "none")
    g = torch.Generator().manual_seed(0)
    model = (AMPNetClassifier(mcfg, num_windows=3, generator=g) if kind == "cls"
             else AMPNetSegmenter(mcfg, generator=g))
    cfg = AMPNetConfig(model=mcfg)
    batch = tensors(b)
    if kind == "cls":
        batch["cls_label"] = torch.tensor([0, 1], dtype=torch.int32)
        step = make_cls_step_fns(cfg, np.array([0.4, 0.6]))[0]
    else:
        step = make_step_fns(cfg)[0]  # augmentation on: the same draws both times
    state = create_train_state(cfg, model, 1, "cpu")
    m = step(state, batch)
    return (m, {n: p.grad.clone() for n, p in model.named_parameters()},
            {**dict(model.named_parameters()), **dict(model.named_buffers())})


def test_remat_step_matches_jax_remat_step(setup, jax_steps):
    """The port's remat step against JAX's ``nn.remat`` step at the float32
    step's tolerances: loss 1e-5, parameters 1e-4, statistics 1e-5."""
    jloss, jgrads, jparams, jstats, _ = jax_steps["remat"]
    loss, _, state, _ = port_step(setup, remat=True)
    assert loss == pytest.approx(jloss, abs=1e-5)
    after = flax_variables(state.model)
    assert_params_after_step(jparams, after["params"], jgrads)
    assert_stats_close(jstats, after["batch_stats"], atol=1e-5)


# -- oversampling and class weights ----------------------------------------------


def write_rare_dataset(folder, n_train=6, n_val=2, n_points=64, n_windows=3, seed=0):
    """kmeans_<name>.npz [N, 13, W]: background and vegetation everywhere,
    tower points (raw 15) in clouds 1 and 4 only, lines (raw 14) in cloud 4
    only: towers and lines are each under 5 % of the points. The val clouds
    are also written as 13-column ``<name>.pkl`` for ``test``."""
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n_train + n_val):
        pc = rng.uniform(0, 1, size=(n_points, 13, n_windows)).astype(np.float32)
        pc[:, 3] = rng.choice([1, 3, 5], size=(n_points, n_windows))
        if i in (1, 4):
            pc[:3, 3, 0] = 15
        if i == 4:
            pc[3:5, 3, 1] = 14
        save_cloud(str(folder / f"kmeans_cloud{i}.npz"), pc)
        if i >= n_train:
            save_cloud(str(folder / f"cloud{i}.pkl"), pc.transpose(0, 2, 1).reshape(-1, 13))
        names.append(f"cloud{i}.pkl")
    write_split_list(str(folder / "train_seg_files.txt"), names[:n_train])
    write_split_list(str(folder / "val_seg_files.txt"), names[n_train:])
    return names[:n_train]


@pytest.fixture
def rare(tmp_path):
    names = write_rare_dataset(tmp_path)
    return tmp_path, names, WindowedCloudDataset(str(tmp_path), names), \
        JWindowedCloudDataset(str(tmp_path), names)


@pytest.mark.parametrize("factor, spec", [(3, "auto"), (2, "1"), (4, "1,2"), (2, "0"),
                                          (3, "2,9")])
def test_rare_class_repeats_equal_jax(factor, spec, rare):
    _, _, ds, jds = rare
    if spec == "2,9":
        for fn, d in ((rare_class_repeats, ds), (jcli.rare_class_repeats, jds)):
            with pytest.raises(ValueError, match=r"out of range: \[9\]"):
                fn(d, factor, spec, 5)
        return
    got, want = rare_class_repeats(ds, factor, spec, 5), jcli.rare_class_repeats(jds, factor,
                                                                                  spec, 5)
    assert got[1:] == want[1:]
    if want[0] is None:
        assert got[0] is None
    else:
        np.testing.assert_array_equal(got[0], want[0])
    if spec == "auto":
        assert got[1] == [1, 2] and got[2] == 2


@pytest.mark.parametrize("method", ["EFS", "INS", "ISNS", "sklearn", "nope"])
def test_seg_class_weights_equal_jax(method, rare):
    _, _, ds, jds = rare
    (w, counts), (jw, jcounts) = seg_class_weights(ds, method, 5, 0.999), \
        jcli.seg_class_weights(jds, method, 5, 0.999)
    np.testing.assert_array_equal(counts, jcounts)
    if jw is None:
        assert w is None
    else:
        np.testing.assert_allclose(w, np.asarray(jw), rtol=1e-6)


def test_repeated_epoch_orders_equal_jax_after_the_peek(rare):
    """The host batcher and the device cache under ``repeats``, epochs 0 and
    1 after the trainer's peek (the port's ``Trainer`` spends the first
    epoch's draw as JAX's ``next(iter(train_data))`` does), and ``len()``,
    equal JAX's exactly; so does a host-sharded batcher's length."""
    folder, names, ds, jds = rare
    reps = rare_class_repeats(ds, 3, "auto", 5)[0]
    kw = dict(n_points=64, max_windows=3, seed=4, repeats=reps)
    cfg = AMPNetConfig(data=DataConfig(n_points=64, max_windows=3),
                       train=TrainConfig(batch_size=2))
    host, cache = PaddedBatcher(ds, 2, **kw), DeviceCachedBatcher(PaddedBatcher(ds, 2, **kw), "cpu")
    jhost = JPaddedBatcher(jds, 2, prefetch=0, **kw)
    jcache = JDeviceCachedBatcher(JPaddedBatcher(jds, 2, prefetch=0, **kw))
    assert len(host) == len(cache) == len(jhost) == len(jcache) == int(reps.sum()) // 2
    for data in (host, cache):
        Trainer(cfg, AMPNetSegmenter(cfg.model), data, None, str(folder / "w"), device="cpu")
        assert data.epoch == 1
    next(iter(jhost))
    next(iter(jcache))
    for _ in range(2):
        for a, b in zip(host, jhost, strict=True):
            assert a["names"] == b["names"]
            np.testing.assert_array_equal(a["points"], b["points"])
        idxs, pads, _ = cache.epoch_index_matrix()
        j_idxs, j_pads, _ = jcache.epoch_index_matrix()
        np.testing.assert_array_equal(idxs, j_idxs)
        np.testing.assert_array_equal(pads, j_pads)
    sharded = dict(host_id=1, host_count=2, n_points=64, max_windows=3, seed=4, repeats=reps)
    assert len(HostShardedBatcher(ds, 4, **sharded)) == len(
        JHostShardedBatcher(jds, 4, prefetch=0, **sharded))


# -- the trainer's epoch dispatch ------------------------------------------------


def test_epoch_dispatch_off_gives_the_auto_epoch(rare):
    """``epoch_dispatch='off'`` steps the cache batch by batch; ``auto``
    runs its epoch loop: the same metrics, parameters and statistics."""
    folder, names, ds, _ = rare
    cfg = AMPNetConfig(data=DataConfig(n_points=64, max_windows=3),
                       model=ModelConfig(dropout=0.0),
                       train=TrainConfig(batch_size=2, epochs=1))
    out = []
    for mode in ("auto", "off"):
        data = DeviceCachedBatcher(PaddedBatcher(ds, 2, n_points=64, max_windows=3), "cpu")
        val = DeviceCachedBatcher(PaddedBatcher(
            WindowedCloudDataset(str(folder), ["cloud6.pkl", "cloud7.pkl"]), 2,
            n_points=64, max_windows=3, seed=1), "cpu")
        model = AMPNetSegmenter(cfg.model, generator=torch.Generator().manual_seed(0))
        trainer = Trainer(cfg, model, data, val, str(folder / mode), device="cpu",
                          epoch_dispatch=mode)
        history = trainer.fit(1)
        trainer.close()
        out.append((history, model.state_dict()))
    (h0, s0), (h1, s1) = out
    for split in ("train", "val"):
        for k, v in h0[split][0].items():
            if k not in ("epoch_seconds", "windows_per_sec"):
                assert v == h1[split][0][k] or (np.isnan(v) and np.isnan(h1[split][0][k])), k
    for n in s0:
        assert torch.equal(s0[n], s1[n]), n
    with pytest.raises(ValueError, match="epoch_dispatch"):
        Trainer(cfg, AMPNetSegmenter(cfg.model), data, None, str(folder / "x"), device="cpu",
                epoch_dispatch="on")


# -- the host batcher's prefetch thread and worker pool -------------------------------


def batch_stream(batcher, epochs=2):
    return [b for _ in range(epochs) for b in batcher]


@pytest.mark.parametrize("prefetch, workers", [(2, 0), (2, 2), (0, 2)])
def test_prefetch_and_workers_give_the_synchronous_batches(prefetch, workers, rare):
    _, _, ds, _ = rare
    kw = dict(n_points=48, max_windows=3, seed=2, drop_last=False)  # resampled every epoch
    want = batch_stream(PaddedBatcher(ds, 4, prefetch=0, **kw))
    b = PaddedBatcher(ds, 4, prefetch=prefetch, workers=workers, **kw)
    try:
        got = batch_stream(b)
    finally:
        b.close()
    assert b._pool is None and len(got) == len(want)
    for x, y in zip(got, want):
        assert x["names"] == y["names"]
        for k in ("points", "labels", "centroids"):
            np.testing.assert_array_equal(x[k], y[k])


class _Failing:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        raise OSError(f"sample {i} unreadable")


def test_prefetch_thread_raises_the_producers_error_and_stops_when_abandoned(rare):
    with pytest.raises(OSError, match="sample"):
        list(PaddedBatcher(_Failing(), 2, prefetch=2))
    _, _, ds, _ = rare
    before = threading.active_count()
    it = iter(PaddedBatcher(ds, 1, n_points=64, max_windows=3, prefetch=1))
    next(it)  # the producer now waits on a full queue
    it.close()  # an abandoned iterator: the producer must end
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


# -- the train command ------------------------------------------------------------


def test_train_oversamples_and_weighs_as_jax_computes(rare, capsys):
    """``train --oversample_factor 3 --oversample_classes auto --seg_weighing
    EFS``: the printed lines are the JAX command's, from JAX's functions on
    the same data, and the epoch takes ``len(repeated pool) // batch`` steps."""
    folder, names, _, jds = rare
    reps, rare_cls, n_over = jcli.rare_class_repeats(jds, 3, "auto", 5)
    cw, counts = jcli.seg_class_weights(jds, "EFS", 5, 0.999)
    out = folder / "out"
    assert main(["train", str(folder), "--path_list_files", str(folder), "--out_path", str(out),
                 "--number_of_points", "64", "--number_of_windows", "3", "--batch_size", "2",
                 "--epochs", "1", "--device", "cpu", "--oversample_factor", "3",
                 "--oversample_classes", "auto", "--seg_weighing", "EFS",
                 "--device_cache", "off", "--epoch_dispatch", "off"]) == 0
    err = capsys.readouterr().err
    assert (f"oversampling x3: {n_over}/{len(jds)} train clouds contain rare classes "
            f"{rare_cls}") in err
    assert (f"seg class weights (EFS, counts {counts.tolist()}): "
            f"{[round(float(x), 5) for x in cw]}") in err
    ckpt = str(out / "checkpoints" / "attention_segmentation_best")
    assert int(read_payload(ckpt)["step"]) == int(reps.sum()) // 2
    saved = read_meta(ckpt)["config"]["train"]
    np.testing.assert_allclose(saved["class_weights"], np.asarray(cw), rtol=1e-6)
    assert saved["weighing_method"] == "EFS"


def test_bfloat16_checkpoint_evaluates_in_bfloat16_under_xla(rare, capsys):
    """``train --dtype bfloat16`` records the dtype; restored, the model
    computes in bfloat16 under ``--backend xla`` (its logits), and the other
    backends in their own dtype (float32 under ``fused``); ``test`` runs
    under both."""
    folder, names, _, _ = rare
    out = folder / "bf"
    assert main(["train", str(folder), "--path_list_files", str(folder), "--out_path", str(out),
                 "--number_of_points", "64", "--number_of_windows", "3", "--batch_size", "2",
                 "--epochs", "1", "--device", "cpu", "--dtype", "bfloat16"]) == 0
    ckpt = str(out / "checkpoints" / "attention_segmentation_best")
    assert read_meta(ckpt)["config"]["model"]["dtype"] == "bfloat16"
    cfg, model = load_model(ckpt, device="cpu")
    b = tensors(make_batch(shape=(1, 3, 64)))
    pad = (b["labels"] == -1).all(-1)
    assert make_forward(model, cfg, "xla", "cpu")(b["points"], b["centroids"], pad).dtype \
        == torch.bfloat16
    assert make_forward(model, cfg, "fused", "cpu")(b["points"], b["centroids"], pad).dtype \
        == torch.float32
    capsys.readouterr()
    for backend in ("xla", "fused"):
        assert main(["test", str(folder), "--path_list_files", str(folder), "--model_checkpoint",
                     ckpt, "--out_path", str(folder / f"t_{backend}"), "--backend", backend,
                     "--max_clusters", "3", "--device", "cpu"]) == 0
        out_text = capsys.readouterr().out
        assert json.loads(out_text[out_text.index("{"):out_text.rindex("}") + 1])["miou"] >= 0
    assert os.path.exists(folder / "t_xla" / "IoU-results.csv")
