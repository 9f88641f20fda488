"""Training with the geometry blocks and in-step distillation, the port against
the JAX package on the same weights and batches: one train step of an edge +
geometry-token model, and one step of a plain 9-column student distilled from
a cross-family teacher set (two stacked 15-column attention teachers and a
9-column GRU teacher), each under ``grad_accum`` 1 and 2 (loss 1e-5,
gradients 1e-4 of each leaf's largest, parameters 1e-4: the ROADMAP parity
rules, as tests/test_torch_train.py holds them); the teachers' probabilities
alone; and ``train --distill_from`` end to end on the CPU.

The batches hold no duplicate point within a window: the edge block's
max-pool over neighbours would tie there, and two correct implementations
route such a gradient apart. Near-ties do the same in float32: the edge
block adds a max-pool over 8 neighbours per point and channel, and on some
draws a maximum lies within float32 rounding of a second one, where either
package's float32 step may route that gradient to the other point (JAX's
own float32 step moves with XLA's host thread partitioning there, which the
8 virtual devices of tests/conftest.py change) and lands up to 1e-2 of a
leaf's largest from the float64 step. ``geom_batch`` seeds 0 and 2 at
[2, 3, 64] and 0 to 4 at [4, 3, 64] are such draws (seed 0 also parts the
6-row T-Net BatchNorms by 1.2e-4); the two below are free of them, and the
port's float64 step is held to JAX's as well, which a near-tie would break."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import DataConfig as JDataConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.core.config import TrainConfig as JTrainConfig
from ampnet_tpu.models.factory import build_model as j_build_model
from ampnet_tpu.train.distill import make_teacher_fn as j_make_teacher_fn
from ampnet_tpu.train.state import AMPTrainState, clone_state, multistep_adam
from ampnet_tpu.train.step import make_step_fns as j_make_step_fns
from ampnet_tpu_torch.cli.main import main
from ampnet_tpu_torch.core.checkpoint import CheckpointManager
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig, TrainConfig
from ampnet_tpu_torch.core.weights import _get, _leaves, flax_variables, load_flax_variables
from ampnet_tpu_torch.data.io_utils import save_cloud, write_split_list
from ampnet_tpu_torch.models.amp import knn_indices
from ampnet_tpu_torch.models.factory import build_model
from ampnet_tpu_torch.train.distill import make_teacher_fn
from ampnet_tpu_torch.train.state import create_train_state
from ampnet_tpu_torch.train.step import make_step_fns
from test_torch_geometry import _jax_knn
from test_torch_train import (
    LR,
    _perturbed,
    assert_grads_close,
    assert_params_after_step,
    make_batch,
    param_grads,
    tensors,
)

MODEL = dict(global_feat=64, att_heads=4, dropout=0.0, local_agg_k=8)
GEOM_DATA = dict(extra_features=6)
DISTILL = dict(distill_alpha=0.4, distill_temp=2.0)


def geom_batch(seed, shape):
    """tests/test_torch_train.py's batch (a scale and an offset per window,
    the last window replicate-padded) with 6 geometric columns in [0, 1]."""
    batch = make_batch(seed=seed, shape=shape)
    geo = np.random.default_rng(seed + 100).uniform(size=(*shape, 6)).astype(np.float32)
    geo[-1, -1] = geo[-1, -2]
    batch["points"] = np.concatenate([batch["points"], geo], axis=-1)
    return batch


def pair(arch, seed, data=None, jtrain=None, **model_kw):
    """(JAX config, module, perturbed variables, port config, port model) of
    one architecture; ``data``: DataConfig fields of both."""
    mkw, data = {**MODEL, **model_kw}, data or {}
    jcfg = JConfig(data=JDataConfig(**data), model=JModelConfig(**mkw),
                   train=JTrainConfig(**(jtrain or {})))
    jm = j_build_model(jcfg, arch)
    width = 9 + data.get("extra_features", 0)
    x = jnp.asarray(np.random.default_rng(seed).normal(size=(1, 3, 32, width)), jnp.float32)
    v = _perturbed(jm.init(jax.random.PRNGKey(seed), x, x[..., :2].mean(2), None), seed, 0.02)
    cfg = AMPNetConfig(data=DataConfig(**data), model=ModelConfig(**mkw),
                       train=TrainConfig(**(jtrain or {})))
    model = load_flax_variables(build_model(cfg, arch), jax.tree.map(np.asarray, v))
    return jcfg, jm, v, cfg, model


def j_state(jm, v):
    return AMPTrainState.create(
        apply_fn=jm.apply, params=v["params"], batch_stats=v["batch_stats"],
        tx=multistep_adam(LR, (150,), 0.5, 1), rng=jax.random.PRNGKey(1),
        epoch=jnp.zeros((), jnp.int32), lr_scale=jnp.ones((), jnp.float32))


def steps_agree(jcfg, jm, v, cfg, model, batch, grad_accum, teacher=None, port_teacher=None,
                dtype=torch.float32):
    """One step of each package from the same weights on ``batch`` (the
    port's in ``dtype``): the metrics, gradients, parameters and BatchNorm
    statistics (to 1e-5 relative and absolute: the head's variances run to
    1.4, and E[x²] − E[x]² over a micro-batch cancels in float32)."""
    step, _ = j_make_step_fns(jcfg, augment=False, grad_accum=grad_accum, teacher=teacher)
    jnew, jm_ = step(clone_state(j_state(jm, v)), {k: jnp.asarray(a) for k, a in batch.items()})
    jnew = jax.tree.map(np.asarray, jnew)
    jgrads = jax.tree.map(lambda mu: np.asarray(mu) / 0.1, jnew.opt_state[0].mu)
    state = create_train_state(cfg, model.to(dtype), 1, "cpu")
    cast = {k: t.to(dtype) if t.is_floating_point() else t for k, t in tensors(batch).items()}
    m = make_step_fns(cfg, augment=False, grad_accum=grad_accum, teacher=port_teacher)[0](
        state, cast)
    assert sorted(m) == sorted(jm_)
    for k in ("loss", "ce_loss", "distill_loss"):
        if k in m:
            assert float(m[k]) == pytest.approx(float(jm_[k]), abs=1e-5), k
    assert float(m["reg_loss"]) == pytest.approx(float(jm_["reg_loss"]), rel=1e-5)
    np.testing.assert_array_equal(m["confusion"].numpy(),
                                  np.asarray(jm_["confusion"]).astype(np.int64))
    assert_grads_close(jgrads, jax.tree.map(lambda g: g.astype(np.float32),
                                            param_grads(state.model)))
    after = flax_variables(state.model)
    assert_params_after_step(jnew.params, after["params"], jgrads)
    for path, a in _leaves(jnew.batch_stats):
        np.testing.assert_allclose(_get(after["batch_stats"], path), a, rtol=1e-5, atol=1e-5,
                                   err_msg=str(path))
    return m


@pytest.mark.parametrize("grad_accum, seed, shape", [(1, 1, (2, 3, 64)), (2, 5, (4, 3, 64))])
def test_edge_and_token_train_step_matches_jax(grad_accum, seed, shape):
    """Float32 and float64 steps of the port against JAX's float32 step; the
    kNN picks JAX's neighbours on every window."""
    batch = geom_batch(seed, shape)
    coords = batch["points"][..., :3].reshape(-1, shape[2], 3)
    np.testing.assert_array_equal(knn_indices(torch.from_numpy(coords), None, 8).numpy(),
                                  _jax_knn(coords, None, 8))
    for dtype in (torch.float32, torch.float64):
        jcfg, jm, v, cfg, model = pair("attention", 1, GEOM_DATA, local_agg="edge",
                                       att_geom_tokens=True)
        steps_agree(jcfg, jm, v, cfg, model, batch, grad_accum, dtype=dtype)


@pytest.fixture(scope="module")
def teachers():
    """Two stacked 15-column attention teachers (one group) and a 9-column
    GRU teacher, in both packages' group forms."""
    a1, a2 = (pair("attention", s, GEOM_DATA) for s in (2, 3))
    g = pair("gru", 4, context="gru")
    jax_groups = [(a1[0], a1[1], [a1[2], a2[2]]), (g[0], g[1], g[2])]
    port_groups = [(a1[3], [a1[4], a2[4]]), (g[3], [g[4]])]
    return jax_groups, port_groups


def test_teacher_probabilities_match_jax(teachers):
    """Tempered softmax averaged over all three members, each group reading
    its own column prefix; a batch narrower than a teacher is refused."""
    jax_groups, port_groups = teachers
    batch = geom_batch(5, (2, 3, 32))
    pad = (batch["labels"] == -1).all(-1)
    want = np.asarray(j_make_teacher_fn(jax_groups, 2.0)(
        jnp.asarray(batch["points"]), jnp.asarray(batch["centroids"]), jnp.asarray(pad), None))
    fn = make_teacher_fn(port_groups, 2.0)
    got = fn(torch.from_numpy(batch["points"]), torch.from_numpy(batch["centroids"]),
             torch.from_numpy(pad), None)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="teacher expects 15 feature columns but the batch "
                                         "carries 9"):
        fn(torch.from_numpy(batch["points"][..., :9]), None, None, None)


@pytest.mark.parametrize("grad_accum, seed, shape", [(1, 0, (2, 3, 64)), (2, 11, (4, 3, 64))])
def test_distillation_step_matches_jax(teachers, grad_accum, seed, shape):
    """A plain 9-column student on a 15-column batch: it reads its prefix;
    ``(1 − α)·CE + α·T²·KL``, over the global valid count under
    ``grad_accum``; the ``distill_loss`` metric."""
    jax_groups, port_groups = teachers
    jcfg, jm, v, cfg, model = pair("attention", 6, jtrain=DISTILL)
    m = steps_agree(jcfg, jm, v, cfg, model, geom_batch(seed, shape), grad_accum,
                    teacher=jax_groups, port_teacher=port_groups)
    assert float(m["distill_loss"]) > 0
    assert model.encoder.mlp_a.mlp_0.dense.in_features == 12  # 3 + the student's 9


def _write_geom_dataset(folder, n_clouds=6, n_points=40, n_windows=3, seed=0):
    """kmeans_<name>.npz artifacts [N, 19, W] (13 columns + 6 geometric) and
    the split lists."""
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n_clouds):
        pc = rng.uniform(size=(n_points, 19, n_windows)).astype(np.float32)
        pc[:, 3] = np.where(pc[:, 2] > 0.7, 15, np.where(pc[:, 9] > 0.5, 5, 1))
        save_cloud(str(folder / f"kmeans_cloud{i}.npz"), pc)
        names.append(f"cloud{i}.pkl")
    write_split_list(str(folder / "train_seg_files.txt"), names[:4])
    write_split_list(str(folder / "val_seg_files.txt"), names[4:])


def test_batchers_and_device_cache_carry_15_columns(tmp_path):
    """The windowed dataset with ``extra_features=6``, ``PaddedBatcher`` and
    the device cache carry the 15 columns, equal to JAX's on the same
    artifacts (resampling and window padding included)."""
    from ampnet_tpu.data.datasets import WindowedCloudDataset as JWindowedCloudDataset
    from ampnet_tpu.data.device_cache import DeviceCachedBatcher as JDeviceCachedBatcher
    from ampnet_tpu.data.pipeline import PaddedBatcher as JPaddedBatcher
    from ampnet_tpu_torch.data.datasets import WindowedCloudDataset
    from ampnet_tpu_torch.data.device_cache import DeviceCachedBatcher
    from ampnet_tpu_torch.data.pipeline import PaddedBatcher

    _write_geom_dataset(tmp_path, n_clouds=5, n_points=30)
    names = [f"cloud{i}.pkl" for i in range(5)]
    kw = dict(n_points=40, max_windows=4, seed=1, drop_last=False, pad_to_multiple=1)
    port = PaddedBatcher(WindowedCloudDataset(str(tmp_path), names, extra_features=6), 2, **kw)
    jax_b = JPaddedBatcher(JWindowedCloudDataset(str(tmp_path), names, extra_features=6), 2,
                           prefetch=0, **kw)
    for a, b in zip(port, jax_b):
        assert a["points"].shape[1:] == (4, 40, 15)
        for k in ("points", "labels", "centroids"):
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    cache = DeviceCachedBatcher(port, "cpu")
    jcache = JDeviceCachedBatcher(jax_b)
    np.testing.assert_array_equal(cache.data["points"].numpy(), np.asarray(jcache._data["points"]))
    assert cache.data["points"].shape[-1] == 15


def _ckpt(root, name, cfg, model):
    return CheckpointManager(str(root)).save(name, create_train_state(cfg, model, 1, "cpu"),
                                             config_json=cfg.to_json())


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_distill_from_a_cross_family_pair(teachers, tmp_path, capsys, grad_accum):
    """``train --distill_from <geometry attention>,<gru>`` of a plain student:
    the batch widens to 15 columns, the student keeps its 9, and the epoch
    CSV carries ``distill_loss``."""
    _, port_groups = teachers
    _write_geom_dataset(tmp_path)
    (a_cfg, (a_model, _)), (g_cfg, (g_model,)) = port_groups
    a = _ckpt(tmp_path / "t", "geom", a_cfg, a_model)
    g = _ckpt(tmp_path / "t", "gru", g_cfg, g_model)
    out = tmp_path / "out"
    assert main(["train", str(tmp_path), "--path_list_files", str(tmp_path), "--out_path",
                 str(out), "--number_of_points", "16", "--number_of_windows", "3",
                 "--batch_size", "2", "--epochs", "1", "--device", "cpu",
                 "--grad_accum", str(grad_accum), "--distill_from", f"{a},{g}"]) == 0
    err = capsys.readouterr().err
    assert "distilling from 2 teacher member(s) in 2 group(s): alpha=0.5, T=2.0" in err
    assert "teacher reads 6 extra geom columns" in err and "own 9-column schema" in err
    rows = (out / "logs" / "attention_segmentation_train" / "scalars.csv").read_text()
    distill = [float(r.split(",")[-1]) for r in rows.splitlines() if ",distill_loss," in r]
    assert len(distill) == 1 and distill[0] > 0 and np.isfinite(distill[0])
    meta = json.loads((out / "checkpoints" / "attention_segmentation_best" / "meta.json")
                      .read_text())
    assert meta["config"]["data"]["extra_features"] == 0
    assert meta["config"]["train"]["distill_alpha"] == 0.5
    assert main(["train", str(tmp_path), "--task", "classification", "--device", "cpu",
                 "--distill_from", a]) == 1
    assert ("--distill_from is segmentation-only (per-point soft targets)"
            in capsys.readouterr().err)
