"""The GRU, classification and PointNet families of the port against the JAX
package on the same inputs and weights (a Flax init, perturbed, carried
across with ``load_flax_variables``): the forward of every family in eval
and train mode, PointNet++'s sampling and grouping indices, one train step of
the GRU, classic and PointNet++ segmenters and of the attention classifier,
and GRU reference ``.pth`` files in both directions.

Inputs give each window its own scale and offset (``make_batch`` of the
training tests): batch-statistics BatchNorm over few rows of like windows
divides rounding noise by a small variance. The step comparisons follow
``tests/test_torch_train.py``: loss to 1e-5, parameters to 1e-4 where the
gradient determines the first Adam update's sign; a bias that feeds a
batch-statistics BatchNorm has no gradient in exact arithmetic, so its
update, of either sign, is held to the learning rate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import DataConfig as JDataConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.core.torch_export import export_reference_checkpoint
from ampnet_tpu.core.torch_import import import_reference_checkpoint
from ampnet_tpu.models import pointnet2 as jpn2
from ampnet_tpu.models.factory import build_model as j_build_model
from ampnet_tpu.models.pointnet import ClassificationPointNet as JClassificationPointNet
from ampnet_tpu.ops.sampling import farthest_point_sampling as j_fps
from ampnet_tpu.train.cls_step import make_cls_step_fns as j_make_cls_step_fns
from ampnet_tpu.train.step import make_step_fns as j_make_step_fns
from ampnet_tpu.train.state import clone_state
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig
from ampnet_tpu_torch.core.weights import (
    _get,
    _leaves,
    flax_variables,
    load_flax_variables,
    load_reference_pth,
    save_reference_pth,
)
from ampnet_tpu_torch.models import pointnet2
from ampnet_tpu_torch.models.amp import GRUContext
from ampnet_tpu_torch.models.factory import ARCHS, build_model
from ampnet_tpu_torch.models.pointnet import ClassificationPointNet
from ampnet_tpu_torch.ops.sampling import batched_farthest_point_sampling
from ampnet_tpu_torch.train.cls_step import make_cls_step_fns
from ampnet_tpu_torch.train.state import create_train_state
from ampnet_tpu_torch.train.step import make_step_fns
from test_torch_train import (
    LR,
    _perturbed,
    assert_params_after_step,
    assert_stats_close,
    jax_state,
    make_batch,
    tensors,
)

# [B, W, N]: tests/test_variants.py's windows and points, with 6 clouds, so
# that every batch-statistics BatchNorm of the whole-cloud heads (T-Net FC,
# classifier FC) takes 6 rows, as the T-Net FC rows of tests/test_torch_train.py.
# PointNet++ takes 2 clouds of one window: its set-abstraction BatchNorms
# reduce over [B, S, 32, C], and XLA's float32 sum over those axes is about
# 20x less exact than torch's, so at B·W = 18 JAX's own train-mode logits
# are 1e-4 of max|ref| from exact (the port's float64 forward) where the
# port's float32 ones are 1e-5 (test_pointnet2_train_forward_is_exact...).
SHAPE = (6, 3, 64)
PN2_SHAPE = (2, 1, 64)
CASES = [("gru", "segmentation"), ("baseline", "segmentation"), ("classic", "segmentation"),
         ("pointnet2", "segmentation"), ("attention", "classification"),
         ("gru", "classification"), ("baseline", "classification"),
         ("classic", "classification")]
CLS_WEIGHTS = np.array([0.3, 0.7], np.float32)


def _cfgs(windows=SHAPE[1]):
    return (JConfig(data=JDataConfig(max_windows=windows), model=JModelConfig(dropout=0.0)),
            AMPNetConfig(data=DataConfig(max_windows=windows), model=ModelConfig(dropout=0.0)))


def _batch(seed=0, shape=SHAPE):
    """``make_batch`` with a ``cls_label`` per cloud; at one window per cloud
    the last cloud is the replicate-padded one (labels −1)."""
    b, w, n = shape
    batch = make_batch(seed, (b, max(w, 2), n))
    if w == 1:
        batch = {k: np.ascontiguousarray(a[:, :1]) for k, a in batch.items()}
        batch["labels"][-1] = -1
    batch["cls_label"] = (np.arange(b) % 2).astype(np.int32)
    return batch


def _pad_mask(batch):
    return jnp.asarray((batch["labels"] == -1).all(-1))


class _SingleWindowClassifierNoDrop(flax_nn.Module):
    """JAX's ``SingleWindowClassifier`` (same tree: ``net``) at dropout 0."""

    variant: str
    point_dim: int

    @flax_nn.compact
    def __call__(self, points, centroids=None, window_pad_mask=None, point_mask=None,
                 train: bool = False):
        logp, t_feat = JClassificationPointNet(2, self.variant, self.point_dim, dropout=0.0,
                                               name="net")(points[:, 0], None, train=train)
        return logp, t_feat, None


def _jax_model(arch, task, jcfg):
    """The JAX module of the case; the single-window classifiers and
    PointNet++ come without their fixed dropout (0.3, 0.5) so that train mode
    is deterministic."""
    if arch == "pointnet2":
        return jpn2.PointNet2Segmenter(jcfg.model.num_classes, dropout=0.0)
    if arch in ("baseline", "classic") and task == "classification":
        return _SingleWindowClassifierNoDrop(*(("light", 2) if arch == "baseline"
                                               else ("classic", 3)))
    return j_build_model(jcfg, arch, task)


def _port_model(arch, task, cfg, variables):
    model = build_model(cfg, arch, task)
    if arch == "pointnet2":
        model.drop_rate = 0.0
    elif arch in ("baseline", "classic") and task == "classification":
        model.net.drop_rate = 0.0
    return load_flax_variables(model, jax.tree.map(np.asarray, variables))


def _case_batch(arch):
    return _batch(shape=PN2_SHAPE) if arch == "pointnet2" else _batch()


@pytest.fixture(scope="module")
def inits():
    """One perturbed Flax init per case, on the case's batch."""
    jcfg, _ = _cfgs()
    out = {}
    for arch, task in CASES:
        batch = _case_batch(arch)
        jm = _jax_model(arch, task, jcfg)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["points"]),
                    jnp.asarray(batch["centroids"]), _pad_mask(batch), train=False)
        out[arch, task] = (jm, _perturbed(v, 5, 0.02))
    return _batch(), out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arch, task", CASES)
def test_forward_matches_jax(inits, arch, task, train):
    _, models = inits
    batch = _case_batch(arch)
    jm, v = models[arch, task]
    _, cfg = _cfgs()
    args = (jnp.asarray(batch["points"]), jnp.asarray(batch["centroids"]), _pad_mask(batch))
    if train:
        (ref, t_ref, _), upd = jm.apply(v, *args, train=True, mutable=["batch_stats"])
    else:
        ref, t_ref, _ = jm.apply(v, *args, train=False)
    model = _port_model(arch, task, cfg, v).train(train)
    with torch.no_grad():
        got, t_feat, _ = model(torch.from_numpy(batch["points"]),
                               torch.from_numpy(batch["centroids"]),
                               torch.from_numpy(np.array(args[2])))
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max(), rtol=0)
    np.testing.assert_allclose(t_feat.numpy(), np.asarray(t_ref), atol=1e-4)
    if train:
        assert_stats_close(jax.tree.map(np.asarray, upd["batch_stats"]),
                           flax_variables(model)["batch_stats"], atol=1e-5)


def test_pointnet2_train_forward_is_exact_in_float32(inits):
    """The port's float32 train-mode PointNet++ against its own float64
    forward at the forward test's larger batch (6 × 3 windows), where the JAX
    float32 reference is itself 1e-4 of max|ref| from exact: to 3e-5 of
    max|exact| (float32 through 13 layers and 12 batch-statistics
    BatchNorms; measured 1e-5)."""
    _, models = inits
    batch = _batch()
    _, cfg = _cfgs()
    v = models["pointnet2", "segmentation"][1]
    x = torch.from_numpy(batch["points"])
    with torch.no_grad():
        got = _port_model("pointnet2", "segmentation", cfg, v).train()(x)[0]
        exact = _port_model("pointnet2", "segmentation", cfg, v).double().train()(x.double())[0]
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=3e-5 * exact.abs().max().item(),
                               rtol=0)


def test_factory_matches_jax_and_refuses_alike():
    cfg = AMPNetConfig()
    assert ARCHS == ("attention", "gru", "baseline", "classic", "pointnet2")
    for bad in (("transformer++", "segmentation"), ("pointnet2", "classification")):
        with pytest.raises(ValueError) as ours:
            build_model(cfg, *bad)
        with pytest.raises(ValueError) as theirs:
            j_build_model(JConfig(), *bad)
        assert str(theirs.value).split(";")[0] in str(ours.value)
    # the classification head's window mix is [max_windows, 1]; the GRU head is 128 wide
    model = build_model(cfg.replace(data=DataConfig(max_windows=5)), "gru", "classification")
    assert tuple(model.head.mix_kernel.shape) == (5, 1)
    assert build_model(cfg, "gru").head.dense_1.out_features == 128


def test_classification_pointnet_keeps_its_dropout_and_returns_log_probs(inits):
    """The baselines' fixed dropout (0.3) draws from the step generator in
    training only; the output is a log-softmax."""
    batch, models = inits
    jm, v = models["classic", "classification"]
    model = build_model(AMPNetConfig(), "classic", "classification")
    load_flax_variables(model, jax.tree.map(np.asarray, v))
    assert model.net.drop_rate == 0.3 and isinstance(model.net, ClassificationPointNet)
    x = torch.from_numpy(batch["points"])
    # in eval mode: no dropout, the JAX module of the same variant at dropout 0
    jnet = JClassificationPointNet(2, "classic", 3, dropout=0.0)
    ref, _ = jnet.apply({"params": v["params"]["net"], "batch_stats": v["batch_stats"]["net"]},
                        jnp.asarray(batch["points"][:, 0]), train=False)
    with torch.no_grad():
        got = model.eval()(x)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4 * np.abs(ref).max())
    with pytest.raises(ValueError, match="torch.Generator"):
        model.train()(x)
    logp = model(x, generator=torch.Generator().manual_seed(0))[0]
    np.testing.assert_allclose(torch.logsumexp(logp, -1).detach().numpy(), 0.0, atol=1e-6)


# -- PointNet++ indices ------------------------------------------------------------


@pytest.fixture(scope="module")
def cloud_xyz():
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-0.3, 0.3, size=(2, 200, 3)).astype(np.float32)
    xyz[1, 100:110] = xyz[1, 0]  # duplicates: ties in every distance
    return xyz


def test_pointnet2_fps_and_ball_query_indices_equal_jax(cloud_xyz):
    xyz = torch.from_numpy(cloud_xyz)
    fps = batched_farthest_point_sampling(xyz, 64)
    want = np.stack([np.asarray(j_fps(jnp.asarray(c), 64)) for c in cloud_xyz])
    np.testing.assert_array_equal(fps.numpy(), want)
    centers = pointnet2.gather_points(xyz, fps)
    np.testing.assert_array_equal(
        centers.numpy(), np.asarray(jpn2.gather_points(jnp.asarray(cloud_xyz), jnp.asarray(want))))
    for radius, nsample in ((0.1, 32), (0.2, 32), (0.05, 8)):
        got = pointnet2.ball_query(centers, xyz, radius, nsample)
        ref = jpn2.ball_query(jnp.asarray(centers.numpy()), jnp.asarray(cloud_xyz), radius,
                              nsample)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_pointnet2_three_nn_takes_lax_top_k_order(cloud_xyz):
    fine = torch.from_numpy(cloud_xyz)
    coarse = torch.cat([fine[:, :20], fine[:, :5]], dim=1)  # exact ties between indices
    d2 = pointnet2._sqdist(fine, coarse)
    vals, idx = pointnet2.three_nn(d2)
    neg, ref = jax.lax.top_k(-jnp.asarray(d2.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


# -- one train step ------------------------------------------------------------------


STEP_CASES = {
    # name: (arch, task, [B, W, N]). A max-pool routes its whole gradient to
    # one point: where two candidates lie within float32 rounding of each
    # other, two correct float32 implementations route it to different
    # points, and a gradient leaf moves by O(1) of its largest entry. Classic
    # (1024-channel pools) and PointNet++ (a pool per group) meet such ties
    # often; their steps are compared where neither package meets one (JAX's
    # and the port's float64 step agree there to 2e-5 of each leaf's largest
    # entry): classic at 8 clouds of 16 points (8 rows for the T-Net FC
    # BatchNorms), PointNet++ at PN2_SHAPE.
    "gru": ("gru", "segmentation", (4, 3, 64)),
    "classic": ("classic", "segmentation", (8, 1, 16)),
    "pointnet2": ("pointnet2", "segmentation", PN2_SHAPE),
    "cls_attention": ("attention", "classification", (8, 3, 64)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    arch, task, shape = STEP_CASES[case]
    batch = _batch(seed=0, shape=shape)
    jcfg, cfg = _cfgs(shape[1])
    jm = _jax_model(arch, task, jcfg)
    v = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["points"]),
                           jnp.asarray(batch["centroids"]), _pad_mask(batch), train=False),
                   5, 0.02)
    cls = task == "classification"
    j_step = (j_make_cls_step_fns(jcfg, CLS_WEIGHTS, augment=False) if cls
              else j_make_step_fns(jcfg, augment=False))[0]
    jnew, jmetrics = j_step(clone_state(jax_state(jm, v)),
                            {k: jnp.asarray(a) for k, a in batch.items()})
    jnew = jax.tree.map(np.asarray, jnew)
    jgrads = jax.tree.map(lambda mu: np.asarray(mu) / 0.1, jnew.opt_state[0].mu)

    state = create_train_state(cfg, _port_model(arch, task, cfg, v), 1, "cpu")
    step = (make_cls_step_fns(cfg, CLS_WEIGHTS, augment=False) if cls
            else make_step_fns(cfg, augment=False))[0]
    m = step(state, tensors(batch))
    assert float(m["loss"]) == pytest.approx(float(jmetrics["loss"]), abs=1e-5)
    assert float(m["ce_loss"]) == pytest.approx(float(jmetrics["ce_loss"]), abs=1e-5)
    np.testing.assert_array_equal(m["confusion"].numpy(),
                                  np.asarray(jmetrics["confusion"]).astype(np.int64))
    after = flax_variables(state.model)
    cancelled = [path for path, _ in _leaves(jnew.params) if _bias_before_batch_norm(jnew.params, path)]
    for path in cancelled:  # no gradient in exact arithmetic: the sign of its rounding decides
        step = np.abs(_get(after["params"], path) - _get(jnew.params, path))
        assert np.all(step <= 2 * LR * (1 + 1e-5)), path
    keep = lambda tree: _tree_without(tree, cancelled)
    assert_params_after_step(keep(jnew.params), keep(after["params"]), keep(jgrads))
    assert_stats_close(jnew.batch_stats, after["batch_stats"], atol=1e-5)


def _bias_before_batch_norm(params, path) -> bool:
    """A dense bias whose layer feeds a batch-statistics BatchNorm: the
    normalisation removes it, so its exact gradient is 0 (the classic
    family's biased convs and FCs, the segmentation head's dense layers)."""
    *parent, mod, leaf = path
    if leaf != "bias":
        return False
    siblings = _get(params, tuple(parent))
    if mod == "dense":
        return "bn" in siblings
    return any(mod.startswith(a) and b + mod[len(a):] in siblings
               for a, b in (("fc_", "fc_bn_"), ("fc_", "bn_"), ("head_", "bn_"),
                            ("dense_", "bn_")))


def _tree_without(tree, paths):
    out = {}
    for path, leaf in _leaves(tree):
        if path not in paths:
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = leaf
    return out


def test_classification_eval_step_matches_jax(inits):
    batch, models = inits
    jm, v = models["gru", "classification"]
    jcfg, cfg = _cfgs()
    j_eval = j_make_cls_step_fns(jcfg, CLS_WEIGHTS)[1]
    jm_, jpreds = j_eval(jax_state(jm, v), {k: jnp.asarray(a) for k, a in batch.items()})
    state = create_train_state(cfg, _port_model("gru", "classification", cfg, v), 1, "cpu")
    m, preds = make_cls_step_fns(cfg, CLS_WEIGHTS)[1](state, tensors(batch))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
    np.testing.assert_allclose(m["pos_prob"].numpy(), np.asarray(jm_["pos_prob"]), atol=1e-5)
    assert float(m["loss"]) == pytest.approx(float(jm_["loss"]), abs=1e-5)
    assert state.model.training  # the eval step puts the mode back


# -- GRU reference .pth ----------------------------------------------------------------


@pytest.fixture(scope="module")
def gru_variables(inits):
    return jax.tree.map(np.asarray, inits[1]["gru", "segmentation"][1])


def _reference_gru_pth(variables, path, seed=0):
    """A reference-layout GRU ``.pth`` (JAX's export) whose ``bias_hh`` is not
    zero for r and z, as torch's own ``nn.GRU`` training leaves it."""
    export_reference_checkpoint(variables, str(path), arch="gru",
                                meta={"number_of_points": 64})
    ckpt = torch.load(path, weights_only=False)
    bhh = ckpt["segmen_net"]["gru_global.bias_hh_l0"]
    ckpt["segmen_net"]["gru_global.bias_hh_l0"] = torch.from_numpy(
        np.random.default_rng(seed).normal(size=bhh.shape).astype(np.float32))
    torch.save(ckpt, path)
    return str(path)


def test_gru_pth_imports_to_jax_arrays_exactly(gru_variables, tmp_path):
    path = _reference_gru_pth(gru_variables, tmp_path / "gru.pth")
    ours, meta = load_reference_pth(path)
    ref, jmeta = import_reference_checkpoint(path)
    for coll in ("params", "batch_stats"):
        got = dict(_leaves(ours[coll]))
        want = dict(_leaves(jax.tree.map(np.asarray, ref[coll])))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    for k in ("arch", "point_dim", "global_feat", "gru_hidden", "number_of_points"):
        assert meta[k] == jmeta[k], k
    assert meta["arch"] == "gru" and meta["gru_hidden"] == 64


def test_gru_export_matches_jax_and_round_trips_bitwise(gru_variables, tmp_path):
    save_reference_pth(gru_variables, str(tmp_path / "ours.pth"), meta={"number_of_points": 64})
    export_reference_checkpoint(gru_variables, str(tmp_path / "jax.pth"), arch="gru",
                                meta={"number_of_points": 64})
    ours, ref = (torch.load(tmp_path / f, weights_only=False) for f in ("ours.pth", "jax.pth"))
    for group in ("base_pointnet", "segmen_net"):
        assert list(ours[group]) == list(ref[group])
        for k, t in ref[group].items():
            assert ours[group][k].dtype == t.dtype and torch.equal(ours[group][k], t), k
    back, _ = load_reference_pth(str(tmp_path / "ours.pth"))
    for coll in ("params", "batch_stats"):
        for path, a in _leaves(gru_variables[coll]):
            b = dict(_leaves(back[coll]))[path]
            assert np.array_equal(a, b), path


def test_gru_context_matches_torch_nn_gru(gru_variables, tmp_path):
    """The port's GRU cell against ``torch.nn.GRU`` loaded from the exported
    ``.pth`` (summed r/z biases in ``bias_ih``, 0 in ``bias_hh``)."""
    save_reference_pth(gru_variables, str(tmp_path / "m.pth"))
    sd = torch.load(tmp_path / "m.pth", weights_only=True)["segmen_net"]
    g, h = gru_variables["params"]["context"]["gru"]["ir"]["kernel"].shape
    gru = torch.nn.GRU(g, h, batch_first=True)
    gru.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items() if k.startswith("gru_global.")})
    ctx = GRUContext(ModelConfig(), torch.Generator().manual_seed(0))
    load_flax_variables(ctx, {"params": {"gru": gru_variables["params"]["context"]["gru"]}})
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 9, g)).astype(np.float32))
    with torch.no_grad():
        want, _ = gru(x)
        got, _ = ctx(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
