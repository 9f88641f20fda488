"""The port's training slice against the JAX package on the same inputs and
weights (a Flax init, perturbed, carried across with load_flax_variables):
train-mode BatchNorm, losses, metrics, augmentations, one train step, the
learning-rate schedule, gradient accumulation, the epoch loop, and the data
pipeline's own copies.

How the step comparisons treat gradients near zero: Adam's first update is
about ``lr · sign(g)``, so where |g| is rounding noise its sign, and the
parameter it moves, differ between two correct implementations. A gradient
leaf is held to 1e-4 of its largest |g|; a leaf whose largest |g| is below
1e-7 (the head's dense biases, which the batch-statistics BatchNorm after
them cancels exactly) is held to |g| ≤ 1e-6 in both packages. After a step,
parameters are held to 1e-4 where the reference |g| exceeds max(1e-7, 1e-4 ·
the leaf's largest |g|), the gradient tolerance; elsewhere the sign is not
determined, and the change is held to at most the learning rate.

The inputs give each window its own scale and offset: a batch of like
windows makes the T-Net FC BatchNorms (6 rows here) divide rounding noise by
a small variance (E[x²] − E[x]² cancels), and then two float32
implementations part by more than these tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core import metrics as jmetrics
from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.core.config import TrainConfig as JTrainConfig
from ampnet_tpu.data import schema as jschema
from ampnet_tpu.data.datasets import WindowedCloudDataset as JWindowedCloudDataset
from ampnet_tpu.data.device_cache import DeviceCachedBatcher as JDeviceCachedBatcher
from ampnet_tpu.data.io_utils import save_cloud as j_save_cloud
from ampnet_tpu.data.pipeline import PaddedBatcher as JPaddedBatcher
from ampnet_tpu.data.pipeline import pad_windowed_sample as j_pad_windowed_sample
from ampnet_tpu.models.amp import AMPNetSegmenter as JSegmenter
from ampnet_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from ampnet_tpu.ops import augment as jaug
from ampnet_tpu.train import losses as jlosses
from ampnet_tpu.train.state import AMPTrainState, clone_state, multistep_adam
from ampnet_tpu.train.step import make_step_fns as j_make_step_fns
from ampnet_tpu_torch.core import metrics
from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig, TrainConfig
from ampnet_tpu_torch.core.weights import _get, _leaves, flax_variables, load_flax_variables
from ampnet_tpu_torch.data import schema
from ampnet_tpu_torch.data.datasets import WindowedCloudDataset
from ampnet_tpu_torch.data.device_cache import DeviceCachedBatcher, gather_batch
from ampnet_tpu_torch.data.io_utils import load_cloud, read_split_list, save_cloud, write_split_list
from ampnet_tpu_torch.data.pipeline import PaddedBatcher, pad_windowed_sample, to_device_batch
from ampnet_tpu_torch.models.amp import AMPNetSegmenter
from ampnet_tpu_torch.models.layers import MaskedBatchNorm
from ampnet_tpu_torch.ops import augment
from ampnet_tpu_torch.train import losses
from ampnet_tpu_torch.train.epoch import make_epoch_fns
from ampnet_tpu_torch.train.state import create_train_state
from ampnet_tpu_torch.train.step import make_step_fns, window_pad_mask_from_labels

LR = 1e-3
NOISE = 1e-7  # a gradient below this is rounding noise (see the module docstring)


def _perturbed(variables, seed, noise):
    leaves, treedef = jax.tree.flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    leaves = [l + jax.random.normal(k, l.shape, l.dtype) * noise for k, l in zip(keys, leaves)]
    return jax.tree.unflatten(treedef, leaves)


def make_batch(seed=0, shape=(2, 3, 64)):
    """[B, W, N, 9] points with a scale and an offset per window, labels in
    0..4, and the last window of the last cloud replicate-padded (labels −1)."""
    rng = np.random.default_rng(seed)
    b, w, n = shape
    pts = rng.normal(size=(b, w, n, 9)).astype(np.float32) * 0.5
    pts *= rng.uniform(0.2, 2.0, size=(b, w, 1, 1)).astype(np.float32)
    pts[..., :3] += rng.uniform(-1, 1, size=(b, w, 1, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=(b, w, n)).astype(np.int32)
    pts[-1, -1] = pts[-1, -2]
    labels[-1, -1] = -1
    return {"points": pts, "labels": labels, "centroids": pts[..., :2].mean(axis=2)}


def jax_state(jm, variables, milestones=(150,), spe=1):
    return AMPTrainState.create(
        apply_fn=jm.apply, params=variables["params"], batch_stats=variables["batch_stats"],
        tx=multistep_adam(LR, milestones, 0.5, spe), rng=jax.random.PRNGKey(1),
        epoch=jnp.zeros((), jnp.int32), lr_scale=jnp.ones((), jnp.float32))


def port_state(variables, cfg, spe=1):
    model = AMPNetSegmenter(cfg.model)
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    return create_train_state(cfg, model, spe, "cpu")


def tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def param_grads(model):
    """The model's gradients as a Flax params tree of numpy arrays."""
    named = dict(model.named_parameters())
    out = {}
    for path, _ in _leaves(flax_variables(model)["params"]):
        *mod, leaf = path
        g = named[".".join(mod + ["weight" if leaf == "kernel" else leaf])].grad.numpy()
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = g.T if leaf == "kernel" else g
    return out


def assert_grads_close(ref, got, noise=NOISE):
    for path, g_ref in _leaves(ref):
        g = _get(got, path)
        scale = np.abs(g_ref).max()
        if scale < noise:  # exactly zero in exact arithmetic
            assert np.abs(g).max() <= 10 * noise, path
        else:
            np.testing.assert_allclose(g, g_ref, atol=1e-4 * scale, rtol=0, err_msg=str(path))


def assert_params_after_step(ref_params, got_params, ref_grads, lr=LR):
    for path, p_ref in _leaves(ref_params):
        p, g = _get(got_params, path), np.abs(_get(ref_grads, path))
        determined = g > max(NOISE, 1e-4 * g.max())
        np.testing.assert_allclose(p[determined], p_ref[determined], atol=1e-4, rtol=0,
                                   err_msg=str(path))
        assert np.all(np.abs(p - p_ref)[~determined] <= 2 * lr * (1 + 1e-5)), path


def assert_stats_close(ref_stats, got_stats, atol):
    for path, a in _leaves(ref_stats):
        np.testing.assert_allclose(_get(got_stats, path), a, atol=atol, rtol=0,
                                   err_msg=str(path))


@pytest.fixture(scope="module")
def setup():
    batch = make_batch()
    jcfg = JConfig(model=JModelConfig(dropout=0.0))
    jm = JSegmenter(jcfg.model)
    pad = jnp.asarray((batch["labels"] == -1).all(-1))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["points"]),
                jnp.asarray(batch["centroids"]), pad, train=False)
    return jcfg, jm, _perturbed(v, 5, 0.02), batch


@pytest.fixture(scope="module")
def jax_step(setup):
    """One JAX train step (augment=False): (new state, metrics, grads)."""
    jcfg, jm, v, batch = setup
    step, _ = j_make_step_fns(jcfg, augment=False)
    new, m = step(clone_state(jax_state(jm, v)), {k: jnp.asarray(a) for k, a in batch.items()})
    new = jax.tree.map(np.asarray, new)
    # Adam's first moment after one update is (1 - b1)·g
    grads = jax.tree.map(lambda mu: mu / 0.1, new.opt_state[0].mu)
    return new, jax.tree.map(np.asarray, m), grads


@pytest.fixture(scope="module")
def port_step(setup):
    _, _, v, batch = setup
    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0))
    state = port_state(v, cfg)
    step, _ = make_step_fns(cfg, augment=False)
    m = step(state, tensors(batch))
    return state, {k: t.numpy() for k, t in m.items()}


# -- MaskedBatchNorm in training -------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_train_mode_batchnorm_matches_jax(masked):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 40, 8)) * 2 + 1).astype(np.float32)
    mask = rng.uniform(size=(3, 40)) > 0.3 if masked else None
    scale, bias = rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    ra_mean, ra_var = rng.normal(size=8).astype(np.float32), rng.uniform(0.5, 2, 8).astype(np.float32)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": ra_mean, "var": ra_var}}
    y_j, upd = JMaskedBatchNorm().apply(v, jnp.asarray(x), None if mask is None else jnp.asarray(mask),
                                        mutable=["batch_stats"])
    bn = MaskedBatchNorm(8).train()
    with torch.no_grad():
        for name, a in (("scale", scale), ("bias", bias), ("mean", ra_mean), ("var", ra_var)):
            getattr(bn, name).copy_(torch.from_numpy(a))
    y = bn(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=1e-6)


def test_batchnorm_running_variance_is_biased_with_flax_momentum():
    x = torch.tensor([[0.0], [2.0]])
    bn = MaskedBatchNorm(1).train()
    bn(x)
    # batch mean 1, biased variance 1 (torch's BatchNorm1d would take 2)
    assert bn.mean.item() == pytest.approx(0.1) and bn.var.item() == pytest.approx(1.0)
    bn.eval()
    y = bn(x)  # running statistics in eval
    np.testing.assert_allclose(y.detach().numpy()[:, 0], (np.array([0.0, 2.0]) - 0.1) / np.sqrt(1 + 1e-5),
                               rtol=1e-6)


def test_window_mode_keeps_no_running_statistics():
    bn = MaskedBatchNorm(4, norm_mode="window").train()
    bn(torch.randn(2, 10, 4, generator=torch.Generator().manual_seed(0)))
    assert torch.equal(bn.mean, torch.zeros(4)) and torch.equal(bn.var, torch.ones(4))


# -- losses ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 3, 50, 5)).astype(np.float32) * 2
    targets = rng.integers(-1, 5, size=(2, 3, 50)).astype(np.int32)
    probs = rng.dirichlet(np.ones(5), size=(2, 3, 50)).astype(np.float32)
    return logits, targets, probs, np.asarray((1.0, 2.0, 2.0, 1.0, 1.0), np.float32)


LOSS_CASES = {
    "weighted_cross_entropy": lambda m, lg, t, p, w: m.weighted_cross_entropy(lg, t, w),
    "weighted_cross_entropy_unweighted": lambda m, lg, t, p, w: m.weighted_cross_entropy(lg, t),
    "weighted_cross_entropy_parts": lambda m, lg, t, p, w: m.weighted_cross_entropy_parts(lg, t, w),
    "cross_entropy_weight_sum": lambda m, lg, t, p, w: m.cross_entropy_weight_sum(t, w),
    "weighted_focal": lambda m, lg, t, p, w: m.weighted_focal(lg, t, w, 2.0),
    "weighted_focal_parts": lambda m, lg, t, p, w: m.weighted_focal_parts(lg, t, w, 0.5),
    "distillation_kl": lambda m, lg, t, p, w: m.distillation_kl(lg, p, t, 2.0),
    "distillation_kl_parts": lambda m, lg, t, p, w: m.distillation_kl_parts(lg, p, t, 1.5),
    "orthogonality_regularizer": lambda m, lg, t, p, w: m.orthogonality_regularizer(
        lg.reshape(-1)[: 6 * 25].reshape(6, 5, 5) * 0.3),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_jax(case, loss_inputs):
    logits, targets, probs, w = loss_inputs
    want = LOSS_CASES[case](jlosses, jnp.asarray(logits), jnp.asarray(targets),
                            jnp.asarray(probs), jnp.asarray(w))
    got = LOSS_CASES[case](losses, torch.from_numpy(logits), torch.from_numpy(targets),
                           torch.from_numpy(probs), torch.from_numpy(w))
    got = [float(g) for g in got] if isinstance(got, tuple) else [float(got)]
    np.testing.assert_allclose(got, np.atleast_1d(np.asarray(want, np.float64)), rtol=1e-6,
                               atol=1e-6)


def test_focal_at_gamma_zero_is_the_weighted_ce(loss_inputs):
    logits, targets, _, w = (torch.from_numpy(a) for a in loss_inputs)
    assert float(losses.weighted_focal(logits, targets, w, 0.0)) == pytest.approx(
        float(losses.weighted_cross_entropy(logits, targets, w)), rel=1e-6)


def test_regulariser_gradient_is_finite_at_the_identity():
    a = torch.eye(64).repeat(4, 1, 1).requires_grad_(True)
    reg = losses.orthogonality_regularizer(a)
    reg.backward()
    assert float(reg.detach()) == pytest.approx(1e-6) and torch.isfinite(a.grad).all()


# -- metrics ---------------------------------------------------------------------


@pytest.mark.parametrize("with_mask", [False, True])
def test_confusion_matrix_and_metrics_match_jax(with_mask):
    rng = np.random.default_rng(3)
    preds = rng.integers(0, 5, size=(4, 300)).astype(np.int32)
    targets = rng.integers(-1, 5, size=(4, 300)).astype(np.int32)
    targets[0] = 4  # one class dominant in a row
    mask = (rng.uniform(size=(4, 300)) > 0.2) & (targets >= 0) if with_mask else None
    jm_ = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    cm_j = np.asarray(jmetrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(targets), 5, jm_))
    cm = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(targets), 5, tm)
    assert cm.dtype == torch.int64
    np.testing.assert_array_equal(cm.numpy(), cm_j.astype(np.int64))
    iou_j, valid_j = jmetrics.iou_from_confusion(jnp.asarray(cm_j))
    iou, valid = metrics.iou_from_confusion(cm)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    np.testing.assert_allclose(iou.numpy(), np.asarray(iou_j), rtol=1e-6)
    assert float(metrics.mean_iou(iou, valid)) == pytest.approx(
        float(jmetrics.mean_iou(iou_j, valid_j)), rel=1e-6)
    for fn in ("accuracy",):
        assert float(getattr(metrics, fn)(torch.from_numpy(preds), torch.from_numpy(targets), tm)) \
            == pytest.approx(float(getattr(jmetrics, fn)(jnp.asarray(preds), jnp.asarray(targets), jm_)),
                             rel=1e-6)
    assert float(metrics.balanced_accuracy(torch.from_numpy(preds), torch.from_numpy(targets), 5, tm)) \
        == pytest.approx(float(jmetrics.balanced_accuracy(jnp.asarray(preds), jnp.asarray(targets),
                                                          5, jm_)), rel=1e-6)
    sm = metrics.segmentation_metrics(torch.from_numpy(preds), torch.from_numpy(targets), 5, tm)
    sm_j = jmetrics.segmentation_metrics(jnp.asarray(preds), jnp.asarray(targets), 5, jm_)
    for k in ("miou", "accuracy"):
        assert float(sm[k]) == pytest.approx(float(sm_j[k]), rel=1e-6)


@pytest.mark.parametrize("method", ["EFS", "INS", "ISNS", "sklearn", "none"])
def test_class_weights_match_jax(method):
    counts = [1000, 20, 35, 400, 700]
    want, got = jmetrics.get_class_weights(method, counts), metrics.get_class_weights(method, counts)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


# -- augmentation ----------------------------------------------------------------


@pytest.fixture(scope="module")
def aug_batch():
    b = make_batch(seed=4, shape=(2, 4, 32))
    return b["points"], b["labels"], b["centroids"]


def test_rotate_z_matches_jax_and_keeps_norms(aug_batch):
    pts = aug_batch[0]
    got = augment.rotate_z(torch.from_numpy(pts), angle=1.234).numpy()
    np.testing.assert_allclose(got, np.asarray(jaug.rotate_z(jnp.asarray(pts), angle=1.234)),
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got[..., :2], axis=-1),
                               np.linalg.norm(pts[..., :2], axis=-1), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[..., 2:], pts[..., 2:])  # z and features 3.. unchanged


def test_jitter_scale_shift_match_jax_on_its_draws(aug_batch):
    pts = jnp.asarray(aug_batch[0])
    key = jax.random.PRNGKey(7)
    t = torch.from_numpy(aug_batch[0])
    noise = np.array(jax.random.normal(key, pts[..., :3].shape))
    np.testing.assert_allclose(augment.jitter(t, noise=noise).numpy(),
                               np.asarray(jaug.jitter(pts, key)), atol=1e-6)
    s = float(jax.random.uniform(key, (), minval=0.8, maxval=1.25))
    np.testing.assert_allclose(augment.random_scale(t, scale=s).numpy(),
                               np.asarray(jaug.random_scale(pts, key)), atol=1e-6)
    shift = np.array(jax.random.uniform(key, (3,), minval=-0.1, maxval=0.1))
    np.testing.assert_allclose(augment.random_shift(t, shift=shift).numpy(),
                               np.asarray(jaug.random_shift(pts, key)), atol=1e-6)
    for out in (augment.jitter(t, torch.Generator().manual_seed(0)),
                augment.random_scale(t, torch.Generator().manual_seed(0)),
                augment.random_shift(t, torch.Generator().manual_seed(0))):
        torch.testing.assert_close(out[..., 3:], t[..., 3:], rtol=0, atol=0)


def test_point_dropout_matches_jax_and_labels_follow(aug_batch):
    pts, labels, _ = aug_batch
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    ratio = float(jax.random.uniform(k1, ()) * 0.875)
    u = np.array(jax.random.uniform(k2, pts.shape[:-1]))
    jp, jl = jaug.random_point_dropout(jnp.asarray(pts), key, labels=jnp.asarray(labels))
    p, lb = augment.random_point_dropout(torch.from_numpy(pts), labels=torch.from_numpy(labels),
                                         ratio=ratio, u=u)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(lb.numpy(), np.asarray(jl))
    # a dropped point is the window's first point, label and all
    p, lb = augment.random_point_dropout(torch.from_numpy(pts), torch.Generator().manual_seed(1),
                                         labels=torch.from_numpy(labels))
    moved = (p.numpy() != pts).any(-1)
    np.testing.assert_array_equal(p.numpy()[moved], np.broadcast_to(pts[:, :, :1], pts.shape)[moved])
    np.testing.assert_array_equal(lb.numpy()[moved],
                                  np.broadcast_to(labels[:, :, :1], labels.shape)[moved])


def test_shuffle_windows_matches_jax_on_its_permutation(aug_batch):
    pts, labels, cent = aug_batch
    key = jax.random.PRNGKey(11)
    perm = np.asarray(jax.random.permutation(key, pts.shape[1]))
    want = jaug.shuffle_windows(jnp.asarray(pts), jnp.asarray(labels), key, jnp.asarray(cent))
    got = augment.shuffle_windows(torch.from_numpy(pts), torch.from_numpy(labels),
                                  centroids=torch.from_numpy(cent), perm=perm)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # from a generator: one permutation moves points, labels and centroids together
    p, lb, c = augment.shuffle_windows(torch.from_numpy(pts), torch.from_numpy(labels),
                                       torch.Generator().manual_seed(5), torch.from_numpy(cent))
    for w in range(pts.shape[1]):
        src = next(i for i in range(pts.shape[1]) if np.array_equal(p.numpy()[:, w], pts[:, i]))
        np.testing.assert_array_equal(lb.numpy()[:, w], labels[:, src])
        np.testing.assert_array_equal(c.numpy()[:, w], cent[:, src])


# -- one train step against JAX ----------------------------------------------------


def test_window_pad_mask_from_labels():
    labels = torch.tensor([[[0, 1], [-1, -1], [2, -1]]])
    assert window_pad_mask_from_labels(labels).tolist() == [[False, True, False]]


def test_train_step_loss_and_metrics_match_jax(jax_step, port_step):
    _, jm, _ = jax_step
    _, m = port_step
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    assert float(m["ce_loss"]) == pytest.approx(float(jm["ce_loss"]), abs=1e-5)
    assert float(m["reg_loss"]) == pytest.approx(float(jm["reg_loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    np.testing.assert_array_equal(m["confusion"], jm["confusion"].astype(np.int64))
    assert sorted(m) == sorted(jm)


def test_train_step_gradients_match_jax(jax_step, port_step):
    _, _, jgrads = jax_step
    state, _ = port_step
    assert_grads_close(jax.tree.map(np.asarray, jgrads), param_grads(state.model))


def test_train_step_params_and_bn_statistics_match_jax(jax_step, port_step):
    jnew, _, jgrads = jax_step
    state, _ = port_step
    after = flax_variables(state.model)
    assert_params_after_step(jnew.params, after["params"], jax.tree.map(np.asarray, jgrads))
    assert_stats_close(jnew.batch_stats, after["batch_stats"], atol=1e-5)
    assert state.step == int(jnew.step) == 1


def test_eval_step_matches_jax(setup, jax_step):
    """JAX's weights and running statistics after its step, in both packages'
    eval step: running statistics, no dropout, the data loss only."""
    jcfg, _, _, batch = setup
    jnew, _, _ = jax_step
    _, j_eval = j_make_step_fns(jcfg, augment=False)
    jm, jpreds = j_eval(jnew, {k: jnp.asarray(a) for k, a in batch.items()})
    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0))
    state = port_state({"params": jnew.params, "batch_stats": jnew.batch_stats}, cfg)
    state.model.train()
    m, preds = make_step_fns(cfg, augment=False)[1](state, tensors(batch))
    assert state.model.training  # eval_step puts the model back in the mode it found
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    assert float(m["ce_loss"]) == pytest.approx(float(jm["ce_loss"]), abs=1e-5)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
    np.testing.assert_array_equal(m["confusion"].numpy(), np.asarray(jm["confusion"]).astype(np.int64))


def test_lr_schedule_across_a_milestone(setup):
    """Three steps with steps_per_epoch 1 and milestone 2: optax reads the
    count before it increments it, so updates 0 and 1 take lr and update 2
    takes lr · gamma. Each update is held against optax's on the port's own
    gradients (so no sign is in doubt)."""
    _, jm, v, batch = setup
    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0),
                       train=TrainConfig(learning_rate=LR, lr_milestones=(2,), lr_gamma=0.5))
    state = port_state(v, cfg, spe=1)
    step, _ = make_step_fns(cfg, augment=False)
    tx = multistep_adam(LR, (2,), 0.5, 1)
    params = jax.tree.map(np.asarray, v["params"])
    opt = tx.init(params)
    lrs = []
    for _ in range(3):
        lrs.append(state.learning_rate())
        before = flax_variables(state.model)["params"]
        step(state, tensors(batch))
        updates, opt = tx.update(param_grads(state.model), opt, before)
        after = flax_variables(state.model)["params"]
        for path, u in _leaves(jax.tree.map(np.asarray, updates)):
            np.testing.assert_allclose(_get(after, path) - _get(before, path), u, atol=1e-7,
                                       rtol=0, err_msg=str(path))
    assert lrs == [LR, LR, LR * 0.5]
    assert [float(opt[1].count)] == [3.0] and state.step == 3


def test_lr_scale_multiplies_the_update(setup):
    _, _, v, batch = setup
    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0))
    a, b = port_state(v, cfg), port_state(v, cfg)
    b.scale_lr(0.5)
    step, _ = make_step_fns(cfg, augment=False)
    p0 = flax_variables(a.model)["params"]
    step(a, tensors(batch))
    step(b, tensors(batch))
    pa, pb = flax_variables(a.model)["params"], flax_variables(b.model)["params"]
    for path, x0 in _leaves(p0):
        # to a few float32 ulps of parameters of order 1
        np.testing.assert_allclose(_get(pb, path) - x0, 0.5 * (_get(pa, path) - x0), atol=3e-7)


def test_grad_accum_matches_jax(setup):
    """Four clouds, so each micro-batch's T-Net FC BatchNorms see 6 windows.
    The draw matters: some draws (seed 10) put two windows' pooled T-Net
    features so close that even JAX's scan and a plain sum of its own
    micro-batch gradients part by more than 1e-4 of a leaf's max; seed 11 is
    well conditioned."""
    jcfg, jm, v, _ = setup
    batch = make_batch(seed=11, shape=(4, 3, 64))
    j2, _ = j_make_step_fns(jcfg, augment=False, grad_accum=2)
    jnew, jmt = j2(clone_state(jax_state(jm, v)), {k: jnp.asarray(a) for k, a in batch.items()})
    jnew = jax.tree.map(np.asarray, jnew)
    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0))
    state = port_state(v, cfg)
    m = make_step_fns(cfg, augment=False, grad_accum=2)[0](state, tensors(batch))
    for k in ("loss", "ce_loss"):
        assert float(m[k]) == pytest.approx(float(jmt[k]), abs=1e-5)
    assert float(m["reg_loss"]) == pytest.approx(float(jmt["reg_loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jmt["grad_norm"]), rel=1e-4)
    np.testing.assert_array_equal(m["confusion"].numpy(), np.asarray(jmt["confusion"]).astype(np.int64))
    jgrads = jax.tree.map(lambda mu: np.asarray(mu) / 0.1, jnew.opt_state[0].mu)
    assert_grads_close(jgrads, param_grads(state.model))
    after = flax_variables(state.model)
    assert_params_after_step(jnew.params, after["params"], jgrads)
    # the running statistics chain through both micro-batches
    assert_stats_close(jnew.batch_stats, after["batch_stats"], atol=1e-5)


def test_grad_accum_ce_gradient_equals_the_full_batch_gradient():
    """reg_weight 0 isolates the CE; window-mode BatchNorm makes the trunks'
    micro and full forwards the same function; micro-batches of unequal weight
    mass. The T-Net FC heads keep batch statistics over their micro-batch's
    windows (as in every framework's accumulation); from the zero-initialised
    ``fc_out`` they reach the loss only through ``fc_out.kernel``'s gradient,
    the one leaf left out here. Under window statistics the window context
    (mlp_b, the attention) reaches the head as a per-window constant, which
    the head's window BatchNorm subtracts: those gradients are exactly zero
    and come out as rounding noise of order 1e-7, so the noise floor here
    is 1e-6."""
    batch = make_batch(seed=6, shape=(4, 3, 32))
    batch["labels"][2:, 1:] = -1
    batch["labels"][2:, 0, ::2] = -1
    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0, bn_mode="window"),
                       train=TrainConfig(reg_weight=0.0))
    grads, metric = [], []
    for k in (1, 2):
        model = AMPNetSegmenter(cfg.model, generator=torch.Generator().manual_seed(2))
        state = create_train_state(cfg, model, 1, "cpu")
        metric.append(make_step_fns(cfg, augment=False, grad_accum=k)[0](state, tensors(batch)))
        grads.append(param_grads(model))
    assert float(metric[1]["loss"]) == pytest.approx(float(metric[0]["loss"]), rel=1e-5)
    for g in grads:
        for tnet in ("input_tnet", "feature_tnet"):
            del g["encoder"][tnet]["fc_out"]["kernel"]
    assert_grads_close(grads[0], grads[1], noise=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        make_step_fns(cfg, augment=False, grad_accum=3)[0](state, tensors(batch))


def test_focal_step_reports_true_ce_and_focal_loss(setup):
    _, _, v, batch = setup
    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0), train=TrainConfig(focal_gamma=2.0))
    state = port_state(v, cfg)
    m = make_step_fns(cfg, augment=False)[0](state, tensors(batch))
    assert float(m["focal_loss"]) < float(m["ce_loss"])
    ce_state = port_state(v, AMPNetConfig(model=ModelConfig(dropout=0.0)))
    m_ce = make_step_fns(AMPNetConfig(model=ModelConfig(dropout=0.0)), augment=False)[0](
        ce_state, tensors(batch))
    assert float(m["ce_loss"]) == pytest.approx(float(m_ce["ce_loss"]), rel=1e-6)


@pytest.mark.parametrize("train_kw, says", [
    (dict(distill_alpha=0.0), r"distillation needs 0 < distill_alpha <= 1, got 0\.0"),
    (dict(distill_alpha=1.5), r"distillation needs 0 < distill_alpha <= 1, got 1\.5"),
    (dict(distill_alpha=0.5, distill_temp=0.0), r"distill_temp must be > 0, got 0\.0"),
])
def test_distillation_options_are_checked_as_in_jax(train_kw, says):
    for fn, cfg in ((make_step_fns, AMPNetConfig(train=TrainConfig(**train_kw))),
                    (j_make_step_fns, JConfig(train=JTrainConfig(**train_kw)))):
        with pytest.raises(ValueError, match=says):
            fn(cfg, teacher=[])


def test_unknown_augmentation_is_refused():
    with pytest.raises(ValueError, match="unknown augmentation"):
        make_step_fns(AMPNetConfig(train=TrainConfig(augmentations=("bogus",))))


def test_dropout_and_augmentation_draw_from_the_step_generator():
    """With dropout 0.3 and the full recipe, a step is a function of (seed,
    step): two states from the same weights take the same step, bit for bit;
    another seed takes another."""
    batch = tensors(make_batch(seed=8, shape=(2, 3, 32)))
    recipe = ("shuffle_windows", "rotate_z", "jitter", "scale", "shift", "point_dropout")
    out = []
    for seed in (0, 0, 1):
        cfg = AMPNetConfig(train=TrainConfig(augmentations=recipe, seed=seed))
        model = AMPNetSegmenter(cfg.model, generator=torch.Generator().manual_seed(3))
        state = create_train_state(cfg, model, 1, "cpu")
        m = make_step_fns(cfg)[0](state, batch)
        assert torch.isfinite(m["loss"])
        out.append(flax_variables(model)["params"])
    for path, a in _leaves(out[0]):
        np.testing.assert_array_equal(_get(out[1], path), a)
    assert any(not np.array_equal(_get(out[2], p), a) for p, a in _leaves(out[0]))


def test_dropout_needs_an_explicit_generator():
    model = AMPNetSegmenter(ModelConfig(dropout=0.3)).train()
    b = tensors(make_batch(seed=9, shape=(1, 2, 16)))
    with pytest.raises(ValueError, match="torch.Generator"):
        model(b["points"], b["centroids"])


# -- data pipeline and the epoch loop --------------------------------------------


def write_windowed_dataset(folder, n_clouds, n_windows, n_points, seed=0, points_each=None):
    """kmeans_<name>.npz artifacts ``[N, 13, W]`` and the split lists."""
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n_clouds):
        n = points_each[i] if points_each else n_points
        pc = rng.uniform(0, 1, size=(n, 13, n_windows)).astype(np.float32)
        pc[:, 3, :] = rng.choice([1, 2, 3, 5, 14, 15], size=(n, n_windows))
        save_cloud(str(folder / f"kmeans_c{i}.npz"), pc)
        names.append(f"c{i}.pkl")
    return names


def test_io_utils_round_trip_every_format(tmp_path):
    arr = np.random.default_rng(0).normal(size=(20, 13)).astype(np.float32)
    for ext in (".pkl", ".npy", ".npz", ".pt"):
        save_cloud(str(tmp_path / f"a{ext}"), arr)
        np.testing.assert_array_equal(load_cloud(str(tmp_path / f"a{ext}")), arr)
    j_save_cloud(str(tmp_path / "j.npz"), arr)
    np.testing.assert_array_equal(load_cloud(str(tmp_path / "j.npz")), arr)
    write_split_list(str(tmp_path / "l" / "train_seg_files.txt"), ["a.pkl", "b.pkl"])
    assert read_split_list(str(tmp_path / "l" / "train_seg_files.txt")) == ["a.pkl", "b.pkl"]
    with pytest.raises(ValueError, match="unsupported"):
        load_cloud(str(tmp_path / "a.las"))


def test_schema_matches_jax():
    raw = np.array([-1, 0, 2, 3, 4, 5, 7, 14, 15, 30, 300], np.float32)
    np.testing.assert_array_equal(schema.remap_segmentation_labels(raw),
                                  np.asarray(jschema.remap_segmentation_labels(raw)))
    pc = np.random.default_rng(1).uniform(0, 1, size=(50, 13, 3)).astype(np.float32)
    pc[:, 3, :] = np.random.default_rng(2).choice([1, 2, 7, 14, 15], size=(50, 3))
    for noise in (schema.DATASET_NOISE_CLASSES, schema.REFERENCE_NOISE_CLASSES):
        np.testing.assert_array_equal(schema.drop_noise_points(pc, noise),
                                      jschema.drop_noise_points(pc, noise))
    assert schema.REFERENCE_NOISE_CLASSES == jschema.REFERENCE_NOISE_CLASSES
    assert schema.DATASET_NOISE_CLASSES == jschema.DATASET_NOISE_CLASSES
    assert schema.NUM_CANONICAL_COLS == jschema.NUM_CANONICAL_COLS
    assert schema.COL.CLASS == jschema.COL.CLASS and schema.COL.NDVI == jschema.COL.NDVI


def test_windowed_dataset_and_batcher_match_jax(tmp_path):
    names = write_windowed_dataset(tmp_path, 5, 3, 40, points_each=[40, 30, 50, 40, 45])
    ds, jds = WindowedCloudDataset(str(tmp_path), names), JWindowedCloudDataset(str(tmp_path), names)
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        for k in ("points", "labels", "centroids"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["name"] == b["name"]
    kw = dict(n_points=40, max_windows=4, seed=3, drop_last=False, pad_to_multiple=2)
    port, jax_b = PaddedBatcher(ds, 2, **kw), JPaddedBatcher(jds, 2, prefetch=0, **kw)
    for _ in range(2):  # two epochs: seed + epoch orders
        got, want = list(port), list(jax_b)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for k in ("points", "labels", "centroids"):
                np.testing.assert_array_equal(g[k], w[k])
            assert g["names"] == w["names"]
    sample = ds[1]
    for n, w in ((50, 2), (20, 5)):
        a = pad_windowed_sample(sample, n, w, np.random.default_rng(0))
        b = j_pad_windowed_sample(sample, n, w, np.random.default_rng(0))
        for k in ("points", "labels", "centroids"):
            np.testing.assert_array_equal(a[k], b[k])


def test_device_cache_matches_jax_and_pads_labels(tmp_path):
    names = write_windowed_dataset(tmp_path, 5, 3, 40, points_each=[40, 30, 50, 40, 45])
    kw = dict(n_points=40, max_windows=3, seed=1, drop_last=False, pad_to_multiple=1)
    cache = DeviceCachedBatcher(PaddedBatcher(WindowedCloudDataset(str(tmp_path), names), 2, **kw),
                                "cpu")
    jcache = JDeviceCachedBatcher(JPaddedBatcher(JWindowedCloudDataset(str(tmp_path), names), 2,
                                                 prefetch=0, **kw))
    for k in ("points", "labels", "centroids"):  # resampling fixed at build, as in JAX
        np.testing.assert_array_equal(cache.data[k].numpy(), np.asarray(jcache._data[k]))
    assert cache.names == jcache.names
    for _ in range(2):
        idxs, pads, _ = cache.epoch_index_matrix()
        j_idxs, j_pads, _ = jcache.epoch_index_matrix()
        np.testing.assert_array_equal(idxs, j_idxs)
        np.testing.assert_array_equal(pads, j_pads)
    assert pads[-1].tolist() == [False, True]  # 5 clouds in batches of 2: one pad entry
    out = gather_batch(cache.data, torch.from_numpy(idxs[-1]), torch.from_numpy(pads[-1]))
    assert (out["labels"][1] == -1).all() and (out["labels"][0] >= 0).any()
    batches = list(cache)
    assert [len(b["names"]) for b in batches] == [2, 2, 1]
    dev = to_device_batch({"points": np.zeros((1, 2), np.float32), "names": ["x"]}, "cpu")
    assert list(dev) == ["points"] and dev["points"].device.type == "cpu"


def test_epoch_loop_equals_the_per_step_loop(tmp_path):
    """The epoch loop over the cache's index matrix takes the same steps, bit
    for bit, as a per-step loop over the same batches: each step draws from
    its (seed, step) generator."""
    names = write_windowed_dataset(tmp_path, 4, 3, 32)
    cfg = AMPNetConfig(train=TrainConfig(augmentations=("shuffle_windows", "rotate_z", "jitter")))
    results = []
    for per_step in (False, True):
        cache = DeviceCachedBatcher(PaddedBatcher(WindowedCloudDataset(str(tmp_path), names), 2,
                                                  n_points=32, max_windows=3, seed=0), "cpu")
        model = AMPNetSegmenter(cfg.model, generator=torch.Generator().manual_seed(1))
        state = create_train_state(cfg, model, len(cache), "cpu")
        train_step, eval_step = make_step_fns(cfg)
        train_epoch, eval_epoch = make_epoch_fns(train_step, eval_step)
        if per_step:
            ms = [train_step(state, b) for b in cache]
            ms = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        else:
            idxs, pads, _ = cache.epoch_index_matrix()
            ms = train_epoch(state, cache.data, idxs, pads)
        assert ms["loss"].shape == (2,) and ms["confusion"].shape == (2, 5, 5)
        results.append((flax_variables(model), ms["loss"]))
    for path, a in _leaves(results[0][0]):
        np.testing.assert_array_equal(_get(results[1][0], path), a)
    torch.testing.assert_close(results[0][1], results[1][1], rtol=0, atol=0)


def test_float64_step_keeps_float64_and_tracks_float32(setup):
    """BatchNorm statistics and losses are taken in float32, or in float64
    for a float64 model (the card-against-CPU check in chip_smoke.py)."""
    _, _, v, batch = setup
    cfg = AMPNetConfig(model=ModelConfig(dropout=0.0))
    step, _ = make_step_fns(cfg, augment=False)
    s32, s64 = port_state(v, cfg), port_state(v, cfg)
    s64.model.double()
    m32 = step(s32, tensors(batch))
    b64 = {k: t.double() if t.is_floating_point() else t for k, t in tensors(batch).items()}
    m64 = step(s64, b64)
    assert m64["loss"].dtype == torch.float64 and m32["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float64 for p in s64.model.parameters())
    assert float(m64["loss"]) == pytest.approx(float(m32["loss"]), abs=1e-5)
    assert_grads_close(param_grads(s64.model), param_grads(s32.model))
