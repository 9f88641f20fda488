"""The port's AMP-Net model and inference backends against the JAX package on
the same inputs and the same weights (a Flax init, perturbed, carried across
with load_flax_variables); reference .pth round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.core.torch_export import export_reference_checkpoint
from ampnet_tpu.models.amp import AMPNetSegmenter as JSegmenter
from ampnet_tpu.models.backends import make_forward as j_make_forward
from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig
from ampnet_tpu_torch.core.weights import (
    flax_variables,
    load_flax_variables,
    load_reference_pth,
    save_reference_pth,
)
from ampnet_tpu_torch.models.amp import AMPNetSegmenter
from ampnet_tpu_torch.models.backends import make_forward


def _perturbed(variables, seed, noise):
    leaves, treedef = jax.tree.flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    leaves = [l + jax.random.normal(k, l.shape, l.dtype) * noise for k, l in zip(keys, leaves)]
    return jax.tree.unflatten(treedef, leaves)


def _port(variables, cfg=None):
    model = AMPNetSegmenter((cfg or ModelConfig(dropout=0.0)))
    return load_flax_variables(model, jax.tree.map(np.asarray, variables)).eval()


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def golden():
    data = np.load("tests/golden/amp_forward.npz")
    jm = JSegmenter(JModelConfig(dropout=0.0))
    pts, cent, pad = data["points"], data["centroids"], data["pad"]
    v = jm.init(jax.random.PRNGKey(42), jnp.asarray(pts), jnp.asarray(cent),
                jnp.asarray(pad), train=False)
    return jm, _perturbed(v, 7, 0.03), (pts, cent, pad), (data["logits"], data["attw"])


@pytest.fixture(scope="module")
def setup():
    """tests/test_backends.py's model, inputs and perturbed weights."""
    rng = np.random.default_rng(0)
    cfg = JConfig(model=JModelConfig(dropout=0.0))
    jm = JSegmenter(cfg.model)
    pts = jnp.asarray(rng.normal(size=(2, 3, 128, 9)).astype(np.float32) * 0.5)
    cent = jnp.asarray(rng.normal(size=(2, 3, 2)).astype(np.float32))
    pad = jnp.zeros((2, 3), bool).at[:, 2].set(True)
    v = _perturbed(jm.init(jax.random.PRNGKey(0), pts, cent, pad, train=False), 5, 0.05)
    model = _port(v)
    ref = np.asarray(j_make_forward(jm, cfg, "xla")(v, pts, cent, pad))
    return cfg, jm, v, model, (pts, cent, pad), ref


def test_xla_forward_matches_jax_on_golden_inputs(golden):
    jm, v, (pts, cent, pad), (gold_logits, gold_attw) = golden
    jl, _, jw = jm.apply(v, jnp.asarray(pts), jnp.asarray(cent), jnp.asarray(pad), train=False)
    with torch.inference_mode():
        logits, t_feat, attw = _port(v)(*_t(pts, cent, pad))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(attw.numpy(), np.asarray(jw), atol=1e-4)
    # and the snapshot tests/test_golden.py pins for the JAX model
    np.testing.assert_allclose(logits.numpy(), gold_logits, atol=1e-4)
    np.testing.assert_allclose(attw.numpy(), gold_attw, atol=1e-4)
    assert t_feat.shape == (2, 3, 64, 64)


@pytest.mark.parametrize("backend,tol", [("folded", 2e-4), ("fused", 2e-4)])
def test_backend_matches_jax_backend(setup, backend, tol):
    """fp32 folded/fused against the same JAX backend (the JAX 'fused' runs
    its Pallas kernel in interpret mode)."""
    cfg, jm, v, model, (pts, cent, pad), _ = setup
    jref = np.asarray(j_make_forward(jm, cfg, backend, interpret=True)(v, pts, cent, pad))
    out = make_forward(model, AMPNetConfig(), backend, device="cpu")(*_t(pts, cent, pad))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jref, atol=tol, rtol=tol)


def test_fused_tracks_jax_xla(setup):
    cfg, jm, v, model, (pts, cent, pad), ref = setup
    out = make_forward(model, AMPNetConfig(), "fused", device="cpu")(*_t(pts, cent, pad)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-3, rtol=5e-3)
    assert (out.argmax(-1) == ref.argmax(-1)).mean() > 0.999


def test_int8_matches_jax_int8(setup):
    """int8 against the JAX int8 backend (its Pallas kernel in interpret
    mode), given the same weights: the same quantization, so near-identical
    logits."""
    cfg, jm, v, model, (pts, cent, pad), _ = setup
    jref = np.asarray(j_make_forward(jm, cfg, "int8", interpret=True)(v, pts, cent, pad))
    out = make_forward(model, AMPNetConfig(), "int8", device="cpu")(*_t(pts, cent, pad))
    assert out.dtype == torch.float32 and out.shape == jref.shape
    np.testing.assert_allclose(out.numpy(), jref, atol=2e-2, rtol=0)
    assert (out.numpy().argmax(-1) == jref.argmax(-1)).mean() >= 0.999


def test_int8_prediction_agreement(setup):
    """int8 against JAX xla, at tests/test_backends.py's limit."""
    cfg, jm, v, model, (pts, cent, pad), ref = setup
    out = make_forward(model, AMPNetConfig(), "int8", device="cpu")(*_t(pts, cent, pad))
    assert (out.numpy().argmax(-1) == ref.argmax(-1)).mean() > 0.97


def test_bf16_prediction_agreement(setup):
    cfg, jm, v, model, (pts, cent, pad), ref = setup
    out = make_forward(model, AMPNetConfig(), "bf16", device="cpu")(*_t(pts, cent, pad))
    assert out.dtype == torch.float32  # logits come back fp32
    np.testing.assert_allclose(out.numpy(), ref, atol=0.15, rtol=0.15)
    assert (out.numpy().argmax(-1) == ref.argmax(-1)).mean() > 0.99


def test_backend_refusals():
    model = AMPNetSegmenter(ModelConfig())
    with pytest.raises(ValueError, match="unknown backend"):
        make_forward(model, AMPNetConfig(), "fp4", device="cpu")
    forward = make_forward(model, AMPNetConfig(), "int8", device="cpu")  # int8 builds on the CPU
    assert forward(torch.zeros(1, 2, 8, 9), torch.zeros(1, 2, 2), None).shape == (1, 2, 8, 5)
    wcfg = AMPNetConfig(model=ModelConfig(bn_mode="window"))
    wmodel = AMPNetSegmenter(wcfg.model)
    for backend in ("folded", "bf16", "fused", "int8"):
        with pytest.raises(ValueError, match="bn_mode"):
            make_forward(wmodel, wcfg, backend, device="cpu")
    make_forward(wmodel, wcfg, "xla", device="cpu")  # the module path stays available
    for field, value in (("local_agg", "edge"), ("att_geom_tokens", True)):
        for backend in ("fused", "int8"):
            with pytest.raises(ValueError, match=field):
                make_forward(model, AMPNetConfig(model=ModelConfig(**{field: value})), backend,
                             device="cpu")


def test_unported_model_options_raise():
    for kw in ({"local_agg": "edge"}, {"att_geom_tokens": True},
               {"context": "gru", "att_geom_tokens": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item 4b"):
            AMPNetSegmenter(ModelConfig(**kw))
    AMPNetSegmenter(ModelConfig(context="gru"))  # the GRU context is ported
    # training mode runs (the training slice); its dropout draws only from
    # an explicit generator
    model = AMPNetSegmenter(ModelConfig()).train()
    with pytest.raises(ValueError, match="torch.Generator"):
        model(torch.zeros(1, 2, 8, 9))
    logits, _, _ = model(torch.zeros(1, 2, 8, 9), generator=torch.Generator().manual_seed(0))
    assert logits.shape == (1, 2, 8, 5) and torch.isfinite(logits).all()


def test_window_bn_mode_matches_jax(rng):
    """bn_mode='window' eval normalizes per window; the xla path carries it."""
    jcfg = JModelConfig(dropout=0.0, bn_mode="window")
    jm = JSegmenter(jcfg)
    pts = rng.normal(size=(1, 2, 32, 9)).astype(np.float32)
    cent = pts[..., :2].mean(axis=2)
    v = _perturbed(jm.init(jax.random.PRNGKey(1), pts, cent, None, train=False), 2, 0.05)
    jl, _, _ = jm.apply(v, pts, cent, None, train=False)
    with torch.inference_mode():
        logits, _, _ = _port(v, ModelConfig(dropout=0.0, bn_mode="window"))(*_t(pts, cent))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4)


def test_reference_pth_roundtrip(setup, tmp_path):
    """A .pth written by the JAX package's export reads into the same tree;
    the port's writer reads back into it too."""
    cfg, jm, v, model, (pts, cent, pad), ref = setup
    path = str(tmp_path / "model_attention.pth")
    export_reference_checkpoint(v, path, arch="attention", meta={"number_of_points": 128})
    back, meta = load_reference_pth(path)
    assert meta["arch"] == "attention" and meta["number_of_points"] == 128
    assert meta["point_dim"] == 3 and meta["global_feat"] == 256
    want = dict(jax.tree.leaves_with_path(jax.tree.map(np.asarray, v)))
    got = dict(jax.tree.leaves_with_path(back))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))

    path2 = str(tmp_path / "port.pth")
    save_reference_pth(flax_variables(model), path2, meta={"epoch": 3})
    again, meta2 = load_reference_pth(path2)
    assert meta2["epoch"] == 3
    for k, a in jax.tree.leaves_with_path(again):
        np.testing.assert_array_equal(a, want[k], err_msg=str(k))
    sd = torch.load(path2, weights_only=True)
    assert sd["base_pointnet"]["conv_1.weight"].shape == (64, 12, 1)
    assert "bn_1.num_batches_tracked" in sd["base_pointnet"]
