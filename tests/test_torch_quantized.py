"""The port's int8 chain and encoder against the JAX package (its Pallas
kernel in interpret mode on the CPU). On CPU tensors the wrapper runs the
kernel's plain PyTorch version; the CUDA kernel itself is held against that
plain version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.models.amp import WindowEncoder as JEncoder
from ampnet_tpu.models.quantized_infer import encode_windows_int8 as j_encode_int8
from ampnet_tpu.ops.pallas import fused_mlp as jfm
from ampnet_tpu.ops.pallas import quantized_mlp as jqm
from ampnet_tpu_torch.core.config import ModelConfig
from ampnet_tpu_torch.core.weights import load_flax_variables
from ampnet_tpu_torch.models.amp import WindowEncoder
from ampnet_tpu_torch.models.quantized_infer import encode_windows_int8, quantize_encoder_chains
from ampnet_tpu_torch.ops import quantized_mlp as tqm


def _t(a):
    return torch.from_numpy(np.array(a))


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("shape", [(64, 128), (12, 64), (128, 256), (3, 1)])
def test_weight_quantization_matches_jax_bitwise(rng, shape):
    w = (rng.normal(size=shape) * 0.3).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    jq, js = jqm.quantize_weights_per_channel(jnp.asarray(w))
    tq, ts = tqm.quantize_weights_per_channel(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    (jqs, jss), (tqs, tss) = jqm.quantize_chain([jnp.asarray(w)]), tqm.quantize_chain([_t(w)])
    np.testing.assert_array_equal(tqs[0].numpy(), np.asarray(jqs[0]))
    np.testing.assert_array_equal(tss[0].numpy(), np.asarray(jss[0]))


@pytest.mark.parametrize(
    "m,n,dims,kw,g",
    [
        (3, 128, (16, 64, 64), {}, 1),  # tests/test_quantized.py's chain
        (2, 64, (8, 16), {"pool": True, "return_acts": False}, 1),  # ... and its pool
        (6, 128, (12, 64, 64), {}, 3),  # mlp_a at the [2, 3, 128, 9] backend shape
        (6, 128, (64, 64, 128, 128, 256), {"pool": True, "return_acts": False}, 3),  # mlp_b
        (4, 64, (16, 32, 48), {"pool": True}, 2),  # acts and pool together
        (4, 64, (16, 32, 48), {"relu_last": False}, 2),
        (7, 128, (12, 64, 64), {}, 3),  # g = 3: two zero windows padded
        (5, 64, (16, 32, 48), {"block_windows": 2}, 2),  # explicit g, one padded
    ],
)
def test_plain_chain_matches_pallas(rng, m, n, dims, kw, g):
    assert tqm.block_windows_for(m, n, max(dims[1:]), kw.get("block_windows", 0)) == g
    x = rng.normal(size=(m, n, dims[0])).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) * 0.3).astype(np.float32) for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.normal(size=b) * 0.1).astype(np.float32) for b in dims[1:]]
    jq, js = jqm.quantize_chain([jnp.asarray(w) for w in ws])
    ref = jqm.quantized_mlp_chain(jnp.asarray(x), jq, js, [jnp.asarray(b) for b in bs],
                                  interpret=True, **kw)
    out = tqm.quantized_mlp_chain(_t(x), [_t(q) for q in jq], [_t(s) for s in js],
                                  [_t(b) for b in bs], **kw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-4 * max(1.0, np.abs(r).max()))
    if not kw.get("relu_last", True):
        assert (out[0] < 0).any()  # negatives survive without the final relu


def test_padded_windows_count_toward_the_scale(rng):
    """Zero windows padded onto the last block hold relu(b) from layer 1 on
    and enter that block's absmax. Here the real rows give relu(1 - a
    positive sum) < 1 and the padding gives 1, so the padding sets the second
    layer's scale and the window's result differs from the window alone."""
    x = np.abs(rng.normal(size=(3, 32, 8))).astype(np.float32)
    w1 = -np.abs(rng.normal(size=(8, 16)) * 0.3).astype(np.float32)
    w2 = rng.normal(size=(16, 8)).astype(np.float32)
    qs, ss = tqm.quantize_chain([_t(w1), _t(w2)])
    bs = [torch.ones(16), torch.zeros(8)]
    padded = tqm.quantized_mlp_chain(_t(x), qs, ss, bs, block_windows=2)
    alone = tqm.quantized_mlp_chain(_t(x[2:]), qs, ss, bs, block_windows=1)
    torch.testing.assert_close(padded[:2], tqm.quantized_mlp_chain(_t(x[:2]), qs, ss, bs,
                                                                   block_windows=2))
    assert padded.shape == (3, 32, 8)
    assert not torch.equal(padded[2], alone[0])


def test_block_windows_follow_the_jax_picker():
    for m, n, cmax in ((6, 128, 64), (18, 4096, 64), (18, 4096, 256), (288, 2048, 64),
                       (288, 2048, 256), (37, 1000, 64), (1, 1, 1), (100, 7, 300)):
        assert tqm._pick_block_windows(m, n, cmax) == jfm._pick_block_windows(m, n, cmax)
    # mlp_a served (18 x 4096), at the bench geometry, and a padded case
    assert tqm.block_windows_for(18, 4096, 64) == 1
    assert tqm.block_windows_for(288, 2048, 64) == 2
    assert tqm.block_windows_for(37, 1000, 64) == 4


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch(rng):
    x = _t(rng.normal(size=(3, 32, 8)).astype(np.float32))
    qs, ss = tqm.quantize_chain([_t(rng.normal(size=(8, 16)).astype(np.float32))])
    bs = [torch.zeros(16)]
    before = tqm.quantized_mlp_chain.launches
    out = tqm.quantized_mlp_chain(x, qs, ss, bs, pool=True)
    ref = tqm.quantized_mlp_chain_reference(x, qs, ss, bs, pool=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert tqm.quantized_mlp_chain.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    x = _t(rng.normal(size=(2, 16, 4)).astype(np.float32))
    qs, ss = tqm.quantize_chain([_t(rng.normal(size=(4, 8)).astype(np.float32))])
    bs = [torch.zeros(8)]
    with pytest.raises(TypeError, match="int8"):
        tqm.quantized_mlp_chain(x, [qs[0].float()], ss, bs)
    with pytest.raises(TypeError, match="float32"):
        tqm.quantized_mlp_chain(x.double(), qs, ss, bs)
    with pytest.raises(ValueError, match="chain"):
        tqm.quantized_mlp_chain(x, [qs[0].T.contiguous()], ss, bs)
    with pytest.raises(ValueError, match="layers"):
        tqm.quantized_mlp_chain(x, qs * 5, ss * 5, bs * 5)
    with pytest.raises(ValueError, match="pool or return_acts"):
        tqm.quantized_mlp_chain(x, qs, ss, bs, return_acts=False)
    with pytest.raises(ValueError, match="block_windows"):
        tqm.quantized_mlp_chain(x, qs, ss, bs, block_windows=-1)


@pytest.fixture(scope="module")
def encoder_pair():
    """tests/test_quantized.py's encoder: a Flax init perturbed by 0.05 so
    the zero-init T-Net heads are not trivial, carried into the port."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2, 2, 128, 9)).astype(np.float32) * 0.5
    jm = JEncoder(JModelConfig(dropout=0.0))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(pts), train=False)
    leaves, treedef = jax.tree.flatten(v)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    v = jax.tree.unflatten(treedef, [l + jax.random.normal(k, l.shape, l.dtype) * 0.05
                                     for k, l in zip(keys, leaves)])
    model = load_flax_variables(WindowEncoder(ModelConfig(dropout=0.0)),
                                jax.tree.map(np.asarray, v)).eval()
    return jm, v, model, pts


def test_int8_encoder_matches_jax(encoder_pair):
    jm, v, model, pts = encoder_pair
    j_local, j_glob, j_t = j_encode_int8(v, jnp.asarray(pts), interpret=True)
    with torch.inference_mode():
        local, glob, t_feat = encode_windows_int8(model, _t(pts))
        again = encode_windows_int8(model, _t(pts), quantize_encoder_chains(model))
    assert local.shape == j_local.shape and glob.shape == j_glob.shape
    assert t_feat.shape == j_t.shape == (2, 2, 64, 64)
    assert _cos(glob.numpy(), j_glob) > 0.9999
    assert _cos(local.numpy(), j_local) > 0.9999
    for a, b in zip(again, (local, glob, t_feat)):
        assert torch.equal(a, b)  # chains quantized once give the same numbers


def test_int8_encoder_tracks_jax_fp32(encoder_pair):
    jm, v, model, pts = encoder_pair
    ref_local, ref_glob, _ = jm.apply(v, jnp.asarray(pts), train=False)
    with torch.inference_mode():
        local, glob, _ = encode_windows_int8(model, _t(pts))
    assert _cos(glob.numpy(), ref_glob) > 0.99
    assert _cos(local.numpy(), ref_local) > 0.99
