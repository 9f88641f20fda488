"""The port's fused_mlp_chain module against the Pallas kernel (interpret
mode on the CPU), at the tests/test_pallas.py shapes. On CPU tensors the
wrapper runs the kernel's plain PyTorch version; the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py.

What the CUDA kernel's arithmetic rests on is checked here on the CPU: the
tf32 split against a numpy reference, prepare_chain's layout against the
kernel's addresses, a CPU emulation of the 3xTF32 products against the
plain version (and of one TF32 product, to show why three), and that the
fused and int8 forwards fold once per make_forward."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.ops.pallas import fused_mlp as jfm
from ampnet_tpu_torch.ops import fused_mlp as tfm


def _chain(rng, m, n, dims, zero_bias=False):
    x = rng.normal(size=(m, n, dims[0])).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) * 0.3).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [np.zeros(b, np.float32) if zero_bias else rng.normal(size=b).astype(np.float32)
          for b in dims[1:]]
    return x, ws, bs


def _jax(x, ws, bs, **kw):
    out = jfm.fused_mlp_chain(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                              [jnp.asarray(b) for b in bs], interpret=True, **kw)
    return jax.tree.map(np.asarray, out)


def _torch(x, ws, bs, **kw):
    t = lambda a: torch.from_numpy(a)
    out = tfm.fused_mlp_chain(t(x), [t(w) for w in ws], [t(b) for b in bs], **kw)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


@pytest.mark.parametrize(
    "m,n,dims,kw",
    [
        (3, 64, (16, 32, 48), {}),
        (3, 64, (16, 32, 48), {"pool": True}),
        (3, 64, (16, 32, 48), {"pool": True, "return_acts": False}),
        (5, 32, (8, 16), {"pool": True}),  # prime m
        (2, 32, (8, 8), {"relu_last": False}),
        (4, 128, (12, 64, 64), {}),  # mlp_a's widths
        (2, 64, (3, 64, 128, 256), {"pool": True, "return_acts": False}),  # T-Net trunk
    ],
)
def test_plain_chain_matches_pallas(rng, m, n, dims, kw):
    x, ws, bs = _chain(rng, m, n, dims, zero_bias=not kw.get("relu_last", True))
    ref, out = _jax(x, ws, bs, **kw), _torch(x, ws, bs, **kw)
    if isinstance(ref, tuple):
        assert len(out) == len(ref)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    else:
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    if not kw.get("relu_last", True):
        assert (out < 0).any()  # negatives survive without the final relu


def test_fold_bn_matches_jax(rng):
    cin, cout = 8, 16
    k = rng.normal(size=(cin, cout)).astype(np.float32)
    scale = rng.uniform(0.5, 2, cout).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    mean = rng.normal(size=cout).astype(np.float32)
    var = rng.uniform(0.5, 2, cout).astype(np.float32)
    dense_bias = rng.normal(size=cout).astype(np.float32)
    for db in (None, dense_bias):
        jw, jb = jfm.fold_bn(*(jnp.asarray(a) for a in (k, scale, bias, mean, var)),
                             dense_bias=None if db is None else jnp.asarray(db))
        tw, tb = tfm.fold_bn(*(torch.from_numpy(a) for a in (k, scale, bias, mean, var)),
                             dense_bias=None if db is None else torch.from_numpy(db))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch(rng):
    x, ws, bs = _chain(rng, 3, 32, (8, 16, 4))
    t = lambda a: torch.from_numpy(a)
    before = tfm.fused_mlp_chain.launches
    out = tfm.fused_mlp_chain(t(x), [t(w) for w in ws], [t(b) for b in bs], pool=True)
    ref = tfm.fused_mlp_chain_reference(t(x), [t(w) for w in ws], [t(b) for b in bs], pool=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert tfm.fused_mlp_chain.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    x, ws, bs = _chain(rng, 2, 16, (4, 8))
    t = lambda a: torch.from_numpy(a)
    with pytest.raises(TypeError):
        tfm.fused_mlp_chain(t(x).double(), [t(w).double() for w in ws], [t(b).double() for b in bs])
    with pytest.raises(ValueError, match="chain"):
        tfm.fused_mlp_chain(t(x), [t(ws[0]).T.contiguous()], [t(bs[0])])
    with pytest.raises(ValueError, match="layers"):
        tfm.fused_mlp_chain(t(x), [torch.ones(4, 4)] * 5, [torch.ones(4)] * 5)
    with pytest.raises(ValueError, match="pool or return_acts"):
        tfm.fused_mlp_chain(t(x), [t(w) for w in ws], [t(b) for b in bs], return_acts=False)


# --- the kernel's preparation and arithmetic, on the CPU ----------------------------


def _rna_tf32_numpy(x):
    """Round fp32 ``x`` to tf32 (10 stored mantissa bits) to nearest, ties
    away from zero: of the two tf32 neighbours toward and away from zero,
    the nearer in float64, the one away on a tie."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32)
    down = bits & np.uint32(0xFFFFE000)
    up = down + np.uint32(0x2000)  # past the largest finite value: inf
    # one tf32 step at x's exponent (subnormals share the smallest normal's)
    exponent = np.maximum((bits >> np.uint32(23)) & np.uint32(0xFF), 1).astype(np.float64)
    step = 2.0 ** (exponent - 127 - 10)
    d_down = np.abs(x.astype(np.float64) - down.view(np.float32).astype(np.float64))
    return np.where(step - d_down <= d_down, up, down).view(np.float32)


def _split_inputs(kind):
    rng = np.random.default_rng(3)
    tiny = np.finfo(np.float32).tiny
    if kind == "normal":
        return (rng.normal(size=4096) * 10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    if kind in ("ties", "negative ties"):
        # the low 13 bits exactly half an ulp of tf32: 0x1000
        hi = rng.integers(0x00800000, 0x7F000000, 2048, dtype=np.uint32) & np.uint32(0xFFFFE000)
        x = (hi | np.uint32(0x1000)).view(np.float32)
        return -x if kind == "negative ties" else x
    if kind == "zeros":
        return np.array([0.0, -0.0], np.float32)
    if kind == "subnormals":
        return np.concatenate([rng.uniform(-tiny, tiny, 2048).astype(np.float32),
                               np.array([tiny / 2, -tiny / 3, np.float32(1e-45)], np.float32)])
    assert kind == "large"
    big = np.finfo(np.float32).max
    return np.concatenate([rng.uniform(-big, big, 2048).astype(np.float32),
                           np.array([big, -big, 3.0e38], np.float32)])


@pytest.mark.parametrize("kind", ["normal", "ties", "negative ties", "zeros", "subnormals",
                                  "large"])
def test_tf32_split_rounds_to_nearest_ties_away(kind):
    x = _split_inputs(kind)
    hi, lo = (t.numpy() for t in tfm.tf32_split(torch.from_numpy(x)))
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (lo.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_array_equal(hi.view(np.uint32), _rna_tf32_numpy(x).view(np.uint32))
    finite = np.isfinite(hi)
    x64 = x.astype(np.float64)[finite]
    resid = np.abs(x64 - hi.astype(np.float64)[finite] - lo.astype(np.float64)[finite])
    # the bound holds for normal numbers; subnormals lose their last bits
    # to the 13 cleared ones, so there the residual is under one tf32 step
    bound = np.maximum(2.0 ** -21 * np.abs(x64), 2.0 ** -136)
    assert (resid <= bound).all()
    if kind in ("ties", "negative ties"):
        assert (np.abs(hi) > np.abs(x)).all()  # every tie went away from zero


def _main_path_chains():
    """The seeded flagship model's four chains, BatchNorm folded, with
    random BatchNorm statistics (as chip_smoke.seeded_model draws them)."""
    from ampnet_tpu_torch.core.config import AMPNetConfig
    from ampnet_tpu_torch.models.amp import AMPNetSegmenter
    from ampnet_tpu_torch.models.folded_infer import folded_chain_params
    from ampnet_tpu_torch.models.layers import MaskedBatchNorm

    cfg = AMPNetConfig()
    g = torch.Generator().manual_seed(0)
    model = AMPNetSegmenter(cfg.model, num_features=cfg.data.num_features, generator=g)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, MaskedBatchNorm):
                mod.mean.normal_(0.0, 0.1, generator=g)
                mod.var.uniform_(0.5, 1.5, generator=g)
                mod.scale.uniform_(0.8, 1.2, generator=g)
                mod.bias.normal_(0.0, 0.1, generator=g)
        enc = model.eval().encoder
        mlps = {"input_tnet": enc.input_tnet.trunk, "mlp_a": enc.mlp_a,
                "feature_tnet": enc.feature_tnet.trunk, "mlp_b": enc.mlp_b}
        return {name: tuple([t.detach().clone() for t in ts] for ts in folded_chain_params(mlp))
                for name, mlp in mlps.items()}


@pytest.fixture(scope="module")
def main_chains():
    return _main_path_chains()


def _check_packed(prep, ws, bs):
    kpad = tfm.pad_depth(ws[0].shape[0])
    for layer, (w, b, packed, bpad) in enumerate(zip(ws, bs, prep.packed, prep.bias_pad)):
        cin, cout = w.shape
        npad = tfm.pad_width(cout)
        assert packed.shape == (kpad // 16, 2, npad // 8, 4, 8, 4)
        hi, lo = tfm.unpack_weight(packed)
        assert hi.shape == lo.shape == (npad, kpad)
        want_hi, want_lo = tfm.tf32_split(w.t().contiguous())
        assert torch.equal(hi[:cout, :cin], want_hi) and torch.equal(lo[:cout, :cin], want_lo)
        for plane in (hi, lo):  # zero padding in K and in N
            assert not plane[cout:].any() and not plane[:, cin:].any()
        assert torch.equal(bpad[:cout], b) and not bpad[cout:].any()
        # what the kernel is told of this layer: Cout, padded depth and width
        assert [a[layer] for a in prep.c_args[2:]] == [cout, kpad, npad]
        assert prep.c_args[0][layer] == packed.data_ptr()
        assert prep.c_args[1][layer] == bpad.data_ptr()
        # the kernel's addresses: slab k // 16 holds the hi plane then the lo
        # plane; core matrix (n // 8, k % 16 // 4) at 32 floats each (the
        # wgmma descriptor's 128-byte K and 512-byte N offsets), row n % 8
        flat = packed.flatten()
        gen = torch.Generator().manual_seed(cin * 1000 + cout)
        for n, k in zip(torch.randint(0, cout, (64,), generator=gen).tolist(),
                        torch.randint(0, cin, (64,), generator=gen).tolist()):
            base = (k // 16) * 2 * npad * 16 + ((n // 8) * 4 + k % 16 // 4) * 32 + n % 8 * 4 + k % 4
            assert flat[base] == want_hi[n, k] and flat[base + npad * 16] == want_lo[n, k]
        kpad = npad


@pytest.mark.parametrize("chain", ["input_tnet", "mlp_a", "feature_tnet", "mlp_b"])
def test_prepare_chain_round_trips_the_main_path_chains(main_chains, chain):
    ws, bs = main_chains[chain]
    _check_packed(tfm.prepare_chain(ws, bs), ws, bs)


@pytest.mark.parametrize("width", [1, 3, 5, 33, 70, 256])
def test_prepare_chain_round_trips_ragged_widths(rng, width):
    _, ws, bs = _chain(rng, 1, 1, (width, 33, width, 70))
    ws, bs = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    _check_packed(tfm.prepare_chain(ws, bs), ws, bs)


def _emulate(x, prep, n_products, pool):
    """The kernel's arithmetic on the CPU: activations and weights split into
    tf32 hi and lo (the weights as prepare_chain packed them), products of
    tf32 values (exact in fp32) summed in fp32; ``n_products`` 3 sums
    lo·hi + hi·lo + hi·hi, 1 only hi·hi."""
    h = x
    for i, (w, packed, bpad) in enumerate(zip(prep.weights, prep.packed, prep.bias_pad)):
        cin, cout = w.shape
        w_hi, w_lo = (p[:cout, :cin].t() for p in tfm.unpack_weight(packed))
        a_hi, a_lo = tfm.tf32_split(h)
        acc = a_hi @ w_hi if n_products == 1 else a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi
        h = torch.relu(acc + bpad[:cout])
    return h.amax(dim=1) if pool else h


@pytest.mark.parametrize("chain", ["input_tnet", "mlp_a", "feature_tnet", "mlp_b"])
def test_3xtf32_emulation_is_fp32_accurate_and_1xtf32_is_not(main_chains, rng, chain):
    ws, bs = main_chains[chain]
    pool = chain != "mlp_a"
    x = torch.from_numpy(rng.normal(size=(2, 512, ws[0].shape[0])).astype(np.float32))
    prep = tfm.prepare_chain(ws, bs)
    ref = tfm.fused_mlp_chain_reference(x, ws, bs, pool=pool, return_acts=not pool)
    scale = max(1.0, ref.abs().max().item())
    err3 = (_emulate(x, prep, 3, pool) - ref).abs().max().item()
    err1 = (_emulate(x, prep, 1, pool) - ref).abs().max().item()
    assert err3 <= 1e-4 * scale  # chip_smoke.KERNEL_RTOL
    assert err1 >= 10 * err3


def test_prepared_chain_on_the_cpu_is_the_plain_version(rng):
    x, ws, bs = _chain(rng, 3, 32, (8, 16, 4))
    t = lambda a: torch.from_numpy(a)
    prep = tfm.prepare_chain([t(w) for w in ws], [t(b) for b in bs])
    before = tfm.fused_mlp_chain.launches
    out = tfm.fused_mlp_chain(t(x), prep, pool=True)
    ref = tfm.fused_mlp_chain_reference(t(x), [t(w) for w in ws], [t(b) for b in bs], pool=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert tfm.fused_mlp_chain.launches == before
    with pytest.raises(ValueError, match="biases"):
        tfm.fused_mlp_chain(t(x), prep, [t(b) for b in bs])
    with pytest.raises(ValueError, match="channels"):
        tfm.fused_mlp_chain(t(x)[..., :4], prep)
    with pytest.raises(ValueError, match="widths up to"):
        tfm.prepare_chain([torch.ones(8, 300)], [torch.ones(300)])


@pytest.mark.parametrize("backend", ["fused", "int8"])
def test_make_forward_folds_once(monkeypatch, backend):
    """fused and int8 fold every chain and head at make_forward: a forward
    calls fold_bn no more, and two forwards give the same logits."""
    from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig
    from ampnet_tpu_torch.models import folded_infer
    from ampnet_tpu_torch.models.amp import AMPNetSegmenter
    from ampnet_tpu_torch.models.backends import make_forward

    calls = []
    fold = folded_infer.fold_bn
    monkeypatch.setattr(folded_infer, "fold_bn", lambda *a, **k: calls.append(1) or fold(*a, **k))
    model = AMPNetSegmenter(ModelConfig(), generator=torch.Generator().manual_seed(0))
    forward = make_forward(model, AMPNetConfig(), backend, device="cpu")
    folded = len(calls)
    assert folded > 0
    pts = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 2, 32, 9)).astype(np.float32))
    cent = pts[..., :2].mean(dim=2)
    first = forward(pts, cent, None)
    second = forward(pts, cent, None)
    assert len(calls) == folded
    assert torch.equal(first, second) and first.shape == (1, 2, 32, 5)


def _kernel_timing():
    spec = importlib.util.spec_from_file_location(
        "kernel_timing", Path(__file__).resolve().parents[1] / "kernel_timing.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


VARIANTS = ("cvt_rna", "one_product", "no_weight_copies", "no_mma", "no_mma_no_load",
            "no_mma_no_load_no_stores", "no_mma_no_load_no_stores_no_pool")


@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_timing_variants_apply_to_the_kernel_source(variant):
    """Every source variant ``kernel_timing.py --variants`` times still finds
    the text it replaces in csrc/fused_mlp.cu, and changes it."""
    timing = _kernel_timing()
    assert tuple(timing.VARIANTS) == VARIANTS
    source = (Path(tfm.__file__).resolve().parents[1] / "csrc" / "fused_mlp.cu").read_text()
    assert timing.variant_source(variant, source) != source
