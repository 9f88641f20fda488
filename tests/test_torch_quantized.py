"""The port's int8 chain and encoder against the JAX package (its Pallas
kernel in interpret mode on the CPU). On CPU tensors the wrapper runs the
kernel's plain PyTorch version; the CUDA kernel itself is held against that
plain version on the card by chip_smoke.py."""

import importlib.util
from fractions import Fraction
from pathlib import Path

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


# --- the kernel's layout, pass plan and division, emulated on the CPU -----

TILE_ROWS = 64  # the kernel's rows per tile (csrc/quantized_mlp.cu, kRows)
LAYOUT_DIMS = [(12, 64, 64), (64, 64, 128, 128, 256), (5, 33, 70), (128, 1),
               (256, 256, 256, 256, 256)]


def _int8_chain(rng, dims):
    ws = [_t((rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32))
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [_t((rng.normal(size=b) * 0.1).astype(np.float32)) for b in dims[1:]]
    qs, ss = tqm.quantize_chain(ws)
    return qs, ss, bs


@pytest.mark.parametrize("dims", LAYOUT_DIMS)
def test_prepared_chain_round_trips(rng, dims):
    """prepare_quantized_chain's packing unpacks to the int8 weights, with
    zeros in the padding; the C arguments carry the padding it chose."""
    qs, ss, bs = _int8_chain(rng, dims)
    chain = tqm.prepare_quantized_chain(qs, ss, bs)
    kpad = tqm.pad_depth(dims[0])
    assert kpad % 32 == 0 and kpad >= dims[0]
    w_ptrs, s_ptrs, b_ptrs, couts, kpads, npads = chain.c_args
    for i, (q, s, b) in enumerate(zip(qs, ss, bs)):
        npad = tqm.pad_width(q.shape[1])
        packed = chain.packed[i]
        assert packed.dtype == torch.int8 and packed.shape == (npad // 8, kpad // 16, 8, 16)
        wt = tqm.unpack_weight_s8(packed)
        assert wt.shape == (npad, kpad)
        assert torch.equal(wt[: q.shape[1], : q.shape[0]], q.t())
        pad = torch.ones_like(wt, dtype=torch.bool)
        pad[: q.shape[1], : q.shape[0]] = False
        assert not wt[pad].any()
        for full, real in ((chain.scale_pad[i], s), (chain.bias_pad[i], b)):
            assert full.shape == (npad,) and torch.equal(full[: real.shape[0]], real)
            assert not full[real.shape[0]:].any()
        assert (couts[i], kpads[i], npads[i]) == (q.shape[1], kpad, npad)
        assert (w_ptrs[i], s_ptrs[i], b_ptrs[i]) == (
            packed.data_ptr(), chain.scale_pad[i].data_ptr(), chain.bias_pad[i].data_ptr())
        kpad = npad  # the next layer's depth is this layer's padded width


@pytest.mark.parametrize("dims", LAYOUT_DIMS[:3])
def test_prepared_layout_is_the_kernels_address_formula(rng, dims):
    """Byte (n, k) of a packed layer lies where the kernel's tile_offset puts
    it: core matrix (n / 8, k / 16) at 128 bytes, row n % 8 at 16 bytes."""
    qs, ss, bs = _int8_chain(rng, dims)
    chain = tqm.prepare_quantized_chain(qs, ss, bs)
    for packed in chain.packed:
        wt = tqm.unpack_weight_s8(packed)
        npad, kpad = wt.shape
        nn, kk = torch.meshgrid(torch.arange(npad), torch.arange(kpad), indexing="ij")
        offset = ((nn >> 3) * (kpad >> 4) + (kk >> 4)) * 128 + (nn & 7) * 16 + (kk & 15)
        assert torch.equal(packed.reshape(-1)[offset], wt)


ABSMAX_THREADS, ABSMAX_CHUNK = 256, 256 * 16  # csrc/quantized_mlp.cu: kAbsmaxThreads, kAbsmaxChunk


def _absmax_reads(m, n, cin, g, address):
    """The flat indices of x that absmax_kernel reads for each block of g
    windows, walked as its loops walk them, with x at byte ``address``: one
    CUDA block per (group, chunk), 16-byte loads where the group's own start
    is 16-byte aligned, then one float at a time from where those end."""
    group_elems, total = g * n * cin, m * n * cin
    stride = min(-(-group_elems // ABSMAX_CHUNK), 65535) * ABSMAX_THREADS
    reads = []
    for grp in range(-(-m // g)):
        base = grp * group_elems
        end = min(group_elems, total - base)
        got, vec_end = [], 0
        if (address + 4 * base) % 16 == 0:
            for first in range(stride):  # blockIdx.y * kAbsmaxThreads + threadIdx.x
                got += [4 * i + e for i in range(first, end // 4, stride) for e in range(4)]
            vec_end = 4 * (end // 4)
        for first in range(stride):
            got += range(vec_end + first, end, stride)
        reads.append(base + np.sort(np.array(got, dtype=np.int64)))
    return reads


@pytest.mark.parametrize(
    "m,n,cin,g,offset",
    [
        (5, 33, 6, 2, 0),  # the last block holds 198 floats, 2 past a multiple of 4
        (4, 33, 6, 2, 198),  # x_big[1:]: 8 bytes past a 16-byte boundary
        (4, 33, 12, 2, 2),
        (18, 4096, 12, 1, 0),  # mlp_a served
        (6, 128, 64, 3, 1),
        (7, 65, 5, 4, 3),  # 4 windows a block, one padded
        (1, 1, 3, 1, 0),
    ],
)
def test_absmax_pass_reads_every_element_once(m, n, cin, g, offset):
    """absmax_kernel's loops cover each real element of x exactly once, for
    any block length and any alignment of x (``offset`` floats past a 16-byte
    boundary), so every block's scale sees its largest |x|."""
    reads = _absmax_reads(m, n, cin, g, 4 * offset)
    assert len(reads) == -(-m // g)
    assert np.array_equal(np.concatenate(reads), np.arange(m * n * cin))


def _emulate_pass_plan(x, chain, pool=False, relu_last=True, return_acts=True,
                       block_windows=0, address=0):
    """The kernel's plan, tile by tile on the CPU with the prepared (padded)
    weights: pass 0 takes each block's absmax of x (x at byte ``address``)
    as absmax_kernel reads it; pass 1 quantizes x into
    x_q tiles and runs layer 0; pass p < L runs layers 0..p-1 from x_q and
    folds max|h_p| of the tiles' real rows into word p; pass L runs every
    layer from x_q over the real windows only and writes the outputs. No
    activation is kept between passes."""
    m, n, cin = x.shape
    layers = len(chain.packed)
    cout = chain.wq[-1].shape[1]
    g = tqm.block_windows_for(m, n, max(q.shape[1] for q in chain.wq), block_windows)
    mp = m + (-m % g)
    ws = [tqm.unpack_weight_s8(p).t().float() for p in chain.packed]  # [kpad, npad]
    xp = torch.nn.functional.pad(torch.cat([x, x.new_zeros((mp - m, n, cin))]),
                                 (0, ws[0].shape[0] - cin))
    amax = torch.zeros(layers, mp // g)
    for grp, idx in enumerate(_absmax_reads(m, n, cin, g, address)):
        amax[0, grp] = x.reshape(-1)[torch.from_numpy(idx)].abs().amax()

    def scale(l, grp):
        return tqm._div_qmax(torch.clamp(amax[l, grp], min=1e-12))

    def quant(h, s):
        return torch.clamp(torch.round(h / s), -tqm.QMAX, tqm.QMAX)

    tiles = -(-n // TILE_ROWS)
    xq = {}
    out = torch.zeros(m, n, chain.packed[-1].shape[0] * 8)
    for p in range(1, layers + 1):
        final = p == layers
        for w in range(m if final else mp):
            grp = w // g
            for t in range(tiles):
                r0 = t * TILE_ROWS
                rows = min(TILE_ROWS, n - r0)
                if p == 1:
                    a = torch.zeros(TILE_ROWS, ws[0].shape[0])
                    a[:rows] = quant(xp[w, r0:r0 + rows], scale(0, grp))
                    xq[w, t] = a
                a = xq[w, t]
                for l in range(p):
                    acc = a @ ws[l]
                    h = acc * (scale(l, grp) * chain.scale_pad[l]) + chain.bias_pad[l]
                    if l < layers - 1 or relu_last:
                        h = torch.relu(h)
                    if l < p - 1:
                        a = quant(h, scale(l + 1, grp))
                if final:
                    out[w, r0:r0 + rows] = h[:rows]
                else:
                    amax[p, grp] = torch.maximum(amax[p, grp], h[:rows].abs().amax())
    out = out[..., :cout]
    if pool and return_acts:
        return out, out.amax(dim=1)
    return out.amax(dim=1) if pool else out


@pytest.mark.parametrize(
    "m,n,dims,kw",
    [
        (5, 100, (12, 64, 64), {}),  # g = 2: one zero window padded
        (3, 70, (16, 32, 48), {"pool": True, "relu_last": False}),
        (4, 65, (64, 64, 128, 128, 256), {"pool": True, "block_windows": 3}),  # explicit g
        (6, 128, (64, 64, 128, 128, 256), {"pool": True, "return_acts": False}),  # mlp_b
        (3, 129, (5, 33, 70), {"pool": True, "relu_last": False}),
        (2, 64, (128, 1), {"pool": True, "relu_last": False}),
        # chip_smoke.py's INT8_EDGE_CASES: the last block's length not a
        # multiple of 4; x at `offset` floats past a 16-byte boundary
        (5, 33, (6, 64, 64), {"block_windows": 2, "pool": True}),
        (4, 33, (6, 64, 64), {"block_windows": 2, "pool": True, "offset": 198}),
        (4, 33, (12, 64, 64), {"block_windows": 2, "offset": 2}),
    ],
)
def test_pass_plan_equals_the_plain_version(rng, m, n, dims, kw):
    """Recomputing each scale pass from x_q gives the scales, and so the
    outputs, of the plain version that keeps every activation: bit for bit.
    x's largest |value| lies in its last element, which the absmax pass
    must reach."""
    kw = dict(kw)
    address = 4 * kw.pop("offset", 0)
    qs, ss, bs = _int8_chain(rng, dims)
    x = _t(rng.normal(size=(m, n, dims[0])).astype(np.float32))
    x[-1, -1, -1] = 2 * x.abs().max()
    out = _emulate_pass_plan(x, tqm.prepare_quantized_chain(qs, ss, bs), address=address, **kw)
    ref = tqm.quantized_mlp_chain_reference(x, qs, ss, bs, **kw)
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(out, ref, strict=True):
        assert torch.equal(o, r)


def test_prepared_chain_runs_the_plain_version_on_the_cpu(rng):
    qs, ss, bs = _int8_chain(rng, (12, 64, 64))
    x = _t(rng.normal(size=(3, 40, 12)).astype(np.float32))
    chain = tqm.prepare_quantized_chain(qs, ss, bs)
    for a, b in zip(tqm.quantized_mlp_chain(x, chain, pool=True),
                    tqm.quantized_mlp_chain(x, qs, ss, bs, pool=True)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="carries its own"):
        tqm.quantized_mlp_chain(x, chain, ss, bs)
    with pytest.raises(ValueError, match="widths up to"):
        tqm.prepare_quantized_chain(*_int8_chain(rng, (300, 8)))


def _pow2(k):
    return Fraction(1 << k) if k >= 0 else Fraction(1, 1 << -k)


def _rn32(q: Fraction) -> Fraction:
    """q rounded to the nearest float32, ties to even, exactly (subnormals
    included; no overflow here)."""
    if q == 0:
        return Fraction(0)
    a = abs(q)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if a < _pow2(e):
        e -= 1
    quantum = _pow2(max(e, -126) - 23)
    k, rem = divmod(a, quantum)
    if rem > quantum / 2 or (rem == quantum / 2 and k % 2 == 1):
        k += 1
    return k * quantum if q > 0 else -k * quantum


def _div_rn_kernel(v: Fraction, s: Fraction) -> Fraction:
    """csrc/quantized_mlp.cu's div_rn, each operation rounded as the card
    rounds it: r = RN(1/s) (__frcp_rn), y = RN(v r), then twice
    y = RN(r RN(v - s y) + y) (two FMAs each)."""
    r = _rn32(1 / s)
    y = _rn32(v * r)
    for _ in range(2):
        y = _rn32(r * _rn32(v - s * y) + y)
    return y


def _round_half_even(q: Fraction) -> int:
    k, rem = divmod(q, 1)
    return k + (1 if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and k % 2) else 0)


def test_kernel_division_is_correctly_rounded():
    """The kernel's reciprocal-and-FMA division gives the correctly rounded
    quotient, checked against exact rational division, on the quotients a
    quantization meets: scales from absmaxes over many binades (and the
    1e-12 floor), random values, values on either side of every half-integer
    quotient (the ties of round half to even) and at the clamp."""
    rng = np.random.default_rng(7)
    f32 = np.float32
    amaxes = list(f32(10.0) ** rng.uniform(-13, 6, size=24).astype(f32))
    amaxes += [f32(0), f32(63.5), f32(127), f32(1), np.nextafter(f32(2), f32(0)),
               f32(127) * (f32(1) + f32(2.0 ** -23) * f32(5))]
    checked = ties = 0
    for amax in amaxes:
        s = f32(max(amax, f32(1e-12))) / f32(127)  # the block's scale, as _div_qmax
        vs = [f32(0), amax, -amax, np.nextafter(amax, f32(np.inf)), -np.nextafter(amax, f32(0))]
        vs += list(rng.uniform(-1, 1, size=40).astype(f32) * amax)
        for k in range(-128, 127, 3):
            tie = f32((k + 0.5) * float(s))
            vs += [tie, np.nextafter(tie, f32(np.inf)), np.nextafter(tie, f32(-np.inf))]
        S = Fraction(float(s))
        for v in vs:
            V = Fraction(float(v))
            exact = _rn32(V / S)
            got = _div_rn_kernel(V, S)
            assert got == exact, (float(v), float(s), float(got), float(exact))
            q = max(-127, min(127, _round_half_even(exact)))
            assert q == max(-127, min(127, _round_half_even(got)))
            ties += abs(exact) % 1 == Fraction(1, 2)
            checked += 1
    assert checked > 5000 and ties > 100  # the sample holds exact ties


QUANTIZED_VARIANTS = ("no_mma", "no_scale_passes", "multiply_not_divide", "fdiv_rn")


@pytest.mark.parametrize("variant", QUANTIZED_VARIANTS)
def test_kernel_timing_variants_apply_to_the_int8_kernel_source(variant):
    """Every source variant ``kernel_timing.py --variants`` times for the
    int8 kernel still finds the text it replaces in csrc/quantized_mlp.cu,
    and changes it."""
    spec = importlib.util.spec_from_file_location(
        "kernel_timing", Path(__file__).resolve().parents[1] / "kernel_timing.py")
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    assert tuple(timing.QUANTIZED_VARIANTS) == QUANTIZED_VARIANTS
    source = (Path(tqm.__file__).resolve().parents[1] / "csrc" / "quantized_mlp.cu").read_text()
    assert timing.variant_source(variant, source, "quantized_mlp") != source


def test_kernel_float_int_conversions_are_exact():
    """The kernel's conversions on the FP32 pipe (csrc/quantized_mlp.cu,
    kMagic): an int32 sum through the bits of 1.5 * 2^23 comes back exact,
    and a clipped quotient plus 1.5 * 2^23 holds round-half-to-even of it
    in its low byte, as int8."""
    magic, magic_bits = np.float32(12582912.0), np.int32(0x4B400000)
    acc = np.concatenate([np.arange(-5000, 5000), np.array([127 * 127 * 256, -127 * 127 * 256]),
                          np.random.default_rng(0).integers(-(1 << 22), 1 << 22, 100_000)])
    acc = acc.astype(np.int32)
    back = (acc + magic_bits).view(np.float32) - magic
    np.testing.assert_array_equal(back, acc.astype(np.float32))
    q = np.concatenate([np.arange(-130, 130, 0.5), np.random.default_rng(1).uniform(-140, 140, 100_000)])
    q = q.astype(np.float32)
    q = np.concatenate([q, np.nextafter(q, np.float32(np.inf)), np.nextafter(q, np.float32(-np.inf))])
    clipped = np.minimum(np.maximum(q, np.float32(-127)), np.float32(127))
    low = ((clipped + magic).view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    want = np.clip(np.round(q), -127, 127).astype(np.int8)  # numpy rounds half to even
    np.testing.assert_array_equal(low, want)
