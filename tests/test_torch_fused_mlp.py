"""The port's fused_mlp_chain module against the Pallas kernel (interpret
mode on the CPU), at the tests/test_pallas.py shapes. On CPU tensors the
wrapper runs the kernel's plain PyTorch version; the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py."""

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
