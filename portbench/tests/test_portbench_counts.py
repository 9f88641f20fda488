"""``portbench/counts.py`` against counts worked out by hand."""

import pytest

from portbench import counts

M, N = 288, 2048  # the bench forward: 32 clouds x 9 windows of 2,048 points
TF32, INT8, HBM = 495e12, 1979e12, 3.35e12


@pytest.mark.parametrize("chain,macs,params,out", [
    # multiply-adds a point; float32 weights + biases; the output's floats
    ("input_tnet", 3 * 64 + 64 * 128 + 128 * 256, 192 + 64 + 8192 + 128 + 32768 + 256, M * 256),
    ("mlp_a", 12 * 64 + 64 * 64, 768 + 64 + 4096 + 64, M * N * 64),
    ("feature_tnet", 64 * 64 + 64 * 128 + 128 * 256, 4096 + 64 + 8192 + 128 + 32768 + 256, M * 256),
    ("mlp_b", 64 * 64 + 64 * 128 + 128 * 128 + 128 * 256,
     4096 + 64 + 8192 + 128 + 16384 + 128 + 32768 + 256, M * 256),
])
def test_bench_chains(chain, macs, params, out):
    dims, pool = counts.CHAINS[chain]
    ops, nbytes = counts.chain_work(M, N, dims, pool)
    assert ops == 2 * M * N * macs
    assert nbytes == 4 * (M * N * dims[0] + out) + 4 * params
    assert counts.bound_s(ops, nbytes) == max(ops / TF32, nbytes / HBM)


def test_int8_chain():
    # mlp_a in int8: 12 -> 64 -> 64, activations out
    ops, nbytes = counts.chain_work(M, N, (12, 64, 64), pool=False, int8=True)
    assert ops == 2 * M * N * (768 + 4096)
    assert nbytes == 4 * (M * N * 12 + M * N * 64) + (768 + 8 * 64) + (4096 + 8 * 64)
    assert counts.bound_s(ops, nbytes, int8=True) == pytest.approx(nbytes / HBM)  # bytes bound


def test_bench_forward_bound():
    # three chains bound by their operations at one TF32 product a
    # multiply-add; mlp_a, which writes its activations, by its bytes
    s = counts.kernel_bound_s(M, N, list(counts.CHAINS))
    pooled = 2 * M * N * (41152 + 45056 + 61440) / TF32
    mlp_a = 4 * (M * N * (12 + 64) + 768 + 64 + 4096 + 64) / HBM
    assert s == pytest.approx(pooled + mlp_a, rel=1e-12)
    assert 0.40e-3 < s < 0.41e-3


def test_model_ops_split_by_precision():
    full = counts.model_ops(9, 2048, clouds=32)
    q = counts.model_ops(9, 2048, clouds=32, quantized=("mlp_a", "mlp_b"))
    assert full["int8"] == 0 and q["int8"] == 2 * M * N * (4864 + 61440)
    assert q["tf32"] + q["int8"] == full["tf32"]
    assert counts.least_time_s(full) == full["tf32"] / TF32
    # chains, transforms and head: ~412k operations a point
    assert 4.0e5 < full["tf32"] / (M * N) < 4.3e5
