"""The port's native host solver (its own copy of ``balanced_assign.cc``,
built by ``g++`` at first use) against the JAX package's: the exact
min-cost-flow assignment, the balanced k-means driver and the FPS, naive and
grid, bit for bit; the NumPy plain versions against JAX's fallbacks; the
port's torch FPS against JAX's ``farthest_point_sampling`` and the native
FPS; and a build that fails raises instead of falling back."""

import argparse
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu import native as jnative
from ampnet_tpu.cli import main as jcli
from ampnet_tpu.ops import sampling as jsampling
from ampnet_tpu_torch import native
from ampnet_tpu_torch.cli.main import main
from ampnet_tpu_torch.data.io_utils import load_cloud, save_cloud
from ampnet_tpu_torch.ops import cuda_build, sampling


def _need_jax_native():
    if not jnative.native_available():
        pytest.skip("the JAX package's native library did not build: nothing to hold "
                    "the port's solver against")


def scipy_optimum(cost, caps):
    from scipy.optimize import linear_sum_assignment

    expanded = np.repeat(cost, caps.tolist(), axis=1)
    r, c = linear_sum_assignment(expanded)
    return expanded[r, c].sum()


@pytest.mark.parametrize("n, caps", [(48, (12, 12, 12, 12)), (30, (5, 10, 15)),
                                     (10, (8, 8)), (200, (40,) * 5), (7, (7,))])
def test_balanced_assign_equal_jax_and_optimal(n, caps):
    _need_jax_native()
    rng = np.random.default_rng(n)
    cost = rng.random((n, len(caps))).astype(np.float32)
    caps = np.asarray(caps, np.int32)
    a = native.balanced_assign(cost, caps)
    assert a.dtype == np.int32 and np.array_equal(a, jnative.balanced_assign(cost, caps))
    load = np.bincount(a, minlength=len(caps))
    assert (load <= caps).all() and load.sum() == n
    if caps.sum() == n:
        assert cost[np.arange(n), a].sum() == pytest.approx(scipy_optimum(cost, caps), abs=1e-4)


@pytest.mark.parametrize("n, d, k, seed", [(1024, 3, 4, 0), (18432 // 8, 3, 9, 7), (300, 2, 3, 1)])
def test_balanced_kmeans_equal_jax(n, d, k, seed):
    _need_jax_native()
    pts = np.random.default_rng(seed).random((n, d)).astype(np.float32)
    caps = np.full(k, n // k, np.int32)
    caps[: n % k] += 1
    a, ca = native.balanced_kmeans_native(pts, k, caps, seed=seed)
    b, cb = jnative.balanced_kmeans_native(pts, k, caps, seed=seed)
    assert np.array_equal(a, b) and np.array_equal(ca, cb)
    np.testing.assert_array_equal(np.bincount(a, minlength=k), caps)
    assert np.array_equal(native.mcf_balanced_assign(pts[: k * 30], k, 30, seed=seed),
                          jnative.mcf_balanced_assign(pts[: k * 30], k, 30, seed=seed))


@pytest.mark.parametrize("method", ["naive", "grid", "auto"])
def test_fps_native_equal_jax_and_torch(method):
    _need_jax_native()
    rng = np.random.default_rng(3)
    pts = (rng.uniform(size=(20000, 4)) * [100, 100, 30, 1]).astype(np.float32)
    got = native.fps_native(pts, 256, method=method)
    assert np.array_equal(got, jnative.fps_native(pts, 256, method=method))
    want = sampling.farthest_point_sampling(torch.from_numpy(pts), 256)
    assert np.array_equal(got, want.numpy())
    with pytest.raises(ValueError, match="method"):
        native.fps_native(pts, 4, method="fast")


def test_plain_versions_equal_jax_fallbacks():
    rng = np.random.default_rng(11)
    cost = rng.random((90, 3)).astype(np.float32)
    caps = np.array([30, 30, 30], np.int32)
    assert np.array_equal(native.assign_plain(cost, caps), jnative._assign_fallback(cost, caps))
    assert np.array_equal(native.assign_plain(cost[:, :1], caps[:1] * 3),
                          jnative._assign_fallback(cost[:, :1], caps[:1] * 3))
    pts = rng.random((120, 3)).astype(np.float32)
    caps = np.full(4, 30, np.int32)
    a, ca = native.kmeans_plain(pts, 4, caps, 5, 2)
    b, cb = jnative._kmeans_fallback(pts, 4, caps, 5, 2)
    assert np.array_equal(a, b) and np.array_equal(ca, cb)


def test_native_cost_is_at_most_the_plain_greedy():
    rng = np.random.default_rng(5)
    pts = rng.random((900, 3)).astype(np.float32)
    cents = pts[:9]
    cost = ((pts[:, None] - cents[None]) ** 2).sum(-1).astype(np.float32)
    caps = np.full(9, 100, np.int32)
    exact, plain = native.balanced_assign(cost, caps), native.assign_plain(cost, caps)
    for a in (exact, plain):
        np.testing.assert_array_equal(np.bincount(a, minlength=9), caps)
    rows = np.arange(900)
    assert cost[rows, exact].sum() <= cost[rows, plain].sum() + 1e-3


@pytest.mark.parametrize("n, s, mask", [(300, 24, False), (1000, 64, False), (500, 40, True)])
def test_torch_fps_equal_jax(n, s, mask):
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 5)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.7 if mask else None
    want = np.asarray(jsampling.farthest_point_sampling(
        jnp.asarray(pts), s, None if valid is None else jnp.asarray(valid)))
    got = sampling.farthest_point_sampling(
        torch.from_numpy(pts), s, None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    if valid is None:
        assert np.array_equal(sampling.fps_points(torch.from_numpy(pts), s).numpy(), pts[want])
    else:
        assert valid[got.numpy()].all()


def test_resample_to_fixed_size():
    gen = torch.Generator().manual_seed(0)
    pts = torch.arange(40, dtype=torch.float32).reshape(20, 2)
    down = sampling.resample_to_fixed_size(pts, 8, gen)
    assert down.shape == (8, 2) and len(set(down[:, 0].tolist())) == 8  # without replacement
    up = sampling.resample_to_fixed_size(pts, 50, gen)
    assert set(up[:, 0].tolist()) == set(pts[:, 0].tolist())  # every point, some twice
    valid = torch.zeros(20, dtype=torch.bool)
    valid[[2, 5, 7]] = True
    masked = sampling.resample_to_fixed_size(pts, 9, gen, valid_mask=valid)
    assert set(masked[:, 0].tolist()) == {4.0, 10.0, 14.0}


def test_fps_command_equal_jax(tmp_path):
    _need_jax_native()
    rng = np.random.default_rng(0)
    (tmp_path / "in").mkdir()
    save_cloud(str(tmp_path / "in" / "a.pkl"), rng.random((300, 13)).astype(np.float32))
    save_cloud(str(tmp_path / "in" / "b.pkl"), rng.random((40, 13)).astype(np.float32))
    assert jcli.cmd_fps(argparse.Namespace(in_path=str(tmp_path / "in"),
                                           out_path=str(tmp_path / "j"), n_points=64)) == 0
    assert main(["fps", "--in_path", str(tmp_path / "in"), "--out_path", str(tmp_path / "p"),
                 "--n_points", "64"]) == 0
    for name, n in (("a.pkl", 64), ("b.pkl", 40)):
        a, b = load_cloud(str(tmp_path / "j" / name)), load_cloud(str(tmp_path / "p" / name))
        assert b.shape == (n, 13) and np.array_equal(a, b)


def test_failed_build_raises_and_does_not_fall_back(monkeypatch, tmp_path):
    """A g++ that fails (a flag it does not know, so a new build name) raises
    with its message from every entry point; nothing falls back to NumPy."""
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path)
    monkeypatch.setattr(cuda_build, "HOST_FLAGS", [*cuda_build.HOST_FLAGS, "-fno-such-flag"])
    cost = np.random.default_rng(0).random((8, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*no-such-flag"):
        native.balanced_assign(cost, np.array([4, 4], np.int32))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.fps_native(cost, 2)
    assert not native.native_available()
    assert not list(tmp_path.iterdir())  # no half-written library left behind
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.balanced_assign(cost, np.array([4, 4], np.int32))


def test_concurrent_builds_load_one_library(monkeypatch, tmp_path):
    """Builders racing on one fresh build directory (as spawned preprocess
    workers may) each compile to a temporary file and rename it into place:
    every one gets a whole library, and one file is left."""
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path)
    src = cuda_build.CSRC / "balanced_assign.cc"
    paths, errors = [], []

    def build():
        try:
            paths.append(cuda_build.build_host(src))
        except Exception as e:  # noqa: BLE001 - the assertion below reports it
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    import ctypes

    assert ctypes.CDLL(str(paths[0])).ampnet_fps is not None


def test_threads_that_load_together_declare_the_library_once(monkeypatch):
    """``cuda_build.load`` declares a library's signature table once: two
    threads that load the solver at the same time get one library, declared
    once, and a later load returns that library without declaring again."""
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_name_locks", {})
    declared = []
    real_declare = cuda_build.declare

    def counting_declare(lib, signatures):
        declared.append(lib)
        return real_declare(lib, signatures)

    monkeypatch.setattr(cuda_build, "declare", counting_declare)
    start = threading.Barrier(2)
    libs = []

    def load():
        start.wait()
        libs.append(cuda_build.load("balanced_assign", native.SIGNATURES))

    threads = [threading.Thread(target=load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(libs) == 2 and libs[0] is libs[1] and declared == [libs[0]]
    for fn, (restype, argtypes) in native.SIGNATURES.items():
        assert getattr(libs[0], fn).restype is restype
        assert getattr(libs[0], fn).argtypes == list(argtypes)
    assert cuda_build.load("balanced_assign", native.SIGNATURES) is libs[0]
    assert native.load_native() is libs[0] and declared == [libs[0]]


@pytest.fixture
def no_card(monkeypatch):
    """``torch.cuda``'s device guard and current stream stood in for, so
    ``cuda_build.launch`` runs here; the stream handle it appends is 1234."""
    import contextlib
    import types

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=1234))


@pytest.mark.parametrize("launches", [1, 2])
def test_launch_appends_the_stream_and_counts_each_launch(no_card, launches):
    def wrapper():
        pass

    wrapper.launches = 0
    calls = []

    def sinkhorn_columns(*args):
        calls.append(args)
        return 0

    cuda_build.launch(wrapper, sinkhorn_columns, "cuda:0", 7, None, launches=launches)
    assert calls == [(7, None, 1234)] and wrapper.launches == launches


def test_a_failed_launch_raises_naming_the_kernel_and_counts_nothing(no_card):
    def sinkhorn_iterations():
        pass

    sinkhorn_iterations.launches = 0

    def sinkhorn_rows(*args):
        return 700  # cudaErrorIllegalAddress

    with pytest.raises(RuntimeError, match="sinkhorn_iterations: the launch of sinkhorn_rows "
                                           "failed: CUDA error 700"):
        cuda_build.launch(sinkhorn_iterations, sinkhorn_rows, "cuda:0", 1, 2, launches=2)
    assert sinkhorn_iterations.launches == 0
