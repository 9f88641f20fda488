"""The port's ``bench`` (``ampnet_tpu_torch/bench.py``) against the JAX bench
(``bench.py``): the same draws, the same forward with its carry on the same
weights, the same keys, and the command line; and its copy of the CPU
reference loop against ``benchmarks/torch_baseline.py``. CPU only, small
sizes."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.models.amp import AMPNetSegmenter as JSegmenter
from ampnet_tpu.models.backends import make_forward as j_make_forward
from ampnet_tpu_torch import bench
from ampnet_tpu_torch.cli.main import build_parser, cmd_bench
from ampnet_tpu_torch.cli.main import main as cli_main
from ampnet_tpu_torch.core.config import AMPNetConfig
from ampnet_tpu_torch.core.weights import load_flax_variables
from benchmarks import torch_baseline

SMALL = dict(batch=2, windows=3, points=64, feats=9)
# bench.py's measure_tpu return keys and main's stdout keys
FORWARD_KEYS = {"windows_per_sec", "points_per_sec", "throughput_step_ms", "latency_step_ms",
                "throughput_rep_ms", "latency_rep_ms", "windows_per_sec_reps", "compile_s",
                "backend", "device"}
TRAIN_KEYS = {"step_ms", "windows_per_sec", "compile_s", "batch"}
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "compile_s", "reps_windows_per_sec",
             "rep_spread_pct"}


@pytest.fixture(autouse=True)
def one_thread():
    """Each test runs its tiny tensors on one thread: the bench's loops make
    hundreds of small ops a call, and under a parallel test run every op
    with several threads waits on the busiest core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_draws_are_the_jax_bench_sequence():
    """bench.py:207-209 (forward) and :298-303 (train), each from its own
    default_rng(0)."""
    b, w, n, f = 2, 3, 64, 9
    rng = np.random.default_rng(0)
    want_pts = rng.normal(size=(b, w, n, f)).astype(np.float32)
    want_cent = rng.normal(size=(b, w, 2)).astype(np.float32)
    pts, cent = bench.forward_inputs(b, w, n, f)
    np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_array_equal(cent, want_cent)

    rng = np.random.default_rng(0)
    want = {"points": rng.normal(size=(b, w, n, f)).astype(np.float32),
            "labels": rng.integers(-1, 5, size=(b, w, n)).astype(np.int32),
            "centroids": rng.normal(size=(b, w, 2)).astype(np.float32)}
    got = bench.train_inputs(b, w, n, f)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def jax_bench_model():
    """The JAX bench's model at the small geometry: init from PRNGKey(0) on
    the bench draws, weights perturbed so BatchNorm and the T-Nets are not
    the identity, carried into the port."""
    pts, cent = bench.forward_inputs(**SMALL)
    cfg = JConfig()
    jm = JSegmenter(cfg.model)
    pad = jnp.zeros(pts.shape[:2], bool)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(cent), pad)
    leaves, treedef = jax.tree.flatten(v)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    v = jax.tree.unflatten(treedef, [l + jax.random.normal(k, l.shape, l.dtype) * 0.05
                                     for k, l in zip(keys, leaves)])
    model = load_flax_variables(bench.bench_model(AMPNetConfig()),
                                jax.tree.map(np.asarray, v)).eval()
    return cfg, jm, v, model, (pts, cent, np.zeros(pts.shape[:2], bool))


@pytest.mark.parametrize("backend,tol", [("xla", 1e-4), ("folded", 1e-4), ("fused", 5e-3)])
def test_bench_forward_with_its_carry_matches_jax(jax_bench_model, backend, tol):
    """Two chained calls of the bench forward (``points + carry``, then
    ``carry = max(logits) * 1e-12``) against the same chain over JAX's
    ``make_forward`` (its Pallas chain in interpret mode under fused)."""
    cfg, jm, v, model, (pts, cent, pad) = jax_bench_model
    jfwd = j_make_forward(jm, cfg, backend, interpret=True)
    fwd = bench.make_bench_forward(model, AMPNetConfig(), backend, "cpu")
    jcarry = jnp.zeros((), jnp.float32)
    carry = torch.zeros(())
    for _ in range(2):
        jlogits = jfwd(v, jnp.asarray(pts) + jcarry, jnp.asarray(cent), jnp.asarray(pad))
        jcarry = jnp.max(jlogits) * 1e-12
        logits, carry = fwd(torch.from_numpy(pts), torch.from_numpy(cent),
                            torch.from_numpy(pad), carry)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=tol, rtol=tol)
        np.testing.assert_allclose(float(carry), float(jcarry), rtol=tol)
    assert (logits.argmax(-1).numpy() == np.asarray(jlogits).argmax(-1)).mean() > 0.999


@pytest.mark.parametrize("backend", [None, "fused", "int8"])
def test_measure_forward_returns_the_jax_keys(monkeypatch, backend):
    """Under each backend, and under xla when AMPNET_BACKEND is unset."""
    if backend is None:
        monkeypatch.delenv("AMPNET_BACKEND", raising=False)
    else:
        monkeypatch.setenv("AMPNET_BACKEND", backend)
    out = bench.measure_forward(iters=1, device="cpu", **SMALL)
    assert set(out) == FORWARD_KEYS
    assert out["backend"] == (backend or "xla") and out["device"] == "cpu"
    assert len(out["windows_per_sec_reps"]) == 3 and out["windows_per_sec"] > 0
    assert out["points_per_sec"] == pytest.approx(out["windows_per_sec"] * SMALL["points"])


def test_measure_train_returns_the_jax_keys():
    out = bench.measure_train(iters=1, device="cpu", **SMALL)
    assert set(out) == {"fp32", "bf16"}
    for arm in out.values():
        assert set(arm) == TRAIN_KEYS
        assert arm["batch"] == SMALL["batch"] and arm["step_ms"] > 0
        assert arm["windows_per_sec"] == pytest.approx(
            SMALL["batch"] * SMALL["windows"] / (arm["step_ms"] / 1e3))


def small_main(monkeypatch, train=None):
    """``main`` over the real forward at the small size; the train arms (held
    by the test above) replaced by ``train`` or by their keys."""
    monkeypatch.setattr(bench, "measure_forward",
                        functools.partial(bench.measure_forward, iters=1, **SMALL))
    monkeypatch.setattr(bench, "measure_train", train or (lambda device: {
        arm: dict.fromkeys(TRAIN_KEYS, 1.0) for arm in ("fp32", "bf16")}))
    return bench.main("cpu")


def test_main_prints_one_line_with_the_jax_keys(monkeypatch, capsys):
    monkeypatch.delenv("AMPNET_BENCH_REMEASURE", raising=False)
    assert small_main(monkeypatch) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS
    assert line["metric"] == "ampnet_inference_throughput" and line["unit"] == "windows/sec"
    with open(bench.BASELINE_PIN) as f:
        pin = json.load(f)
    assert line["vs_baseline"] == round(line["value"] / pin["windows_per_sec"], 2)
    detail = json.loads(err[err.index("{"):])
    assert set(detail) == {"baseline_cpu_torch", "train", "forward"}
    assert not [k for part in ("train", "forward") for k in (part, *detail[part])
                if "tpu" in k]
    assert set(detail["train"]) == {"fp32", "bf16"}


def test_main_keeps_a_train_arm_error_in_the_detail(monkeypatch, capsys):
    def broken(device):
        raise RuntimeError("no step")

    assert small_main(monkeypatch, train=broken) == 0
    out, err = capsys.readouterr()
    assert len(out.strip().splitlines()) == 1
    detail = json.loads(err[err.index("{\n"):])
    assert detail["train"] == {"error": "RuntimeError('no step')"}


def test_bench_command_line():
    args = build_parser().parse_args(["bench", "--device", "cpu"])
    assert args.fn is cmd_bench and args.device == "cpu"
    assert build_parser().parse_args(["bench"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli_main(["bench"])


def test_reference_loop_is_the_benchmarks_copy():
    """The same modules in the same order: one seed gives the same weights
    and the same logits as ``benchmarks/torch_baseline.py``'s model."""
    models = []
    for build in (bench.build_reference_ampnet, torch_baseline.build_torch_ampnet):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            enc, head = build()
        models.append((enc.eval(), head.eval()))
    (enc, head), (t_enc, t_head) = models
    for mine, theirs in ((enc, t_enc), (head, t_head)):
        a, b = mine.state_dict(), theirs.state_dict()
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    rng = np.random.default_rng(1)
    windows = torch.from_numpy(rng.normal(size=(2, 64, 9)).astype(np.float32))
    cent = torch.from_numpy(rng.normal(size=(1, 2, 2)).astype(np.float32))
    torch.testing.assert_close(bench.reference_cloud(enc, head, windows, cent),
                               bench.reference_cloud(t_enc, t_head, windows, cent),
                               rtol=0, atol=0)


def test_measure_reference_inference_keys_and_threads():
    threads = torch.get_num_threads()
    out = bench.measure_reference_inference(n_clouds=1, n_windows=2, n_points=32, repeats=1)
    want = torch_baseline.measure_reference_inference(n_clouds=1, n_windows=2, n_points=32,
                                                      threads=1, repeats=1)
    torch.set_num_threads(threads)
    assert set(out) == set(want)
    assert out["torch_threads"] == 1 and out["windows_per_sec"] > 0
    assert torch.get_num_threads() == threads


def test_get_baseline_pin_cache_and_fallback(monkeypatch, tmp_path):
    monkeypatch.delenv("AMPNET_BENCH_REMEASURE", raising=False)
    with open(bench.BASELINE_PIN) as f:
        assert bench.get_baseline() == json.load(f)
    cache = tmp_path / "cache.json"
    monkeypatch.setattr(bench, "BASELINE_CACHE", str(cache))
    monkeypatch.setenv("AMPNET_BENCH_REMEASURE", "1")
    monkeypatch.setattr(bench, "measure_reference_inference",
                        lambda **kw: {"windows_per_sec": 1.5, **kw})
    first = bench.get_baseline()
    assert first["windows_per_sec"] == 1.5 and first["n_points"] == bench.POINTS
    assert json.loads(cache.read_text()) == first
    cache.unlink()

    def fails(**_):
        raise OSError("no host")

    monkeypatch.setattr(bench, "measure_reference_inference", fails)
    assert bench.get_baseline() == bench.FALLBACK_BASELINE
    assert not cache.exists()
