"""The port's ``test``, ``infer`` and ``export`` command lines against the JAX
package's on the same reference ``.pth`` and seeded ``.pkl`` clouds, and how
``test`` / ``infer`` / ``serve`` group comma-separated checkpoints and refuse
what is not ported. The clouds tile into one window each (n < 2·n_points), so
both packages pad them alike and no k-means start needs injecting."""

import contextlib
import csv
import importlib.util
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from ampnet_tpu.cli.main import main as jmain
from ampnet_tpu.core.torch_export import export_reference_checkpoint
from ampnet_tpu_torch.cli.main import build_parser, main, make_server
from ampnet_tpu_torch.core.checkpoint import CheckpointManager, load_model
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig, TrainConfig
from ampnet_tpu_torch.core.weights import flax_variables, load_reference_pth, save_reference_pth
from ampnet_tpu_torch.infer.tiled import EnsembleInferencer, TiledInferencer, evaluate_dataset
from ampnet_tpu_torch.models.amp import AMPNetSegmenter
from ampnet_tpu_torch.train.state import create_train_state
from test_torch_eval import TIMING, _write_clouds

N_POINTS = 64
SIZES = (70, 90, 100, 127)  # k = 1 at n_points 64


def _model(seed, **model_kw):
    return AMPNetSegmenter(ModelConfig(**model_kw), generator=torch.Generator().manual_seed(seed))


def _pth(path, seed, n_points=N_POINTS):
    save_reference_pth(flax_variables(_model(seed)), str(path),
                       meta={"number_of_points": n_points})
    return str(path)


def _ckpt_dir(root, name, seed, **model_kw):
    """A port checkpoint directory (meta.json + state.pt) of a fresh model."""
    cfg = AMPNetConfig(data=DataConfig(n_points=N_POINTS), model=ModelConfig(**model_kw),
                       train=TrainConfig(batch_size=8, learning_rate=3e-4))
    model = _model(seed, **model_kw)
    path = CheckpointManager(str(root)).save(
        name, create_train_state(cfg, model, 1, "cpu"), config_json=cfg.to_json(),
        batch_size=8, learning_rate=3e-4, number_of_points=N_POINTS)
    return path, model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One ``test`` and one ``infer`` run of each package on the same .pth."""
    root = tmp_path_factory.mktemp("cli")
    data = root / "data"
    data.mkdir()
    _write_clouds(data, SIZES, seed=61)
    pth = _pth(root / "model_attention.pth", seed=3)
    common = [str(data), "--model_checkpoint", pth]
    for tag, fn, extra in (("jax", jmain, []), ("port", main, ["--device", "cpu"])):
        assert fn(["test", *common, "--path_list_files", str(data), "--max_clusters", "3",
                   "--out_path", str(root / f"{tag}_test"), *extra]) == 0
        probs = ["--save_probs"] if tag == "port" else []
        assert fn(["infer", *common, "--out_path", str(root / f"{tag}_infer"),
                   *probs, *extra]) == 0
    return root, pth


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f)), open(path).readline()


def test_cli_test_writes_the_jax_csv_row(runs):
    root, _ = runs
    (ja,), jhead = _csv(root / "jax_test" / "IoU-results.csv")
    (pa,), phead = _csv(root / "port_test" / "IoU-results.csv")
    assert jhead == phead
    for k in ja:
        if k == "model":
            assert ja[k] == pa[k] == "model_attention.pth"
        elif k not in TIMING:
            a, b = float(ja[k]), float(pa[k])
            assert np.isnan(a) == np.isnan(b) and (np.isnan(a) or abs(a - b) <= 1e-6), k


def test_cli_infer_writes_the_jax_predictions(runs):
    root, _ = runs
    stems = [f"cloud{i}" for i in range(len(SIZES))]
    for stem, n in zip(stems, SIZES):
        jp = np.load(root / "jax_infer" / f"{stem}_preds.npy")
        pp = np.load(root / "port_infer" / f"{stem}_preds.npy")
        assert pp.dtype == np.int32 and pp.shape == (n,)
        assert (pp == jp).mean() >= 0.999
        probs = np.load(root / "port_infer" / f"{stem}_probs.npy")
        assert probs.dtype == np.float16 and probs.shape == (n, 5)
        np.testing.assert_array_equal(probs.argmax(-1), pp)
        assert (root / "port_infer" / f"{stem}_hist.png").exists()


def test_cli_infer_refuses_before_any_work(tmp_path, capsys):
    missing = str(tmp_path / "nowhere.pth")
    assert main(["infer", str(tmp_path), "--model_checkpoint", missing, "--tta", "9"]) == 1
    assert "--tta must be in 1..8" in capsys.readouterr().err
    assert main(["infer", str(tmp_path), "--model_checkpoint", missing,
                 "--tile_votes", "0"]) == 1
    assert "--tile_votes must be >= 1" in capsys.readouterr().err
    (tmp_path / "tile0.las").write_bytes(b"LASF")
    assert main(["infer", str(tmp_path), "--model_checkpoint", missing, "--save_probs"]) == 1
    assert "not supported in whole-tile LAS mode" in capsys.readouterr().err
    assert main(["test", str(tmp_path), "--model_checkpoint", missing,
                 "--path_list_files", str(tmp_path), "--device", "cpu"]) == 1
    assert "not found" in capsys.readouterr().err
    assert main(["test", str(tmp_path), "--model_checkpoint", str(tmp_path),
                 "--path_list_files", str(tmp_path), "--device", "cpu"]) == 1
    assert "orbax" in capsys.readouterr().err


def test_figure_flags_need_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib is missing, each figure flag exits 1 before any work
    (the checkpoint named here does not exist) and names it."""
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    missing = str(tmp_path / "nowhere.pth")
    test = ["test", str(tmp_path), "--path_list_files", str(tmp_path), "--model_checkpoint",
            missing, "--device", "cpu"]
    for argv in ([*test, "--plot"], [*test, "--analysis"],
                 ["infer", str(tmp_path), "--model_checkpoint", missing, "--save_probs"]):
        assert main(argv) == 1, argv
        err = capsys.readouterr().err
        assert "matplotlib" in err and argv[-1] in err and "not found" not in err
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        evaluate_dataset(None, [], plot_dir=str(tmp_path / "plots"))
    assert not os.path.exists(tmp_path / "plots")


def test_cli_export_equals_the_jax_export(tmp_path):
    ckpt, model = _ckpt_dir(tmp_path / "ckpts", "attention_segmentation_best", seed=7)
    out = tmp_path / "exported" / "model.pth"
    assert main(["export", "--model_checkpoint", ckpt, "--out", str(out), "--device", "cpu"]) == 0
    variables = flax_variables(model)
    meta = {"number_of_points": N_POINTS, "batch_size": 8, "lr": 3e-4}
    export_reference_checkpoint(variables, str(tmp_path / "jax.pth"), arch="attention", meta=meta)
    ours = torch.load(out, map_location="cpu", weights_only=True)
    ref = torch.load(tmp_path / "jax.pth", map_location="cpu", weights_only=True)
    assert ours.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], dict):
            assert ours[k].keys() == ref[k].keys()
            for key, t in ref[k].items():
                assert t.dtype == ours[k][key].dtype and torch.equal(t, ours[k][key]), key
        elif isinstance(ref[k], float) and np.isnan(ref[k]):
            assert np.isnan(ours[k])
        else:
            assert ours[k] == ref[k], k
    back, back_meta = load_reference_pth(str(out))
    assert back_meta["number_of_points"] == N_POINTS and back_meta["lr"] == 3e-4
    for coll in ("params", "batch_stats"):
        for a, b in zip(jax_leaves(variables[coll]), jax_leaves(back[coll])):
            assert a[0] == b[0] and np.array_equal(a[1], b[1]), a[0]
    # a .pth exports too, keeping its number_of_points
    pth = _pth(tmp_path / "ref.pth", seed=8, n_points=32)
    assert main(["export", "--model_checkpoint", pth, "--out", str(tmp_path / "again.pth"),
                 "--device", "cpu"]) == 0
    assert load_reference_pth(str(tmp_path / "again.pth"))[1]["number_of_points"] == 32
    with pytest.raises(NotImplementedError, match="attention/gru segmenters"):
        save_reference_pth({"params": {"context": {}}}, str(tmp_path / "other.pth"))


def jax_leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from jax_leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(tree[k])


@contextlib.contextmanager
def serving(*argv):
    """``serve --device cpu --port 0 *argv`` answering on a thread."""
    server = make_server(build_parser().parse_args(
        ["serve", "--device", "cpu", "--port", "0", *argv]))
    t = threading.Thread(target=server.httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield server
    finally:
        server.close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_serve_stacks_same_signature_checkpoints(tmp_path):
    """Two .pth files of one signature stack in one TiledInferencer; the
    server answers as predict_many does and /v1/stats reports the ensemble."""
    a, b = _pth(tmp_path / "a.pth", 1), _pth(tmp_path / "b.pth", 2)
    with serving("--model_checkpoint", f"{a},{b}", "--backend", "fused",
                 "--max_clusters", "3") as server:
        inf = server.service.inferencer
        assert isinstance(inf, TiledInferencer) and inf.ensemble == 2
        host, port = server.address
        pts = np.random.default_rng(0).normal(size=(150, 9)).astype(np.float32)
        req = urllib.request.Request(f"http://{host}:{port}/v1/predict", data=pts.tobytes(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            labels = np.frombuffer(r.read(), np.int8)
        np.testing.assert_array_equal(labels, inf.predict_many([pts], seeds=[0])[0])
        with urllib.request.urlopen(f"http://{host}:{port}/v1/stats", timeout=30) as r:
            assert json.loads(r.read())["ensemble"] == 2


def test_grouping_and_refusals(tmp_path, capsys):
    a, c = _pth(tmp_path / "a.pth", 1), _pth(tmp_path / "c.pth", 3, n_points=32)
    with serving("--model_checkpoint", f"{a},{c}") as server:
        inf = server.service.inferencer
        assert isinstance(inf, EnsembleInferencer) and inf.ensemble == 2
        assert [m.n_points for m in inf.members] == [N_POINTS, 32]
    d5, _ = _ckpt_dir(tmp_path / "ckpts", "five", seed=1)
    d3, _ = _ckpt_dir(tmp_path / "ckpts", "three", seed=2, num_classes=3)
    base = [str(tmp_path), "--path_list_files", str(tmp_path), "--device", "cpu"]
    assert main(["test", *base, "--model_checkpoint", f"{d5},{d3}"]) == 1
    assert "disagree on num_classes: [3, 5]" in capsys.readouterr().err
    for argv, item in ((["test", *base, "--model_checkpoint", a, "--task", "classification"],
                        "attention/gru segmenters"),
                       (["test", *base, "--model_checkpoint", a, "--arch", "baseline"],
                        "attention/gru segmenters"),
                       (["test", *base, "--model_checkpoint", d5, "--task",
                         "classification"], "is a segmentation checkpoint"),
                       (["test", *base, "--model_checkpoint", f"{a},{c}", "--task",
                         "classification"], "ensembles support segmentation only"),
                       (["serve", "--model_checkpoint", a, "--num_devices", "2"], "item 5"),
                       (["serve", "--model_checkpoint", a, "--task", "classification",
                         "--device", "cpu"], "attention/gru segmenters")):
        assert main(argv) == 1, argv
        assert item in capsys.readouterr().err, argv


def test_evaluation_entry_points_default_to_the_card(tmp_path, monkeypatch):
    ckpt, _ = _ckpt_dir(tmp_path / "ckpts", "best", seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load_model(ckpt)
    for argv in (["test", str(tmp_path), "--model_checkpoint", ckpt,
                  "--path_list_files", str(tmp_path)],
                 ["infer", str(tmp_path), "--model_checkpoint", ckpt],
                 ["export", "--model_checkpoint", ckpt, "--out", str(tmp_path / "m.pth")]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    assert not os.path.exists(tmp_path / "m.pth")
