"""The families on the port's inference engines and command line: whole-cloud
(k = 1) tiled inference of baseline, classic and PointNet++ and a
cross-family ``attention,gru`` ensemble against the JAX package, then each
command path once on the CPU (``demo --arch gru`` at the verify recipe,
``train``/``test``/``infer``/``serve``/``export`` of the GRU, whole-cloud and
classification checkpoints), the JAX command's refusal messages and exit
codes, and the geometry and distillation options that the port once refused,
built and checked as the JAX package builds and checks them."""

import csv
import json
import os
import pickle
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import DataConfig as JDataConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.cli.main import main as jax_main
from ampnet_tpu.infer import tiled as jtiled
from ampnet_tpu.models.factory import build_model as j_build_model
from ampnet_tpu.data import schema as jschema
from ampnet_tpu.data.datasets import CloudDataset as JCloudDataset
from ampnet_tpu.train.step import make_step_fns as j_make_step_fns
from ampnet_tpu_torch.cli.main import NON_XLA, main
from ampnet_tpu_torch.core.checkpoint import load_model
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig
from ampnet_tpu_torch.core.weights import flax_variables, load_flax_variables, save_reference_pth
from ampnet_tpu_torch.data.datasets import CloudDataset
from ampnet_tpu_torch.data import schema
from ampnet_tpu_torch.infer.classify import CloudClassifier
from ampnet_tpu_torch.infer.tiled import EnsembleInferencer, TiledInferencer
from ampnet_tpu_torch.models.factory import build_model
from ampnet_tpu_torch.preproc.pipeline import PreprocessParams
from ampnet_tpu_torch.train.step import make_step_fns
from test_torch_eval_cli import serving
from test_torch_train import _perturbed

N_POINTS = 64
DEMO = ["--epochs", "2", "--n_tiles", "3", "--points_per_window", "5000",
        "--number_of_points", "256", "--device", "cpu"]


def _models(arch, seed):
    """A perturbed Flax init of ``arch``'s segmenter as (JAX module, variables,
    port model)."""
    jcfg = JConfig(data=JDataConfig(n_points=N_POINTS), model=JModelConfig(dropout=0.0))
    jm = j_build_model(jcfg, arch, "segmentation")
    x = jnp.asarray(np.random.default_rng(0).normal(size=(1, 2, N_POINTS, 9)), jnp.float32)
    v = _perturbed(jm.init(jax.random.PRNGKey(seed), x, x[..., :2].mean(2), None), seed, 0.05)
    model = build_model(AMPNetConfig(model=ModelConfig(context=arch)), arch)
    return jm, v, load_flax_variables(model, jax.tree.map(np.asarray, v))


def _cfgs(max_clusters):
    data = dict(n_points=N_POINTS, max_clusters_test=max_clusters)
    return JConfig(data=JDataConfig(**data)), AMPNetConfig(data=DataConfig(**data))


def _clouds(sizes, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 9)) * 0.5).astype(np.float32) for n in sizes]


@pytest.mark.parametrize("arch", ["baseline", "classic", "pointnet2"])
def test_whole_cloud_bucket_matches_jax(arch):
    """k = 1: the whole cloud replicate-padded to its capacity (64 · 2^j),
    the duplicates dropped on output."""
    jm, v, model = _models(arch, seed=1)
    jcfg, cfg = _cfgs(1)
    clouds, seeds = _clouds((40, 64, 300), seed=2), [5, 6, 7]
    ref = jtiled.TiledInferencer(jm, v, jcfg).predict_many(clouds, seeds, return_probs=True)
    tt = TiledInferencer(model, cfg, max_clusters=1, device="cpu")
    got = tt.predict_many(clouds, seeds, return_probs=True)
    for c, (gl, gp), (jl, jp) in zip(clouds, got, ref):
        assert gl.shape == (len(c),) and gp.shape == (len(c), 5)
        assert (gl == jl).mean() >= 0.999
        np.testing.assert_allclose(gp.astype(np.float32), jp.astype(np.float32), atol=2e-3)
    assert {k[:2] for k in tt._warm_shapes} == {(1, 64), (1, 512)}


def test_attention_gru_ensemble_matches_jax():
    members = [_models(arch, seed) for arch, seed in (("attention", 2), ("gru", 3))]
    jcfg, cfg = _cfgs(3)
    clouds, seeds = _clouds((40, 90, 120), seed=4), [1, 2, 3]  # k = 1 (n < 2 · n_points)
    jens = jtiled.EnsembleInferencer(
        [jtiled.TiledInferencer(jm, v, jcfg.replace(model=JModelConfig(context=jm.cfg.context)))
         for jm, v, _ in members])
    pens = EnsembleInferencer([TiledInferencer(m, cfg.replace(model=m.cfg), device="cpu")
                               for _, _, m in members])
    for (gl, gp), (jl, jp) in zip(pens.predict_many(clouds, seeds, return_probs=True),
                                  jens.predict_many(clouds, seeds, return_probs=True)):
        assert (gl == jl).mean() >= 0.999
        np.testing.assert_allclose(gp.astype(np.float32), jp.astype(np.float32), atol=2e-3)


# -- the command line -----------------------------------------------------------------


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """``demo --arch gru`` at the verify recipe on the CPU: its data and its
    GRU checkpoint serve every command below."""
    out = tmp_path_factory.mktemp("demo")
    assert main(["demo", "--out_path", str(out), "--arch", "gru", *DEMO]) == 0
    return out


def _summary(capsys):
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"): out.rindex("}") + 1])


def test_demo_gru_exits_0_with_its_summary(demo):
    rows = list(csv.DictReader(open(demo / "run" / "IoU-results.csv")))
    assert rows[-1]["model"] == "gru_segmentation_best" and np.isfinite(float(rows[-1]["miou"]))
    cfg, model = load_model(str(demo / "run" / "checkpoints" / "gru_segmentation_best"), "cpu")
    assert cfg.model.context == "gru" and hasattr(model.context, "gru")


def test_gru_export_test_infer_and_ensemble(demo, tmp_path, capsys):
    data, ckpt = str(demo / "data"), str(demo / "run" / "checkpoints" / "gru_segmentation_best")
    base = ["test", data, "--path_list_files", data, "--device", "cpu"]
    assert main([*base, "--model_checkpoint", ckpt, "--out_path", str(tmp_path / "a")]) == 0
    direct = _summary(capsys)
    pth = str(tmp_path / "gru.pth")
    assert main(["export", "--model_checkpoint", ckpt, "--out", pth, "--device", "cpu"]) == 0
    assert "(gru)" in capsys.readouterr().out
    assert main([*base, "--model_checkpoint", pth, "--arch", "gru",
                 "--out_path", str(tmp_path / "b")]) == 0
    exported = _summary(capsys)
    for k in ("miou", "oa"):  # the .pth restores the same model
        assert exported[k] == direct[k], k
    assert main(["infer", data, "--model_checkpoint", ckpt, "--out_path", str(tmp_path / "p"),
                 "--device", "cpu"]) == 0
    assert len([f for f in os.listdir(tmp_path / "p") if f.endswith("_preds.npy")]) == 9
    # attention + gru: two groups averaged in an EnsembleInferencer
    att = AMPNetConfig(data=DataConfig(n_points=256))
    save_reference_pth(flax_variables(build_model(att)), str(tmp_path / "att.pth"),
                       meta={"number_of_points": 256})
    assert main([*base, "--model_checkpoint", f"{tmp_path / 'att.pth'},{ckpt}",
                 "--out_path", str(tmp_path / "c")]) == 0
    assert _summary(capsys)["model"] == "att.pth+gru_segmentation_best"
    # the backend gate of the JAX command: exit 1, no work
    for argv in ([*base, "--model_checkpoint", ckpt, "--backend", "fused"],
                 ["infer", data, "--model_checkpoint", ckpt, "--backend", "int8", "--device",
                  "cpu"]):
        assert main(argv) == 1
        assert NON_XLA in capsys.readouterr().err


def _post_json(server, clouds):
    host, port = server.address
    req = urllib.request.Request(f"http://{host}:{port}/v1/predict",
                                 data=json.dumps({"clouds": [c.tolist() for c in clouds]}).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=120).read())


def test_serve_gru_falls_back_from_folded_and_refuses_int8(demo, capsys):
    ckpt = str(demo / "run" / "checkpoints" / "gru_segmentation_best")
    clouds = _clouds((700,), seed=9)
    with serving("--model_checkpoint", ckpt) as server:
        assert "backend 'folded' is attention-only; serving with 'xla'" in capsys.readouterr().err
        inf = server.service.inferencer
        assert inf.backend == "xla"
        answer = _post_json(server, clouds)
        want = inf.predict_many(clouds, seeds=[0])[0]
    assert np.array_equal(np.asarray(answer["labels"][0]), want)
    assert main(["serve", "--model_checkpoint", ckpt, "--backend", "int8", "--device", "cpu"]) == 1
    assert NON_XLA in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["pointnet2", "classic"])
def test_whole_cloud_train_then_test(demo, tmp_path, arch, capsys):
    data = str(demo / "data")
    assert main(["train", data, "--arch", arch, "--path_list_files", data, "--out_path",
                 str(tmp_path), "--number_of_points", "256", "--batch_size", "2", "--epochs",
                 "1", "--device", "cpu"]) == 0
    ckpt = str(tmp_path / "checkpoints" / f"{arch}_segmentation_best")
    meta = json.load(open(os.path.join(ckpt, "meta.json")))
    assert meta["config"]["model"]["context"] == arch and meta["task"] == "segmentation"
    capsys.readouterr()
    assert main(["test", data, "--path_list_files", data, "--model_checkpoint", ckpt,
                 "--out_path", str(tmp_path), "--device", "cpu"]) == 0
    summary = _summary(capsys)
    assert summary["n_clouds"] == 2 and np.isfinite(summary["miou"])


def test_classification_train_test_and_serve(demo, tmp_path, capsys):
    data = str(demo / "data")
    assert main(["train", data, "--task", "classification", "--arch", "baseline",
                 "--path_list_files", data, "--out_path", str(tmp_path), "--number_of_points",
                 "256", "--batch_size", "2", "--epochs", "2", "--device", "cpu"]) == 0
    assert "iou_tower" in _summary(capsys)
    ckpt = str(tmp_path / "checkpoints" / "baseline_classification_best")
    assert main(["test", data, "--task", "classification", "--path_list_files", data,
                 "--model_checkpoint", ckpt, "--out_path", str(tmp_path), "--device", "cpu"]) == 0
    out = _summary(capsys)
    assert out["n_samples"] == 2 and set(out) == {"accuracy", "precision", "recall", "f1",
                                                  "n_samples", "pr_auc"}
    row = next(csv.DictReader(open(tmp_path / "classification-results.csv")))
    assert row["model"] == "baseline_classification_best" and int(row["n_samples"]) == 2
    clouds = _clouds((300, 100), seed=3)
    with serving("--model_checkpoint", ckpt, "--task", "classification", "--backend",
                 "fused", "--tiler", "fast") as server:
        assert ("--task classification ignores: --backend, --tiler"
                in capsys.readouterr().err)
        inf = server.service.inferencer
        assert isinstance(inf, CloudClassifier)
        answer = _post_json(server, clouds)
        want = inf.predict_many(clouds, seeds=[0, 0])
    assert [a for a in answer["labels"]] == [w.tolist() for w in want]
    # a classification checkpoint is not a segmenter: test, infer and export refuse it
    for argv in (["test", data, "--path_list_files", data, "--model_checkpoint", ckpt],
                 ["infer", data, "--model_checkpoint", ckpt],
                 ["export", "--model_checkpoint", ckpt, "--out", str(tmp_path / "x.pth")]):
        assert main([*argv, "--device", "cpu"]) == 1
        assert "is a classification checkpoint" in capsys.readouterr().err


def test_jax_refusals_and_exit_codes(demo, tmp_path, capsys):
    """The port's refusals print the JAX command's messages, exit 1, as the
    JAX command does on the same arguments."""
    data = str(demo / "data")
    ckpt = str(demo / "run" / "checkpoints" / "gru_segmentation_best")
    train = ["train", data, "--path_list_files", data, "--device", "cpu", "--batch_size", "4"]
    save_reference_pth(flax_variables(build_model(AMPNetConfig())), str(tmp_path / "m.pth"))
    for argv, msg in (  # the JAX command prints each message but pointnet2's (a ValueError)
        ([*train, "--task", "classification", "--grad_accum", "2"],
         "--grad_accum is segmentation-only (the classification step has no accumulation "
         "path; its residuals are tiny)"),
        ([*train, "--task", "classification", "--focal_gamma", "2"],
         "--focal_gamma is segmentation-only (make_cls_step_fns builds its own weighted-CE "
         "objective)"),
        ([*train, "--task", "classification", "--arch", "pointnet2"],
         "pointnet2 supports segmentation only"),
        (["test", data, "--path_list_files", data, "--task", "classification",
          "--model_checkpoint", f"{ckpt},{ckpt}", "--device", "cpu"],
         "checkpoint ensembles support segmentation only"),
        (["serve", "--task", "classification", "--model_checkpoint", f"{ckpt},{ckpt}",
          "--device", "cpu"], "checkpoint ensembles support segmentation only"),
        (["test", data, "--path_list_files", data, "--model_checkpoint",
          str(tmp_path / "m.pth"), "--arch", "baseline", "--device", "cpu"],
         "torch checkpoint import supports the attention/gru segmenters"),
    ):
        assert main(argv) == 1, argv
        assert msg in capsys.readouterr().err, argv
        if "pointnet2" not in argv:
            i = argv.index("--device")
            assert jax_main(argv[:i] + argv[i + 2:]) == 1, argv
            assert msg in capsys.readouterr().err, argv
    whole = tmp_path / "ckpts"
    assert main(["train", data, "--arch", "baseline", "--path_list_files", data, "--out_path",
                 str(whole), "--number_of_points", "256", "--batch_size", "2", "--epochs", "1",
                 "--device", "cpu"]) == 0
    capsys.readouterr()
    assert main(["export", "--model_checkpoint",
                 str(whole / "checkpoints" / "baseline_segmentation_best"), "--out",
                 str(tmp_path / "b.pth"), "--device", "cpu"]) == 1
    assert ("torch export supports the attention/gru segmenters (no context.mha/context.gru "
            "in the checkpoint's parameters)") in capsys.readouterr().err
    assert not (tmp_path / "b.pth").exists()


def _shapes(variables):
    """{collection/path: shape} of a Flax-layout variable tree."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out["/".join(prefix + (k,))] = tuple(np.shape(v))

    for coll in ("params", "batch_stats"):
        walk(variables.get(coll, {}), (coll,))
    return out


def test_geometry_and_distillation_options_build_as_in_jax(tmp_path, capsys):
    """What the port once refused builds and checks as JAX does: the edge
    block and the geometry tokens give JAX's parameter tree (the classifier
    and the GRU context ignore the tokens), the datasets read the geometric
    columns, the schema refuses an artifact without them, ``PreprocessParams``
    takes ``geom_features``, a teacher needs ``0 < distill_alpha <= 1``, and
    ``train --distill_from`` exits 1 on a checkpoint that does not exist."""
    x = jnp.zeros((1, 2, 16, 15), jnp.float32)
    for arch, task, mkw in (("attention", "segmentation",
                             dict(local_agg="edge", local_agg_k=4, att_geom_tokens=True)),
                            ("gru", "classification", dict(att_geom_tokens=True)),
                            ("attention", "classification", dict(local_agg="edge",
                                                                 att_geom_tokens=True))):
        data = dict(extra_features=6, max_windows=2)
        jm = j_build_model(JConfig(data=JDataConfig(**data), model=JModelConfig(**mkw)), arch,
                           task)
        jv = jm.init(jax.random.PRNGKey(0), x, x[..., :2].mean(2), None)
        port = build_model(AMPNetConfig(data=DataConfig(**data), model=ModelConfig(**mkw)),
                           arch, task)
        assert _shapes(flax_variables(port)) == _shapes(jv), (arch, task)
    pc = np.random.default_rng(0).uniform(size=(50, 19)).astype(np.float32)
    np.testing.assert_array_equal(schema.select_model_features(pc, 6),
                                  np.asarray(jschema.select_model_features(pc, 6)))
    with pytest.raises(ValueError, match="re-run `ampnet preprocess --geom_features`") as got:
        schema.select_model_features(pc[:, :13], 6)
    with pytest.raises(ValueError) as want:
        jschema.select_model_features(pc[:, :13], 6)
    assert str(got.value) == str(want.value)
    with open(tmp_path / "c.pkl", "wb") as f:
        pickle.dump(pc, f)
    a = CloudDataset(str(tmp_path), ["c.pkl"], number_of_points=64, extra_features=6)[0]
    b = JCloudDataset(str(tmp_path), ["c.pkl"], number_of_points=64, extra_features=6)[0]
    assert a["points"].shape == (64, 15)
    np.testing.assert_array_equal(a["points"], b["points"])
    assert PreprocessParams(out_path=str(tmp_path), geom_features=True).geom_k == 24
    for fn, cfg in ((make_step_fns, AMPNetConfig()), (j_make_step_fns, JConfig())):
        with pytest.raises(ValueError, match=r"distillation needs 0 < distill_alpha <= 1, "
                                             r"got 0\.0"):
            fn(cfg, teacher=[object()])
    assert main(["train", str(tmp_path), "--path_list_files", str(tmp_path), "--device", "cpu",
                 "--distill_from", "a"]) == 1
    assert "checkpoint not found: a" in capsys.readouterr().err
