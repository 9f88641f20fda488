"""Geometry in the port against the JAX package on the same seeded inputs:
the eigenfeature columns (``preproc/geomfeat.py``, ``preprocess
--geom_features``), the kNN edge block and the geometry tokens of the model
(eval mode, from loaded JAX variables), a ``--geom_features`` checkpoint
under the ``fused`` and ``int8`` backends, and its ``test``, ``infer``,
``serve``, ``export`` and ``demo`` command lines on the CPU.

The kNN picks the same neighbours only where no two distances lie within
rounding of each other, so the clouds here are normal draws (no near-ties);
exact ties (duplicate points) go to the lower index in both packages, which
``test_knn_matches_lax_top_k_with_ties`` holds."""

import argparse
import csv
import json
import pickle
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ampnet_tpu.cli import main as jcli
from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import DataConfig as JDataConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.core.torch_export import export_reference_checkpoint
from ampnet_tpu.data.datasets import EvalCloudDataset as JEvalCloudDataset
from ampnet_tpu.infer import tiled as jtiled
from ampnet_tpu.models import amp as jamp
from ampnet_tpu.models.backends import make_forward as j_make_forward
from ampnet_tpu.models.factory import build_model as j_build_model
from ampnet_tpu.preproc import geomfeat as jgeom
from ampnet_tpu_torch.cli.main import Refused, build_parser, main, make_server
from ampnet_tpu_torch.core.checkpoint import CheckpointManager, load_model
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig, TrainConfig
from ampnet_tpu_torch.core.weights import flax_variables, load_flax_variables
from ampnet_tpu_torch.data.io_utils import load_cloud
from ampnet_tpu_torch.models import amp
from ampnet_tpu_torch.models.backends import make_forward
from ampnet_tpu_torch.models.factory import build_model
from ampnet_tpu_torch.preproc import geomfeat
from ampnet_tpu_torch.train.state import create_train_state
from test_torch_eval import TIMING
from test_torch_eval_cli import serving
from test_torch_preproc import PRE, _need_jax_native, _port_preprocess_argv, _same_tree
from test_torch_train import _perturbed

N_POINTS = 64
MODEL = dict(global_feat=64, att_heads=4, dropout=0.0, local_agg_k=8)


def _with_stats(variables, seed):
    """``variables`` with seeded running statistics: mean ~ N(0, 0.1), var in
    [0.5, 1.5], so eval-mode BatchNorm is not the identity."""
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: np.asarray(a), variables["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.1, a.shape)).astype(np.float32), stats)
    return {"params": variables["params"], "batch_stats": stats}


def _points(shape, seed, extra=6):
    """[..., N, 9 + extra] normal model features, x/y/z varied per window,
    the geometric columns in [0, 1]."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(*shape, 9)) * 0.5).astype(np.float32)
    geo = rng.uniform(size=(*shape, extra)).astype(np.float32)
    return np.concatenate([pts, geo], axis=-1)


# -- the eigenfeature columns -------------------------------------------------------


def _geom_case(name):
    rng = np.random.default_rng(7)
    if name == "empty":
        return np.zeros((0, 3))
    if name == "one_point":
        return rng.normal(size=(1, 3))
    if name == "two_points":  # kk = 1 < 2
        return rng.normal(size=(2, 3))
    if name == "coincident":  # every neighbourhood flat: zeros, not NaN
        return np.tile(rng.normal(size=(1, 3)) * 10, (30, 1))
    if name == "k_above_n":
        return rng.normal(size=(10, 3)) * 5
    if name == "line_and_plane":
        t = rng.uniform(0, 50, 200)
        line = np.stack([t, 0.01 * rng.normal(size=200), 20 + 0.01 * rng.normal(size=200)], 1)
        plane = np.stack([rng.uniform(0, 50, 300), rng.uniform(0, 50, 300),
                          0.05 * rng.normal(size=300)], 1)
        return np.concatenate([line, plane]) + 430000.0
    return rng.normal(size=(500, 3)) * [30.0, 30.0, 8.0]


@pytest.mark.parametrize("radius_norm", ["absolute", "median"])
@pytest.mark.parametrize("case", ["empty", "one_point", "two_points", "coincident", "k_above_n",
                                  "line_and_plane", "cloud"])
def test_geometric_features_match_jax(case, radius_norm):
    xyz = _geom_case(case)
    got = geomfeat.geometric_features(xyz, k=24, radius_norm=radius_norm)
    want = jgeom.geometric_features(xyz, k=24, radius_norm=radius_norm)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(xyz), 6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.isfinite(got).all() and (got >= 0).all() and (got <= 1).all()
    assert geomfeat.GEOM_FEATURE_NAMES == jgeom.GEOM_FEATURE_NAMES


def test_geometric_features_refuse_an_unknown_radius_norm():
    with pytest.raises(ValueError, match="radius_norm must be 'absolute' or 'median'"):
        geomfeat.geometric_features(np.zeros((5, 3)), radius_norm="mean")


@pytest.fixture(scope="module")
def geom_preprocessed(tmp_path_factory):
    """``preprocess --geom_features --geom_k 16 --geom_radius_norm median`` of
    each package, once each, on the same synthetic tiles, and the port's plain
    ``preprocess`` of them."""
    _need_jax_native()
    root = tmp_path_factory.mktemp("geom_pre")
    jcli.cmd_synth(argparse.Namespace(out_path=str(root / "las"), n_tiles=2, windows_per_tile=2,
                                      points_per_window=1500, window_size=50.0, seed=3,
                                      terrain_relief=2.0))
    assert jcli.cmd_preprocess(argparse.Namespace(
        in_path=str(root / "las"), out_path=str(root / "jax"), workers=1, assigner="exact_mcf",
        blocks_json=None, geom_features=True, geom_k=16, geom_radius_norm="median", **PRE)) == 0
    geo = ["--geom_features", "--geom_k", "16", "--geom_radius_norm", "median"]
    assert main(_port_preprocess_argv(root / "las", root / "port") + geo) == 0
    assert main(_port_preprocess_argv(root / "las", root / "plain")) == 0
    return root


def test_preprocess_geom_features_equal_jax(geom_preprocessed):
    root = geom_preprocessed
    files = _same_tree(root / "jax", root / "port")
    clouds = [f for f in files if f.endswith(".pkl")]
    assert clouds and len(clouds) == len([f for f in files if f.startswith("kmeans_")])
    for f in clouds:
        pc, plain = load_cloud(str(root / "port" / f)), load_cloud(str(root / "plain" / f))
        assert pc.shape == (plain.shape[0], 19)
        assert np.array_equal(pc[:, :13], plain)  # the first 13 columns, bit for bit
        assert (pc[:, 13:] >= 0).all() and (pc[:, 13:] <= 1).all()


# -- the kNN, the edge block and the geometry tokens ----------------------------------


def _jax_knn(coords, mask, k):
    """The neighbour choice of JAX's EdgeLocalAggregation, written out."""
    c32 = jnp.asarray(coords, jnp.float32)
    sq = jnp.sum(c32 * c32, axis=-1)
    d2 = sq[:, :, None] - 2.0 * jnp.einsum("bnd,bmd->bnm", c32, c32) + sq[:, None, :]
    if mask is not None:
        d2 = jnp.where(jnp.asarray(mask)[:, None, :], d2, jnp.inf)
    return np.asarray(jax.lax.top_k(-d2, k)[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_knn_matches_lax_top_k_with_ties(dtype, monkeypatch):
    """Exact duplicates (replicate padding) and points on a grid (equal
    distances): ties go to the lower index, as ``lax.top_k`` gives them;
    padded points are never picked; windows in several passes."""
    monkeypatch.setattr(amp, "KNN_WINDOWS_PER_PASS", 2)
    rng = np.random.default_rng(4)
    coords = rng.normal(size=(5, 40, 3)).astype(np.float32)
    coords[0, 20:] = coords[0, :20]  # every point twice
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(2.0)), -1).reshape(-1, 3)
    coords[1, :32] = g  # integer grid: many equal distances
    coords[1, 32:] = g[:8]
    mask = rng.uniform(size=(5, 40)) > 0.2
    mask[2, 3:] = False  # fewer real points than k
    for m in (None, mask):
        got = amp.knn_indices(torch.from_numpy(coords).to(dtype),
                              None if m is None else torch.from_numpy(m), 8).numpy()
        np.testing.assert_array_equal(got, _jax_knn(coords, m, 8))


def test_edge_block_and_geometry_tokens_match_jax():
    """``EdgeLocalAggregation`` (masked and not) and ``GeomTokenEncoding`` in
    eval mode from perturbed JAX variables with seeded running statistics:
    5e-4 (tests/test_model_parity_torch.py)."""
    rng = np.random.default_rng(5)
    cfg = JModelConfig(**MODEL)
    h = rng.normal(size=(3, 64, 64)).astype(np.float32)
    coords = (rng.normal(size=(3, 64, 3)) * 0.5).astype(np.float32)
    mask = rng.uniform(size=(3, 64)) > 0.25
    je = jamp.EdgeLocalAggregation(cfg)
    v = _with_stats(_perturbed(je.init(jax.random.PRNGKey(0), h, coords, None), 1, 0.05), 2)
    port = amp.EdgeLocalAggregation(ModelConfig(**MODEL), 64, torch.Generator().manual_seed(0))
    load_flax_variables(port, jax.tree.map(np.asarray, v))
    port.eval()
    for m in (None, mask):
        want = np.asarray(je.apply(v, h, coords, None if m is None else jnp.asarray(m)))
        with torch.no_grad():
            got = port(torch.from_numpy(h), torch.from_numpy(coords),
                       None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)
    summary = rng.uniform(size=(2, 9, 12)).astype(np.float32)
    jg = jamp.GeomTokenEncoding(64)
    gv = _perturbed(jg.init(jax.random.PRNGKey(3), summary), 4, 0.1)
    pg = amp.GeomTokenEncoding(12, 64, torch.Generator().manual_seed(0))
    load_flax_variables(pg, jax.tree.map(np.asarray, gv))
    with torch.no_grad():
        got = pg(torch.from_numpy(summary)).numpy()
    np.testing.assert_allclose(got, np.asarray(jg.apply(gv, summary)), atol=5e-4, rtol=0)


def _pair(arch="attention", task="segmentation", seed=0, **model_kw):
    """(JAX module, perturbed variables with seeded statistics, port model in
    eval mode) of a 15-column model."""
    mkw = {**MODEL, **model_kw}
    data = dict(n_points=N_POINTS, extra_features=6, max_windows=3)
    jm = j_build_model(JConfig(data=JDataConfig(**data), model=JModelConfig(**mkw)), arch, task)
    x = jnp.asarray(_points((1, 3, N_POINTS), seed))
    v = jm.init(jax.random.PRNGKey(seed), x, x[..., :2].mean(2), None)
    v = _with_stats(_perturbed(v, seed + 1, 0.05), seed + 2)
    port = build_model(AMPNetConfig(data=DataConfig(**data), model=ModelConfig(**mkw)), arch, task)
    return jm, v, load_flax_variables(port, jax.tree.map(np.asarray, v)).eval()


@pytest.mark.parametrize("task, model_kw", [
    ("segmentation", dict(local_agg="edge", att_geom_tokens=True)),
    ("classification", dict(local_agg="edge")),
])
def test_geometry_models_match_jax_in_eval(task, model_kw):
    """The segmenter with the edge block and the geometry tokens and the
    classifier with the edge block, with a point mask and a padded window,
    in float32 and float64: 5e-4."""
    jm, v, port = _pair(task=task, **model_kw)
    pts = _points((2, 3, N_POINTS), 6)
    cent = pts[..., :2].mean(2)
    pad = np.array([[False, False, False], [False, False, True]])
    pmask = np.ones((2, 3, N_POINTS), bool)
    pmask[0, 1, 50:] = False
    want = np.asarray(jm.apply(v, jnp.asarray(pts), jnp.asarray(cent), jnp.asarray(pad),
                               jnp.asarray(pmask), train=False)[0])
    for dtype in (torch.float32, torch.float64):
        model = port.to(dtype)
        with torch.no_grad():
            got = model(torch.from_numpy(pts).to(dtype), torch.from_numpy(cent).to(dtype),
                        torch.from_numpy(pad), torch.from_numpy(pmask))[0]
        if task == "segmentation":
            got, want_ = got[pmask], want[pmask]
        else:
            want_ = want
        np.testing.assert_allclose(got.double().numpy(), want_, atol=5e-4, rtol=0)


def test_variables_round_trip_and_serve_refuses_as_jax(tmp_path):
    """The edge and token leaves (``encoder/edge_agg/edge_mlp/…``,
    ``context/geom_enc/fc1|fc2``) load from JAX's tree and come back bit for
    bit; ``serve`` of an edge + token checkpoint under its default
    ``folded`` stops with the ValueError JAX's ``make_forward`` raises there
    (the JAX command's fallback to ``xla`` looks at the context only)."""
    jm, v, model = _pair(seed=40, local_agg="edge", att_geom_tokens=True)
    back = flax_variables(model)
    flat = lambda t, p=(): [x for k, u in sorted(t.items()) for x in (
        flat(u, p + (k,)) if isinstance(u, dict) else [(p + (k,), np.asarray(u))])]
    for (pa, a), (pb, b) in zip(flat(back), flat(jax.tree.map(np.asarray, v)), strict=True):
        assert pa == pb and np.array_equal(a, b), pa
    assert any(p[:3] == ("params", "encoder", "edge_agg") for p, _ in flat(back))
    assert any(p[:3] == ("params", "context", "geom_enc") for p, _ in flat(back))
    cfg = AMPNetConfig(data=DataConfig(n_points=N_POINTS, extra_features=6),
                       model=ModelConfig(**MODEL, local_agg="edge", att_geom_tokens=True))
    ckpt = CheckpointManager(str(tmp_path)).save(
        "edge", create_train_state(cfg, model, 1, "cpu"), config_json=cfg.to_json())
    jcfg = JConfig(data=JDataConfig(n_points=N_POINTS, extra_features=6),
                   model=JModelConfig(**MODEL, local_agg="edge", att_geom_tokens=True))
    with pytest.raises(ValueError) as want:
        j_make_forward(jm, jcfg, "folded")
    with pytest.raises(Refused) as got:
        make_server(build_parser().parse_args(["serve", "--model_checkpoint", ckpt,
                                               "--device", "cpu", "--port", "0"]))
    assert str(got.value) == str(want.value)
    assert "local_agg='edge' edge block" in str(got.value)


def test_padded_points_and_masked_windows():
    """tests/test_variants.py on the port: padded points are in no
    neighbourhood (scrambling them leaves the real points' logits), and a
    window whose every point is masked gives finite logits elsewhere."""
    _, _, model = _pair(local_agg="edge", att_geom_tokens=True)
    pts = torch.from_numpy(_points((2, 3, N_POINTS), 8))
    cent = pts[..., :2].mean(2)
    pad = torch.zeros(2, 3, dtype=torch.bool)
    pmask = torch.ones(2, 3, N_POINTS, dtype=torch.bool)
    pmask[0, 0, 40:] = False
    with torch.no_grad():
        ref = model(pts, cent, pad, pmask)[0]
        scrambled = pts.clone()
        scrambled[0, 0, 40:] = 1e3
        out = model(scrambled, cent, pad, pmask)[0]
        np.testing.assert_allclose(out[0, 0, :40].numpy(), ref[0, 0, :40].numpy(), atol=1e-5)
        pad[0, 2] = True
        pmask[0, 2] = False
        out = model(pts, cent, pad, pmask)[0]
    assert torch.isfinite(out[:, :2]).all()


# -- a --geom_features checkpoint on the backends and the command line -----------------


def test_geometry_checkpoint_fused_and_int8_track_jax():
    """mlp_a reads 18 channels (3 transformed coordinates ‖ 15 columns), at
    tests/test_backends.py's [2, 3, 128] points: ``fused`` against JAX's
    ``fused`` (Pallas interpret mode) to 5e-3 with argmax agreement > 0.999;
    ``int8`` against ``xla`` > 0.97, and against JAX's ``int8`` > 0.999."""
    jm, v, model = _pair(seed=10)
    assert model.encoder.mlp_a.mlp_0.dense.in_features == 18
    pts = _points((2, 3, 128), 11)
    cent = pts[..., :2].mean(2)
    cfg = AMPNetConfig(data=DataConfig(n_points=N_POINTS, extra_features=6),
                       model=ModelConfig(**MODEL))
    jcfg = JConfig(data=JDataConfig(n_points=N_POINTS, extra_features=6),
                   model=JModelConfig(**MODEL))
    jt = (jnp.asarray(pts), jnp.asarray(cent), None)
    want = np.asarray(j_make_forward(jm, jcfg, "fused")(v, *jt))
    want_int8 = np.asarray(j_make_forward(jm, jcfg, "int8")(v, *jt))
    t = (torch.from_numpy(pts), torch.from_numpy(cent), None)
    fused = make_forward(model, cfg, "fused", device="cpu")(*t).numpy()
    xla = make_forward(model, cfg, "xla", device="cpu")(*t).numpy()
    int8 = make_forward(model, cfg, "int8", device="cpu")(*t).numpy()
    agree = lambda a, b: (a.argmax(-1) == b.argmax(-1)).mean()
    assert np.abs(fused - want).max() <= 5e-3 and agree(fused, want) > 0.999
    assert agree(int8, xla) > 0.97 and agree(int8, want_int8) > 0.999


SIZES = (70, 90, 100, 127)  # k = 1 at n_points 64: no k-means start to inject


@pytest.fixture(scope="module")
def geom_ckpt(tmp_path_factory):
    """A port checkpoint directory of a geometry model (15 columns, no edge,
    no tokens), its JAX twin, and 19-column .pkl clouds."""
    root = tmp_path_factory.mktemp("geom_ckpt")
    jm, v, model = _pair(seed=20)
    cfg = AMPNetConfig(data=DataConfig(n_points=N_POINTS, extra_features=6),
                       model=ModelConfig(**MODEL), train=TrainConfig(batch_size=8))
    ckpt = CheckpointManager(str(root / "ckpts")).save(
        "geom", create_train_state(cfg, model, 1, "cpu"), config_json=cfg.to_json(),
        batch_size=8, number_of_points=N_POINTS)
    rng = np.random.default_rng(22)
    names = []
    for i, n in enumerate(SIZES):
        pc = rng.uniform(size=(n, 19)).astype(np.float32)
        pc[:, 3] = rng.choice([1, 3, 5, 14, 15], size=n)
        names.append(f"cloud{i}.pkl")
        with open(root / names[-1], "wb") as f:
            pickle.dump(pc, f)
    (root / "test_seg_files.txt").write_text("\n".join(names) + "\n")
    jcfg = JConfig(data=JDataConfig(n_points=N_POINTS, extra_features=6),
                   model=JModelConfig(**MODEL))
    return root, ckpt, names, jtiled.TiledInferencer(jm, v, jcfg)


def test_test_and_infer_of_a_geometry_checkpoint_match_jax(geom_ckpt):
    """``test`` writes JAX ``evaluate_dataset``'s CSV row on the 15-column
    clouds (to 1e-6), and ``infer`` its labels (>= 0.999), under ``fused``."""
    root, ckpt, names, jinf = geom_ckpt
    assert main(["test", str(root), "--path_list_files", str(root), "--model_checkpoint",
                 ckpt, "--device", "cpu", "--backend", "fused",
                 "--out_path", str(root / "port_test")]) == 0
    ds = JEvalCloudDataset(str(root), names, extra_features=6)
    jtiled.evaluate_dataset(jinf, ds, out_csv=str(root / "jax_test" / "IoU-results.csv"),
                            model_name="geom")
    rows = []
    for tag in ("jax_test", "port_test"):
        with open(root / tag / "IoU-results.csv", newline="") as f:
            rows.append(next(csv.DictReader(f)))
    for k in rows[0]:
        if k not in (*TIMING, "model"):
            a, b = float(rows[0][k]), float(rows[1][k])
            assert np.isnan(a) == np.isnan(b) and (np.isnan(a) or abs(a - b) <= 1e-6), k
    assert main(["infer", str(root), "--model_checkpoint", ckpt, "--device", "cpu",
                 "--backend", "fused", "--out_path", str(root / "port_infer")]) == 0
    want = jinf.predict_many([ds[i]["points"] for i in range(len(ds))],
                             seeds=list(range(len(ds))))
    for i, w in enumerate(want):
        got = np.load(root / "port_infer" / f"cloud{i}_preds.npy")
        assert got.shape == (SIZES[i],) and (got == w).mean() >= 0.999


def test_serve_a_geometry_checkpoint_on_15_column_bodies(geom_ckpt):
    """The wire carries 15 columns; a 9-column body is refused; answers
    equal ``predict_many`` and JAX's labels (>= 0.999) under ``int8`` and
    ``fused``."""
    root, ckpt, names, jinf = geom_ckpt
    pts = _points((120,), 23)  # k = 1: no k-means start to inject
    want = jinf.predict_many([pts], seeds=[0])[0]
    for backend in ("fused", "int8"):
        with serving("--model_checkpoint", ckpt, "--backend", backend) as server:
            host, port = server.address
            url = f"http://{host}:{port}/v1/predict"
            req = urllib.request.Request(url, data=pts.tobytes(),
                                         headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=60) as r:
                labels = np.frombuffer(r.read(), np.int8).astype(np.int32)
            np.testing.assert_array_equal(
                labels, server.service.inferencer.predict_many([pts], seeds=[0])[0])
            assert (labels == want).mean() >= (0.999 if backend == "fused" else 0.97)
            bad = urllib.request.Request(url, data=pts[:, :9].copy().tobytes() + b"\0" * 4,
                                         headers={"Content-Type": "application/octet-stream"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(bad, timeout=60)
            assert e.value.code == 400 and b"[N, 15]" in e.value.read()


def test_export_drops_the_geometry_blocks_as_jax(tmp_path, capsys):
    """``export`` of an edge + token checkpoint writes the ``.pth`` JAX's
    ``export_reference_checkpoint`` writes from the same tree, bit for bit:
    the reference layout has no slot for ``edge_agg`` or ``geom_enc``, so
    both packages drop them (and keep the 18-channel ``conv_1``)."""
    _, v, model = _pair(seed=30, local_agg="edge", att_geom_tokens=True)
    cfg = AMPNetConfig(data=DataConfig(n_points=N_POINTS, extra_features=6),
                       model=ModelConfig(**MODEL, local_agg="edge", att_geom_tokens=True),
                       train=TrainConfig(batch_size=8, learning_rate=3e-4))
    ckpt = CheckpointManager(str(tmp_path / "ckpts")).save(
        "edge", create_train_state(cfg, model, 1, "cpu"), config_json=cfg.to_json())
    assert main(["export", "--model_checkpoint", ckpt, "--out", str(tmp_path / "p.pth"),
                 "--device", "cpu"]) == 0
    export_reference_checkpoint(jax.tree.map(np.asarray, v), str(tmp_path / "j.pth"),
                                arch="attention", meta={"number_of_points": N_POINTS,
                                                        "batch_size": 8, "lr": 3e-4})
    a = torch.load(tmp_path / "p.pth", weights_only=True)
    b = torch.load(tmp_path / "j.pth", weights_only=True)
    assert a.keys() == b.keys()
    for group in ("base_pointnet", "segmen_net"):
        assert a[group].keys() == b[group].keys()
        assert not any("edge" in k or "geom" in k for k in a[group])
        for k in a[group]:
            assert torch.equal(a[group][k], b[group][k]), k
    assert a["base_pointnet"]["conv_1.weight"].shape == (64, 18, 1)


@pytest.mark.parametrize("arch", ["attention", "gru"])
def test_demo_with_geometry_on_the_cpu(arch, tmp_path, capsys):
    """``demo --geom_features``: preprocess and train with the eigenfeature
    columns, then ``test`` of the checkpoint, which reads them (exit 0,
    ``test``'s summary JSON last)."""
    assert main(["demo", "--out_path", str(tmp_path), "--arch", arch, "--geom_features",
                 "--epochs", "1", "--n_tiles", "2", "--points_per_window", "3000",
                 "--number_of_points", "256", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.rfind("\n{") + 1:])
    assert np.isfinite(summary["miou"]) and summary["n_clouds"] >= 1
    cfg, _ = load_model(str(tmp_path / "run" / "checkpoints" / f"{arch}_segmentation_best"),
                        "cpu")
    assert cfg.data.extra_features == 6
    pc = load_cloud(next(str(p) for p in (tmp_path / "data").glob("*.pkl")))
    assert pc.shape[1] == 19
