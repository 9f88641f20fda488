"""Whole-tile LAS inference of the port (``infer/full_tile.py``, ``infer`` on
a folder of ``.las`` tiles) against the JAX package on the same weights and
the same LAS, and the ``demo`` command end to end on the CPU.

torch's generators give other bits than jax.random, so windows that tile into
k > 1 clusters get JAX's k-means start through a test-side wrapper (as in
``tests/test_torch_eval.py``)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import DataConfig as JDataConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.data import las_io as jlas
from ampnet_tpu.infer import full_tile as jfull
from ampnet_tpu.infer import tiled as jtiled
from ampnet_tpu.models.amp import AMPNetSegmenter as JSegmenter
from ampnet_tpu.ops.kmeans import num_tiles_test
from ampnet_tpu_torch.cli.main import main
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig
from ampnet_tpu_torch.core.weights import flax_variables, save_reference_pth
from ampnet_tpu_torch.data.las_io import LasCloud, read_las, write_las
from ampnet_tpu_torch.infer.full_tile import SEG_TO_LAS, classify_las_file, predict_tile
from ampnet_tpu_torch.infer.tiled import TiledInferencer
from ampnet_tpu_torch.models.amp import AMPNetSegmenter

N_POINTS, MAX_CLUSTERS = 128, 4  # as tests/test_full_tile.py
LAS_FIELDS = ("x", "y", "z", "intensity", "red", "green", "blue", "nir", "point_format")


def _jax_init(n, seed):
    """The k-means start JAX's bucket program draws for a cloud of n points."""
    k = num_tiles_test(n, N_POINTS, MAX_CLUSTERS)
    if k == 1:
        return None
    cap = N_POINTS
    while cap * k < n:
        cap *= 2
    return np.array(jax.random.permutation(jax.random.PRNGKey(seed), k * cap)[:k])


class JaxStart:
    """The port's inferencer, its k-means started where JAX's is."""

    def __init__(self, inner):
        self.inner, self.cfg, self.n_points = inner, inner.cfg, inner.n_points

    def predict_many(self, clouds, seeds=None, return_probs=False):
        init = [_jax_init(c.shape[0], s) for c, s in zip(clouds, seeds)]
        return self.inner.predict_many(clouds, seeds, return_probs, init_idx=init)


@pytest.fixture(scope="module")
def weights():
    pcfg = AMPNetConfig(data=DataConfig(n_points=N_POINTS, max_clusters_test=MAX_CLUSTERS),
                        model=ModelConfig(dropout=0.0))
    jcfg = JConfig(data=JDataConfig(n_points=N_POINTS, max_clusters_test=MAX_CLUSTERS),
                   model=JModelConfig(dropout=0.0))
    model = AMPNetSegmenter(pcfg.model, generator=torch.Generator().manual_seed(3))
    return pcfg, model, jcfg, flax_variables(model)


def _las(path, seed, nir=True, n=3000):
    """A 150 m x 150 m tile (4 windows of 100 m) with ground (filtered) and
    every class the model knows, as tests/test_full_tile.py writes it."""
    rng = np.random.default_rng(seed)
    cls = rng.choice([1, 2, 3, 5, 14, 15], n)
    z = rng.uniform(1, 40, n)
    z[cls == 2] = rng.uniform(0, 0.2, int((cls == 2).sum()))  # ground sits at ~0
    cloud = LasCloud(
        x=rng.uniform(430000, 430150, n), y=rng.uniform(4590000, 4590150, n), z=z,
        intensity=rng.uniform(0, 4000, n), classification=cls,
        red=rng.uniform(0, 65535, n), green=rng.uniform(0, 65535, n),
        blue=rng.uniform(0, 65535, n), nir=rng.uniform(0, 65535, n) if nir else None,
    )
    write_las(path, cloud, point_format=8 if nir else 3)
    return path


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    folder = tmp_path_factory.mktemp("las")
    return (_las(str(folder / "tile_nir.las"), 1),
            _las(str(folder / "tile_rgb.las"), 2, nir=False, n=2200))


def _agree(a, b):
    return float((a == b).mean())


@pytest.mark.parametrize("backend, tta, votes, tile", [("xla", 1, 1, 0), ("fused", 1, 1, 1),
                                                       ("xla", 2, 2, 0)])
def test_predict_tile_matches_jax(weights, tiles, backend, tta, votes, tile):
    pcfg, model, jcfg, variables = weights
    ref = jtiled.TiledInferencer(JSegmenter(jcfg.model), variables, jcfg, backend=backend)
    port = JaxStart(TiledInferencer(model, pcfg, backend=backend, device="cpu"))
    jp, jm = jfull.predict_tile(ref, jlas.read_las(tiles[tile]), tta=tta, votes=votes)
    pp, pm = predict_tile(port, read_las(tiles[tile]), tta=tta, votes=votes)
    assert pp.dtype == np.int32 and pp.shape == jp.shape
    np.testing.assert_array_equal(pp < 0, jp < 0)  # the same points filtered out
    assert (pp >= 0).mean() > 0.5
    assert _agree(pp, jp) >= 0.999
    assert pm.keys() == jm.keys()
    assert (pm["points_evaluated"], pm["points_total"]) == (jm["points_evaluated"],
                                                            jm["points_total"])
    tol = 1e-6 if np.array_equal(pp, jp) else 1e-2
    for k in jm:
        assert np.isnan(jm[k]) == np.isnan(pm[k]), k
        if not np.isnan(jm[k]):
            assert abs(pm[k] - jm[k]) <= tol, (k, pm[k], jm[k])


def test_classify_las_file_matches_jax(weights, tiles, tmp_path):
    pcfg, model, jcfg, variables = weights
    ref = jtiled.TiledInferencer(JSegmenter(jcfg.model), variables, jcfg)
    port = JaxStart(TiledInferencer(model, pcfg, device="cpu"))
    for path in tiles:
        jout, pout = str(tmp_path / "j.las"), str(tmp_path / "p.las")
        jfull.classify_las_file(ref, path, jout)
        classify_las_file(port, path, pout)
        a, b, orig = jlas.read_las(jout), read_las(pout), read_las(path)
        for f in LAS_FIELDS:  # every field but the predicted classes, exactly
            va, vb = getattr(a, f), getattr(b, f)
            assert (va == vb if not isinstance(va, np.ndarray) else np.array_equal(va, vb)), f
        assert b.point_format == (8 if orig.nir is not None else 3)
        assert _agree(a.classification, b.classification) >= 0.999
        kept = orig.classification == 2  # ground is filtered: keeps its class
        np.testing.assert_array_equal(b.classification[kept], 2)
        assert set(np.unique(b.classification[~kept])) <= set(SEG_TO_LAS.tolist())


def test_infer_las_folder_writes_classify_las_file(weights, tiles, tmp_path):
    """``infer`` on a folder of .las tiles: each ``<name>_classified.las`` is
    the one ``classify_las_file`` writes (same checkpoint, same seeds), and
    ``tile_metrics.json`` holds its metrics."""
    pcfg, model, _, variables = weights
    ckpt = str(tmp_path / "m.pth")
    save_reference_pth(variables, ckpt, meta={"number_of_points": N_POINTS})
    folder = tmp_path / "tiles"
    folder.mkdir()
    for t in tiles:
        os.symlink(t, folder / os.path.basename(t))
    out = tmp_path / "out"
    assert main(["infer", str(folder), "--model_checkpoint", ckpt, "--device", "cpu",
                 "--backend", "fused", "--out_path", str(out), "--window_size", "80"]) == 0
    direct = TiledInferencer(model, pcfg.replace(data=DataConfig(n_points=N_POINTS)),
                             backend="fused", device="cpu")
    metrics = json.loads((out / "tile_metrics.json").read_text())
    assert sorted(metrics) == ["tile_nir", "tile_rgb"]
    for t in tiles:
        name = os.path.splitext(os.path.basename(t))[0]
        want = classify_las_file(direct, t, str(tmp_path / "want.las"), window_size=80.0)
        assert metrics[name] == pytest.approx(want, nan_ok=True)
        assert ((out / f"{name}_classified.las").read_bytes()
                == (tmp_path / "want.las").read_bytes())


def test_infer_las_refusals_come_before_any_work(tiles, tmp_path, capsys):
    folder = os.path.dirname(tiles[0])
    missing = str(tmp_path / "no_such_checkpoint")
    base = ["infer", folder, "--model_checkpoint", missing, "--device", "cpu",
            "--out_path", str(tmp_path / "o")]
    assert main([*base, "--save_probs"]) == 1
    assert "--save_probs is not supported in whole-tile LAS mode" in capsys.readouterr().err
    assert main([*base, "--tta", "9"]) == 1
    assert "--tta must be in 1..8" in capsys.readouterr().err
    assert main([*base, "--tile_votes", "0"]) == 1
    assert not (tmp_path / "o").exists()


def test_geometry_checkpoints_and_other_families_refused(weights, tiles, tmp_path, capsys):
    pcfg, model, _, _ = weights
    geom = pcfg.replace(data=DataConfig(n_points=N_POINTS, extra_features=6))
    tt = TiledInferencer(model, pcfg, device="cpu")
    tt.cfg = geom
    with pytest.raises(NotImplementedError, match="item 4"):
        predict_tile(tt, read_las(tiles[0]))
    for flags in (["--arch", "gru", "--geom_features"], ["--geom_features"]):
        assert main(["demo", "--out_path", str(tmp_path), "--device", "cpu", *flags]) == 1
        assert "item 4" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_demo_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["demo", "--out_path", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_demo_on_the_cpu(tmp_path, capsys):
    """synth → preprocess → train → test through the port's own commands:
    exit 0 and ``test``'s summary JSON, last."""
    assert main(["demo", "--out_path", str(tmp_path), "--epochs", "1", "--n_tiles", "2",
                 "--points_per_window", "1500", "--number_of_points", "64",
                 "--backend", "fused", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.rindex("\n{") + 1:])
    assert summary["n_clouds"] >= 1 and summary["n_points"] == 64
    assert 0.0 <= summary["oa"] <= 1.0 and np.isfinite(summary["miou"])
    assert (tmp_path / "run" / "IoU-results.csv").exists()
    assert sorted(os.listdir(tmp_path / "las")) == ["tile0.las", "tile1.las"]
