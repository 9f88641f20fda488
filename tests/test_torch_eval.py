"""The port's checkpoint evaluation against the JAX package on the same seeded
clouds and weights: the evaluation datasets, ``evaluate_cloud`` and
``evaluate_dataset`` (with TTA and tile votes), stacked and cross-family
ensembles, and the error analysis.

torch's generators give other bits than jax.random, so clouds that tile into
k > 1 windows get JAX's k-means start through ``init_idx`` (a test-side
wrapper); k = 1 clouds (n < 2·n_points) need none."""

import csv
import inspect
import pickle

import jax
import numpy as np
import pytest
import torch

from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import DataConfig as JDataConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.data import datasets as jdatasets
from ampnet_tpu.data import schema as jschema
from ampnet_tpu.infer import analysis as janalysis
from ampnet_tpu.infer import tiled as jtiled
from ampnet_tpu.models.amp import AMPNetSegmenter as JSegmenter
from ampnet_tpu.ops.kmeans import num_tiles_test
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig
from ampnet_tpu_torch.core.weights import flax_variables, load_flax_variables
from ampnet_tpu_torch.data import datasets, schema
from ampnet_tpu_torch.infer import analysis
from ampnet_tpu_torch.infer.tiled import (
    EnsembleInferencer,
    TiledInferencer,
    eval_chunks,
    evaluate_cloud,
    evaluate_dataset,
)
from ampnet_tpu_torch.models.amp import AMPNetSegmenter

N_POINTS, MAX_CLUSTERS = 64, 3
SIZES = (70, 100, 200, 300)  # k = 1, 1, 3, 3 at n_points 64
TIMING = ("inference_minutes", "points_per_sec")


def _jax_init(n, seed, n_points=N_POINTS):
    """The k-means start JAX's bucket program draws for a cloud of n points."""
    k = num_tiles_test(n, n_points, MAX_CLUSTERS)
    if k == 1:
        return None
    cap = n_points
    while cap * k < n:
        cap *= 2
    return np.array(jax.random.permutation(jax.random.PRNGKey(seed), k * cap)[:k])


class Recorder:
    """An inferencer as ``evaluate_dataset`` sees it: records the labels it
    returns; with ``init`` the port's k-means starts where JAX's does."""

    def __init__(self, inner, init=False):
        self.inner, self.init, self.labels = inner, init, []
        self.cfg, self.n_points = inner.cfg, inner.n_points

    def predict_many(self, clouds, seeds=None, return_probs=False):
        kw = {}
        if self.init:
            kw["init_idx"] = [_jax_init(c.shape[0], s, self.n_points)
                              for c, s in zip(clouds, seeds)]
        out = self.inner.predict_many(clouds, seeds, return_probs, **kw)
        self.labels += [o[0] if return_probs else o for o in out]
        return out


def _perturbed(v, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda l: (l + rng.normal(size=l.shape) * 0.05).astype(np.float32), v)


def _cfgs(n_points=N_POINTS):
    return (JConfig(data=JDataConfig(n_points=n_points, max_clusters_test=MAX_CLUSTERS),
                    model=JModelConfig(dropout=0.0)),
            AMPNetConfig(data=DataConfig(n_points=n_points, max_clusters_test=MAX_CLUSTERS),
                         model=ModelConfig(dropout=0.0)))


@pytest.fixture(scope="module")
def models():
    """Two seeded weight sets, as Flax trees and as port models."""
    jcfg, pcfg = _cfgs()
    v0 = flax_variables(AMPNetSegmenter(pcfg.model, generator=torch.Generator().manual_seed(0)))
    vs = [_perturbed(v0, seed) for seed in (5, 6)]
    ports = [load_flax_variables(AMPNetSegmenter(pcfg.model), v) for v in vs]
    return JSegmenter(jcfg.model), vs, ports


def _write_clouds(folder, sizes, seed):
    """Seeded raw 13-column .pkl clouds (x, y in [0, 1]; every raw class of the
    schema, noise classes included) and a test_seg_files.txt."""
    rng = np.random.default_rng(seed)
    names = []
    for i, n in enumerate(sizes):
        pc = rng.uniform(size=(n, 13)).astype(np.float32)
        pc[:, 3] = rng.choice([0, 1, 2, 3, 4, 5, 7, 8, 13, 14, 15, 30], size=n)
        names.append(f"cloud{i}.pkl")
        with open(folder / names[-1], "wb") as f:
            pickle.dump(pc, f)
    (folder / "test_seg_files.txt").write_text("\n".join(names) + "\n")
    return names


@pytest.fixture(scope="module")
def cloud_dir(tmp_path_factory):
    folder = tmp_path_factory.mktemp("clouds")
    return folder, _write_clouds(folder, SIZES, seed=21)


def test_datasets_and_feature_selection_equal_jax(cloud_dir):
    folder, names = cloud_dir
    for (jd, pd) in ((jdatasets.EvalCloudDataset(str(folder), names),
                      datasets.EvalCloudDataset(str(folder), names)),
                     (jdatasets.InferenceCloudDataset(str(folder), names),
                      datasets.InferenceCloudDataset(str(folder), names))):
        assert len(jd) == len(pd) == len(names)
        for i in range(len(names)):
            a, b = jd[i], pd[i]
            assert a.keys() == b.keys()
            for k in a:
                if k == "name":
                    assert a[k] == b[k]
                else:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    pc = datasets.InferenceCloudDataset(str(folder), names)[0]["points"]
    np.testing.assert_array_equal(schema.select_model_features(pc),
                                  np.asarray(jschema.select_model_features(pc)))
    # noise classes stay in the evaluation set (the training set drops them)
    assert len(datasets.EvalCloudDataset(str(folder), names)[0]["labels"]) == SIZES[0]
    with pytest.raises(NotImplementedError, match="item 4"):
        datasets.EvalCloudDataset(str(folder), names, extra_features=6)
    with pytest.raises(NotImplementedError, match="item 4"):
        schema.select_model_features(pc, extra_features=6)


def _assert_same_metrics(a, b, atol):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k], k
        else:
            assert np.isnan(a[k]) == np.isnan(b[k]), k
            if not np.isnan(a[k]):
                assert abs(a[k] - b[k]) <= atol, (k, a[k], b[k])


@pytest.mark.parametrize("n_clouds, views", [(0, 1), (20, 1), (33, 1), (9, 2), (9, 4), (5, 16),
                                             (3, 64)])
def test_eval_chunks_match_jax(n_clouds, views):
    """``test`` and ``infer`` predict in the chunks, and so with the seeds,
    of JAX's ``evaluate_dataset`` (chunk_size // views, at least 1)."""
    size = inspect.signature(jtiled.evaluate_dataset).parameters["chunk_size"].default
    if views > 1:
        size = max(1, size // views)
    want = [range(s, min(s + size, n_clouds)) for s in range(0, n_clouds, size)]
    assert eval_chunks(n_clouds, views) == want


def test_evaluate_cloud_matches_jax():
    rng = np.random.default_rng(3)
    labels = rng.choice([-1, 0, 1, 3], size=500)  # lines and high veg absent
    preds = np.where(rng.uniform(size=500) < 0.7, np.clip(labels, 0, None),
                     rng.integers(0, 4, size=500))  # high veg never predicted: NaN
    preds[:5] = 2  # lines predicted but absent from the labels: IoU 0, not NaN
    a = jtiled.evaluate_cloud(preds, labels, 5)
    b = evaluate_cloud(preds, labels, 5)
    np.testing.assert_array_equal(a.pop("confusion"), b.pop("confusion"))
    _assert_same_metrics(a, b, 1e-6)
    assert np.isnan(b["iou_high_veg"]) and b["iou_lines"] == 0.0


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("backend, tta, votes", [("xla", 1, 1), ("fused", 1, 1),
                                                 ("fused", 2, 2)])
def test_evaluate_dataset_matches_jax(models, cloud_dir, tmp_path, backend, tta, votes):
    jm, vs, ports = models
    jcfg, pcfg = _cfgs()
    folder, names = cloud_dir
    ds = datasets.EvalCloudDataset(str(folder), names)
    ref = Recorder(jtiled.TiledInferencer(jm, vs[0], jcfg, backend=backend))
    port = Recorder(TiledInferencer(ports[0], pcfg, backend=backend, device="cpu"), init=True)
    kw = dict(model_name="m", tta=tta, tile_votes=votes)
    a = jtiled.evaluate_dataset(ref, ds, out_csv=str(tmp_path / "jax.csv"), **kw)
    b = evaluate_dataset(port, ds, out_csv=str(tmp_path / "port.csv"), **kw)
    assert len(ref.labels) == len(port.labels) == len(SIZES) * tta * votes
    agree = [(x == y).mean() for x, y in zip(ref.labels, port.labels)]
    assert min(agree) >= 0.999
    exact = min(agree) == 1.0 and tta * votes == 1
    sa, sb = ({k: v for k, v in s.items() if k not in TIMING} for s in (a["summary"], b["summary"]))
    _assert_same_metrics(sa, sb, 1e-6 if exact else 1e-3)
    assert sb["n_clouds"] == len(SIZES) and sb["n_points"] == N_POINTS
    ja, jb = _csv_rows(tmp_path / "jax.csv"), _csv_rows(tmp_path / "port.csv")
    assert ja[0] == jb[0] and len(ja) == len(jb) == 2
    for ra, rb in zip(a["per_cloud"], b["per_cloud"]):
        _assert_same_metrics(ra, rb, 1e-6 if exact else 1e-2)


def test_evaluate_dataset_validates_views_and_draws(models, cloud_dir, tmp_path):
    _, _, ports = models
    _, pcfg = _cfgs()
    folder, names = cloud_dir
    ds = datasets.EvalCloudDataset(str(folder), names[:2])
    tt = TiledInferencer(ports[0], pcfg, device="cpu")
    for bad in ({"tta": 9}, {"tta": 0}, {"tile_votes": 0}):
        with pytest.raises(ValueError):
            evaluate_dataset(tt, ds, **bad)
    out = evaluate_dataset(tt, ds, plot_dir=str(tmp_path / "plots"),
                           analysis_dir=str(tmp_path / "analysis"))
    assert (tmp_path / "plots" / "class_counts.png").exists()
    assert (tmp_path / "plots" / f"{names[0]}_hist.png").exists()
    assert (tmp_path / "analysis" / "analysis.json").exists()
    assert (tmp_path / "analysis" / "confusion.png").exists()
    assert out["analysis"]["per_class"].keys() == set(schema.SEG_CLASS_NAMES)


def test_stacked_ensemble_matches_jax(models):
    jm, vs, ports = models
    jcfg, pcfg = _cfgs()
    rng = np.random.default_rng(31)
    clouds = [rng.normal(size=(n, 9)).astype(np.float32) for n in SIZES]
    seeds = [4, 5, 6, 7]
    ref = jtiled.TiledInferencer(jm, list(vs), jcfg).predict_many(clouds, seeds, return_probs=True)
    tt = TiledInferencer(ports, pcfg, device="cpu")
    assert tt.ensemble == 2
    out = tt.predict_many(clouds, seeds, return_probs=True,
                          init_idx=[_jax_init(c.shape[0], s) for c, s in zip(clouds, seeds)])
    for (jl, jp), (tl, tp) in zip(ref, out):
        assert (tl == jl).mean() >= 0.999
        np.testing.assert_allclose(tp.astype(np.float32), jp.astype(np.float32), atol=2e-3)
    # two copies of one model: the mean of equal probabilities is each of them
    for backend in ("xla", "fused"):
        alone = TiledInferencer(ports[0], pcfg, backend=backend, device="cpu")
        twice = TiledInferencer([ports[0], ports[0]], pcfg, backend=backend, device="cpu")
        for (al, ap), (wl, wp) in zip(alone.predict_many(clouds, seeds, return_probs=True),
                                      twice.predict_many(clouds, seeds, return_probs=True)):
            np.testing.assert_array_equal(al, wl)
            np.testing.assert_array_equal(ap, wp)
    with pytest.raises(ValueError, match="same parameter"):
        TiledInferencer([ports[0], AMPNetSegmenter(ModelConfig(global_feat=128))], pcfg,
                        device="cpu")


def test_ensemble_inferencer_matches_jax(models):
    """Members of another n_points (window geometry) average on the host."""
    jm, vs, ports = models
    (jcfg64, pcfg64), (jcfg32, pcfg32) = _cfgs(64), _cfgs(32)
    rng = np.random.default_rng(41)
    clouds = [rng.normal(size=(n, 9)).astype(np.float32) for n in (40, 50, 63)]  # k = 1
    seeds = [1, 2, 3]
    jens = jtiled.EnsembleInferencer([jtiled.TiledInferencer(jm, vs[0], jcfg64),
                                      jtiled.TiledInferencer(jm, vs[1], jcfg32)])
    pens = EnsembleInferencer([TiledInferencer(ports[0], pcfg64, device="cpu"),
                               TiledInferencer(ports[1], pcfg32, device="cpu")])
    assert (pens.ensemble, pens.n_points, pens.max_clusters) == (2, 64, MAX_CLUSTERS)
    for probs in (True, False):
        ref = jens.predict_many(clouds, seeds, return_probs=probs)
        out = pens.predict_many(clouds, seeds, return_probs=probs)
        for r, o in zip(ref, out):
            if probs:
                assert o[1].dtype == np.float16
                np.testing.assert_allclose(o[1].astype(np.float32), r[1].astype(np.float32),
                                           atol=2e-3)
                r, o = r[0], o[0]
            assert o.dtype == np.int32 and (o == r).mean() >= 0.999
    assert pens.cold_programs_seen >= 2
    tl, tp = pens.predict_tta(clouds[0], seed=3, transforms=2, return_probs=True)
    jl, jp = jens.predict_tta(clouds[0], seed=3, transforms=2, return_probs=True)
    assert (tl == jl).mean() >= 0.999
    np.testing.assert_allclose(tp.astype(np.float32), jp.astype(np.float32), atol=2e-3)
    with pytest.raises(ValueError, match="num_classes"):
        EnsembleInferencer([TiledInferencer(ports[0], pcfg64, device="cpu"),
                            TiledInferencer(AMPNetSegmenter(ModelConfig(num_classes=3)),
                                            AMPNetConfig(model=ModelConfig(num_classes=3)),
                                            device="cpu")])


def _assert_reports_equal(a, b, path="report"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_reports_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_reports_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, float) and (np.isnan(a) and np.isnan(b) or abs(a - b) <= 1e-12), path
    else:
        assert type(a) is type(b) and a == b, path


def test_error_analysis_matches_jax():
    rng = np.random.default_rng(51)
    ja, pa = janalysis.ErrorAnalysisAccumulator(5), analysis.ErrorAnalysisAccumulator(5)
    for i, n in enumerate((300, 400, 80, 1)):
        xyz = rng.uniform(size=(n, 9)).astype(np.float32)  # continuous: no distance ties
        labels = rng.choice([-1, 0, 1, 1, 2, 3], size=n)
        preds = np.where(rng.uniform(size=n) < 0.8, np.clip(labels, 0, None),
                         rng.integers(0, 5, size=n))
        np.testing.assert_array_equal(janalysis.boundary_mask(xyz[:, :3], labels),
                                      analysis.boundary_mask(xyz[:, :3], labels))
        ja.update(f"c{i}", xyz, labels, preds)
        pa.update(f"c{i}", xyz, labels, preds)
    ra, rb = ja.finalize(), pa.finalize()
    _assert_reports_equal(ra, rb)
    assert any(rb["worst_clouds"].values())
    pr = analysis.precision_recall_from_confusion(np.asarray(rb["confusion"]))
    _assert_reports_equal(janalysis.precision_recall_from_confusion(np.asarray(ra["confusion"])),
                          pr)
