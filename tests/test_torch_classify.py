"""The classification task of the port against the JAX package on the same
seeded clouds and weights: ``classification_label``, ``CloudDataset``, the
classification windows of ``WindowedCloudDataset``, ``SingleCloudBatcher``
and its device cache, the binary metrics and epoch tags, ``CloudClassifier``
and ``evaluate_classification`` (its CSV files byte for byte)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import average_precision_score

from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import DataConfig as JDataConfig
from ampnet_tpu.data import datasets as jdatasets
from ampnet_tpu.data import schema as jschema
from ampnet_tpu.data.device_cache import DeviceCachedBatcher as JDeviceCachedBatcher
from ampnet_tpu.data.pipeline import PaddedBatcher as JPaddedBatcher
from ampnet_tpu.data.pipeline import SingleCloudBatcher as JSingleCloudBatcher
from ampnet_tpu.infer import classify as jclassify
from ampnet_tpu.models.factory import build_model as j_build_model
from ampnet_tpu.train.cls_step import binary_metrics_from_confusion as j_binary_metrics
from ampnet_tpu.train.cls_step import make_cls_step_fns as j_make_cls_step_fns
from ampnet_tpu.train.trainer import _epoch_metrics as j_epoch_metrics
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig
from ampnet_tpu_torch.core.weights import load_flax_variables
from ampnet_tpu_torch.data import datasets, schema
from ampnet_tpu_torch.data.device_cache import DeviceCachedBatcher, gather_batch
from ampnet_tpu_torch.data.io_utils import save_cloud
from ampnet_tpu_torch.data.pipeline import PaddedBatcher, SingleCloudBatcher
from ampnet_tpu_torch.infer import classify
from ampnet_tpu_torch.models.factory import build_model
from ampnet_tpu_torch.train.cls_step import binary_metrics_from_confusion, make_cls_step_fns
from ampnet_tpu_torch.train.state import create_train_state
from ampnet_tpu_torch.train.trainer import epoch_metrics
from test_torch_train import _perturbed, jax_state

N_POINTS, WINDOWS = 64, 3


def _raw_cloud(rng, n, tower):
    """A 13-column cloud in [0, 1]; a tower cloud carries classes 14 and 15,
    a landscape one none (the noise classes appear in both)."""
    pc = rng.uniform(size=(n, 13)).astype(np.float32)
    classes = [1, 2, 3, 4, 5, 7, 30] + ([14, 15] if tower else [])
    pc[:, 3] = rng.choice(classes, size=n)
    return pc


@pytest.fixture(scope="module")
def cloud_dir(tmp_path_factory):
    """Whole .pkl clouds (names with and without the ``tower_`` prefix, some
    above and some below N_POINTS) and windowed ``kmeans_*.npz`` artifacts."""
    folder = tmp_path_factory.mktemp("cls")
    rng = np.random.default_rng(0)
    names = []
    for i, n in enumerate((90, 50, 120, 64, 70, 40, 100)):
        tower = i % 2 == 0
        name = f"{'tower' if tower else 'pc'}_{i}.pkl"
        with open(folder / name, "wb") as f:
            pickle.dump(_raw_cloud(rng, n, tower), f)
        win = np.stack([_raw_cloud(rng, 48, tower and w == 1) for w in range(WINDOWS)], axis=-1)
        save_cloud(str(folder / f"kmeans_{name[:-4]}.npz"), win)
        names.append(name)
    return folder, names


def _same_samples(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "name":
            assert a[k] == b[k]
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_classification_label_matches_jax():
    for raw in ([1, 2, 3], [1, 15], [14, 0], [], [[5, 14], [1, 2]]):
        raw = np.asarray(raw, np.float32)
        got, want = schema.classification_label(raw), jschema.classification_label(raw)
        assert got.dtype == np.int32 and int(got) == int(want)


@pytest.mark.parametrize("mode, task", [("nine", "classification"), ("seven", "classification"),
                                        ("nine", "segmentation")])
def test_cloud_dataset_matches_jax(cloud_dir, mode, task):
    folder, names = cloud_dir
    kw = dict(task=task, number_of_points=N_POINTS, feature_mode=mode, seed=3)
    ours, ref = (datasets.CloudDataset(str(folder), names, **kw),
                 jdatasets.CloudDataset(str(folder), names, **kw))
    assert (ours.len_towers, ours.len_landscape) == (ref.len_towers, ref.len_landscape) == (4, 3)
    for i in range(len(names)):  # one generator in read order: the same draws
        _same_samples(ours[i], ref[i])
    pc = np.random.default_rng(1).normal(size=(30, 13))
    for n in (20, 30, 45):
        np.testing.assert_array_equal(
            datasets.resample_points(pc, n, np.random.default_rng(n)),
            jdatasets.resample_points(pc, n, np.random.default_rng(n)))


def test_windowed_dataset_classification_matches_jax(cloud_dir):
    folder, names = cloud_dir
    ours = datasets.WindowedCloudDataset(str(folder), names, task="classification")
    ref = jdatasets.WindowedCloudDataset(str(folder), names, task="classification")
    for i in range(len(names)):
        _same_samples(ours[i], ref[i])
    assert [int(ours[i]["cls_label"]) for i in range(len(names))] == [1, 0, 1, 0, 1, 0, 1]


@pytest.mark.parametrize("pad_to", [1, 4])
def test_single_cloud_batcher_and_cache_match_jax(cloud_dir, pad_to):
    folder, names = cloud_dir
    kw = dict(n_points=N_POINTS, seed=2, drop_last=False, pad_to_multiple=pad_to)
    mk = lambda m: m.CloudDataset(str(folder), names, task="classification",
                                  number_of_points=80, seed=4)
    ours = SingleCloudBatcher(mk(datasets), 3, **kw)
    ref = JSingleCloudBatcher(mk(jdatasets), 3, prefetch=0, **kw)
    assert ours.max_windows == 1
    for _ in range(2):  # two epochs: seed + epoch orders and resampling
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g["names"] == w["names"]
            for k in ("points", "labels", "centroids", "cls_label"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if pad_to > 1:  # a padded cloud carries no loss: labels and cls_label −1
        assert (got[-1]["cls_label"][1:] == -1).all() and (got[-1]["labels"][1:] == -1).all()
    cache = DeviceCachedBatcher(SingleCloudBatcher(mk(datasets), 3, **kw), "cpu")
    jcache = JDeviceCachedBatcher(JSingleCloudBatcher(mk(jdatasets), 3, prefetch=0, **kw))
    for k in ("points", "labels", "centroids", "cls_label"):
        np.testing.assert_array_equal(cache.data[k].numpy(), np.asarray(jcache._data[k]))
    idxs, pads, _ = cache.epoch_index_matrix()
    np.testing.assert_array_equal((idxs, pads), jcache.epoch_index_matrix()[:2])
    out = gather_batch(cache.data, torch.from_numpy(idxs[-1]), torch.from_numpy(pads[-1]))
    assert (out["cls_label"][torch.from_numpy(pads[-1])] == -1).all()
    # the windowed batcher carries cls_label the same way
    wds = lambda m: m.WindowedCloudDataset(str(folder), names, task="classification")
    got = next(iter(PaddedBatcher(wds(datasets), 4, n_points=48, max_windows=4, seed=1,
                                  pad_to_multiple=3)))
    want = next(iter(JPaddedBatcher(wds(jdatasets), 4, n_points=48, max_windows=4, seed=1,
                                    pad_to_multiple=3, prefetch=0)))
    for k in ("points", "labels", "cls_label"):
        np.testing.assert_array_equal(got[k], want[k])


def test_binary_metrics_and_epoch_tags_match_jax():
    for cm in (np.array([[8, 2], [1, 9]], float), np.array([[5, 0], [0, 0]], float)):
        assert binary_metrics_from_confusion(cm) == j_binary_metrics(cm)
    cms = [np.array([[3, 1], [0, 6]]), np.array([[2, 2], [1, 0]])]
    ours = epoch_metrics(cms, {"loss": [0.5, 0.25]})
    ref = j_epoch_metrics([c.astype(float) for c in cms], {"loss": [0.5, 0.25]})
    assert "iou_tower" in ours and "iou_cables" not in ours
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=1e-12, nan_ok=True), k


def test_average_precision_is_sklearns():
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 50):
        for _ in range(5):
            t = rng.integers(0, 2, n)
            s = rng.choice([0.1, 0.3, 0.5, 0.9], n) if n > 2 else rng.uniform(size=n)
            want = average_precision_score(t, s) if t.any() else 0.0
            assert classify.average_precision(t, s) == pytest.approx(want, abs=1e-12)


@pytest.fixture(scope="module")
def classifiers():
    """Perturbed Flax inits of the attention and the baseline classifier,
    sized to WINDOWS windows, and the port models carrying them."""
    jcfg = JConfig(data=JDataConfig(n_points=N_POINTS, max_windows=WINDOWS))
    cfg = AMPNetConfig(data=DataConfig(n_points=N_POINTS, max_windows=WINDOWS))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, WINDOWS, N_POINTS, 9)), jnp.float32)
    out = {}
    for arch in ("attention", "baseline"):
        jm = j_build_model(jcfg, arch, "classification")
        v = _perturbed(jm.init(jax.random.PRNGKey(0), x, x[..., :2].mean(2), None), 5, 0.05)
        model = build_model(cfg, arch, "classification")
        load_flax_variables(model, jax.tree.map(np.asarray, v))
        out[arch] = (jm, v, model.eval())
    return jcfg, cfg, out


@pytest.mark.parametrize("arch", ["attention", "baseline"])
def test_cloud_classifier_matches_jax(classifiers, arch):
    jcfg, cfg, models = classifiers
    jm, v, model = models[arch]
    rng = np.random.default_rng(6)
    clouds = [rng.normal(size=(n, 9)).astype(np.float32) * 0.5 for n in (200, 64, 30)]
    seeds = [3, 4, 5]  # 3 clouds: the batch pads to 4
    ref = jclassify.CloudClassifier(jm, v, jcfg)
    ours = classify.CloudClassifier(model, cfg, device="cpu")
    assert (ours.n_points, ours.max_clusters, ours.backend, ours.ensemble) == (N_POINTS, 1, "xla", 1)
    for probs in (False, True):
        got = ours.predict_many(clouds, seeds, return_probs=probs)
        want = ref.predict_many(clouds, seeds, return_probs=probs)
        for g, w in zip(got, want):
            if probs:
                assert g[1].dtype == np.float16 and g[1].shape == (2,)
                np.testing.assert_allclose(g[1].astype(np.float32), w[1].astype(np.float32),
                                           atol=1e-3)  # float16 rounding
                g, w = g[0], w[0]
            assert g.dtype == np.int32 and g.shape == (1,)
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ["attention", "baseline"])
def test_evaluate_classification_csv_equals_jax(classifiers, cloud_dir, tmp_path, arch):
    jcfg, cfg, models = classifiers
    jm, v, model = models[arch]
    folder, names = cloud_dir
    if arch == "attention":
        mk = lambda m, bm: bm(m.WindowedCloudDataset(str(folder), names, task="classification"),
                              4, n_points=N_POINTS, max_windows=WINDOWS, shuffle=False,
                              drop_last=False)
        batchers = (mk(datasets, PaddedBatcher), mk(jdatasets, JPaddedBatcher))
    else:
        mk = lambda m, bm: bm(m.CloudDataset(str(folder), names, task="classification",
                                             number_of_points=N_POINTS),
                              4, n_points=N_POINTS, shuffle=False, drop_last=False)
        batchers = (mk(datasets, SingleCloudBatcher), mk(jdatasets, JSingleCloudBatcher))
    ours = classify.evaluate_classification(
        create_train_state(cfg, model, device="cpu"), make_cls_step_fns(cfg)[1], batchers[0],
        out_dir=str(tmp_path / "ours"), model_name="m")
    ref = jclassify.evaluate_classification(
        jax_state(jm, v), j_make_cls_step_fns(jcfg)[1], batchers[1],
        out_dir=str(tmp_path / "jax"), model_name="m")
    assert ours == ref and ours["n_samples"] == len(names)
    for csv_name in ("classification-results.csv", "wrong_predictions.csv"):
        path = tmp_path / "jax" / csv_name
        if path.exists():
            assert (tmp_path / "ours" / csv_name).read_text() == path.read_text(), csv_name
        else:
            assert not (tmp_path / "ours" / csv_name).exists()
