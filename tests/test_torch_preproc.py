"""The port's host data stages against the JAX package on the same seeded
inputs: LAS I/O, synthetic scenes and the ``synth`` command (byte-identical
tiles), window split, height above ground, filter and normalise, balanced
k-means tiling (the native solver exactly, Sinkhorn from JAX's start), split
lists, and the ``preprocess`` command (equal artifacts and split lists)."""

import argparse
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from ampnet_tpu import native as jnative
from ampnet_tpu.cli import main as jcli
from ampnet_tpu.data import las_io as jlas
from ampnet_tpu.data import synthetic as jsynth
from ampnet_tpu.ops.kmeans import num_tiles_train as j_num_tiles_train
from ampnet_tpu.preproc import filter_norm as jfilter
from ampnet_tpu.preproc import hag as jhag
from ampnet_tpu.preproc import splits as jsplits
from ampnet_tpu.preproc import tiling as jtiling
from ampnet_tpu.preproc import window_split as jwindow
from ampnet_tpu_torch.cli.main import main
from ampnet_tpu_torch.data import las_io, synthetic
from ampnet_tpu_torch.data.io_utils import load_cloud
from ampnet_tpu_torch.ops.kmeans import num_tiles_train
from ampnet_tpu_torch.preproc import filter_norm, hag, splits, tiling, window_split
from ampnet_tpu_torch.preproc.pipeline import PreprocessParams

LAS_FIELDS = ("x", "y", "z", "intensity", "classification", "red", "green", "blue", "nir",
              "point_format")
# the small preprocess geometry of tests/test_cli.py
PRE = dict(dataset="T", window_size=50.0, max_z=100.0, min_points=200, n_points=128,
           max_windows=3, hag_cell=2.0, seed=0, artifact_format="npz")


def _port_preprocess_argv(in_path, out_path, **kw):
    opts = {**PRE, **kw}
    argv = ["preprocess", "--in_path", str(in_path), "--out_path", str(out_path)]
    for k, v in opts.items():
        if isinstance(v, list):
            argv += [f"--{k}", *map(str, v)]
        else:
            argv += [f"--{k}", str(v)]
    return argv


def _need_jax_native():
    if not jnative.native_available():
        pytest.skip("the JAX package's native library did not build: its exact_mcf "
                    "results are its NumPy fallback's, not the solver's")


def _assert_same_las(a, b):
    for f in LAS_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f
        else:
            assert va == vb, f
    assert a.extra.keys() == b.extra.keys()
    for k in a.extra:
        assert np.array_equal(a.extra[k], b.extra[k]), k


def _same_tree(dir_a, dir_b):
    """Both folders hold the same files; clouds equal as arrays, lists as text."""
    files = sorted(os.listdir(dir_a))
    assert files == sorted(os.listdir(dir_b))
    for f in files:
        a, b = os.path.join(dir_a, f), os.path.join(dir_b, f)
        if f.endswith(".txt"):
            assert open(a).read() == open(b).read(), f
        else:
            x, y = load_cloud(a), load_cloud(b)
            assert x.shape == y.shape and np.array_equal(x, y), f
    return files


# ---------------------------------------------------------------- synth


SYNTH_CASES = {
    "easy": dict(n_tiles=2, windows_per_tile=2, points_per_window=1500, window_size=50.0,
                 seed=1),
    "hard": dict(n_tiles=1, windows_per_tile=3, points_per_window=2000, window_size=60.0,
                 seed=3, scene="hard", terrain_relief=4.0, point_jitter=0.3,
                 landscape_fraction=0.3),
}


@pytest.mark.parametrize("case", sorted(SYNTH_CASES))
def test_synth_writes_byte_identical_tiles(tmp_path, case):
    kw = SYNTH_CASES[case]
    assert jcli.cmd_synth(argparse.Namespace(out_path=str(tmp_path / "j"), **kw)) == 0
    argv = ["synth", "--out_path", str(tmp_path / "p")]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    assert main(argv) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) and len(names) == kw["n_tiles"]
    for n in names:
        assert (tmp_path / "j" / n).read_bytes() == (tmp_path / "p" / n).read_bytes(), n


def test_synthetic_generators_equal_jax():
    for fn, kw in ((synthetic.synthetic_scene, dict(n_points=900, with_noise_classes=True)),
                   (synthetic.synthetic_scene, dict(n_points=700, n_pylons=0)),
                   (synthetic.synthetic_scene_hard, dict(n_points=1500, n_pylons=3)),
                   (synthetic.synthetic_scene_hard, dict(n_points=1200, n_pylons=0,
                                                         with_ground=False))):
        a = getattr(jsynth, fn.__name__)(np.random.default_rng(5), **kw)
        b = fn(np.random.default_rng(5), **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b), (fn.__name__, kw)
    fa = jsynth.make_terrain(np.random.default_rng(2), 6.0, 300.0)
    fb = synthetic.make_terrain(np.random.default_rng(2), 6.0, 300.0)
    x, y = np.meshgrid(np.linspace(0, 300, 17), np.linspace(0, 300, 13))
    assert np.array_equal(fa(x, y), fb(x, y))
    ba = jsynth.synthetic_batch(np.random.default_rng(8), batch_size=2, max_windows=3,
                                n_points=32)
    bb = synthetic.synthetic_batch(np.random.default_rng(8), batch_size=2, max_windows=3,
                                   n_points=32)
    assert ba.keys() == bb.keys()
    for k in ba:
        assert np.array_equal(ba[k], bb[k]), k


# ---------------------------------------------------------------- LAS I/O


def _cloud(rng, n, nir=True):
    return las_io.LasCloud(
        x=rng.uniform(430000, 430100, n), y=rng.uniform(4590000, 4590100, n),
        z=rng.uniform(0, 50, n), intensity=rng.integers(0, 4000, n).astype(float),
        classification=rng.choice([1, 2, 5, 14, 15, 135], n),
        red=rng.integers(0, 65535, n).astype(float),
        green=rng.integers(0, 65535, n).astype(float),
        blue=rng.integers(0, 65535, n).astype(float),
        nir=rng.integers(0, 65535, n).astype(float) if nir else None,
    )


def _add_hag_extra_bytes(src, dst, hag, data_type=10):
    """Copy a LAS written by ``write_las`` with a HeightAboveGround extra
    bytes dimension (an Extra Bytes VLR, record id 4) appended to every
    record, as PDAL's HAG stage writes it."""
    blob = bytearray(open(src, "rb").read())
    header_size = struct.unpack_from("<H", blob, 94)[0]
    offset = struct.unpack_from("<I", blob, 96)[0]
    rec_len = struct.unpack_from("<H", blob, 105)[0]
    fmt = "<f8" if data_type == 10 else "<f4"
    width = np.dtype(fmt).itemsize
    n = (len(blob) - offset) // rec_len
    vlr = bytearray(54 + 192)
    vlr[2:11] = b"LASF_Spec"
    struct.pack_into("<HH", vlr, 18, 4, 192)
    vlr[54 + 2] = data_type
    vlr[54 + 4: 54 + 4 + 17] = b"HeightAboveGround"
    records = np.frombuffer(bytes(blob[offset:]), np.uint8).reshape(n, rec_len)
    extra = np.asarray(hag, fmt).view(np.uint8).reshape(n, width)
    header = bytearray(blob[:header_size])
    struct.pack_into("<I", header, 96, header_size + len(vlr))
    struct.pack_into("<I", header, 100, 1)
    struct.pack_into("<H", header, 105, rec_len + width)
    with open(dst, "wb") as f:
        f.write(bytes(header) + bytes(vlr) + np.concatenate([records, extra], 1).tobytes())


@pytest.mark.parametrize("fmt", [3, 8])
def test_read_las_equal_jax_in_every_field(tmp_path, fmt):
    rng = np.random.default_rng(fmt)
    cloud = _cloud(rng, 500, nir=fmt == 8)
    p = str(tmp_path / "t.las")
    las_io.write_las(p, cloud, point_format=fmt)
    q = str(tmp_path / "j.las")
    jlas.write_las(q, jlas.LasCloud(**{f: getattr(cloud, f) for f in LAS_FIELDS[:-1]}),
                   point_format=fmt)
    assert open(p, "rb").read() == open(q, "rb").read()
    hagged = str(tmp_path / "h.las")
    _add_hag_extra_bytes(p, hagged, rng.uniform(0, 40, 500), data_type=10 if fmt == 8 else 9)
    for path in (p, hagged):
        for mmap in (False, True):
            a, b = jlas.read_las(path, mmap=mmap), las_io.read_las(path, mmap=mmap)
            _assert_same_las(a, b)
            assert len(b) == 500 and b.point_format == fmt
    assert las_io.read_las(hagged).height_above_ground is not None
    assert las_io.read_las(p).height_above_ground is None


def test_las_errors_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    good = str(tmp_path / "good.las")
    las_io.write_las(good, _cloud(rng, 20), point_format=3)
    laz = bytearray(open(good, "rb").read())
    laz[104] |= 0x80
    cases = {"truncated": b"LASF" + b"\x00" * 50, "not_las": b"hello world",
             "laz": bytes(laz), "format_5": None}
    fmt5 = bytearray(open(good, "rb").read())
    fmt5[104] = 5
    cases["format_5"] = bytes(fmt5)
    for name, blob in cases.items():
        p = tmp_path / f"{name}.las"
        p.write_bytes(blob)
        errors = []
        for read in (jlas.read_las, las_io.read_las):
            with pytest.raises(Exception) as e:
                read(str(p))
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1], name
    with pytest.raises(ValueError, match="unsupported point format"):
        las_io.write_las(str(tmp_path / "x.las"), _cloud(rng, 5), point_format=5)


# ---------------------------------------------------------------- host stages


def _tile(rng, n=4000, extent=230.0):
    x = rng.uniform(430000, 430000 + extent, n)
    y = rng.uniform(4590000, 4590000 + extent * 0.7, n)
    cls = rng.choice([1, 2, 3, 5, 7, 14, 15, 106, 135], n).astype(np.float64)
    z = rng.uniform(0, 45, n) + 0.01 * (x - x.min())
    z[cls == 2] = rng.uniform(0, 0.3, int((cls == 2).sum())) + 0.01 * (x[cls == 2] - x.min())
    feats = rng.uniform(0, 65535, (5, n))
    return np.vstack([x, y, z, cls, feats, z])


def test_window_split_equal_jax():
    tile = _tile(np.random.default_rng(1))
    for size in ((100.0, 100.0), (60.0, 80.0)):
        for tile_level in (False, True):
            a = jwindow.split_tile_into_windows(tile, size, tile_level_labels=tile_level)
            b = window_split.split_tile_into_windows(tile, size, tile_level_labels=tile_level)
            assert len(a) == len(b) > 4
            for wa, wb in zip(a, b):
                assert wa["label"] == wb["label"] and wa["window_id"] == wb["window_id"]
                assert np.array_equal(wa["points"], wb["points"])
    cls = np.array([135, 106, 15, 2])
    assert np.array_equal(window_split.remap_las_classes(cls), jwindow.remap_las_classes(cls))
    assert (window_split.window_file_name("tower_", "D", "t0", 3)
            == jwindow.window_file_name("tower_", "D", "t0", 3))


def test_height_above_ground_equal_jax():
    rng = np.random.default_rng(2)
    x, y, z, cls = _tile(rng, n=3000)[:4]
    for cell in (2.0, 5.0):
        assert np.array_equal(hag.height_above_ground_grid(x, y, z, cls, cell=cell),
                              jhag.height_above_ground_grid(x, y, z, cls, cell=cell))
    assert np.array_equal(hag.height_above_ground_knn(x, y, z, cls, chunk=700),
                          jhag.height_above_ground_knn(x, y, z, cls, chunk=700))
    grid, origin = hag.rasterize_ground(x, y, z, cls == 2, cell=3.0)
    jgrid, jorigin = jhag.rasterize_ground(x, y, z, cls == 2, cell=3.0)
    assert origin == jorigin and np.array_equal(grid, jgrid, equal_nan=True)
    assert np.array_equal(hag.fill_holes(grid), jhag.fill_holes(jgrid))
    no_ground = np.where(cls == 2, 1, cls)  # falls back to z - min(z)
    assert np.array_equal(hag.height_above_ground_grid(x, y, z, no_ground),
                          jhag.height_above_ground_grid(x, y, z, no_ground))


@pytest.mark.parametrize("nir, xy_range, min_points", [(True, "unit", 100),
                                                       (False, "unit", 100),
                                                       (True, "neg_one", 100),
                                                       (True, "unit", 10_000)])
def test_filter_and_normalize_equal_jax(nir, xy_range, min_points):
    tile = _tile(np.random.default_rng(3), n=2500)
    hagv = jhag.height_above_ground_grid(*tile[:4])
    hagv[:7] = -1.0  # below ground: dropped
    kw = dict(x=tile[0], y=tile[1], hag=hagv, classification=tile[3], intensity=tile[4],
              red=tile[5], green=tile[6], blue=tile[7], nir=tile[8] if nir else None,
              z_raw=tile[9], xy_range=xy_range, min_points=min_points)
    a, pa = jfilter.filter_and_normalize(**kw)
    b, pb = filter_norm.filter_and_normalize(**kw)
    assert pa == pb
    if a is None:
        assert b is None
        return
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert b.shape[1] == 13 and not np.isin(b[:, 3], filter_norm.DROP_CLASSES).any()
    if not nir:  # the reference's constant NDVI without NIR
        assert (b[:, 9] == 0.5).all()
    assert filter_norm.DROP_CLASSES == jfilter.DROP_CLASSES


def test_num_tiles_train_equal_jax():
    for n in (1, 100, 2047, 2048, 2049, 4096, 18432, 18433, 50_000):
        for cap in (1, 5, 9):
            assert num_tiles_train(n, 2048, cap) == j_num_tiles_train(n, 2048, cap)


def _window_cloud(rng, n):
    pc = rng.uniform(size=(n, 13)).astype(np.float32)
    pc[:, 3] = rng.choice([1, 3, 5, 14, 15], n)
    return pc


@pytest.mark.parametrize("n", [100, 200, 300, 650, 1000])
def test_exact_mcf_tiling_equal_jax(n):
    """One window, two windows' worth, the ceil case and over the cap: the
    windowed tensor equals JAX's bit for bit (the same draws, the same solver)."""
    _need_jax_native()
    pc = _window_cloud(np.random.default_rng(n), n)
    a = jtiling.kmeans_tile_cloud(pc, n_points=128, max_clusters=5, seed=4,
                                  assigner="exact_mcf")
    b = tiling.kmeans_tile_cloud(pc, n_points=128, max_clusters=5, seed=4,
                                 assigner="exact_mcf", device="cpu")
    assert a.shape == b.shape and np.array_equal(a, b)
    assert tiling.KMEANS_COLS == jtiling.KMEANS_COLS


def test_sinkhorn_tiling_exact_sizes_and_jax_start():
    """Every window holds exactly n_points; from JAX's start the windows put
    at least 0.999 of the points where JAX's do."""
    pc = _window_cloud(np.random.default_rng(9), 700)  # over the cap: no duplicates
    k, npts, seed = 5, 128, 2
    a = jtiling.kmeans_tile_cloud(pc, n_points=npts, max_clusters=k, seed=seed)
    # the permutation JAX's balanced_kmeans draws, over the points it clusters
    init = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), k * npts)[:k])
    b = tiling.kmeans_tile_cloud(pc, n_points=npts, max_clusters=k, seed=seed,
                                 assigner="sinkhorn", device="cpu", init_idx=init)
    assert a.shape == b.shape == (npts, 13, k)
    # the window of each point, by its raw x (column 10) as an identity
    win = lambda t: {float(t[i, 10, w]): w for w in range(k) for i in range(npts)}
    wa, wb = win(a), win(b)
    assert len(wa) == len(wb) == k * npts
    agree = np.mean([wa[key] == wb[key] for key in wa])
    assert agree >= 0.999, agree
    drawn = tiling.kmeans_tile_cloud(pc, n_points=npts, max_clusters=k, seed=seed,
                                     assigner="sinkhorn", device="cpu")
    assert drawn.shape == (npts, 13, k)  # every window exactly n_points
    with pytest.raises(ValueError, match="assigner"):
        tiling.kmeans_tile_cloud(pc, assigner="lloyd", device="cpu")


def test_sinkhorn_tiling_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc = _window_cloud(np.random.default_rng(1), 400)
    with pytest.raises(RuntimeError, match="cuda"):
        tiling.kmeans_tile_cloud(pc, n_points=128, assigner="sinkhorn")
    with pytest.raises(RuntimeError, match="cuda"):
        main(_port_preprocess_argv(tmp_path, tmp_path / "o", assigner="sinkhorn"))


def test_split_lists_equal_jax(tmp_path):
    files = [f"pc_T_tile{t}_w{w}.pkl" for t in range(4) for w in range(5)]
    blocks = {"train": ["tile0", "tile1"], "val": ["tile2"], "test": ["tile9"]}
    for kw in (dict(seed=3), dict(fractions={"train": 0.5, "val": 0.25, "test": 0.25}),
               dict(blocks=blocks), dict(task="classification", seed=1)):
        a = jsplits.generate_split_lists(files, str(tmp_path / "j"), **kw)
        b = splits.generate_split_lists(files, str(tmp_path / "p"), **kw)
        assert a == b, kw
        assert _same_tree(tmp_path / "j", tmp_path / "p")


# ---------------------------------------------------------------- the command


@pytest.fixture(scope="module")
def las_tiles(tmp_path_factory):
    """Three seeded LAS tiles (terrain under them) written by JAX's synth."""
    folder = tmp_path_factory.mktemp("las")
    jcli.cmd_synth(argparse.Namespace(out_path=str(folder), n_tiles=3, windows_per_tile=2,
                                      points_per_window=1500, window_size=50.0, seed=1,
                                      terrain_relief=3.0))
    return folder


@pytest.fixture(scope="module")
def preprocessed(las_tiles, tmp_path_factory):
    """JAX's preprocess and the port's, once each, on the same tiles."""
    _need_jax_native()
    out = tmp_path_factory.mktemp("pre")
    assert jcli.cmd_preprocess(argparse.Namespace(
        in_path=str(las_tiles), out_path=str(out / "jax"), workers=1, assigner="exact_mcf",
        blocks_json=None, **PRE)) == 0
    assert main(_port_preprocess_argv(las_tiles, out / "port")) == 0
    return out


def test_preprocess_equal_jax(preprocessed):
    files = _same_tree(preprocessed / "jax", preprocessed / "port")
    kmeans = [f for f in files if f.startswith("kmeans_") and f.endswith(".npz")]
    assert len(kmeans) == 6 and len([f for f in files if f.endswith(".pkl")]) == 6
    for f in kmeans:
        assert load_cloud(str(preprocessed / "port" / f)).shape[:2] == (128, 13)
    assert {f for f in files if f.endswith(".txt")} == {
        "train_seg_files.txt", "val_seg_files.txt", "test_seg_files.txt"}


def test_preprocess_workers_equal_serial(las_tiles, preprocessed, tmp_path):
    assert main(_port_preprocess_argv(las_tiles, tmp_path, workers=2)) == 0
    _same_tree(preprocessed / "port", tmp_path)


def test_preprocess_blocks_json_equal_jax(las_tiles, tmp_path):
    _need_jax_native()
    bj = tmp_path / "blocks.json"
    bj.write_text(json.dumps({"train": ["tile0", "tile1"], "val": ["tile2"], "test": []}))
    assert jcli.cmd_preprocess(argparse.Namespace(
        in_path=str(las_tiles), out_path=str(tmp_path / "j"), workers=1,
        assigner="exact_mcf", blocks_json=[str(bj)], **PRE)) == 0
    assert main(_port_preprocess_argv(las_tiles, tmp_path / "p", blocks_json=[bj])) == 0
    _same_tree(tmp_path / "j", tmp_path / "p")
    val = (tmp_path / "p" / "val_seg_files.txt").read_text().splitlines()
    assert val and all("tile2" in ln for ln in val)


def test_preprocess_pt_artifacts_and_hag_extra_bytes(las_tiles, preprocessed, tmp_path):
    """``--artifact_format pt`` writes the same tensors; a tile carrying its
    HeightAboveGround as LAS extra bytes is preprocessed from that HAG."""
    assert main(_port_preprocess_argv(las_tiles, tmp_path / "pt", artifact_format="pt")) == 0
    for f in os.listdir(tmp_path / "pt"):
        if f.endswith(".pt"):
            npz = preprocessed / "port" / f.replace(".pt", ".npz")
            assert np.array_equal(load_cloud(str(tmp_path / "pt" / f)), load_cloud(str(npz)))
    src = las_tiles / "tile0.las"
    cloud = las_io.read_las(str(src))
    given = hag.height_above_ground_grid(cloud.x, cloud.y, cloud.z, cloud.classification,
                                         cell=3.0)
    (tmp_path / "h").mkdir()
    _add_hag_extra_bytes(str(src), str(tmp_path / "h" / "tile0.las"), given)
    _need_jax_native()
    assert jcli.cmd_preprocess(argparse.Namespace(
        in_path=str(tmp_path / "h"), out_path=str(tmp_path / "hj"), workers=1,
        assigner="exact_mcf", blocks_json=None, **PRE)) == 0
    assert main(_port_preprocess_argv(tmp_path / "h", tmp_path / "hp")) == 0
    _same_tree(tmp_path / "hj", tmp_path / "hp")
    # the HAG column is the file's, not the one the grid gives at cell 2
    name = next(f for f in os.listdir(tmp_path / "hp") if f.endswith("_w0.pkl"))
    from_file = load_cloud(str(tmp_path / "hp" / name))
    from_grid = load_cloud(str(preprocessed / "port" / name))
    assert from_file.shape != from_grid.shape or not np.array_equal(from_file, from_grid)


def test_preprocess_skips_corrupt_tile(las_tiles, tmp_path, capsys):
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "bad.las").write_bytes(b"NOT A LAS FILE")
    assert main(_port_preprocess_argv(tmp_path / "in", tmp_path / "o1")) == 1
    err = capsys.readouterr().err
    assert "bad.las: not a LAS file — skipped" in err and "no windows produced" in err
    (tmp_path / "in" / "tile0.las").write_bytes((las_tiles / "tile0.las").read_bytes())
    assert main(_port_preprocess_argv(tmp_path / "in", tmp_path / "o2")) == 0
    captured = capsys.readouterr()
    assert "skipped" in captured.err and "(1 unreadable tiles skipped)" in captured.out


def test_preprocess_refuses_geom_k_below_one(tmp_path, capsys):
    """``--geom_k 0`` is refused before any work (the JAX command line
    silently runs it as 24)."""
    argv = _port_preprocess_argv(tmp_path, tmp_path / "o") + ["--geom_features", "--geom_k", "0"]
    assert main(argv) == 1
    assert "--geom_k must be >= 1, got 0" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()
    with pytest.raises(ValueError, match="geom_k must be >= 1"):
        PreprocessParams(out_path=str(tmp_path), geom_features=True, geom_k=0)
