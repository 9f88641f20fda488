"""The port's observability against the JAX package's on the same inputs:
``core/profiling.py`` (``StepTimer``, ``EnergyTracker``, ``trace``),
``MetricsLogger``'s TensorBoard events beside the CSV (and a training run's),
the figures of ``core/plotting.py`` and its TensorBoard helpers, and the
sliding-window tower scanner. CPU only."""

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from ampnet_tpu.core import plotting as jplot
from ampnet_tpu.core.logging import MetricsLogger as JLogger
from ampnet_tpu.core.profiling import EnergyTracker as JEnergy
from ampnet_tpu.core.profiling import StepTimer as JTimer
from ampnet_tpu.ops import sliding_window as jscan
from ampnet_tpu_torch.core import plotting
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, TrainConfig
from ampnet_tpu_torch.core.logging import MetricsLogger
from ampnet_tpu_torch.core.profiling import EnergyTracker, StepTimer, trace
from ampnet_tpu_torch.data.datasets import WindowedCloudDataset
from ampnet_tpu_torch.data.io_utils import save_cloud
from ampnet_tpu_torch.data.pipeline import PaddedBatcher
from ampnet_tpu_torch.models.amp import AMPNetSegmenter
from ampnet_tpu_torch.ops import sliding_window as scan
from ampnet_tpu_torch.train.trainer import Trainer

# -- profiling -----------------------------------------------------------------


@pytest.mark.parametrize("times,skip", [([], 1), ([0.25], 1), ([0.5, 0.01, 0.02, 0.04], 1),
                                        ([0.5, 0.01, 0.02, 0.04], 0), ([0.3, 0.1], 3)])
def test_step_timer_summary_equals_jax(times, skip):
    mine, jax_timer = StepTimer(), JTimer()
    mine.times, jax_timer.times = list(times), list(times)
    assert mine.summary(skip) == jax_timer.summary(skip)


def test_step_timer_stop_walks_nested_results():
    t = StepTimer()
    for result in (None, torch.ones(2), {"a": (torch.ones(1), [torch.zeros(3)]), "b": 1.0}):
        t.start()
        assert t.stop(result) >= 0
    assert len(t.times) == 3


@pytest.mark.parametrize("watts,n,host,elapsed", [(700.0, 1, 40.0, 3600.0), (100.0, 2, 40.0, 12.5),
                                                  (350.0, 4, 0.0, 0.0)])
def test_energy_tracker_report_equals_jax(watts, n, host, elapsed, tmp_path):
    mine = EnergyTracker(device_watts=watts, n_devices=n, host_watts=host)
    ref = JEnergy(device_watts=watts, n_devices=n, host_watts=host)
    mine.elapsed_s = ref.elapsed_s = elapsed
    assert mine.report() == ref.report()
    mine.save(str(tmp_path / "e" / "emissions.json"))
    assert json.loads((tmp_path / "e" / "emissions.json").read_text()) == mine.report()


def test_energy_tracker_defaults_to_the_h100_power_limit():
    with EnergyTracker() as e:
        pass
    assert e.device_watts == 700.0 and e.elapsed_s >= 0
    assert e.report()["device_watts_assumed"] == 700.0


def test_trace_writes_a_trace_file(tmp_path):
    with trace(str(tmp_path / "prof")) as logdir:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


# -- MetricsLogger ----------------------------------------------------------------


def csv_rows(path):
    with open(path) as f:
        return [r[1:] for r in csv.reader(f)]  # without the wall time


def event_scalars(logdir):
    acc = EventAccumulator(logdir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_metrics_logger_writes_events_and_the_jax_csv(tmp_path):
    values = [({"loss": 1.5, "miou": 0.25}, 0), ({"loss": 0.75, "miou": 0.5}, 1)]
    for logger in (MetricsLogger(str(tmp_path / "p"), "t"), JLogger(str(tmp_path / "j"), "t")):
        for v, step in values:
            logger.scalars(v, step)
        logger.close()
    assert csv_rows(tmp_path / "p" / "t" / "scalars.csv") == csv_rows(
        tmp_path / "j" / "t" / "scalars.csv")
    assert [f for f in os.listdir(tmp_path / "p" / "t") if f.startswith("events")]
    assert event_scalars(str(tmp_path / "p" / "t")) == {
        "loss": [(0, 1.5), (1, 0.75)], "miou": [(0, 0.25), (1, 0.5)]}


def test_metrics_logger_without_tensorboard_writes_the_csv_only(tmp_path):
    logger = MetricsLogger(str(tmp_path), "t", tensorboard=False)
    logger.scalar("loss", 1.0, 0)
    logger.close()
    assert logger._tb is None
    assert os.listdir(tmp_path / "t") == ["scalars.csv"]


def test_a_training_run_writes_tensorboard_events(tmp_path):
    """The port's trainer logs through MetricsLogger as JAX's does
    (``train/trainer.py``): its run leaves events beside each CSV, holding
    the CSV's scalars."""
    rng = np.random.default_rng(0)
    names = []
    for i in range(4):
        pc = rng.uniform(0, 1, size=(40, 13, 3)).astype(np.float32)
        pc[:, 3] = np.where(pc[:, 2] > 0.7, 15, np.where(pc[:, 9] > 0.5, 5, 1))
        save_cloud(str(tmp_path / f"kmeans_cloud{i}.npz"), pc)
        names.append(f"cloud{i}.pkl")
    cfg = AMPNetConfig(data=DataConfig(n_points=32, max_windows=3),
                       train=TrainConfig(batch_size=2, epochs=1))

    def batcher(ns, seed):
        return PaddedBatcher(WindowedCloudDataset(str(tmp_path), ns), 2, n_points=32,
                             max_windows=3, seed=seed)

    model = AMPNetSegmenter(cfg.model, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, model, batcher(names[:2], 0), batcher(names[2:], 1),
                      str(tmp_path / "work"), name="t", device="cpu")
    trainer.fit(1)
    trainer.close()
    for split in ("train", "val"):
        logdir = str(tmp_path / "work" / "logs" / f"t_{split}")
        assert glob.glob(os.path.join(logdir, "events*"))
        rows = csv_rows(os.path.join(logdir, "scalars.csv"))[1:]
        scalars = event_scalars(logdir)
        assert sorted(scalars) == sorted({tag for _, tag, _ in rows})
        for step, tag, value in rows:
            assert (int(step), pytest.approx(float(value))) in scalars[tag]


# -- figures ----------------------------------------------------------------------


def figure_data(fig):
    """What each axes of a figure plots: scatter offsets and colours, line
    data, bar and histogram rectangles, 2-D histogram cells."""
    out = []
    for ax in fig.axes:
        out.append({
            "title": ax.get_title(),
            "collections": [(np.asarray(c.get_offsets()), np.asarray(c.get_facecolor()),
                             np.asarray(c.get_array()) if c.get_array() is not None else None)
                            for c in ax.collections],
            "lines": [np.asarray(line.get_xydata()) for line in ax.lines],
            "patches": [(p.get_x(), p.get_width(), p.get_height())
                        for p in ax.patches if hasattr(p, "get_width")],
        })
    return out


def assert_same_figure(a, b):
    da, db = figure_data(a), figure_data(b)
    assert len(da) == len(db)
    for x, y in zip(da, db):
        assert x["title"] == y["title"]
        assert len(x["collections"]) == len(y["collections"])
        for (o1, c1, a1), (o2, c2, a2) in zip(x["collections"], y["collections"]):
            np.testing.assert_array_equal(o1, o2)
            np.testing.assert_array_equal(c1, c2)
            if a1 is not None or a2 is not None:
                np.testing.assert_array_equal(a1, a2)
        assert len(x["lines"]) == len(y["lines"])
        for l1, l2 in zip(x["lines"], y["lines"]):
            np.testing.assert_array_equal(l1, l2)
        assert x["patches"] == y["patches"]


def test_plot_windows_equals_jax(rng, tmp_path):
    pts = rng.normal(size=(400, 3))
    assign = rng.integers(0, 5, 400)
    assert_same_figure(plotting.plot_windows(pts, assign), jplot.plot_windows(pts, assign))
    path = plotting.plot_windows(pts, assign, save_to=str(tmp_path / "w.png"))
    assert os.path.getsize(path) > 1000


def test_plot_training_curves_equals_jax(tmp_path):
    path = tmp_path / "scalars.csv"
    path.write_text("wall_time,step,tag,value\n" + "".join(
        f"0,{e},loss,{1.0 / (e + 1)}\n0,{e},miou,{e / 10}\n" for e in (3, 0, 1, 2)))
    for tags in (("loss", "miou", "accuracy"), ("miou",)):
        assert_same_figure(plotting.plot_training_curves(str(path), tags),
                           jplot.plot_training_curves(str(path), tags))
    out = plotting.plot_training_curves(str(path), save_to=str(tmp_path / "c.png"))
    assert os.path.getsize(out) > 1000


def test_plot_histograms_equal_jax(rng, tmp_path):
    values = rng.normal(size=1000)
    assert_same_figure(plotting.plot_histogram(values, bins=20, title="h"),
                       jplot.plot_histogram(values, bins=20, title="h"))
    x, y = rng.uniform(size=500), rng.normal(size=500)
    mine, ref = plotting.plot_histogram_2d(x, y, bins=12), jplot.plot_histogram_2d(x, y, bins=12)
    assert_same_figure(mine, ref)
    np.testing.assert_array_equal(mine.axes[0].collections[0].get_coordinates(),
                                  ref.axes[0].collections[0].get_coordinates())
    for fn, args in ((plotting.plot_histogram, (values,)), (plotting.plot_histogram_2d, (x, y))):
        out = fn(*args, save_to=str(tmp_path / f"{fn.__name__}.png"))
        assert os.path.getsize(out) > 1000


def test_tensorboard_helpers_write_events(rng, tmp_path):
    logger = MetricsLogger(str(tmp_path), "t")
    plotting.log_histogram_to_tensorboard(logger, "conf", rng.uniform(size=256), 1)
    plotting.log_figure_to_tensorboard(logger, "hist", plotting.plot_histogram(
        rng.normal(size=100)), 2)
    logger.close()
    acc = EventAccumulator(str(tmp_path / "t"))
    acc.Reload()
    assert acc.Tags()["histograms"] == ["conf"] and acc.Tags()["images"] == ["hist"]
    assert acc.Histograms("conf")[0].histogram_value.num == 256
    # a logger without events takes both calls and writes nothing
    quiet = MetricsLogger(str(tmp_path), "q", tensorboard=False)
    plotting.log_histogram_to_tensorboard(quiet, "conf", rng.uniform(size=8), 1)
    plotting.log_figure_to_tensorboard(quiet, "hist", plotting.plot_histogram([1.0, 2.0]), 1)
    quiet.close()
    assert os.listdir(tmp_path / "q") == ["scalars.csv"]


# -- the sliding-window scanner -----------------------------------------------------


def blob(rng, cx, cy, n=50, cls=15):
    pts = np.zeros((4, n))
    pts[0] = cx + rng.normal(0, 2, n)
    pts[1] = cy + rng.normal(0, 2, n)
    pts[2] = rng.uniform(0, 30, n)
    pts[3] = cls
    return pts


def clouds():
    """tests/test_observability.py's clouds, and a seeded cloud whose towers
    leave empty y-rows between them (the scanner's i_w crosses a skipped row)."""
    rng = np.random.default_rng(0)
    out = {"two_towers": np.concatenate([blob(rng, 10, 10), blob(rng, 80, 80)], axis=1)}
    small = np.zeros((4, 30))
    small[0], small[1] = rng.uniform(0, 5, 30), rng.uniform(0, 5, 30)
    out["small"], out["sparse"] = small, np.zeros((4, 5))
    none = np.zeros((4, 100))
    none[3] = 5
    out["no_towers"] = none
    rng = np.random.default_rng(7)
    gap = [blob(rng, 10, 10, 60), blob(rng, 24, 12, 80), blob(rng, 14, 72, 60),
           blob(rng, 80, 76, 40), blob(rng, 50, 30, 200, cls=2)]
    out["empty_row"] = np.concatenate(gap, axis=1)
    return out


def same_scan(got, want):
    (w, c), (jw, jc) = got, want
    if jw is None:
        assert w is None and c is None and jc is None
        return
    assert list(w) == list(jw) and list(c) == list(jc)
    for k in jw:
        np.testing.assert_array_equal(w[k], jw[k])
        assert c[k] == jc[k]


@pytest.mark.parametrize("name", ["two_towers", "small", "sparse", "no_towers", "empty_row"])
def test_scanner_equals_jax(name):
    pc = clouds()[name]
    for kw in ({}, {"window_size": (20.0, 20.0)}, {"step_x": 5.0, "step_y": 5.0, "min_points": 5}):
        same_scan(scan.sliding_window_scan(pc, **kw), jscan.sliding_window_scan(pc, **kw))
        same_scan(scan.scan_for_towers(pc, **kw), jscan.scan_for_towers(pc, **kw))


def test_the_empty_row_cloud_skips_a_row_between_towers():
    towers = clouds()["empty_row"]
    towers = towers[:, towers[3] == 15]
    y = towers[1]
    rows = [yy for yy in range(round(y.min()), round(y.max()), 10) if yy + 10 <= y.max()]
    empty = [yy for yy in rows if not ((y > yy) & (y < yy + 20)).any()]
    assert empty and rows[0] < empty[0] and empty[-1] < rows[-1]
    windows, centers = scan.scan_for_towers(clouds()["empty_row"])
    assert len(windows) >= 2
    assert min(c[1] for c in centers.values()) < 20 < 60 < max(c[1] for c in centers.values())
