"""The whole-cloud training cell (``pn2_fp32.train_b32``, driver
``train_cloud``): the cell's files found by name, small runs on the CPU,
the readers of the program's ranges on a planted trace, and faults planted
in the program caught."""

import json
import os

import pytest
import torch

from portbench import run as R
from portbench import train_window
from portbench.drivers import train_cloud
from portbench.tests import small
from portbench.trace import Op, Trace

PN2 = "pn2_fp32.train_b32"
BENCH = small.bench()


def reader(name):
    return R.load_module(os.path.join(R.BENCH, "metrics", f"{name}.py"),
                         f"portbench_metric_{name}")


PN2_LAYER = {"pn2.fps_ms", "pn2.ball_query_ms", "pn2.group_ms", "pn2.three_nn_ms",
             "pn2.launches_per_step", "pn2.forward_ms", "pn2.backward_ms", "pn2.idle_share",
             "pn2.mfu", "pn2.peak_gib"}


def test_whole_cloud_cell_found_by_name():
    f = R.cell_files(PN2, BENCH)
    assert f["entry"]["chips"] == 1 and f["workload"]["driver"] == "train_cloud"
    assert os.path.exists(f["driver"])
    assert all(os.path.exists(p) for p in f["readers"].values())
    assert {m["name"] for m in f["e2e"]} == {"points_per_s", "setup_s"}
    assert {m["name"] for m in f["per_layer"]} == PN2_LAYER


def test_configuration_widths_are_the_reference_ones():
    from portbench.reference import pointnet2 as ref

    m = R.cell_files(PN2, BENCH)["config"]["model"]
    for i, (centres, radius, samples, widths) in enumerate(ref.SA):
        assert m[f"sa{i + 1}"] == {"centres": centres, "radius": radius, "samples": samples,
                                  "mlp": list(widths)}
    assert [m[name] for name, _ in ref.FP] == [list(w) for _, w in ref.FP]
    assert (m["head"], m["dropout"]) == (ref.HEAD, ref.DROPOUT)


def test_whole_cloud_cell_sound_and_traced(capsys):
    line = small.run(PN2, capsys)
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"points_per_s", "setup_s"}
    traced = small.run(PN2, capsys, trace=1)
    assert traced["correct"], traced["checks"]
    # the CPU has no device operations and no device memory to read
    assert set(traced["metrics"]) == PN2_LAYER - {"pn2.launches_per_step", "pn2.idle_share",
                                                  "pn2.peak_gib"}


def planted_trace():
    """Kernels launched inside ``pointnet2.fps`` (6 ms), ``pointnet2.ball_query``
    (30 ms), a range no reader reads (4 ms) and outside any range (10 ms)."""
    host = [Op("pointnet2.fps", 0.0, 1.0, thread=1), Op("cudaLaunchKernel", 0.1, 0.2, thread=1),
            Op("pointnet2.ball_query", 1.0, 2.0, thread=1),
            Op("cudaLaunchKernel", 1.1, 1.2, thread=1),
            Op("other.range", 2.0, 2.4, thread=1), Op("cudaLaunchKernel", 2.1, 2.2, thread=1),
            Op("cudaLaunchKernel", 2.5, 2.6, thread=1)]
    device = [Op("fps_kernel", 0.2, 0.206, corr=1), Op("sort_kernel", 1.2, 1.23, corr=2),
              Op("other_kernel", 2.2, 2.204, corr=3), Op("gemm", 2.6, 2.61, corr=4)]
    return Trace(device=device, host=host,
                 launches={1: host[1], 2: host[3], 3: host[5], 4: host[6]}, t0=0.0, t1=3.0)


def test_readers_on_a_planted_trace():
    trace = planted_trace()
    layers = {"trace": trace, "trace_steps": 2,
              "ranges": train_window.seen_ranges(trace, train_cloud.RANGES)}
    want = {"pn2.fps_ms": 3.0, "pn2.ball_query_ms": 15.0, "pn2.group_ms": None,
            "pn2.three_nn_ms": None, "pn2.launches_per_step": 2.0}
    for name, value in want.items():
        got = reader(name).read(layers)
        assert got == (None if value is None else pytest.approx(value)), name


def test_readers_read_none_without_the_ranges():
    """A program without the ranges (the parent of the change that added
    them) gives no entry, so its readers give None, not 0."""
    trace = planted_trace()
    trace.host = [o for o in trace.host if o.name == "cudaLaunchKernel"]
    layers = {"trace": trace, "trace_steps": 2,
              "ranges": train_window.seen_ranges(trace, train_cloud.RANGES)}
    assert layers["ranges"] == {}
    for name in ("pn2.fps_ms", "pn2.ball_query_ms", "pn2.group_ms", "pn2.three_nn_ms"):
        assert reader(name).read(layers) is None
    assert reader("pn2.launches_per_step").read(layers) == pytest.approx(2.0)
    assert reader("pn2.fps_ms").read({}) is None


def fault_run(capsys) -> dict:
    """The small cell at 512 points a cloud: SA1's balls hold a few members,
    so a radius moves many of them."""
    f = small.files(PN2)
    f["config"]["model"]["n_points"] = 512
    rc = R.main(["--workload", PN2, "--seed", str(small.SEED), "--seconds", "0.5"],
                require_chip=False, bench=BENCH, files=f, device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sa1_radius_at_0_09_is_caught(monkeypatch, capsys):
    from ampnet_tpu_torch.models import pointnet2

    init = pointnet2.PointNet2Segmenter.__init__

    def planted(self, *a, **k):
        init(self, *a, **k)
        self.sa1.radius = 0.09

    monkeypatch.setattr(pointnet2.PointNet2Segmenter, "__init__", planted)
    line = fault_run(capsys)
    assert not line["correct"]
    # the loss alone catches it, not only the first gradient
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"]["limit"]


def test_fp1_weights_made_uniform_are_caught(monkeypatch, capsys):
    from ampnet_tpu_torch.core import checkpoint

    load = checkpoint.load_model

    def planted(*a, **k):
        cfg, model = load(*a, **k)
        with torch.no_grad():
            for name, p in model.fp1.named_parameters():
                if name.startswith("mlp_"):
                    p.fill_(float(p.abs().mean()))
        return cfg, model

    monkeypatch.setattr(checkpoint, "load_model", planted)
    assert not fault_run(capsys)["correct"]
