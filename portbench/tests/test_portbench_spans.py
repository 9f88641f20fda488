"""The readers of the serving path's own spans: each reads None where the
server has no spans (the snapshot of a server without them, or no snapshot),
and the planted value otherwise. ``portbench/serve_idle.py`` reads the
planted overlap of a synthetic trace's idle gaps with planted
``batch.dispatch`` spans and the planted idle split by finest span, and runs
the small serving cell on the CPU with the recorder on. On the card, a
traced replay's ``graph.replay`` span holds the ``cudaGraphLaunch`` that
CUPTI records on the same thread."""

import os
import threading

import numpy as np
import pytest

from portbench import run as R
from portbench import serve_idle
from portbench.tests import small
from portbench.trace import Op, Trace

SPAN_READERS = ("serve.handler_ms", "serve.queue_ms", "serve.dispatch_ms",
                "serve.batch_tiling_ms", "serve.batch_forward_ms", "serve.pad_share")


def reader(name):
    return R.load_module(os.path.join(R.BENCH, "metrics", f"{name}.py"),
                         f"portbench_metric_{name}")


def span(mean_ms, count=10):
    return {"count": count, "total_s": mean_ms * count / 1e3, "mean_ms": mean_ms}


SNAPSHOT = {
    "latency_s": {"p50": 0.05},
    "breakdown": {"device_s_total": 1.0, "device_batches": 10, "pad_share": 0.3125},
    "spans": {"http.request": span(60.5), "service.predict": span(57.25),
              "batch.queue": span(12.0), "batch.dispatch": span(21.75),
              "device.tiling": span(40.0, 9), "device.forward": span(4.5, 9)},
}
PLANTED = {"serve.handler_ms": 3.25, "serve.queue_ms": 12.0, "serve.dispatch_ms": 21.75,
           "serve.batch_tiling_ms": 40.0, "serve.batch_forward_ms": 4.5,
           "serve.pad_share": 31.25}


@pytest.mark.parametrize("name", SPAN_READERS)
def test_reader_reads_none_without_spans(name):
    old = {"latency_s": {"p50": 0.05}, "breakdown": {"device_s_total": 1.0,
                                                      "device_batches": 10}}
    for layers in ({}, {"stats": {}}, {"stats": old}, {"stats": {**old, "spans": {}}}):
        assert reader(name).read(layers) is None


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_reader_reads_the_planted_snapshot(name):
    assert reader(name).read({"stats": SNAPSHOT}) == pytest.approx(PLANTED[name])


def planted_stretch():
    """Busy [1, 2), [4, 5), [7, 9) in a stretch [0, 10): idle [0, 1), [2, 4),
    [5, 7), [9, 10). Dispatch spans [0.5, 1.5) (0.5 s idle), [3, 6) (1 + 1),
    [5.5, 6.5) (overlaps the last, adding 0.5), [8, 8.5) (none): 3 s of 10.
    Inside the first dispatch, ``graph.replay`` [1.2, 1.4) (busy: none);
    ``batch.queue`` [0, 9.5) holds the rest but [9.5, 10)."""
    trace = Trace(device=[Op("k", 1, 2), Op("k", 4, 5), Op("k", 7, 9)], t0=0.0, t1=10.0)
    ns = lambda name, a, b: {"name": name, "start_ns": int(a * 1e9), "end_ns": int(b * 1e9),
                             "thread": 7}
    records = [ns("batch.dispatch", 0.5, 1.5), ns("batch.dispatch", 3, 6),
               ns("batch.dispatch", 5.5, 6.5), ns("batch.dispatch", 8, 8.5),
               ns("graph.replay", 1.2, 1.4), ns("batch.queue", 0, 9.5),
               {**ns("device.tiling", 0, 10), "clock": "device"}]
    return trace, records


def test_idle_in_dispatch_reads_the_planted_overlap():
    trace, records = planted_stretch()
    assert serve_idle.dispatch_idle_share(trace, records, 10.0) == pytest.approx(30.0)
    assert serve_idle.dispatch_idle_share(trace, records[4:], 10.0) == 0.0


def test_idle_split_gives_each_idle_second_to_its_finest_span():
    """6 s idle: 3 in dispatch, 2.5 more in the queue, 0.5 in no span; the
    replay's span is busy, so it takes none. Its launch, 1.25-1.3 s on the
    thread whose ident is 0x1_0000_0009 (CUPTI keeps the low 32 bits), is
    held by time and by thread."""
    trace, records = planted_stretch()
    trace.host.append(Op("cudaGraphLaunch", 1.25, 1.3))
    got = serve_idle.split(trace, records, 10.0, launches=[(9, int(1.25e9), int(1.3e9))],
                           idents={7: 0x1_0000_0009})
    assert got["idle_s"] == pytest.approx(6.0)
    assert got["idle_in_some_span_s"] == pytest.approx(5.5)
    assert got["idle_s_by_finest_span"] == pytest.approx(
        {"graph.replay": 0.0, "batch.dispatch": 3.0, "batch.queue": 2.5, "no span": 0.5})
    assert got["dispatch_idle_share"] == pytest.approx(30.0)
    assert got["graph_replays"] == {"in_stretch": 1, "holding_a_launch": 1,
                                    "holding_one_of_their_thread": 1}
    assert serve_idle.split(trace, records, 10.0, launches=[(8, int(1.25e9), int(1.3e9))],
                            idents={7: 0x1_0000_0009})["graph_replays"][
        "holding_one_of_their_thread"] == 0


@pytest.mark.parametrize("recorder", ["traced", "window"])
def test_serve_idle_runs_the_small_cell(recorder, capsys):
    """The tool on the small serving cell on the CPU (no device operations:
    the whole stretch is idle): a correct harness line, then its own; traced,
    raw spans were recorded and each idle second of the stretch is given
    once. (How much of the stretch the spans cover is not fixed here: a CPU
    batch can outlast the stretch and the run.)"""
    import json

    rc = serve_idle.run(small.SEED, 1.5, recorder, files=small.files(serve_idle.CELL),
                        device="cpu", require_chip=False)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    harness, line = json.loads(out[-2]), json.loads(out[-1])["serve_idle"]
    assert harness["correct"] and line["recorder"] == recorder
    if recorder == "window":
        assert "points_per_s" in harness["metrics"] and "idle_s" not in line
        return
    assert line["records"] > 0 and line["busy_s"] == 0.0
    assert sum(line["idle_s_by_finest_span"].values()) == pytest.approx(line["idle_s"])
    assert 0.0 <= line["idle_in_some_span_s"] <= line["idle_s"] + 1e-9
    assert line["idle_s"] == pytest.approx(line["stretch_s"][1] - line["stretch_s"][0])


@pytest.mark.card
def test_graph_replay_span_holds_its_launch(card):
    """One traced replay of a bucket graph, made on a thread of its own as
    the server's worker makes it: its ``graph.replay`` span (on the epoch
    clock, ``thread`` the native id) contains the ``cudaGraphLaunch`` that
    CUPTI records for the same thread. CUPTI names a thread the profiler does
    not record by its pthread id cut to 32 bits, signed (the event's
    ``device_resource_id``; ``start_thread_id`` is the profiler's own
    numbering). Its device stamps give a positive tiling and forward."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig
    from ampnet_tpu_torch.core.profiling import SpanGroup, SpanRecorder, Spans
    from ampnet_tpu_torch.infer.tiled import TiledInferencer
    from ampnet_tpu_torch.models.amp import AMPNetSegmenter
    from portbench.trace import prime_tracer

    prime_tracer()
    cfg = AMPNetConfig(data=DataConfig(n_points=64, max_clusters_test=3),
                       model=ModelConfig(dropout=0.0))
    torch.manual_seed(0)
    tt = TiledInferencer(AMPNetSegmenter(cfg.model).eval(), cfg, backend="xla", device=card)
    cloud = np.random.default_rng(0).normal(size=(200, 9)).astype(np.float32)  # k 3
    tt.predict_many([cloud])  # the capture
    rec, group, events = SpanRecorder(), SpanGroup("batch"), []

    def on_thread(**kw):
        t = threading.Thread(target=lambda: tt.predict_many([cloud], **kw))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        torch.cuda.synchronize()
        return t

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.profiler.kineto_results.events())) as prof:
        on_thread()  # the profiler's warm-up step
        prof.step()
        rec.start()
        worker = on_thread(spans=Spans(group))
        prof.step()
    rec.commit(group)
    records = rec.stop()
    (replay,) = [r for r in records if r["name"] == "graph.replay"]
    assert replay["thread"] == worker.native_id
    launches = [(e.device_resource_id(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in events if e.name() == "cudaGraphLaunch"]
    held = [x for x in launches if x[0] & 0xFFFFFFFF == worker.ident & 0xFFFFFFFF
            and replay["start_ns"] <= x[1] <= x[2] <= replay["end_ns"]]
    assert len(held) == 1, (replay, worker.ident, launches)
    dev = {r["name"]: r["end_ns"] - r["start_ns"] for r in records if r.get("clock") == "device"}
    assert dev["device.tiling"] > 0 and dev["device.forward"] > 0
