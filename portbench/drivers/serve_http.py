"""Driver of the serving cell: the server ``serve`` builds
(``cli/main.py::make_server``, every flag at its default but the
configuration's backend, port 0), loading the seed's weights from a
published ``.pth`` under ``$TMPDIR``, driven over HTTP by the clients of
``portbench/clients.py`` in a spawned process that loads no torch.

The weights are the seed's with the last layer standardized on a cloud of
the traffic (``serving_weights``), so that every class leads somewhere.

Set-up warms each micro-batch size the traffic makes (the bucket graphs of
``warm_batches`` clouds, twice) and the HTTP path (a few requests a client).
The window is the clients' own: a request counts when it completed inside
it. The server's counters (``/v1/stats``) and the clients' median and 95th
percentile are read over the window, or, in a traced run, over the
untraced rest of it once the profiler has stopped. Correctness: once the window has closed and the
server is gone, a sample of the finished requests drawn from the seed, the
largest cloud among them, is labelled again by the plain reference
(tiling, forward, scatter) under the tiling of each micro-batch size the
traffic makes (the server's batch is not visible from outside); compared
are the widest gap by which a served label's reference logit lies below
the reference's best (over the RMS of the cloud's logits), and the count
of requests that failed."""

from __future__ import annotations

import math
import multiprocessing
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from portbench import clients, counts, program
from portbench.reference import ampnet as ref
from portbench.reference.tiling import predict_cloud, served_gaps, tiles_for
from portbench.trace import Profiler, prime_tracer


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in 0..100)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


CALIBRATION_STREAM = 10 ** 6  # a stream no client takes


def serving_weights(seed: int, device, model: dict, traffic: dict):
    """The seed's weights with the last layer standardized
    (``ref.standardize_head``) on a cloud of the traffic's largest size,
    drawn from the seed, cut into k strips by x, each ordered by y."""
    weights = ref.make_weights(seed, device, model["global_feat"], model["num_classes"])
    k, cap = tiles_for(traffic["points_max"], model["n_points"], model["max_clusters"])
    cloud = clients.make_cloud(seed, CALIBRATION_STREAM, 0, k * cap)
    cloud = cloud[np.argsort(cloud[:, 0], kind="stable")].reshape(k, cap, -1)
    strips = np.stack([s[np.argsort(s[:, 1], kind="stable")] for s in cloud])
    ref.standardize_head(weights, torch.from_numpy(strips[None]).to(device))
    return weights


def run(r) -> dict:
    from ampnet_tpu_torch.cli.main import build_parser, make_server
    from ampnet_tpu_torch.models.backends import make_forward
    from ampnet_tpu_torch.ops.kmeans import balanced_kmeans

    w, m, dev = r.workload, r.config["model"], r.device
    traffic = w["traffic"]
    weights = serving_weights(r.seed, dev, m, traffic)
    if r.trace:
        prime_tracer()  # before any graph exists: the trace sees replayed kernels
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        pth = os.path.join(tmp, "ampnet_att.pth")
        torch.save(ref.pth_payload(weights, m["n_points"]), pth)
        args = build_parser().parse_args(
            ["serve", "--model_checkpoint", pth, "--backend", r.config["backend"],
             "--port", "0", "--device", str(dev)])
        server = make_server(args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    inferencer = server.service.inferencer
    for _ in range(2):  # the capture, then a first replay
        server.warmup([traffic["points_max"]], batch_sizes=w["warm_batches"])
    httpd = threading.Thread(target=server.httpd.serve_forever, daemon=True)
    httpd.start()
    host, port = server.address

    mp = multiprocessing.get_context("spawn")
    mine, theirs = mp.Pipe()
    proc = mp.Process(target=clients.run, args=(host, port, r.seed, traffic, r.seconds, theirs))
    proc.start()
    theirs.close()
    times = mine.recv()
    stats_type = type(server.service.stats)
    server.service.stats = stats_type()  # the window's counters only
    cold_before = inferencer.cold_programs_seen
    t_open, t_close = times["open"], times["close"]
    r.t_first = time.time() + (t_open - time.perf_counter())
    t_counters = t_open
    snap = {}
    snapper = threading.Timer(max(0.0, t_close - time.perf_counter()),
                              lambda: snap.update(server.service.stats.snapshot()))
    snapper.start()
    prof = None
    if r.trace:
        at = t_open + w["trace_at_s"]
        time.sleep(max(0.0, at - time.perf_counter()))
        prof = Profiler()
        prof.start()
        time.sleep(w["trace_warm_s"])
        prof.step()
        time.sleep(w["trace_s"])
        prof.stop()
        time.sleep(w["trace_settle_s"])
        t_counters = time.perf_counter()  # the counters leave the traced stretch out
        server.service.stats = stats_type()
    reply = mine.recv()
    records = reply["records"]
    proc.join(timeout=60)
    if proc.is_alive():  # nothing of the run outlives it
        proc.terminate()
        proc.join()
    snapper.join()
    snapshot = snap
    if reply["torch_loaded"]:
        raise RuntimeError("the clients' process loaded torch")
    cold = inferencer.cold_programs_seen - cold_before
    peak = program.peak_bytes(dev)

    done = [x for x in records if t_open <= x["done"] <= t_close]
    ok = [x for x in done if x["ok"]]
    failed = [x for x in records if not x["ok"]]
    e2e = {"points_per_s": sum(x["n"] for x in ok) / r.seconds}
    k, cap = tiles_for(traffic["points_max"], m["n_points"], m["max_clusters"])
    least = counts.least_time_s(counts.model_ops(k, cap, m["num_classes"], m["global_feat"],
                                                 m["att_heads"]))
    counted = [(x["done"] - x["sent"]) * 1e3 if x["ok"] else float("inf")
               for x in done if x["sent"] >= t_counters]
    if t_counters >= t_close:  # the window had no untraced rest
        snapshot, counted = {}, []
    layers = {"stats": snapshot, "window_s": r.seconds,
              "client_median_ms": float(np.median(counted)) if counted else None,
              "latency_p95_ms": percentile(counted, 95) if counted else None,
              "cold_shapes_in_window": cold}
    out = {"e2e": e2e, "attempted": len(records), "failed": len(failed),
           "memory_peak_bytes": peak, "layers": layers}
    if prof is not None:
        traced = [x for x in ok if prof.t_begin <= x["done"] <= prof.t_end]
        layers.update(trace=prof.trace, trace_window_s=prof.window_s,
                      trace_model_least_s=least * len(traced))
        out.update(busy_s=prof.trace.busy_s(), window_s=prof.window_s,
                   breakdown={"device_ops": prof.trace.top_ops(10),
                              "idle_gaps": prof.trace.idle_gaps(10)})
    if prof is not None and dev.type == "cuda":
        # the two stages of a bucket alone, each in a graph of its own
        gen = torch.Generator(device=dev).manual_seed(ref.sub_seed(r.seed, 29))
        feats = torch.rand((1, k * cap, 3), generator=gen, device=dev)
        init = torch.randperm(k * cap, generator=gen, device=dev)[:k][None]
        layers["tiling_ms"] = program.graph_ms(
            lambda: balanced_kmeans(feats, k, capacities=(cap,) * k, init_idx=init), dev)
        fwd = make_forward(inferencer.models[0], inferencer.cfg, r.config["backend"], dev)
        win = torch.rand((1, k, cap, 9), generator=gen, device=dev)
        cen = win[..., :2].mean(dim=2)
        layers["forward_ms"] = program.graph_ms(lambda: fwd(win, cen, None), dev)
        del fwd
    server.close()
    del server, inferencer
    program.release(dev)

    rng = np.random.default_rng((r.seed, 17))
    finished = [x for x in records if x["ok"]]
    pick = set(rng.choice(len(finished), size=min(w["check_clouds"], len(finished)),
                          replace=False).tolist()) if finished else set()
    if finished:
        pick.add(max(range(len(finished)), key=lambda i: finished[i]["n"]))
    share, gap = (1.0, float("inf")) if not finished else (0.0, 0.0)
    for i in sorted(pick):
        x = finished[i]
        cloud = clients.make_cloud(r.seed, x["stream"], x["index"], x["n"])
        logits = predict_cloud(cloud, weights, dev, m["n_points"], m["max_clusters"],
                               batches=w["warm_batches"])
        s_i, g_i = served_gaps(logits, np.frombuffer(x["labels"], np.int8))
        share, gap = max(share, s_i), max(gap, g_i)
    print(f"portbench: bucket shapes first run in the window {cold}; worst share of a "
          f"cloud's labels off the reference {share}", file=sys.stderr)
    out["checks"] = {
        "label_gap": {"value": gap, "limit": w["limits"]["label_gap"]},
        "failed_requests": {"value": len(failed), "limit": 0},
    }
    return out


def control(seed: int, files: dict, device, faults: bool = False) -> dict:
    """The control of ``label_gap``: the reference with TF32 products put in
    the program's place, on ``check_clouds`` clouds of the traffic (the
    largest size first), judged as a run judges the served labels."""
    w, m = files["workload"], files["config"]["model"]
    traffic = w["traffic"]
    weights = serving_weights(seed, device, m, traffic)
    sizes = clients.sizes_for(seed, 0, w["check_clouds"], traffic)
    sizes[0] = traffic["points_max"]
    share = gap = 0.0
    for i, n in enumerate(sizes):
        cloud = clients.make_cloud(seed, 0, i, int(n))
        want = predict_cloud(cloud, weights, device, m["n_points"], m["max_clusters"],
                             batches=w["warm_batches"])
        got = predict_cloud(cloud, weights, device, m["n_points"], m["max_clusters"],
                            prec=ref.Precision("tf32"))[0]
        s_i, g_i = served_gaps(want, got.argmax(axis=1))
        share, gap = max(share, s_i), max(gap, g_i)
    return {"control": {"label_mismatch": share, "label_gap": gap}}
