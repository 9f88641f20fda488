"""The port's HTTP server (backend ``fused``, plain chain on the CPU) against
the JAX package on the same clouds and the same weights, with
tests/test_server.py's request shapes; and ``serve --backend int8`` against
the port's own ``predict_many``.

Clouds below 2·n_points tile into one window, so both packages see identical
inputs (the replicate padding is the same numpy draw); a cloud that tiles
into several windows is held against the port's own ``predict_many``, since
the two packages' k-means initializations come from different generators."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from ampnet_tpu.core.config import AMPNetConfig as JConfig
from ampnet_tpu.core.config import DataConfig as JDataConfig
from ampnet_tpu.core.config import ModelConfig as JModelConfig
from ampnet_tpu.infer.tiled import TiledInferencer as JTiled
from ampnet_tpu.models.amp import AMPNetSegmenter as JSegmenter
from ampnet_tpu_torch.cli.main import build_parser, make_server
from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig
from ampnet_tpu_torch.core.weights import flax_variables, load_flax_variables, save_reference_pth
from ampnet_tpu_torch.infer.server import InferenceServer
from ampnet_tpu_torch.infer.tiled import TiledInferencer
from ampnet_tpu_torch.models.amp import AMPNetSegmenter


@pytest.fixture(scope="module")
def pair():
    jcfg = JConfig(data=JDataConfig(n_points=64, max_clusters_test=3),
                   model=JModelConfig(dropout=0.0))
    jm = JSegmenter(jcfg.model)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(1, 2, 64, 9)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), pts, pts[:, :, :, :2].mean(axis=2), np.zeros((1, 2), bool))
    leaves, treedef = jax.tree.flatten(v)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    v = jax.tree.unflatten(treedef, [l + jax.random.normal(k, l.shape, l.dtype) * 0.05
                                     for k, l in zip(keys, leaves)])
    cfg = AMPNetConfig(data=DataConfig(n_points=64, max_clusters_test=3),
                       model=ModelConfig(dropout=0.0))
    model = load_flax_variables(AMPNetSegmenter(cfg.model), jax.tree.map(np.asarray, v))
    jt = JTiled(jm, v, jcfg, backend="fused")
    tt = TiledInferencer(model, cfg, backend="fused", device="cpu")
    srv = InferenceServer(tt, host="127.0.0.1", port=0, model_name="port-model",
                          batch_window_ms=20.0)
    t = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    t.start()
    yield jt, srv
    srv.close()
    t.join(timeout=30)
    assert not t.is_alive()


def _url(srv, path):
    host, port = srv.address
    return f"http://{host}:{port}{path}"


def _post(srv, data, headers):
    req = urllib.request.Request(_url(srv, "/v1/predict"), data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


BINARY = {"Content-Type": "application/octet-stream"}
JSON = {"Content-Type": "application/json"}


def test_healthz(pair):
    _, srv = pair
    with urllib.request.urlopen(_url(srv, "/healthz"), timeout=30) as r:
        body = json.loads(r.read())
    assert body == {"status": "ok", "model": "port-model", "n_points": 64,
                    "max_clusters": 3, "backend": "fused"}


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_binary_predict_matches_jax(pair, dtype):
    jt, srv = pair
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(100, 9)).astype(dtype)
    status, ctype, body = _post(srv, pts.tobytes(), {**BINARY, "X-Dtype": dtype})
    assert status == 200 and ctype == "application/octet-stream"
    labels = np.frombuffer(body, np.int8)
    want = jt.predict_many([pts.astype(np.float32)], seeds=[0])[0]
    assert labels.shape == (100,)
    assert (labels == want).mean() >= 0.999


def test_binary_multi_window_matches_direct(pair):
    """A cloud that tiles into several windows answers what the port's own
    predict_many gives for the same cloud and seed."""
    _, srv = pair
    pts = np.random.default_rng(2).normal(size=(150, 9)).astype(np.float32)
    _, _, body = _post(srv, pts.tobytes(), BINARY)
    direct = srv.service.inferencer.predict_many([pts], seeds=[0])[0]
    np.testing.assert_array_equal(np.frombuffer(body, np.int8), direct)


def test_json_multi_cloud_probs_matches_jax(pair):
    jt, srv = pair
    rng = np.random.default_rng(3)
    clouds = [rng.normal(size=(n, 9)).astype(np.float32) for n in (80, 120)]
    payload = json.dumps({"clouds": [c.tolist() for c in clouds], "probs": True}).encode()
    status, ctype, body = _post(srv, payload, JSON)
    assert status == 200 and ctype == "application/json"
    out = json.loads(body)
    ref = jt.predict_many(clouds, seeds=[0, 0], return_probs=True)
    for labels, probs, (jl, jp) in zip(out["labels"], out["probs"], ref):
        assert (np.asarray(labels) == jl).mean() >= 0.999
        np.testing.assert_allclose(np.asarray(probs), jp.astype(np.float32), atol=2e-3)
        np.testing.assert_array_equal(np.argmax(probs, axis=1), labels)


def test_json_two_buckets_and_a_shared_bucket(pair):
    """One request whose clouds fall in two bucket shapes (the dispatch runs
    each bucket from its own thread), two of them sharing one bucket: each
    answer equals predict_many on the same clouds."""
    _, srv = pair
    rng = np.random.default_rng(7)
    clouds = [rng.normal(size=(n, 9)).astype(np.float32) for n in (260, 150, 250)]
    payload = json.dumps({"clouds": [c.tolist() for c in clouds]}).encode()
    out = json.loads(_post(srv, payload, JSON)[2])["labels"]
    direct = srv.service.inferencer.predict_many(clouds, seeds=[0, 0, 0])
    for labels, want in zip(out, direct):
        np.testing.assert_array_equal(np.asarray(labels), want)


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_tta_route_matches_jax(pair, wire):
    jt, srv = pair
    cloud = np.random.default_rng(4).normal(size=(90, 9)).astype(np.float32)
    if wire == "json":
        payload = json.dumps({"clouds": [cloud.tolist()], "tta": 4}).encode()
        labels = np.asarray(json.loads(_post(srv, payload, JSON)[2])["labels"][0])
    else:
        labels = np.frombuffer(_post(srv, cloud.tobytes(), {**BINARY, "X-TTA": "4"})[2], np.int8)
    want = jt.predict_tta(cloud, seed=0, transforms=4)
    assert (labels == want).mean() >= 0.999


def test_json_normalize_flag_matches_jax(pair):
    jt, srv = pair
    rng = np.random.default_rng(5)
    c = rng.normal(size=(70, 9)).astype(np.float32)
    c[:, :2] = rng.uniform(0, 1, (70, 2))  # raw [0, 1] x/y
    payload = json.dumps({"clouds": [c.tolist()], "normalize": True}).encode()
    labels = np.asarray(json.loads(_post(srv, payload, JSON)[2])["labels"][0])
    norm = c.copy()
    norm[:, :2] = norm[:, :2] * 2.0 - 1.0
    assert (labels == jt.predict_many([norm], seeds=[0])[0]).mean() >= 0.999


def test_concurrent_clients_get_their_solo_answers(pair):
    _, srv = pair
    rng = np.random.default_rng(6)
    clouds = [rng.normal(size=(n, 9)).astype(np.float32) for n in (100, 140, 200)]
    solo = [np.frombuffer(_post(srv, c.tobytes(), BINARY)[2], np.int8) for c in clouds]
    results = [None] * len(clouds)

    def hit(i):
        results[i] = np.frombuffer(_post(srv, clouds[i].tobytes(), BINARY)[2], np.int8)

    ts = [threading.Thread(target=hit, args=(i,)) for i in range(len(clouds))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    for got, want in zip(results, solo):
        np.testing.assert_array_equal(got, want)


def test_bad_requests_and_stats(pair):
    _, srv = pair
    req = urllib.request.Request(_url(srv, "/v1/predict"), data=b"\x00" * 7, headers=BINARY)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    with urllib.request.urlopen(_url(srv, "/v1/stats"), timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 1 and stats["errors"] == 0
    assert stats["latency_s"]["p50"] is not None or stats["cold_requests"] >= 1


def test_serve_int8_command_line_matches_predict_many(pair, tmp_path):
    """``serve --backend int8 --device cpu`` answers a binary and a JSON
    request with the labels of a direct int8 ``predict_many`` on the same
    weights (restored from a reference .pth)."""
    fused = pair[1].service.inferencer  # the port model and config of the fused server
    ckpt = tmp_path / "model_attention.pth"
    save_reference_pth(flax_variables(fused.models[0]), str(ckpt), meta={"number_of_points": 64})
    server = make_server(build_parser().parse_args([
        "serve", "--model_checkpoint", str(ckpt), "--device", "cpu", "--port", "0",
        "--backend", "int8", "--max_clusters", "3", "--batch_window_ms", "1",
    ]))
    t = threading.Thread(target=server.httpd.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
            assert json.loads(r.read())["backend"] == "int8"
        rng = np.random.default_rng(8)
        one = rng.normal(size=(150, 9)).astype(np.float32)
        two = [rng.normal(size=(n, 9)).astype(np.float32) for n in (80, 260)]
        binary = np.frombuffer(_post(server, one.tobytes(), BINARY)[2], np.int8)
        payload = json.dumps({"clouds": [c.tolist() for c in two]}).encode()
        labels = json.loads(_post(server, payload, JSON)[2])["labels"]
    finally:
        server.close()
        t.join(timeout=30)
    assert not t.is_alive()
    direct = TiledInferencer(fused.models[0], fused.cfg, backend="int8", device="cpu")
    np.testing.assert_array_equal(binary, direct.predict_many([one], seeds=[0])[0])
    for got, want in zip(labels, direct.predict_many(two, seeds=[0, 0])):
        np.testing.assert_array_equal(np.asarray(got), want)


def _recorded(srv, send) -> list:
    """The raw span records of the requests ``send()`` makes (it returns
    how many), once their handlers have committed them."""
    stats = srv.service.stats
    before = stats.requests
    stats.start()
    n = send()
    deadline = time.monotonic() + 60
    while stats.requests < before + n and time.monotonic() < deadline:
        time.sleep(0.01)
    return stats.stop()


def _inside(inner, outer) -> bool:
    return outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]


@pytest.mark.parametrize("wire", ["binary", "json", "tta"])
def test_request_spans_nest_and_name_their_batch(pair, wire):
    """A request's spans: ``http.request`` (its id the request's) encloses
    read, decode, predict, encode and write in that order; its
    ``batch.queue`` ends where its batch's ``batch.dispatch`` starts, and the
    dispatch's stages lie inside the dispatch."""
    _, srv = pair
    cloud = np.random.default_rng(9).normal(size=(150, 9)).astype(np.float32)

    def send():
        if wire == "json":
            _post(srv, json.dumps({"clouds": [cloud.tolist()]}).encode(), JSON)
        else:
            _post(srv, cloud.tobytes(), {**BINARY, "X-TTA": "2" if wire == "tta" else "1"})
        return 1

    records = _recorded(srv, send)
    (root,) = [r for r in records if r["name"] == "http.request"]
    rid = root["request"]
    assert root["id"] == rid and root["parent"] == 0
    mine = [r for r in records if r.get("request") == rid]
    kids = sorted((r for r in mine if r["name"] not in ("batch.queue", "http.request")),
                  key=lambda r: r["start_ns"])
    assert [r["name"] for r in kids] == ["http.read", "http.decode", "service.predict",
                                         "http.encode", "http.write"]
    assert all(r["parent"] == rid and _inside(r, root) for r in kids)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(kids, kids[1:]))
    (queue,) = [r for r in mine if r["name"] == "batch.queue"]
    assert _inside(queue, kids[2])
    batch = [r for r in records if r.get("batch") == queue["batch"] and "request" not in r]
    (dispatch,) = [r for r in batch if r["name"] == "batch.dispatch"]
    assert dispatch["start_ns"] == queue["end_ns"]
    stages = [r for r in batch if r["name"].startswith("dispatch.")]
    assert {r["name"] for r in stages} >= {"dispatch.pad", "dispatch.encode", "dispatch.launch"}
    assert all(r["parent"] == dispatch["id"] and _inside(r, dispatch) for r in stages)
    assert {"batch.drain", "batch.fetch_queue", "batch.unpack", "batch.exec", "device.tiling",
            "device.forward"} <= {r["name"] for r in batch}


def test_recording_off_appends_nothing(pair):
    """Off, a request adds to the span totals and appends no record."""
    _, srv = pair
    stats = srv.service.stats
    stats.stop()
    before = stats.requests
    _post(srv, np.random.default_rng(10).normal(size=(90, 9)).astype(np.float32).tobytes(),
          BINARY)
    deadline = time.monotonic() + 60
    while stats.requests == before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert stats.requests == before + 1
    assert stats._records is None and stats.stop() == []


def test_stats_keys_read_the_spans(pair):
    """Each snapshot key that predates the spans holds its value: decode and
    encode totals are their spans' sums, ``device_s_total`` over
    ``device_batches`` is each warm batch's dispatch done to fetch done, the
    request count and latency are ``service.predict``'s."""
    from ampnet_tpu_torch.infer.server import ServingStats

    _, srv = pair
    old, srv.service.stats = srv.service.stats, ServingStats()
    rng = np.random.default_rng(11)
    clouds = [rng.normal(size=(n, 9)).astype(np.float32) for n in (150, 80, 120, 100)]

    def send():
        _post(srv, clouds[0].tobytes(), BINARY)
        _post(srv, json.dumps({"clouds": [c.tolist() for c in clouds[1:3]]}).encode(), JSON)
        _post(srv, clouds[3].tobytes(), BINARY)
        return 3

    try:
        records = _recorded(srv, send)
        snap = srv.service.stats.snapshot()
    finally:
        srv.service.stats = old
    dur = lambda rs: sum(r["end_ns"] - r["start_ns"] for r in rs) * 1e-9
    named = lambda name: [r for r in records if r["name"] == name]
    b = snap["breakdown"]
    assert b["decode_s_total"] == round(dur(named("http.decode")), 4)
    assert b["encode_s_total"] == round(dur(named("http.encode")), 4)
    execs = named("batch.exec")
    warm = [r for r in execs if not r["cold"]]
    assert b["device_batches"] == len(warm) and b["cold_batches"] == len(execs) - len(warm)
    assert b["device_s_total"] == round(dur(warm), 4)
    assert b["cold_device_s_total"] == round(dur(execs) - dur(warm), 4)
    for r in execs:
        mine = [x for x in records if x.get("batch") == r["batch"] and "request" not in x]
        (dispatch,) = [x for x in mine if x["name"] == "batch.dispatch"]
        assert 0 <= r["start_ns"] - dispatch["end_ns"] < 10 ** 8
        assert all(x["end_ns"] <= r["end_ns"] for x in mine if x["name"] == "batch.unpack")
    predicts = named("service.predict")
    assert snap["requests"] == len(predicts) == 3
    assert snap["points"] == sum(c.shape[0] for c in clouds)
    lat = sorted((r["end_ns"] - r["start_ns"]) * 1e-9 for r in predicts if not r["cold"])
    if lat:
        assert snap["latency_s"]["p50"] == lat[int(0.5 * (len(lat) - 1))]


def test_pad_share_and_spans_of_a_warm_batch(pair):
    """A warm 3-cloud bucket (k 3, cap 128) padded to 4 clouds:
    ``pad_share`` is 1 − 630 / (4 · 3 · 128), and ``spans`` counts the
    batch and the request once each."""
    from ampnet_tpu_torch.infer.server import ServingStats

    _, srv = pair
    rng = np.random.default_rng(12)
    clouds = [rng.normal(size=(n, 9)).astype(np.float32) for n in (200, 210, 220)]
    payload = json.dumps({"clouds": [c.tolist() for c in clouds]}).encode()
    _post(srv, payload, JSON)  # the shape's first run: cold
    old, srv.service.stats = srv.service.stats, ServingStats()
    try:
        _recorded(srv, lambda: len([_post(srv, payload, JSON)]))
        snap = srv.service.stats.snapshot()
    finally:
        srv.service.stats = old
    assert snap["breakdown"]["pad_share"] == round(1 - 630 / (4 * 3 * 128), 6)
    spans = snap["spans"]
    for name in ("http.request", "service.predict", "batch.queue", "batch.dispatch",
                 "dispatch.pad", "batch.exec", "device.tiling", "device.forward"):
        assert spans[name]["count"] == 1, name
    assert spans["http.request"]["mean_ms"] >= spans["service.predict"]["mean_ms"] > 0
