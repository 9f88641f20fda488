"""HTTP clients of the serving cell, run in a process of their own that
imports neither torch nor the measured package (the server's interpreter
lock stays the server's): a closed loop of ``clients`` threads over the
binary ``POST /v1/predict`` (a float32 ``[N, 9]`` body, int8 labels back),
each sending its next cloud as soon as the last one has returned.

Cloud sizes come from a fixed ladder shared by every seed, in an order
drawn from the seed; the contents (x, y uniform in [−1, 1], the other seven
columns N(0, 0.5²)) from the seed, the client and the request's index, so
the harness draws the same cloud again for the reference.
"""

from __future__ import annotations

import http.client
import queue
import sys
import threading
import time
from typing import Dict, List

import numpy as np

FEATURES = 9


def size_ladder(lo: int, hi: int, steps: int) -> np.ndarray:
    """``steps`` sizes evenly spread over [lo, hi]."""
    return np.linspace(lo, hi, steps).round().astype(np.int64)


def sizes_for(seed: int, stream: int, count: int, traffic: dict) -> np.ndarray:
    """The first ``count`` sizes of one stream: the ladder in an order drawn
    from (seed, stream), repeated."""
    ladder = size_ladder(traffic["points_min"], traffic["points_max"], traffic["ladder_steps"])
    rng = np.random.default_rng((int(seed), 7, int(stream)))
    reps = -(-count // len(ladder))
    return np.concatenate([rng.permutation(ladder) for _ in range(reps)])[:count]


def make_cloud(seed: int, stream: int, index: int, n: int) -> np.ndarray:
    """One [n, 9] float32 cloud (the serve phase of the repo's smoke draws
    its clouds so)."""
    rng = np.random.default_rng((int(seed), 11, int(stream), int(index)))
    c = rng.normal(size=(n, FEATURES)).astype(np.float32) * 0.5
    c[:, :2] = rng.uniform(-1.0, 1.0, size=(n, 2))
    return c


class _Conn:
    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self.conn = None

    def post(self, body: bytes) -> bytes:
        if self.conn is None:
            self.conn = http.client.HTTPConnection(self.host, self.port, timeout=120)
        try:
            self.conn.request("POST", "/v1/predict", body=body,
                              headers={"Content-Type": "application/octet-stream"})
            resp = self.conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException):
            self.close()
            raise
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")
        return data

    def close(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None


def _record(stream, index, n, sent, done, ok, labels, err=None) -> dict:
    return {"stream": stream, "index": index, "n": int(n), "sent": sent, "done": done,
            "ok": ok, "labels": labels, "error": err}


def _send(conn: _Conn, stream, index, cloud, out: list, lock) -> None:
    n = cloud.shape[0]
    sent = time.perf_counter()
    try:
        labels = conn.post(cloud.tobytes())
        ok = len(labels) == n
        rec = _record(stream, index, n, sent, time.perf_counter(), ok, labels,
                      None if ok else f"{len(labels)} labels for {n} points")
    except (OSError, RuntimeError, http.client.HTTPException) as e:
        rec = _record(stream, index, n, sent, time.perf_counter(), False, None, repr(e))
    with lock:
        out.append(rec)


WARM_INDEX = 10 ** 9  # warm-up clouds: indices no timed request takes


def _warm(conn: _Conn, seed: int, stream: int, traffic: dict) -> None:
    """Requests before the window opens (not recorded)."""
    for j in range(int(traffic.get("warmup_requests", 2))):
        conn.post(make_cloud(seed, stream, WARM_INDEX + j, int(traffic["points_max"])).tobytes())


def _closed(host, port, seed, traffic, times, gate, out, lock, stream):
    conn = _Conn(host, port)
    sizes = sizes_for(seed, stream, 100000, traffic)
    nxt: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def produce():
        i = 0
        while not stop.is_set():
            cloud = make_cloud(seed, stream, i, int(sizes[i]))
            while not stop.is_set():
                try:
                    nxt.put((i, cloud), timeout=0.1)
                    break
                except queue.Full:
                    continue
            i += 1

    prod = threading.Thread(target=produce, daemon=True)
    prod.start()
    try:
        _warm(conn, seed, stream, traffic)
    finally:
        gate.wait()
    t_open, t_close = times
    while time.perf_counter() < t_open:
        time.sleep(0.0005)
    while time.perf_counter() < t_close:
        i, cloud = nxt.get()
        _send(conn, stream, i, cloud, out, lock)
    stop.set()
    prod.join(timeout=5)
    conn.close()


def run(host: str, port: int, seed: int, traffic: dict, seconds: float, conn) -> None:
    """Warm-up requests, then the window of ``seconds``. Through ``conn`` (a
    Pipe end) go {"open": t, "close": t} once the warm-ups are done (times
    on the system's monotonic clock, which ``time.perf_counter`` reads in
    every process), then {"records": [...]} once every request has ended."""
    out: List[Dict] = []
    lock = threading.Lock()
    times: List[float] = []

    def opened():
        t_open = time.perf_counter() + float(traffic.get("open_delay_s", 0.2))
        times.extend([t_open, t_open + seconds])
        conn.send({"open": t_open, "close": t_open + seconds})

    n = int(traffic["clients"])
    gate = threading.Barrier(n, action=opened)
    threads = [threading.Thread(target=_closed, args=(host, port, seed, traffic, times, gate,
                                                      out, lock, c), daemon=True)
               for c in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 600)
    conn.send({"records": out, "torch_loaded": "torch" in sys.modules})
    conn.close()
