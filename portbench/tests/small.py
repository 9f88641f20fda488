"""Small versions of the cells for the CPU tests: the same files, with the
model's window geometry, the traffic and the training set cut down (every
width stays the published one)."""

from __future__ import annotations

import copy
import os

from portbench import run as R

SEED = 2147483711  # above 2**31, as the driver's seeds can be


def bench() -> dict:
    return R.read_json(os.path.join(R.ROOT, "BENCHMARK.json"))


def files(cell: str) -> dict:
    f = copy.deepcopy(R.cell_files(cell, bench()))
    f["config"]["model"].update(n_points=64, windows=3)
    w = f["workload"]
    if "traffic" in w:  # k 18, cap 128: one bucket
        w["traffic"].update(points_min=1153, points_max=2304, ladder_steps=8)
        w.update(check_clouds=3, trace_at_s=0.5, trace_warm_s=0.3, trace_s=0.5)
    if "clouds" in w:
        w.update(clouds=16, steps_per_call=2, trace_at_step=2, trace_steps=2)
        f["config"]["train"]["batch_size"] = 4
    if "batch" in w:
        w.update(batch=2, trace_at_call=2, trace_warm_calls=2, trace_calls=3, min_calls_per_s=2)
    return f


def run(cell: str, capsys, seconds: float = 1.5, trace: int = 0, seed: int = SEED) -> dict:
    """One run of a small cell on the CPU; its JSON line."""
    import json

    rc = R.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                 "--trace", str(trace)], require_chip=False, bench=bench(), files=files(cell),
                device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])
