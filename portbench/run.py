"""Runs one cell of the port's benchmark once and prints one JSON line last.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; everything
else is found by name: ``portbench/workloads/<cell>.json`` (configuration,
driver, traffic), ``portbench/configs/<config>.json``,
``portbench/drivers/<driver>.py`` and one ``portbench/metrics/<metric>.py``
reader per per-layer metric. With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy and traced seconds and a breakdown. Each number the correctness check
compares is printed with its limit, last on stderr and last in the line.

This module imports only the standard library at its top: the clients'
spawned process imports it again and must not load torch.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
FOREIGN = ("jax", "jaxlib", "flax", "optax", "orbax", "ampnet_tpu")


def process_start_time() -> float:
    """This process's start on the ``time.time`` clock (from /proc), or
    now when /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = process_start_time()


def load_module(path: str, name: str):
    """A module from a file named after a benchmark entry (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell_files(cell: str, bench: dict) -> dict:
    """The files of one cell, found by name: its workload, configuration,
    driver, and the readers of its per-layer metrics."""
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    workload = read_json(os.path.join(BENCH, "workloads", f"{cell}.json"))
    config = read_json(os.path.join(BENCH, "configs", f"{entry['config']}.json"))
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"entry": entry, "workload": workload, "config": config, "e2e": e2e,
            "per_layer": layer,
            "driver": os.path.join(BENCH, "drivers", f"{workload['driver']}.py"),
            "readers": {m["name"]: os.path.join(BENCH, "metrics", f"{m['name']}.py")
                        for m in layer}}


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FOREIGN))


class Run:
    """What a driver gets: the arguments, the cell's files, the device."""

    def __init__(self, args, files: dict, device):
        self.seed, self.seconds, self.trace = args.seed, float(args.seconds), bool(args.trace)
        self.workload, self.config = files["workload"], files["config"]
        self.device = device
        self.t_process = T_PROCESS
        self.t_first = None  # set by the driver when the first timed work starts

    def window_opens(self) -> None:
        self.t_first = time.time()

    @property
    def setup_s(self) -> float:
        return self.t_first - self.t_process


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                               "-i", "0"], capture_output=True, text=True, timeout=30,
                              check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unread"


def finite(x: float) -> float:
    """``x``, or the largest float for an infinite reading (a request that
    never came)."""
    return x if x == x and abs(x) != float("inf") else 1.7976931348623157e308


def main(argv=None, require_chip: bool = True, bench: dict = None, files: dict = None,
         device: str = "cuda") -> int:
    """One run; returns the exit code. The tests pass ``require_chip=False``
    with ``device='cpu'`` and small ``files``."""
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    bench = bench if bench is not None else read_json(os.path.join(ROOT, "BENCHMARK.json"))
    files = files if files is not None else cell_files(args.workload, bench)

    import torch

    chips = int(files["entry"].get("chips", 1))
    if require_chip:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s), {have} visible",
                  file=sys.stderr)
            return 2
    run = Run(args, files, torch.device(device))
    driver = load_module(files["driver"], f"portbench_driver_{files['workload']['driver']}")
    out = driver.run(run)

    found = foreign_modules()
    if found:
        print(f"portbench: JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3

    if run.trace:
        metrics = {}
        for m in files["per_layer"]:
            reader = load_module(files["readers"][m["name"]], f"portbench_metric_{m['name']}")
            value = reader.read(out["layers"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=run.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in files["e2e"]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": torch.cuda.get_device_name(0) if run.device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if run.device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": all(c["value"] <= c["limit"] for c in out["checks"].values()),
              "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    if run.trace:
        dev["busy_s"] = float(out["busy_s"])
        dev["window_s"] = float(out["window_s"])
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    for c in [*metrics.values(), *out["checks"].values()]:  # JSON has no infinity
        c["value"] = finite(c["value"])
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
