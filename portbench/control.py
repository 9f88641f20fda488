"""The controls of the correctness checks: the plain reference put in the
program's place at the nearest precision below the configuration's, read
by the same comparison as a run. A limit must fail its control.

    python portbench/control.py --workload <cell> --seeds 1 2 3 [--faults]

prints one JSON line a seed with the numbers the cell compares, from the
``control(seed, files, device, faults)`` of the cell's driver (TF32
products against float32, 4-bit chains against 8-bit; with ``--faults``
also the faults each driver plants in the reference). It runs at the
cell's own sizes on the card (the tests run it small on the CPU) and is
not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell: str, seed: int, files: dict, device, faults: bool = False) -> dict:
    from portbench.run import load_module

    driver = files["workload"]["driver"]
    return load_module(files["driver"], f"portbench_driver_{driver}").control(
        seed, files, device, faults)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.run import cell_files, read_json

    files = cell_files(args.workload, read_json(os.path.join(ROOT, "BENCHMARK.json")))
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        out = readings(args.workload, seed, files, device, args.faults)
        print(json.dumps({"cell": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
