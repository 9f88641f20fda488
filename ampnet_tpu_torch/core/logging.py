"""Per-epoch scalar logging and evaluation-result rows to CSV, counterpart of
``ampnet_tpu/core/logging.py`` (the reference writes TensorBoard scalars and
CSV rows, ``train_pointnet-attention.py:280-309``,
``test_pointnet_att_segmen.py:272-284``). The CSV is the record; the port
writes no TensorBoard events."""

from __future__ import annotations

import csv
import os
import time
from typing import Dict


class MetricsLogger:
    """Appends ``wall_time, step, tag, value`` rows to
    ``<logdir>/<name>/scalars.csv``."""

    def __init__(self, logdir: str, name: str = "train"):
        self.logdir = os.path.join(logdir, name)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "scalars.csv")
        new = not os.path.exists(path)
        self._csv = open(path, "a", newline="")
        self._writer = csv.writer(self._csv)
        if new:
            self._writer.writerow(["wall_time", "step", "tag", "value"])

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._writer.writerow([f"{time.time():.3f}", step, tag, float(value)])

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.scalar(k, v, step)

    def flush(self) -> None:
        self._csv.flush()

    def close(self) -> None:
        self._csv.close()


def append_results_csv(path: str, row: Dict) -> None:
    """Append one evaluation-result row (IoU-results-v2.csv style,
    test_pointnet_att_segmen.py:272-284) in the row's key order; the header
    is written with the file's first row."""
    exists = os.path.exists(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        if not exists:
            w.writeheader()
        w.writerow(row)
