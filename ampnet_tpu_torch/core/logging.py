"""Per-epoch scalar logging and evaluation-result rows, counterpart of
``ampnet_tpu/core/logging.py`` (the reference writes TensorBoard scalars and
CSV rows, ``train_pointnet-attention.py:280-309``,
``test_pointnet_att_segmen.py:272-284``).

``MetricsLogger`` writes two sinks into one directory, as JAX's does: the CSV,
which is the record and always written, and TensorBoard events through
``torch.utils.tensorboard.SummaryWriter`` wherever that imports (it needs the
``tensorboard`` package). Where it does not, ``_tb`` stays ``None`` and only
the CSV is written, as in JAX.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict


class MetricsLogger:
    """Appends ``wall_time, step, tag, value`` rows to
    ``<logdir>/<name>/scalars.csv`` and, with ``tensorboard`` (where the
    writer imports), the same scalars as TensorBoard events beside it
    (``_tb``, which ``core/plotting.py``'s ``tb`` helpers also write to)."""

    def __init__(self, logdir: str, name: str = "train", tensorboard: bool = True):
        self.logdir = os.path.join(logdir, name)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "scalars.csv")
        new = not os.path.exists(path)
        self._csv = open(path, "a", newline="")
        self._writer = csv.writer(self._csv)
        if new:
            self._writer.writerow(["wall_time", "step", "tag", "value"])
        self._tb = None
        if tensorboard:
            try:  # the tensorboard package is optional, as in JAX
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(self.logdir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._writer.writerow([f"{time.time():.3f}", step, tag, float(value)])
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.scalar(k, v, step)

    def flush(self) -> None:
        self._csv.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._csv.close()
        if self._tb is not None:
            self._tb.close()


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
