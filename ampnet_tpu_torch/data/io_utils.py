"""Artifact loading, the port's own copy of ``ampnet_tpu/data/io_utils.py``:
pickled NumPy clouds and ``kmeans_*.pt`` torch tensors (the reference's
formats, ``datasets.py:72-73,335``) and ``.npy``/``.npz``, plus the
train/val/test split lists."""

from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np
import torch


def load_cloud(path: str) -> np.ndarray:
    """Load a point-cloud array from .pkl/.pickle/.pt/.npy/.npz as float32."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pkl", ".pickle"):
        with open(path, "rb") as f:
            arr = pickle.load(f)
        return np.asarray(arr, dtype=np.float32)
    if ext == ".pt":
        t = torch.load(path, map_location="cpu", weights_only=True)
        return np.asarray(t, dtype=np.float32)
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    if ext == ".npz":
        with np.load(path) as z:
            return z[z.files[0]].astype(np.float32)
    raise ValueError(f"unsupported cloud format: {path}")


def save_cloud(path: str, arr: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    arr = np.asarray(arr, dtype=np.float32)
    if ext in (".pkl", ".pickle"):
        with open(path, "wb") as f:
            pickle.dump(arr, f)
    elif ext == ".npz":
        np.savez_compressed(path, cloud=arr)
    elif ext == ".npy":
        np.save(path, arr)
    elif ext == ".pt":
        torch.save(torch.from_numpy(arr), path)
    else:
        raise ValueError(f"unsupported cloud format: {path}")


def read_split_list(path: str) -> List[str]:
    """A train/val/test file list, one filename per line
    (train_pointnet-attention.py:57-60)."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def write_split_list(path: str, names: List[str]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for n in names:
            f.write(n + "\n")
