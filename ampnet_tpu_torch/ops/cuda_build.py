"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``ampnet_tpu_torch/csrc/<name>.cu`` has a plain C interface and is built
on its own by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``ampnet_tpu_torch/build/`` (listed in ``.gitignore``), named by the hash of
its source and flags, so an edited source never loads a stale build. The
build needs only the checkout and the CUDA toolkit; nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()  # guards the two maps below
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA toolkit is "
                       "needed to build the port's kernels")


def build(src: Path) -> Path:
    """The shared library built from the CUDA source ``src`` under ``BUILD``
    (built unless a build of the same source and flags is there)."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD / f"lib{src.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([nvcc_path(), *FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first call). Two
    sources build at the same time; one source builds once."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(CSRC / f"{name}.cu")))
            with _lock:
                _libs[name] = lib
        return _libs[name]

