"""Build the port's native sources at first use and load them with ctypes.

Each ``ampnet_tpu_torch/csrc/<name>.cu`` has a plain C interface and is built
on its own by ``nvcc`` for Hopper (``sm_90a``); each host ``csrc/<name>.cc``
(the balanced-assignment solver) is built by ``g++`` with the JAX package's
Makefile flags (``HOST_FLAGS``). Either becomes a shared library under
``ampnet_tpu_torch/build/`` (listed in ``.gitignore``), named by the hash of
its source and flags, so an edited source never loads a stale build; a host
build's name also hashes the target ``g++`` resolves ``-march=native`` to, so
a build directory copied to another machine is rebuilt there. The build
writes a temporary file and renames it into place, so processes that build
at the same time (``preprocess --workers``) never load half a file. It needs
only the checkout and the toolchain; nothing is downloaded.

Every library is declared and launched here. A module that owns a source
passes ``load`` its C signatures as data, ``{function: (restype,
argtypes)}``, declared once per process; ``declare`` does the same for
another build of that source (``kernel_timing.py --variants``). ``launch``
calls a kernel's C entry point under its device's guard with the current
stream appended, turns a nonzero return into an error that names the kernel,
and counts the launches on the wrapper (``ops/launch_count.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ampnet_tpu_torch.ops.launch_count import count_launch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
# ampnet_tpu/native/Makefile's flags: others may sum the costs in another
# order and break the solver's ties otherwise
HOST_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]

# {C function: (restype, argtypes)}
Signatures = Dict[str, Tuple[Optional[type], Sequence[type]]]

_lock = threading.Lock()  # guards the two maps below
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}  # built, loaded and declared


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA toolkit is "
                       "needed to build the port's kernels")


def gxx_path() -> str:
    cand = shutil.which(os.environ.get("CXX", "g++"))
    if not cand:
        raise RuntimeError("g++ not found on PATH (or $CXX): it builds the port's host "
                           "solver (csrc/balanced_assign.cc)")
    return cand


def _host_target(gxx: str) -> bytes:
    """What ``-march=native`` resolves to on this machine (the enabled
    target options), part of a host build's name."""
    proc = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True)
    return proc.stdout


def _compile(src: Path, cmd: List[str], flags: List[str], salt: bytes = b"") -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode() + salt).hexdigest()[:16]
    out = BUILD / f"lib{src.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([*cmd, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed for {src}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build(src: Path) -> Path:
    """The shared library built from the CUDA source ``src`` under ``BUILD``
    (built unless a build of the same source and flags is there)."""
    return _compile(src, [nvcc_path()], FLAGS)


def build_host(src: Path) -> Path:
    """The shared library built from the C++ source ``src`` by ``g++`` with
    ``HOST_FLAGS`` (built unless a build of the same source, flags and
    target is there)."""
    gxx = gxx_path()
    return _compile(src, [gxx], HOST_FLAGS, salt=_host_target(gxx))


def declare(lib: ctypes.CDLL, signatures: Signatures) -> ctypes.CDLL:
    """``lib`` with each C function of ``signatures`` declared."""
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def load(name: str, signatures: Signatures) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (by ``nvcc``) or
    ``csrc/<name>.cc`` (by ``g++``) with ``signatures`` declared, built and
    declared on the first call. Two sources build at the same time; one
    source builds once per process."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name not in _libs:
            host = CSRC / f"{name}.cc"
            path = build_host(host) if host.exists() else build(CSRC / f"{name}.cu")
            lib = declare(ctypes.CDLL(str(path)), signatures)
            with _lock:
                _libs[name] = lib
        return _libs[name]


def launch(wrapper, fn, device: torch.device, *args, launches: int = 1) -> None:
    """``fn(*args, stream)``, a kernel's C entry point, on ``device``'s
    current stream under its guard. A nonzero return (a CUDA error) raises
    naming the kernel; otherwise ``launches`` launches count on ``wrapper``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__}: the launch of {fn.__name__} failed: CUDA "
                           f"error {err}")
    for _ in range(launches):
        count_launch(wrapper)
