"""The port stands alone and runs on the card unless told otherwise: it
imports with JAX blocked, no file of it imports JAX or the JAX package, its
entry points raise without a GPU instead of running on the CPU, and the
``serve`` command line builds a working server from a reference ``.pth``."""

import json
import pathlib
import re
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import ampnet_tpu_torch
from ampnet_tpu_torch.cli.main import build_parser, make_server
from ampnet_tpu_torch.core.config import AMPNetConfig, ModelConfig
from ampnet_tpu_torch.core.device import resolve_device
from ampnet_tpu_torch.core.weights import flax_variables, save_reference_pth
from ampnet_tpu_torch.infer.tiled import TiledInferencer
from ampnet_tpu_torch.models.amp import AMPNetSegmenter
from ampnet_tpu_torch.models.backends import make_forward

PKG = pathlib.Path(ampnet_tpu_torch.__file__).parent
REPO = PKG.parent


def test_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ampnet_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import ampnet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(ampnet_tpu_torch.__path__, 'ampnet_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


IMPORT_RE = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax|ampnet_tpu)(\.|\s|$)",
                       re.MULTILINE)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not IMPORT_RE.findall((REPO / path).read_text()), path


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a GPU, an entry point called without ``device`` raises; it
    does not quietly run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = AMPNetConfig()
    model = AMPNetSegmenter(cfg.model)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        make_forward(model, cfg, "fused")
    with pytest.raises(RuntimeError, match="cuda"):
        TiledInferencer(model, cfg)
    ckpt = tmp_path / "m.pth"
    save_reference_pth(flax_variables(model), str(ckpt))
    with pytest.raises(RuntimeError, match="cuda"):
        make_server(build_parser().parse_args(["serve", "--model_checkpoint", str(ckpt)]))
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")


def test_serve_command_line_on_cpu(tmp_path):
    """``serve --device cpu`` restores a reference .pth (n_points from its
    meta) and answers over HTTP."""
    model = AMPNetSegmenter(ModelConfig(), generator=torch.Generator().manual_seed(4))
    ckpt = tmp_path / "model_attention.pth"
    save_reference_pth(flax_variables(model), str(ckpt), meta={"number_of_points": 64})
    args = build_parser().parse_args([
        "serve", "--model_checkpoint", str(ckpt), "--device", "cpu", "--port", "0",
        "--backend", "fused", "--max_clusters", "3",
    ])
    server = make_server(args)
    t = threading.Thread(target=server.httpd.serve_forever, daemon=True)
    t.start()
    try:
        host, port = server.address
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["model"] == "model_attention.pth" and health["n_points"] == 64
        assert health["backend"] == "fused" and health["max_clusters"] == 3
        pts = np.random.default_rng(0).normal(size=(150, 9)).astype(np.float32)
        req = urllib.request.Request(f"http://{host}:{port}/v1/predict", data=pts.tobytes(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            labels = np.frombuffer(r.read(), np.int8)
        np.testing.assert_array_equal(
            labels, server.service.inferencer.predict_many([pts], seeds=[0])[0])
    finally:
        server.close()
        t.join(timeout=30)
    assert not t.is_alive()
    with pytest.raises(ValueError, match="orbax"):
        make_server(build_parser().parse_args(
            ["serve", "--model_checkpoint", str(tmp_path), "--device", "cpu"]))
