"""The benchmark's files: every cell's files found by name, the names and
units of BENCHMARK.json within their characters, and the check for JAX
modules by whole top-level names."""

import os
import re
import sys

import pytest

from portbench import run as R
from portbench.tests import small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = small.bench()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    f = R.cell_files(cell, BENCH)
    assert os.path.exists(f["driver"])
    assert all(os.path.exists(p) for p in f["readers"].values())
    assert f["entry"]["chips"] == 1
    assert "setup_s" in {m["name"] for m in f["e2e"]} and len(f["e2e"]) >= 2
    assert f["per_layer"]
    cfg = next(c for c in BENCH["configs"] if c["name"] == f["entry"]["config"])
    assert os.path.join(R.ROOT, cfg["file"]).endswith(f"{cfg['name']}.json")
    assert f["config"]["name"] == cfg["name"]


def test_names_and_units():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for key in ("end_to_end", "per_layer"):
        assert len({m["name"] for m in BENCH[key]}) == len(BENCH[key])
        for m in BENCH[key]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("roofline"):
            assert m["unit"] == "%"


def test_foreign_modules_by_whole_top_level_name(monkeypatch):
    for name in ("ampnet_tpu_torch", "ampnet_tpu_torch.models", "jaxy", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys.modules[__name__])
    clean = R.foreign_modules()
    assert "ampnet_tpu" not in clean and "jax" not in clean
    for name in ("ampnet_tpu.core", "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, sys.modules[__name__])
    assert {"ampnet_tpu", "jaxlib", "flax"} <= set(R.foreign_modules())


def test_harness_sources_import_neither_jax_nor_the_jax_package():
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|orbax|ampnet_tpu)\b(?!_)",
                     re.M)
    for dirpath, _, names in os.walk(os.path.join(R.ROOT, "portbench")):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(dirpath, n)) as f:
                    assert not bad.search(f.read()), os.path.join(dirpath, n)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(R.ROOT, "portbench", "reference")
    for n in os.listdir(ref):
        if n.endswith(".py"):
            with open(os.path.join(ref, n)) as f:
                assert "ampnet_tpu" not in f.read(), n


def test_exits_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = R.main(["--workload", "att_fp32.forward_b32", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_plain_forward_leaves_out_every_kernel_reader_found_by_file():
    from portbench.metrics import _kernels

    kernels = [m["name"] for m in BENCH["per_layer"] if m["name"].endswith("_roofline")]
    assert sorted(_kernels.all_patterns()) == sorted(_kernels.pattern(n) for n in kernels)
