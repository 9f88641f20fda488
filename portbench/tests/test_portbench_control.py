"""The controls fail their cells' limits: the reference one precision below
the configuration's (TF32 products for float32, emulated on the CPU; 4
bits for the int8 chains), read by each cell's own comparison at a small
size. On a card the float32 controls use the card's TF32."""

import pytest
import torch

from portbench import control
from portbench.tests import small

CELLS = ["att_fp32.serve_c4", "att_fp32.train_b32", "att_int8.forward_b32",
         "att_fp32.forward_b32"]


def _fails(cell, readings) -> bool:
    limits = small.files(cell)["workload"]["limits"]
    return any(readings[k] > limits[k] for k in limits if k in readings)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_its_limit(cell):
    f = small.files(cell)
    if "traffic" in f["workload"]:
        f["workload"]["check_clouds"] = 2
    out = control.readings(cell, small.SEED, f, torch.device("cpu"))
    assert _fails(cell, out["control"]), out


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_its_limit_on_the_card(cell, card):
    f = small.files(cell)
    out = control.readings(cell, small.SEED, f, card)
    assert _fails(cell, out["control"]), out


def test_planted_training_faults_fail():
    out = control.readings("att_fp32.train_b32", small.SEED, small.files("att_fp32.train_b32"),
                           torch.device("cpu"), faults=True)
    assert _fails("att_fp32.train_b32", out["half_batch"])
    assert out["state_unchanged"]["change_gap"] == pytest.approx(1.0)
