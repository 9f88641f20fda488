"""A whole run of each small cell on the CPU, past the harness's look for a
card: sound, ``correct`` is true; with the timed path broken underneath,
once for each fault the cell can have, ``correct`` is false. (One card a
cell, so no exchange between chips exists to leave out.)"""

import numpy as np
import pytest
import torch

from portbench.tests import small


def test_sound_runs_are_correct(capsys):
    for cell in ("att_fp32.forward_b32", "att_int8.forward_b32", "att_fp32.train_b32",
                 "att_fp32.serve_c4"):
        line = small.run(cell, capsys)
        assert line["correct"], (cell, line["checks"])
        assert list(line)[-1] == "checks" and line["attempted"] > 0


def test_traced_run_carries_the_layer_metrics(capsys):
    line = small.run("att_int8.forward_b32", capsys, trace=1)
    assert line["correct"] and "forward.mfu" in line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0


def _break_forward(monkeypatch, how):
    import ampnet_tpu_torch.models.backends as backends

    make = backends.make_forward

    def broken(*a, **k):
        fwd = make(*a, **k)

        def forward(points, centroids, pad):
            if how == "half":  # the second half of the batch left out
                h = points.shape[0] // 2
                out = fwd(points[:h], centroids[:h], pad[:h])
                return torch.cat([out, out[: points.shape[0] - h]])
            out = fwd(points, centroids, pad).clone()
            out[0, 0] += 1.0  # one window's logits altered where produced
            return out

        return forward

    monkeypatch.setattr(backends, "make_forward", broken)


@pytest.mark.parametrize("cell", ["att_fp32.forward_b32", "att_int8.forward_b32"])
@pytest.mark.parametrize("how", ["half", "altered"])
def test_forward_faults(cell, how, monkeypatch, capsys):
    _break_forward(monkeypatch, how)
    assert not small.run(cell, capsys)["correct"]


def test_train_step_leaving_the_state_unchanged(monkeypatch, capsys):
    from ampnet_tpu_torch.train.state import TrainState

    def no_update(self):
        self.step += 1

    monkeypatch.setattr(TrainState, "apply_gradients", no_update)
    line = small.run("att_fp32.train_b32", capsys)
    assert not line["correct"] and line["checks"]["change_gap"]["value"] > 0.5


def test_train_step_on_half_its_batch(monkeypatch, capsys):
    import ampnet_tpu_torch.train.step as step

    make = step.make_step_fns

    def broken(*a, **k):
        train_step, eval_step = make(*a, **k)

        def half(state, batch):
            h = batch["points"].shape[0] // 2
            return train_step(state, {key: v[:h] for key, v in batch.items()})

        return half, eval_step

    monkeypatch.setattr(step, "make_step_fns", broken)
    assert not small.run("att_fp32.train_b32", capsys)["correct"]


@pytest.mark.parametrize("how", ["half", "altered"])
def test_serve_faults(how, monkeypatch, capsys):
    from ampnet_tpu_torch.infer.tiled import TiledInferencer

    fetch = TiledInferencer.fetch_many

    def broken(self, handle):
        out = [np.array(x, copy=True) for x in fetch(self, handle)]
        for x in out:
            h = len(x) // 2
            if how == "half":  # a cloud's second half of points answered with its first's
                x[h: 2 * h] = x[:h]
            else:  # a tenth of the labels altered where produced
                x[: len(x) // 10] = (x[: len(x) // 10] + 1) % 5
        return out

    monkeypatch.setattr(TiledInferencer, "fetch_many", broken)
    assert not small.run("att_fp32.serve_c4", capsys)["correct"]
