"""The port's PointNet++ (``models/pointnet2.py``, ``ops/sampling.py``, the
train step) against the benchmark's plain reference
(``portbench/reference/pointnet2.py``, which imports nothing of the port) on
the CPU at 2 clouds × 256 points, on seeded weights written into the port's
model under its own names (``portbench/drivers/train_cloud.py::port_name``).

Tolerances. In float64 the two agree to rounding (measured: loss 1.8e-16,
worst gradient leaf 6.9e-15 of its largest entry), so they are held at
1e-12 and 1e-10. In float32 they are held at about twice the port's own
float32 rounding, read from its float64 run on the same draw: loss 8.4e-8,
worst gradient leaf 2.2e-5 of its largest entry (the reference read 9.9e-8
and 3.2e-6 against the port).
"""

import pytest
import torch

from ampnet_tpu_torch.models import pointnet2 as pm
from ampnet_tpu_torch.models.factory import build_model
from ampnet_tpu_torch.ops.sampling import batched_farthest_point_sampling
from ampnet_tpu_torch.train.state import create_train_state
from ampnet_tpu_torch.train.step import make_step_fns
from portbench.drivers import train_cloud as tc
from portbench.reference import pointnet2 as ref

SEED = 2147483711  # above 2**31, as the benchmark's seeds can be
POINTS, CLOUDS, STEP_SEED = 256, 2, 7
CONFIG = {"model": {"n_points": POINTS, "num_features": 9, "num_classes": 5},
          "train": {"batch_size": CLOUDS, "learning_rate": 1e-3,
                    "class_weights": [1.0, 2.0, 2.0, 1.0, 1.0], "reg_weight": 1e-3,
                    "augmentations": ["shuffle_windows", "rotate_z"]}}
TOL32 = {"loss": 2e-7, "grad": 5e-5}
TOL64 = {"loss": 1e-12, "grad": 1e-10}


@pytest.fixture(scope="module")
def draw():
    cpu = torch.device("cpu")
    return (ref.make_weights(SEED, cpu), tc.clouds(SEED, 200, CLOUDS, POINTS, 5, cpu),
            tc.program_config(CONFIG, STEP_SEED))


def port_model(weights, cfg, dtype=torch.float32):
    model = build_model(cfg, "pointnet2")
    model.load_state_dict({tc.port_name(k): v for k, v in weights.items()})
    return model.to(dtype)


def test_eval_logits(draw):
    weights, data, cfg = draw
    with torch.no_grad():
        got = port_model(weights, cfg).eval()(data["points"])[0]
    want = ref.eval_logits(data["points"], weights)
    assert got.shape == want.shape == (CLOUDS, 1, POINTS, 5)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("level", [0, 1, 2])
def test_sampling_and_grouping_indices(draw, level):
    """FPS, the ball query and the 3-NN of each level, on that level's
    points (the reference's centres of the levels above), equal as
    integers."""
    data = draw[1]
    pts = data["points"][:, 0, :, :3]
    for count in ref.centres(POINTS)[:level]:
        pts = ref.gather(pts, ref.farthest_points(pts, count))
    count, (_, radius, nsample, _) = ref.centres(POINTS)[level], ref.SA[level]
    picked = ref.farthest_points(pts, count)
    assert torch.equal(batched_farthest_point_sampling(pts, count), picked)
    ctr = ref.gather(pts, picked)
    members, real = ref.ball_query(ctr, pts, radius, nsample)
    assert torch.equal(pm.ball_query(ctr, pts, radius, nsample), members)
    assert bool((real >= 1).all())
    d2, idx = ref.three_nearest(pts, ctr)
    got_d2, got_idx = pm.three_nn(pm._sqdist(pts, ctr))
    assert torch.equal(got_idx, idx) and torch.equal(got_d2, d2)


def port_step(weights, data, cfg, dtype):
    model = port_model(weights, cfg, dtype)
    state = create_train_state(cfg, model, device="cpu")
    train_step, _ = make_step_fns(cfg)
    metrics = train_step(state, dict(data, points=data["points"].to(dtype)))
    grads = tc.reference_names({k: p.grad for k, p in model.named_parameters()})
    return float(metrics["loss"]), grads


def reference_step(weights, data, dtype):
    ws = {k: v.to(dtype) for k, v in weights.items()}
    losses, grads, _ = ref.train_steps(ws, [dict(data, points=data["points"].to(dtype))],
                                       STEP_SEED, 0, tc.recipe(CONFIG))
    return losses[0], grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_train_step_loss_and_every_gradient_leaf(draw, dtype):
    weights, data, cfg = draw
    tol = TOL32 if dtype == torch.float32 else TOL64
    loss, grads = port_step(weights, data, cfg, dtype)
    want_loss, want = reference_step(weights, data, dtype)
    assert abs(loss - want_loss) <= tol["loss"] * abs(want_loss)
    assert set(grads) == set(want)
    for k, g in want.items():
        gap = float((grads[k].double() - g.double()).abs().max())
        assert gap <= tol["grad"] * float(g.double().abs().max()), k


def test_direct_difference_reference_is_bounded(draw):
    """The reference with pointnet2_ops' direct-difference distance against
    its |a|² + |b|² − 2a·b one: at this size no first-level ball member
    changes, so the logits part by the distances' rounding (the 3-NN
    weights) alone."""
    weights, data, _ = draw
    pts = data["points"][:, 0, :, :3]
    ctr = ref.gather(pts, ref.farthest_points(pts, POINTS))
    assert torch.equal(ref.ball_query(ctr, pts, 0.1, 32, distance="direct")[0],
                       ref.ball_query(ctr, pts, 0.1, 32)[0])
    dot = ref.eval_logits(data["points"], weights)
    direct = ref.eval_logits(data["points"], weights, distance="direct")
    gap = float((direct - dot).abs().max()) / float(dot.abs().max())
    print(f"direct-difference reference against the dot one: {gap:.3e} of max|logit|")
    assert gap <= 1e-5
