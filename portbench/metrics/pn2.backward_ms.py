"""PointNet++ train step (``train/step.py``, ``models/pointnet2.py``), the
backward pass: device ms a step of the operations launched inside
autograd's engine (``autograd::engine::evaluate_function`` ranges on the
launching thread), from a traced stretch of the window:
``train.backward_ms`` for the whole-cloud cell, which reports
``points_per_s``."""


def read(layers):
    if "split" not in layers or not layers.get("trace_steps"):
        return None
    return layers["split"]["backward"] / layers["trace_steps"] * 1e3
