"""Train step, backward (``train/step.py``): device ms a step of the
operations launched inside autograd's engine (``autograd::engine::
evaluate_function`` ranges on the launching thread), from a traced stretch
of the window."""


def read(layers):
    if "split" not in layers or not layers.get("trace_steps"):
        return None
    return layers["split"]["backward"] / layers["trace_steps"] * 1e3
