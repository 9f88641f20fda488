"""Train step, forward and loss (``train/step.py``): device ms a step of
the operations launched outside autograd's backward and outside
``Optimizer.step`` (the batch gather and augmentation included), from a
traced stretch of the window."""


def read(layers):
    if "split" not in layers or not layers.get("trace_steps"):
        return None
    return layers["split"]["forward"] / layers["trace_steps"] * 1e3
