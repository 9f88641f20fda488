"""PointNet++ train step (``train/step.py``, ``models/pointnet2.py``), the
forward pass and the loss: device ms a step of the operations launched
outside autograd's backward and outside ``Optimizer.step`` (the batch
gather and augmentation included), from a traced stretch of the window:
``train.forward_ms`` for the whole-cloud cell, which reports
``points_per_s``."""


def read(layers):
    if "split" not in layers or not layers.get("trace_steps"):
        return None
    return layers["split"]["forward"] / layers["trace_steps"] * 1e3
