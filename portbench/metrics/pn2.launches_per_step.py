"""PointNet++ step: device operations (kernels, copies and sets) a traced
step, from torch.profiler's device trace: what a captured step or a
sampling kernel would cut (the eager FPS loop launches ~10 a sample)."""


def read(layers):
    trace, steps = layers.get("trace"), layers.get("trace_steps")
    if trace is None or not steps or not trace.device:
        return None
    return len(trace.device) / steps
