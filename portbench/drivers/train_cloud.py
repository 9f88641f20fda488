"""Driver of the whole-cloud training cells: the ``train --arch pointnet2``
loop, ``train/epoch.py::make_epoch_fns``'s ``train_epoch`` over a device
cache in ``SingleCloudBatcher``'s layout (points [C, 1, N, F], labels
[C, 1, N], centroids [C, 1, 2]: each cloud one window), epochs back to back
until the window closes on a device sync (``portbench/train_window.py``).

Set-up draws the clouds and the weights from the seed, writes the weights
as one of the program's checkpoint directories in ``$TMPDIR`` (its own
``CheckpointManager``) and builds the model from it through
``core/checkpoint.py::load_model``, the directory removed once loaded. The
train state (Adam) then takes the first three steps through the window's
own call, which the plain reference of ``portbench/reference/pointnet2.py``
follows; ``loss_gap``, ``grad_gap`` and ``change_gap`` are taken as
``train_epoch.py`` takes them. The end-to-end metric is ``points_per_s``,
the points of the clouds trained in the window over its seconds."""

from __future__ import annotations

import shutil
import sys
import tempfile

import numpy as np
import torch

from portbench import counts_pointnet2, program, train_window
from portbench.drivers.train_epoch import BETA1, epoch_rows, leaf_gap_map, leaf_gaps
from portbench.reference import pointnet2 as ref
from portbench.reference.ampnet import Precision, sub_seed

# the program's range of each per-layer reading (models/pointnet2.py)
RANGES = {"fps": ["pointnet2.fps"], "ball_query": ["pointnet2.ball_query"],
          "group": ["pointnet2.group"], "sa_mlp": ["pointnet2.sa_mlp"],
          "three_nn": ["pointnet2.three_nn"], "fp_mlp": ["pointnet2.fp_mlp"]}
# the published module names of the reference → the program's
_MODULES = (("mlp_convs.", "mlp_"), ("mlp_bns.", "bn_"), ("conv1.", "head_1."),
            ("bn1.", "head_bn."), ("conv2.", "head_out."))
_LEAVES = (("running_mean", "mean"), ("running_var", "var"), ("weight", "scale"))


def port_name(key: str) -> str:
    """The program's state-dict name of a reference key."""
    name = key
    for a, b in _MODULES:
        name = name.replace(a, b)
    if ".bn_" in name or name.startswith("head_bn."):
        for a, b in _LEAVES:
            if name.endswith(a):
                name = name[: -len(a)] + b
    return name


def clouds(seed: int, tag: int, count: int, points: int, classes: int, device,
           features: int = 9):
    """A training set of whole clouds in ``SingleCloudBatcher``'s layout:
    xyz uniform in the unit cube (the frame ``preprocess`` writes), the other
    columns N(0, 0.5²), labels in 0..classes−1, centroids the mean x, y."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, tag))
    pts = torch.randn((count, 1, points, features), generator=gen, device=device) * 0.5
    pts[..., :3] = torch.rand((count, 1, points, 3), generator=gen, device=device)
    labels = torch.randint(0, classes, (count, 1, points), generator=gen, device=device,
                           dtype=torch.int32)
    return {"points": pts, "labels": labels, "centroids": pts[..., :2].mean(dim=2)}


def program_config(config: dict, seed: int):
    """The program's ``AMPNetConfig`` for a configuration file:
    ``train --arch pointnet2``'s, at the file's points and recipe."""
    from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig, TrainConfig

    m, t = config["model"], config["train"]
    return AMPNetConfig(
        data=DataConfig(n_points=m["n_points"], max_windows=1, num_features=m["num_features"]),
        model=ModelConfig(context="pointnet2", num_classes=m["num_classes"]),
        train=TrainConfig(batch_size=t["batch_size"], learning_rate=t["learning_rate"],
                          class_weights=tuple(t["class_weights"]), reg_weight=t["reg_weight"],
                          augmentations=tuple(t["augmentations"]), seed=seed))


def port_model(weights, config: dict, device, seed: int):
    """(cfg, model on ``device``): the weights written as a checkpoint
    directory of the program's own writer in ``$TMPDIR`` and read back by
    its loader; the directory is removed once loaded."""
    from ampnet_tpu_torch.core.checkpoint import CheckpointManager, load_model
    from ampnet_tpu_torch.models.factory import build_model
    from ampnet_tpu_torch.train.state import create_train_state

    cfg = program_config(config, seed)
    model = build_model(cfg, "pointnet2")
    model.load_state_dict({port_name(k): v.detach().cpu() for k, v in weights.items()})
    tmp = tempfile.mkdtemp(prefix="portbench_ckpt_")
    try:
        path = CheckpointManager(tmp).save("pointnet2_segmentation",
                                           create_train_state(cfg, model, device="cpu"),
                                           config_json=cfg.to_json(),
                                           number_of_points=config["model"]["n_points"])
        return load_model(path, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def reference_names(tensors) -> dict:
    """Program-named tensors → reference-named host tensors."""
    back = {port_name(k): k for k, _, _ in ref.parameter_spec()}
    return {back[k]: v.detach().cpu() for k, v in tensors.items()}


def gaps(losses, g1, d3, base_losses, base_g1, base_d3, say: bool = False) -> dict:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of (losses, first
    gradient, change after three steps) against the base, as
    ``train_epoch.py`` takes them: the change over the leaves whose base
    gradient is at least 1e-3 of the median leaf's."""
    gnorm = {k: float(v.double().norm()) for k, v in base_g1.items()}
    med = float(np.median(list(gnorm.values())))
    moved = {k for k, v in gnorm.items() if v >= 1e-3 * med}
    by_step = [abs(a - b) / abs(b) for a, b in zip(losses, base_losses)]
    grads, changes = leaf_gap_map(g1, base_g1), leaf_gap_map(d3, base_d3, moved)
    if say:
        print(f"portbench: loss gap by step {by_step}; worst gradient leaf "
              f"{max(grads, key=grads.get)}; worst change leaf "
              f"{max(changes, key=changes.get)}; median leaf's change gap "
              f"{float(np.median(list(changes.values())))}", file=sys.stderr)
    return {"loss_gap": max(by_step), "grad_gap": leaf_gaps(g1, base_g1),
            "change_gap": leaf_gaps(d3, base_d3, moved)}


def recipe(config: dict) -> dict:
    t = config["train"]
    return {"lr": t["learning_rate"], "class_weights": t["class_weights"],
            "reg_weight": t["reg_weight"]}


def first_batches(seed: int, data: dict, clouds_: int, batch: int, device) -> list:
    idxs, _ = epoch_rows(seed, 0, clouds_, batch)
    return [{k: v[torch.from_numpy(idxs[s]).to(device)] for k, v in data.items()}
            for s in range(3)]


def run(r) -> dict:
    from ampnet_tpu_torch.train.epoch import make_epoch_fns
    from ampnet_tpu_torch.train.state import create_train_state
    from ampnet_tpu_torch.train.step import make_step_fns

    w, m, dev = r.workload, r.config["model"], r.device
    batch, count = r.config["train"]["batch_size"], w["clouds"]
    weights = ref.make_weights(r.seed, dev, m["num_features"], m["num_classes"])
    train_seed = sub_seed(r.seed, 3)
    data = clouds(r.seed, 200, count, m["n_points"], m["num_classes"], dev, m["num_features"])
    cfg, model = port_model(weights, r.config, dev, train_seed)
    state = create_train_state(cfg, model, steps_per_epoch=count // batch, device=dev)
    train_step, eval_step = make_step_fns(cfg, augment=True)
    train_epoch, _ = make_epoch_fns(train_step, eval_step)
    params = dict(model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}

    # the first three steps, through the window's own call and feed
    idxs, pads = epoch_rows(r.seed, 0, count, batch)
    first = first_batches(r.seed, data, count, batch, dev)
    m1 = train_epoch(state, data, idxs[:1], pads[:1])
    moments = state.optimizer.state
    g1 = {k: moments.get(p, {}).get("exp_avg", torch.zeros_like(p)) / (1 - BETA1)
          for k, p in params.items()}  # zero where Adam holds no moment
    m23 = train_epoch(state, data, idxs[1:3], pads[1:3])
    prog_g1 = reference_names(g1)
    prog_d3 = reference_names({k: v.detach() - p0[k] for k, v in params.items()})
    losses = [float(x) for x in torch.cat([m1["loss"], m23["loss"]])]
    peak_setup = program.peak_bytes(dev)

    win = train_window.run_window(
        r, w, lambda i, p: train_epoch(state, data, i, p),
        lambda e: epoch_rows(r.seed, e, count, batch), dev)
    least = counts_pointnet2.least_time_s(counts_pointnet2.model_ops(
        m["n_points"], batch, m["num_classes"], m["num_features"]))
    points = win["steps"] * batch * m["n_points"]
    out = train_window.window_out(win, {"points_per_s": points / win["window_s"]}, peak_setup,
                                  3 * least, RANGES)

    del state, model, train_epoch, train_step, eval_step, data, params, moments, g1, p0
    program.release(dev)
    shares = []
    ref_losses, ref_g1, ref_p3 = ref.train_steps(weights, first, train_seed, 0,
                                                 recipe(r.config), shares=shares)
    print(f"portbench: real members per ball (first batch, SA1-SA3) {shares}", file=sys.stderr)
    ref_d3 = {k: (ref_p3[k] - weights[k]).cpu() for k in ref_p3}
    ref_g1 = {k: v.cpu() for k, v in ref_g1.items()}
    found = gaps(losses, prog_g1, prog_d3, ref_losses, ref_g1, ref_d3, say=True)
    out["checks"] = {k: {"value": v, "limit": w["limits"][k]} for k, v in found.items()}
    return out


def control(seed: int, files: dict, device, faults: bool = False) -> dict:
    """The readings the limits sit between, each the reference put in the
    program's place against the sound reference: TF32 products
    (``control``) and the direct-difference distance (``direct``, a
    rounding a sound program may have); with ``faults`` also SA1's radius
    at 0.09 and FP1's weights made uniform (each entry its layer's mean
    absolute value)."""
    w, m, c = files["workload"], files["config"]["model"], files["config"]
    batch = c["train"]["batch_size"]
    weights = ref.make_weights(seed, device, m["num_features"], m["num_classes"])
    data = clouds(seed, 200, w["clouds"], m["n_points"], m["num_classes"], device,
                  m["num_features"])
    batches = first_batches(seed, data, w["clouds"], batch, device)
    del data
    seed3, rec = sub_seed(seed, 3), recipe(c)

    def reading(ws, **kw):
        losses, g1, p3 = ref.train_steps(ws, batches, seed3, 0, rec, **kw)
        return losses, {k: v.cpu() for k, v in g1.items()}, \
            {k: (p3[k] - ws[k]).cpu() for k in p3}

    base = reading(weights)
    out = {"control": gaps(*reading(weights, prec=Precision("tf32")), *base),
           "direct": gaps(*reading(weights, distance="direct"), *base)}
    if faults:
        out["sa1_radius_0.09"] = gaps(*reading(weights, radii=(0.09, 0.2, 0.4)), *base)
        uniform = {k: (torch.full_like(v, float(v.abs().mean()))
                       if k.startswith("fp1.mlp_convs.") else v) for k, v in weights.items()}
        losses, g1, d3 = reading(uniform)
        out["fp1_uniform"] = gaps(losses, g1, d3, *base)
    return out
