"""Driver of the training cells: the ``train`` subcommand's loop, the
epoch function of ``train/epoch.py::make_epoch_fns`` over a device cache in
``data/device_cache.py``'s layout (every sample padded and resident on the
card, each step gathering its batch from a row of the epoch's index
matrix), epochs back to back until the window closes on a device sync.

Set-up draws the training set and the weights from the seed, builds the
train state (model and Adam) and drives it through the window's own call
for its first three steps, which the reference then follows: each step's
loss, the first gradient as Adam holds it (its first moment over 1 − β1)
and the parameters' change after three steps, by the worst leaf."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import counts, inputs, program
from portbench.reference import ampnet as ref
from portbench.trace import Profiler

BETA1 = 0.9


def epoch_rows(seed: int, epoch: int, clouds: int, batch: int):
    """(idxs [S, B], pads [S, B]) of one epoch: a permutation of the set
    drawn from (seed, epoch), cut into full batches."""
    order = np.random.default_rng((seed, 5, epoch)).permutation(clouds)
    steps = clouds // batch
    idxs = order[: steps * batch].reshape(steps, batch).astype(np.int64)
    return idxs, np.zeros_like(idxs, dtype=bool)


def leaf_gap_map(prog, want, keep=None) -> dict:
    """Per leaf, |‖prog‖ − ‖want‖| over the larger of ‖want‖ and the median
    leaf's ‖want‖ (over the leaves in ``keep``)."""
    keys = [k for k in want if keep is None or k in keep]
    norms = {k: float(want[k].double().norm()) for k in keys}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
            for k in keys}


def leaf_gaps(prog, want, keep=None) -> float:
    """The worst leaf's gap (``leaf_gap_map``)."""
    return max(leaf_gap_map(prog, want, keep).values())


def run(r) -> dict:
    from ampnet_tpu_torch.train.epoch import make_epoch_fns
    from ampnet_tpu_torch.train.state import create_train_state
    from ampnet_tpu_torch.train.step import make_step_fns

    w, m, t, dev = r.workload, r.config["model"], r.config["train"], r.device
    batch, clouds, nw, npts = t["batch_size"], w["clouds"], m["windows"], m["n_points"]
    weights = ref.make_weights(r.seed, dev, m["global_feat"], m["num_classes"])
    train_seed = ref.sub_seed(r.seed, 3)
    pts, cent, labels = inputs.labelled(r.seed, 200, clouds, nw, npts, m["num_classes"], dev)
    data = {"points": pts, "labels": labels, "centroids": cent}
    cfg, model = program.port_model(weights, r.config, dev, seed=train_seed)
    steps_per_epoch = clouds // batch
    state = create_train_state(cfg, model, steps_per_epoch=steps_per_epoch, device=dev)
    train_step, eval_step = make_step_fns(cfg, augment=True)
    train_epoch, _ = make_epoch_fns(train_step, eval_step)
    params = dict(model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}

    # the first three steps, through the window's own call and feed
    idxs, pads = epoch_rows(r.seed, 0, clouds, batch)
    first = [{k: v[torch.from_numpy(idxs[s]).to(dev)] for k, v in data.items()}
             for s in range(3)]
    m1 = train_epoch(state, data, idxs[:1], pads[:1])
    moments = state.optimizer.state
    g1 = {k: moments.get(p, {}).get("exp_avg", torch.zeros_like(p)) / (1 - BETA1)
          for k, p in params.items()}  # zero where Adam holds no moment
    m23 = train_epoch(state, data, idxs[1:3], pads[1:3])
    p3 = {k: v.detach().clone() for k, v in params.items()}
    losses = [float(x) for x in torch.cat([m1["loss"], m23["loss"]])]
    peak_setup = program.peak_bytes(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    chunk, row, epoch, steps = w["steps_per_call"], 3, 0, 0
    prof, traced = None, None
    r.window_opens()
    t0 = time.perf_counter()
    while True:
        if row >= len(idxs):
            epoch += 1
            idxs, pads = epoch_rows(r.seed, epoch, clouds, batch)
            row = 0
        n = min(chunk, len(idxs) - row)
        if r.trace and prof is None and steps >= w["trace_at_step"]:
            prof = Profiler()
            prof.start()
            warm_until = steps + n
        train_epoch(state, data, idxs[row:row + n], pads[row:row + n])
        row, steps = row + n, steps + n
        if prof is not None and traced is None:
            if steps == warm_until:
                prof.step()
                traced_from = steps
            elif steps >= traced_from + w["trace_steps"]:
                prof.stop()
                traced = steps - traced_from
        if time.perf_counter() - t0 >= r.seconds and (not r.trace or traced):
            break
    program.sync(dev)
    elapsed = time.perf_counter() - t0
    window_peak = program.peak_bytes(dev)
    peak = max(peak_setup, window_peak)

    least = counts.least_time_s(counts.model_ops(nw, npts, m["num_classes"], m["global_feat"],
                                                 m["att_heads"], clouds=batch))
    layers = {"steps": steps, "window_s": elapsed, "peak_bytes": window_peak}
    out = {"e2e": {"windows_per_s": steps * batch * nw / elapsed}, "attempted": steps,
           "failed": 0, "memory_peak_bytes": peak, "layers": layers}
    if prof is not None:
        split = prof.trace.split_by_host_range(
            {"backward": ["autograd::engine::evaluate_function"],
             "optimizer": ["Optimizer.step"]}, default="forward")
        layers.update(trace=prof.trace, trace_window_s=prof.window_s, trace_steps=traced,
                      split=split, trace_model_least_s=3 * least * traced)
        phases = [[f"phase:{k}", v] for k, v in split.items()]
        out.update(busy_s=prof.trace.busy_s(), window_s=prof.window_s,
                   breakdown={"device_ops": phases + prof.trace.top_ops(10 - len(phases)),
                              "idle_gaps": prof.trace.idle_gaps(10)})

    prog_g1 = program.reference_layout(model, g1)
    prog_d3 = program.reference_layout(model, {k: p3[k] - p0[k] for k in p3})
    del state, model, train_epoch, train_step, eval_step, data, params, moments, g1, p3, p0
    program.release(dev)

    recipe = {"dropout": t["dropout"], "lr": t["learning_rate"],
              "class_weights": t["class_weights"], "reg_weight": t["reg_weight"]}
    ref_losses, ref_g1, ref_p3 = ref.train_steps(weights, first, train_seed, 0, recipe)
    w0 = {f"{g}/{k}": v for g, sd in weights.items() for k, v in sd.items()}
    ref_d3 = {k: (ref_p3[k] - w0[k]).cpu() for k in ref_p3}
    ref_g1 = {k: v.cpu() for k, v in ref_g1.items()}
    gnorm = {k: float(v.double().norm()) for k, v in ref_g1.items()}
    med = float(np.median(list(gnorm.values())))
    moved = {k for k, v in gnorm.items() if v >= 1e-3 * med}
    by_step = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    grads, changes = leaf_gap_map(prog_g1, ref_g1), leaf_gap_map(prog_d3, ref_d3, moved)
    print(f"portbench: loss gap by step {by_step}; worst gradient leaf "
          f"{max(grads, key=grads.get)}; worst change leaf {max(changes, key=changes.get)}; "
          f"median leaf's change gap {float(np.median(list(changes.values())))}", file=sys.stderr)
    lim = w["limits"]
    out["checks"] = {
        "loss_gap": {"value": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
                     "limit": lim["loss_gap"]},
        "grad_gap": {"value": leaf_gaps(prog_g1, ref_g1), "limit": lim["grad_gap"]},
        "change_gap": {"value": leaf_gaps(prog_d3, ref_d3, moved), "limit": lim["change_gap"]},
    }
    return out


def control(seed: int, files: dict, device, faults: bool = False) -> dict:
    """The control of the three numbers: the reference's first three steps
    with TF32 products against them in float32; with ``faults``, also each
    step on half its batch (the mean over the rest) and a state left
    unchanged, planted in the reference put in the program's place."""
    w, m, t = files["workload"], files["config"]["model"], files["config"]["train"]
    weights = ref.make_weights(seed, device, m["global_feat"], m["num_classes"])
    pts, cent, labels = inputs.labelled(seed, 200, w["clouds"], m["windows"], m["n_points"],
                                        m["num_classes"], device)
    data = {"points": pts, "labels": labels, "centroids": cent}
    idxs, _ = epoch_rows(seed, 0, w["clouds"], t["batch_size"])
    batches = [{k: v[torch.from_numpy(idxs[s]).to(device)] for k, v in data.items()}
               for s in range(3)]
    del data, pts, cent, labels
    recipe = {"dropout": t["dropout"], "lr": t["learning_rate"],
              "class_weights": t["class_weights"], "reg_weight": t["reg_weight"]}
    seed3 = ref.sub_seed(seed, 3)
    w0 = {f"{g}/{k}": v for g, sd in weights.items() for k, v in sd.items()}

    def numbers(losses, g1, p3, base):
        b_losses, b_g1, b_p3 = base
        d3 = {k: p3[k] - w0[k] for k in p3}
        b_d3 = {k: b_p3[k] - w0[k] for k in b_p3}
        gn = {k: float(v.double().norm()) for k, v in b_g1.items()}
        med = float(np.median(list(gn.values())))
        moved = {k for k, v in gn.items() if v >= 1e-3 * med}
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, b_losses)),
                "grad_gap": leaf_gaps(g1, b_g1), "change_gap": leaf_gaps(d3, b_d3, moved)}

    base = ref.train_steps(weights, batches, seed3, 0, recipe)
    out = {"control": numbers(*ref.train_steps(weights, batches, seed3, 0, recipe,
                                               ref.Precision("tf32")), base)}
    if faults:
        half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
        out["half_batch"] = numbers(*ref.train_steps(weights, half, seed3, 0, recipe), base)
        out["state_unchanged"] = numbers(base[0], base[1], {k: w0[k] for k in base[2]}, base)
    return out
