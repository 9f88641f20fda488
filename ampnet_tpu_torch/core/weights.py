"""Weights carried across: Flax variable trees and reference ``.pth`` files.

* ``load_flax_variables(model, variables)`` copies a Flax
  ``{"params", "batch_stats"}`` tree (nested dicts of numpy arrays) onto the
  port's modules, path for path: a Dense ``kernel [Cin, Cout]`` becomes
  ``Linear.weight [Cout, Cin]``; BN ``scale``/``bias``/``mean``/``var`` keep
  their names. ``in_proj``'s columns split q/k/v, which is the row split of
  the transposed weight that ``WindowMHA`` uses.
* ``flax_variables(model)`` is the inverse (through ``flax_leaf_map``, the
  one table of torch name ↔ Flax path).
* ``optax_adam_state`` / ``load_optax_adam_state`` carry Adam's state across:
  optax's ``ScaleByAdamState`` (count, mu, nu) as numpy trees ↔ torch Adam's
  per-parameter ``step``/``exp_avg``/``exp_avg_sq``.
* ``load_reference_pth(path)`` reads the reference checkpoint layout
  (``{'base_pointnet': sd, 'segmen_net': sd, ...}``, utils/utils.py:422-438,
  also what ``ampnet export`` writes) into the same tree; ``save_reference_pth``
  writes it. One key table serves both directions — the port's own copy of the
  mapping in ``ampnet_tpu/core/torch_import.py`` / ``torch_export.py``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from ampnet_tpu_torch.models.amp import FAMILIES_TODO
from ampnet_tpu_torch.models.layers import MaskedBatchNorm


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _get(tree: Dict, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def _target(mod: nn.Module, name: str, leaf) -> Tuple[str, np.ndarray]:
    arr = np.asarray(leaf, dtype=np.float32)
    if isinstance(mod, nn.Linear) and name in ("kernel", "bias"):
        return ("weight", arr.T) if name == "kernel" else ("bias", arr)
    if isinstance(mod, MaskedBatchNorm) and name in ("scale", "bias", "mean", "var"):
        return name, arr
    raise ValueError(f"no counterpart for Flax leaf {name!r} on {type(mod).__name__}")


def load_flax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Copy a Flax variable tree onto ``model`` in place; every parameter and
    buffer of the model must be covered, and shapes must agree."""
    covered = set()
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(coll, {})):
            *mod_path, name = path
            mod = model
            for p in mod_path:
                if not hasattr(mod, p):
                    raise ValueError(f"model has no module {'.'.join(mod_path)!r}")
                mod = getattr(mod, p)
            tname, arr = _target(mod, name, leaf)
            t = getattr(mod, tname)
            if tuple(t.shape) != arr.shape:
                raise ValueError(f"{'.'.join(path)}: shape {arr.shape} vs {tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.array(arr, copy=True)))
            covered.add(".".join(mod_path + [tname]))
    missing = sorted(set(model.state_dict()) - covered)
    if missing:
        raise ValueError(f"variables do not cover {missing}")
    return model


def flax_leaf_map(model: nn.Module) -> List[Tuple[str, str, Tuple[str, ...], bool]]:
    """Every parameter and buffer of ``model`` as (torch name, Flax collection,
    Flax path, transposed): a Dense ``kernel [Cin, Cout]`` is the transposed
    ``Linear.weight``; BatchNorm ``scale``/``bias`` are params, ``mean``/``var``
    batch_stats."""
    out = []
    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        pre = f"{name}." if name else ""
        if isinstance(mod, nn.Linear):
            out.append((pre + "weight", "params", path + ("kernel",), True))
            if mod.bias is not None:
                out.append((pre + "bias", "params", path + ("bias",), False))
        elif isinstance(mod, MaskedBatchNorm):
            out += [(pre + leaf, "params", path + (leaf,), False) for leaf in ("scale", "bias")]
            out += [(pre + leaf, "batch_stats", path + (leaf,), False) for leaf in ("mean", "var")]
    return out


def _to_numpy(t: torch.Tensor, transposed: bool) -> np.ndarray:
    a = t.detach().cpu().numpy().astype(np.float32)
    return np.ascontiguousarray(a.T) if transposed else a


def tensors_to_flax(leaf_map, tensors: Dict[str, torch.Tensor],
                    collections=("params", "batch_stats")) -> Dict:
    """Tensors keyed by torch name → a Flax-layout tree of numpy arrays."""
    out: Dict = {c: {} for c in collections}
    for tname, coll, path, transposed in leaf_map:
        if coll in out:
            _set(out[coll], path, _to_numpy(tensors[tname], transposed))
    return out


def flax_variables(model: nn.Module) -> Dict:
    """The model's weights as a Flax-layout variable tree of numpy arrays."""
    return tensors_to_flax(flax_leaf_map(model), model.state_dict())


# -- Adam state in optax's terms ----------------------------------------------
# optax ``ScaleByAdamState(count, mu, nu)``: ``count`` = updates taken (int32),
# ``mu``/``nu`` = first and second moments in the params' tree. torch's Adam
# keeps the same moments per parameter (``exp_avg``/``exp_avg_sq``, the
# kernel's transposed like the weight) and the count as each one's ``step``.


def adam_tensors(model: nn.Module, optimizer: torch.optim.Optimizer):
    """(count, {torch name: (exp_avg, exp_avg_sq)}) of ``optimizer`` over
    ``model``'s parameters, zeros before the first update."""
    count, out = 0, {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        if st:
            count = int(st["step"])
            out[name] = (st["exp_avg"], st["exp_avg_sq"])
        else:
            out[name] = (torch.zeros_like(p), torch.zeros_like(p))
    return count, out


def optax_adam_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> Dict:
    """torch Adam state → ``{"count", "mu", "nu"}`` as optax's
    ``ScaleByAdamState`` holds it, numpy arrays in the Flax params tree."""
    count, moments = adam_tensors(model, optimizer)
    params = [e for e in flax_leaf_map(model) if e[1] == "params"]
    return {
        "count": np.asarray(count, np.int32),
        "mu": tensors_to_flax(params, {k: m for k, (m, _) in moments.items()}, ("params",))["params"],
        "nu": tensors_to_flax(params, {k: v for k, (_, v) in moments.items()}, ("params",))["params"],
    }


def load_optax_adam_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                          adam: Dict) -> None:
    """Set ``optimizer``'s state from optax's ``{"count", "mu", "nu"}``
    (numpy arrays or tensors in the Flax params tree); every parameter of
    ``model`` must be covered."""
    count = int(np.asarray(adam["count"]))
    named = dict(model.named_parameters())
    for tname, coll, path, transposed in flax_leaf_map(model):
        if coll != "params":
            continue
        p = named[tname]
        moments = []
        for key in ("mu", "nu"):
            a = np.asarray(_get(adam[key], path), np.float32)
            a = np.ascontiguousarray(a.T) if transposed else a
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{key} {'.'.join(path)}: shape {a.shape} vs {tuple(p.shape)}")
            moments.append(torch.from_numpy(np.array(a, copy=True)).to(p.device))
        optimizer.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                              "exp_avg": moments[0], "exp_avg_sq": moments[1]}


# -- the reference .pth layout -------------------------------------------------
# entries: (state-dict group, reference key, Flax collection, Flax path, kind)
# kind: 'conv' = Conv1d weight [Cout, Cin, 1] ↔ kernel [Cin, Cout];
#       'linear' = Linear weight [Cout, Cin] ↔ kernel [Cin, Cout]; 'vec' = as is


def _bn(group, prefix, path):
    yield group, f"{prefix}.weight", "params", path + ("scale",), "vec"
    yield group, f"{prefix}.bias", "params", path + ("bias",), "vec"
    yield group, f"{prefix}.running_mean", "batch_stats", path + ("mean",), "vec"
    yield group, f"{prefix}.running_var", "batch_stats", path + ("var",), "vec"


def _block(group, conv, bn, path):
    """Conv1d(k=1, no bias) + BN → a PointMLP (dense + bn)."""
    yield group, f"{conv}.weight", "params", path + ("dense", "kernel"), "conv"
    yield from _bn(group, bn, path + ("bn",))


def _tnet(prefix, path):
    """Reference TransformationNet (pointnetAtt.py:7-47) ↔ TNet."""
    g = "base_pointnet"
    for i in range(3):
        yield from _block(g, f"{prefix}.conv_{i + 1}", f"{prefix}.bn_{i + 1}",
                          path + ("trunk", f"mlp_{i}"))
    for i in range(2):
        yield g, f"{prefix}.fc_{i + 1}.weight", "params", path + (f"fc_{i}", "kernel"), "linear"
        yield from _bn(g, f"{prefix}.bn_{i + 4}", path + (f"fc_bn_{i}",))
    yield g, f"{prefix}.fc_3.weight", "params", path + ("fc_out", "kernel"), "linear"
    yield g, f"{prefix}.fc_3.bias", "params", path + ("fc_out", "bias"), "vec"


def _reference_layout():
    """BasePointNet + SegmentationWithAttention (pointnetAtt.py:50-209)."""
    enc = ("encoder",)
    yield from _tnet("input_transform", enc + ("input_tnet",))
    yield from _tnet("feature_transform", enc + ("feature_tnet",))
    for i, c in enumerate((1, 2)):
        yield from _block("base_pointnet", f"conv_{c}", f"bn_{c}", enc + ("mlp_a", f"mlp_{i}"))
    for i, c in enumerate((3, 4, 5, 6)):
        yield from _block("base_pointnet", f"conv_{c}", f"bn_{c}", enc + ("mlp_b", f"mlp_{i}"))
    h = "segmen_net"
    for fc in ("fc1", "fc2"):
        yield h, f"{fc}.weight", "params", ("context", "pos_enc", fc, "kernel"), "linear"
        yield h, f"{fc}.bias", "params", ("context", "pos_enc", fc, "bias"), "vec"
    mha = ("context", "mha")
    yield h, "attention.in_proj_weight", "params", mha + ("in_proj", "kernel"), "linear"
    yield h, "attention.in_proj_bias", "params", mha + ("in_proj", "bias"), "vec"
    yield h, "attention.out_proj.weight", "params", mha + ("out_proj", "kernel"), "linear"
    yield h, "attention.out_proj.bias", "params", mha + ("out_proj", "bias"), "vec"
    for ours, conv, bn, tag in (("dense_1", "conv_2", "bn_2", "bn_1"),
                                ("dense_2", "conv_3", "bn_3", "bn_2")):
        yield h, f"{conv}.weight", "params", ("head", ours, "kernel"), "conv"
        yield h, f"{conv}.bias", "params", ("head", ours, "bias"), "vec"
        yield from _bn(h, bn, ("head", tag))
    yield h, "conv_4.weight", "params", ("head", "dense_out", "kernel"), "conv"
    yield h, "conv_4.bias", "params", ("head", "dense_out", "bias"), "vec"


def load_reference_pth(path: str) -> Tuple[Dict, Dict]:
    """Reference ``model_*.pth`` → (Flax-layout variables, meta).

    ``meta`` carries the payload's plain fields (number_of_points, epoch, …)
    plus ``arch``, ``point_dim`` and ``global_feat`` read from the weights.
    GRU checkpoints (``gru_global`` keys) are refused until that family is
    ported."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sds = {g: {k: v.detach().cpu().numpy() for k, v in ckpt[g].items()}
           for g in ("base_pointnet", "segmen_net")}
    if "gru_global.weight_ih_l0" in sds["segmen_net"]:
        raise NotImplementedError(f"GRU checkpoints are not ported yet: {FAMILIES_TODO}")
    variables: Dict = {"params": {}, "batch_stats": {}}
    for group, key, coll, fpath, kind in _reference_layout():
        a = np.asarray(sds[group][key], np.float32)
        if kind == "conv":
            a = a[:, :, 0]
        if kind != "vec":
            a = np.ascontiguousarray(a.T)
        _set(variables[coll], fpath, a)
    meta = {k: v for k, v in ckpt.items()
            if not k.endswith(("pointnet", "net")) and not isinstance(v, dict)}
    meta["arch"] = "attention"
    d2 = sds["base_pointnet"]["input_transform.fc_3.bias"].shape[0]
    meta["point_dim"] = int(round(d2 ** 0.5))
    meta["global_feat"] = int(sds["base_pointnet"]["conv_6.weight"].shape[0])
    return variables, meta


def save_reference_pth(variables: Dict, path: str, meta: Dict = None) -> None:
    """Write Flax-layout ``variables`` (e.g. ``flax_variables(model)``) as a
    reference ``model_*.pth`` (attention segmenter)."""
    sds: Dict = {"base_pointnet": {}, "segmen_net": {}}
    for group, key, coll, fpath, kind in _reference_layout():
        a = np.asarray(_get(variables[coll], fpath), np.float32)
        if kind != "vec":
            a = a.T
        if kind == "conv":
            a = a[:, :, None]
        sds[group][key] = torch.from_numpy(np.ascontiguousarray(a))
        if key.endswith(".running_var"):
            sds[group][key.replace("running_var", "num_batches_tracked")] = torch.zeros(
                (), dtype=torch.long)
    payload = {
        "task": "segmentation", "batch_size": 32, "lr": 1e-3,
        "number_of_points": 2048, "epoch": 0, "epochs_since_improvement": 0,
        "accuracy": float("nan"),
        **(meta or {}),
        **sds,
    }
    torch.save(payload, path)
