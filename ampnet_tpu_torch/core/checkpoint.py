"""Schema-versioned checkpoints, counterpart of ``ampnet_tpu/core/checkpoint.py``
(one schema carrying every logical field of the reference's two,
``utils/utils.py:422-456``), with ``torch.save`` in place of orbax.

Layout on disk::

    <dir>/<name>/state.pt    params, batch_stats, opt_state, step, epoch, lr_scale
    <dir>/<name>/meta.json   the JAX CheckpointManager's meta: schema_version 1,
                             hyperparameters, the full AMPNetConfig

``state.pt`` holds tensors only (``torch.load(weights_only=True)`` reads it):
``params`` and ``batch_stats`` keyed by their Flax paths
(``core/weights.py::flax_leaf_map``), ``opt_state`` as optax's Adam state
(``count`` int32, ``mu``, ``nu`` in the params' tree), then ``step``, ``epoch``
(int32) and ``lr_scale`` (float32). A JAX orbax directory (``state/``) is
refused: the port cannot read orbax.

``save`` is synchronous. ``save_async`` queues a state snapshot
(``TrainState.snapshot()``: device copies, so later in-place steps cannot
change it) on one writer thread, which fetches it to the host and writes it;
pending writes coalesce per name, a write's error is raised by ``wait`` and by
the next save, and every read path waits for the queue first.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from ampnet_tpu_torch.core.config import AMPNetConfig
from ampnet_tpu_torch.core.device import resolve_device
from ampnet_tpu_torch.core.weights import (
    load_flax_variables,
    load_optax_adam_state,
    tensors_to_flax,
)
from ampnet_tpu_torch.models.factory import build_model

SCHEMA_VERSION = 1
STATE_FILE = "state.pt"


def _tensor_tree(tree):
    return {k: _tensor_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def payload(snap) -> Dict[str, Any]:
    """A ``StateSnapshot`` → the ``state.pt`` contents (host tensors)."""
    variables = tensors_to_flax(snap.leaf_map, snap.tensors)
    params = [e for e in snap.leaf_map if e[1] == "params"]
    mu = tensors_to_flax(params, {k: m for k, (m, _) in snap.adam.items()}, ("params",))
    nu = tensors_to_flax(params, {k: v for k, (_, v) in snap.adam.items()}, ("params",))
    return {
        "params": _tensor_tree(variables["params"]),
        "batch_stats": _tensor_tree(variables["batch_stats"]),
        "opt_state": {"count": torch.tensor(snap.count, dtype=torch.int32),
                      "mu": _tensor_tree(mu["params"]), "nu": _tensor_tree(nu["params"])},
        "step": torch.tensor(snap.step, dtype=torch.int32),
        "epoch": torch.tensor(snap.epoch, dtype=torch.int32),
        "lr_scale": torch.tensor(snap.lr_scale, dtype=torch.float32),
    }


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Dict[str, Tuple[Any, Dict[str, Any]]] = {}
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, state, **meta) -> str:
        """Write ``state`` (a ``TrainState``) now; returns the directory."""
        self.wait()
        return self._write(name, payload(state.snapshot(copy=False)), **meta)

    def save_async(self, name: str, snap, **meta) -> None:
        """Queue a write of ``snap`` (a ``StateSnapshot`` whose tensors no
        later step touches); returns at once."""
        with self._lock:
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError("previous async checkpoint write failed") from err
            self._pending[name] = (snap, meta)
            if self._writer is None:
                self._writer = threading.Thread(target=self._drain, name="ckpt-writer",
                                                daemon=True)
                self._writer.start()

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._writer = None
                    return
                name, (snap, meta) = next(iter(self._pending.items()))
                del self._pending[name]
            try:
                self._write(name, payload(snap), **meta)
            except BaseException as e:  # raised again by wait() / the next save_async
                with self._lock:
                    self._error = e
                    self._pending.clear()
                    self._writer = None
                return

    def wait(self) -> None:
        """Block until every queued write has landed; raise a failed one's error."""
        while True:
            with self._lock:
                writer = self._writer
                err, self._error = self._error, None
            if err is not None:
                raise RuntimeError("async checkpoint write failed") from err
            if writer is None:
                return
            writer.join()

    def _write(self, name: str, state_payload: Dict[str, Any], *,
               task: str = "segmentation", accuracy: float = 0.0,
               epochs_since_improvement: int = 0, config_json: Optional[str] = None,
               weighing_method: Optional[str] = None, batch_size: Optional[int] = None,
               learning_rate: Optional[float] = None, number_of_points: Optional[int] = None,
               extra_meta: Optional[Dict[str, Any]] = None) -> str:
        target = self.path(name)
        os.makedirs(target, exist_ok=True)
        tmp = os.path.join(target, STATE_FILE + ".tmp")
        torch.save(state_payload, tmp)
        os.replace(tmp, os.path.join(target, STATE_FILE))
        meta = {
            "schema_version": SCHEMA_VERSION,
            "task": task,
            "accuracy": float(accuracy),
            "epochs_since_improvement": int(epochs_since_improvement),
            "batch_size": batch_size,
            "lr": learning_rate,
            "number_of_points": number_of_points,
            "weighing_method": weighing_method,
            "config": json.loads(config_json) if config_json else None,
        }
        if extra_meta:
            meta.update(extra_meta)
        with open(os.path.join(target, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        return target

    def load_meta(self, name: str) -> Dict[str, Any]:
        self.wait()
        return read_meta(self.path(name))

    def load_payload(self, name: str) -> Dict[str, Any]:
        """``state.pt`` of checkpoint ``name`` (host tensors)."""
        self.wait()
        return read_payload(self.path(name))

    def restore(self, name: str, state) -> Tuple[Any, Dict[str, Any]]:
        """Restore params, BatchNorm statistics, Adam state and counters into
        ``state`` (a ``TrainState``) in place, as the reference resume path
        does (train_pointnet-attention.py:151-162); returns (state, meta)."""
        meta = self.load_meta(name)
        p = self.load_payload(name)
        load_flax_variables(state.model, {"params": _numpy_tree(p["params"]),
                                          "batch_stats": _numpy_tree(p["batch_stats"])})
        opt = p["opt_state"]
        load_optax_adam_state(state.model, state.optimizer,
                              {"count": opt["count"].numpy(), "mu": _numpy_tree(opt["mu"]),
                               "nu": _numpy_tree(opt["nu"])})
        state.step = int(p["step"])
        state.epoch = int(p["epoch"])
        state.lr_scale = float(p["lr_scale"])
        return state, meta

    def exists(self, name: str) -> bool:
        self.wait()
        return os.path.exists(os.path.join(self.path(name), "meta.json"))


def _refuse_orbax(path: str) -> None:
    if os.path.isdir(os.path.join(path, "state")) and not os.path.exists(
            os.path.join(path, STATE_FILE)):
        raise ValueError(f"{path} is a JAX orbax checkpoint directory (state/); the port "
                         f"reads its own checkpoints (meta.json + {STATE_FILE}), not orbax")


def read_meta(path: str) -> Dict[str, Any]:
    """``meta.json`` of the checkpoint directory ``path``, schema checked."""
    _refuse_orbax(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(f"checkpoint schema {meta.get('schema_version')} != "
                         f"supported {SCHEMA_VERSION}")
    return meta


def read_payload(path: str) -> Dict[str, Any]:
    _refuse_orbax(path)
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def is_checkpoint_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "meta.json")) and os.path.isfile(
        os.path.join(path, STATE_FILE))


def load_model(path: str, device="cuda"):
    """(cfg, model in eval mode on ``device``) from a checkpoint directory
    ``<dir>/<name>``: the config from ``meta.json`` (its ``model.context`` is
    the arch, as the JAX command records it, and its ``extra_features``,
    ``geom_k``, ``geom_radius_norm``, ``local_agg`` and ``att_geom_tokens``
    the geometry), the model from the factory for that arch and the meta's
    task at ``num_features + extra_features`` input columns, the weights and BatchNorm statistics from
    ``state.pt``. On the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    meta = read_meta(path)
    if not meta.get("config"):
        raise ValueError(f"{path}: meta.json records no config, so the model cannot be built")
    cfg = AMPNetConfig.from_json(json.dumps(meta["config"]))
    p = read_payload(path)
    model = build_model(cfg, cfg.model.context, meta.get("task", "segmentation"))
    load_flax_variables(model, {"params": _numpy_tree(p["params"]),
                                "batch_stats": _numpy_tree(p["batch_stats"])})
    return cfg, model.to(dev).eval()
