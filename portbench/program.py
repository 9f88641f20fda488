"""What the benchmark takes from the measured program: the model built from
the harness's weights through the program's own checkpoint loader, its
parameters read back in the published layout, and the timing of a callable
captured in a CUDA graph. Every other file of the harness reaches the
program through its drivers."""

from __future__ import annotations

import copy
import dataclasses
import gc
import io
from typing import Callable, Dict

import torch

from portbench.reference.ampnet import is_parameter, pth_payload


def model_config(config: dict):
    """The program's ``AMPNetConfig`` for a configuration file."""
    from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig, TrainConfig

    m, t = config["model"], config.get("train", {})
    return AMPNetConfig(
        data=DataConfig(n_points=m["n_points"], max_windows=m["windows"],
                        max_clusters_test=m["max_clusters"]),
        model=ModelConfig(num_classes=m["num_classes"], global_feat=m["global_feat"],
                          local_feat=m["local_feat"], att_heads=m["att_heads"],
                          dropout=t.get("dropout", 0.3)),
        train=TrainConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in t.items() if k != "dropout"}))


def port_model(weights, config: dict, device, seed: int = 0):
    """(cfg, model) on ``device``: the harness's weights written as the
    published ``.pth`` (in memory) and read by the program's loader."""
    from ampnet_tpu_torch.core.weights import load_flax_variables, load_reference_pth
    from ampnet_tpu_torch.models.factory import build_model

    cfg = model_config(config)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=seed))
    buf = io.BytesIO()
    torch.save(pth_payload(weights, config["model"]["n_points"]), buf)
    buf.seek(0)
    variables, _ = load_reference_pth(buf)
    model = build_model(cfg, "attention")
    load_flax_variables(model, variables)
    return cfg, model.to(device)


def reference_layout(model, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` (the program's state-dict names, a subset) placed in a
    copy of ``model`` and exported through the program's ``.pth`` writer:
    {"group/key": tensor} of the published layout, parameters only."""
    from ampnet_tpu_torch.core.weights import flax_variables, save_reference_pth

    m = copy.deepcopy(model).cpu()
    sd = m.state_dict()
    with torch.no_grad():
        for k, v in tensors.items():
            sd[k].copy_(v.detach().cpu())
    buf = io.BytesIO()
    save_reference_pth(flax_variables(m), buf)
    buf.seek(0)
    payload = torch.load(buf, weights_only=True)
    return {f"{g}/{k}": v for g in ("base_pointnet", "segmen_net")
            for k, v in payload[g].items() if is_parameter(k)}


def graph_ms(fn: Callable[[], object], device, reps: int = 20) -> float:
    """Device ms of one replay of ``fn`` captured in a CUDA graph (after a
    warm-up run on a side stream), timed over ``reps`` replays with CUDA
    events."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device) -> None:
    """Frees what the program's objects left once the caller has dropped them."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
