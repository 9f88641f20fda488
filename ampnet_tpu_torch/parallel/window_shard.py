"""The window-axis forward for giant clouds, counterpart of
``ampnet_tpu/parallel/window_shard.py`` (a sequence-parallel analog).

A cloud is ≤W windows whose only interaction is the context over W tokens of
``global_feat`` floats. So the window axis shards: over an
``n_data × n_window`` grid of devices, device (i, j) takes data row i's
clouds and window block j, encodes them on its own (the encoder is
per-window), receives every block's tokens, centroids and pad mask of its
data row (the JAX all-gather over the ``window`` axis), runs the context over
all of them, keeps its own windows' rows and runs the per-point head. One
process drives the grid (the JAX ``shard_map`` is one program as well); a
grid may name one device several times.

Inference only, with the modules in eval mode and plain torch (``xla``):
neither kernel runs here, as the JAX forward runs the Flax modules.
"""

from __future__ import annotations

import copy
from typing import List, Sequence

import torch

from ampnet_tpu_torch.core.device import resolve_device
from ampnet_tpu_torch.models.amp import _run_context


def make_grid(n_data: int, n_window: int, devices: Sequence) -> List[List[torch.device]]:
    """The first ``n_data · n_window`` of ``devices`` as rows of ``n_window``
    (JAX ``make_2d_mesh``)."""
    if len(devices) < n_data * n_window:
        raise ValueError(f"a {n_data} x {n_window} grid needs {n_data * n_window} devices, "
                         f"got {len(devices)}")
    devs = [resolve_device(d) for d in devices[: n_data * n_window]]
    return [devs[i * n_window:(i + 1) * n_window] for i in range(n_data)]


def make_window_sharded_forward(model, grid: List[List[torch.device]]):
    """``forward(points [B, W, N, F], centroids [B, W, 2], pad [B, W]) →
    logits [B, W, N, C]`` with B split over the grid's rows and W over its
    columns (contiguous blocks; each must divide evenly). The model is put
    in eval mode and copied once onto each distinct device of the grid; the
    logits come back on the first device."""
    if getattr(model, "geom_tokens", False):
        raise ValueError("the window-axis forward does not run the geometry tokens "
                         "(as in the JAX package)")
    model.eval()
    replicas = {}
    for dev in dict.fromkeys(d for row in grid for d in row):
        replicas[dev] = model.to(dev) if not replicas else copy.deepcopy(model).to(dev)
    n_data, n_window = len(grid), len(grid[0])

    def forward(points: torch.Tensor, centroids: torch.Tensor, pad: torch.Tensor):
        b, w = points.shape[:2]
        if b % n_data or w % n_window:
            raise ValueError(f"[{b}, {w}] clouds x windows do not split over a "
                             f"{n_data} x {n_window} grid")
        bl, wl = b // n_data, w // n_window
        out_rows = []
        with torch.inference_mode():
            for i, row in enumerate(grid):
                rows = slice(i * bl, (i + 1) * bl)
                blocks = [slice(j * wl, (j + 1) * wl) for j in range(n_window)]
                # each device encodes its own block of windows
                encoded = [replicas[dev].encoder(points[rows, blk].to(dev))[:2]
                           for dev, blk in zip(row, blocks)]
                outs = []
                for j, dev in enumerate(row):
                    m = replicas[dev]
                    # every block's tokens, centroids and pad mask of this data row
                    tokens = torch.cat([g.to(dev) for _, g in encoded], dim=1)
                    ctx, _ = _run_context(m.context, tokens, centroids[rows].to(dev),
                                          pad[rows].to(dev), None)
                    local = encoded[j][0]
                    outs.append(m.head(local, ctx[:, blocks[j]]).to(grid[0][0]))
                out_rows.append(torch.cat(outs, dim=1))
        return torch.cat(out_rows, dim=0)

    return forward
