"""Pre-tiled windows drawn from a run's seed on the device, in a few large
calls: points [C, W, N, 9] with x, y uniform in [−1, 1] and the other seven
columns N(0, 0.5²) (as the serving clients draw clouds), window centroids
(the mean x, y of each window) and labels in 0..C−1 for training."""

from __future__ import annotations

import torch

from portbench.reference.ampnet import sub_seed


def windows(seed: int, tag: int, clouds: int, windows: int, points: int, device,
            features: int = 9):
    """(points [clouds, windows, points, features], centroids [clouds, windows, 2])."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, tag))
    pts = torch.randn((clouds, windows, points, features), generator=gen, device=device) * 0.5
    pts[..., :2] = torch.rand((clouds, windows, points, 2), generator=gen, device=device) * 2 - 1
    return pts, pts[..., :2].mean(dim=2)


def labelled(seed: int, tag: int, clouds: int, windows_: int, points: int, classes: int,
             device, pad_every: int = 4):
    """A training set: ``windows`` plus labels [clouds, W, N] int32 in
    0..classes−1. Every ``pad_every``-th cloud (in an order drawn from the
    seed) holds fewer real windows (W − 1 … W − 4 in turn); its last windows
    repeat its real ones, labelled −1, as the batcher pads a cloud."""
    pts, cent = windows(seed, tag, clouds, windows_, points, device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, tag, 1))
    labels = torch.randint(0, classes, (clouds, windows_, points), generator=gen, device=device,
                           dtype=torch.int32)
    order = torch.randperm(clouds, generator=gen, device=device)
    real = torch.full((clouds,), windows_, dtype=torch.long, device=device)
    short = torch.arange(clouds, device=device) % pad_every == 0
    cut = 1 + (torch.arange(clouds, device=device) // pad_every) % min(4, windows_ - 1)
    real[order] = torch.where(short, windows_ - cut, real)
    w = torch.arange(windows_, device=device)
    src = w[None, :] % real[:, None]  # [clouds, W]
    idx = torch.arange(clouds, device=device)[:, None]
    pts, cent, labels = pts[idx, src], cent[idx, src], labels[idx, src]
    labels = torch.where((w[None, :] < real[:, None])[..., None], labels,
                         torch.full((), -1, dtype=torch.int32, device=device))
    return pts.contiguous(), cent.contiguous(), labels.contiguous()
