"""Plain PyTorch reference of PointNet++ semantic segmentation (single-scale
grouping): the weights, the eval forward, the training forward with its
augmentation and dropout, the loss and Adam (Qi, Yi, Su, Guibas,
*PointNet++*, NeurIPS 2017, arXiv:1706.02413; github.com/charlesq34/pointnet2).

It imports nothing of the measured package. The widths are those of the
baseline AMP-Net compares itself against
(github.com/marionacaros/3D-semantic-segmentation-AMP-Net
``pointNet/model/pointnetAtt.py:282-322``):

* SA1: 1,024 centres, radius 0.1, 32 samples, MLP 12→32→32→64;
* SA2: 256 centres, radius 0.2, 32 samples, MLP 67→64→64→128;
* SA3: 64 centres, radius 0.4, 32 samples, MLP 131→128→128→256;
* FP3 384→256→256, FP2 320→256→128, FP1 128→128→128→128;
* head: 128, BatchNorm, ReLU, dropout 0.5, then the classes.

A cloud of n points takes min(1024, n), min(256, n // 2) and min(64, n // 4)
centres. A set abstraction groups, for each centre, [member xyz − centre ‖
member features] (the level's whole input features, xyz included at the
first level) and max-pools its MLP over the group; a feature propagation
interpolates the coarse level's features at the fine points and runs its MLP
on [fine features ‖ interpolated]. Every convolution is bias-free and
followed by a BatchNorm (a bias before a training BatchNorm cancels); the
last layer has a bias. Weights are kept as ``[Cout, Cin]`` matrices under
the published module names (``sa1.mlp_convs.0.weight``,
``sa1.mlp_bns.0.running_mean``, ``conv1``, ``bn1``, ``conv2``).

The sampling and grouping operations, as pointnet2_ops computes them:

* farthest point sampling starts at index 0 and takes, at each step, the
  point farthest from those taken (ties to the lowest index), the squared
  distance summed as ``(dx² + dy²) + dz²`` in float32;
* the ball query takes each centre's lowest-index points within the radius,
  the first ``nsample`` of them by a running count, and pads the rest with
  the first member (a centre is one of the points, so one always exists);
* the three nearest neighbours are taken in ascending distance, ties to the
  lower index, weighted by 1 / max(d², 1e-8) and normalised.

**Departure.** The ball query and the three nearest neighbours take the
squared distance as |a|² + |b|² − 2 a·b (one matrix product per block of
centres), as the measured program documents it, where pointnet2_ops takes
the direct difference. The two round apart, and a point that lies at a ball's
radius to within that rounding can change balls: matching the program's
rounding keeps the sound runs' readings at their rounding floor, and
``distance="direct"`` gives the other rounding, a reading the limits must
pass (a later kernel may round either way).

BatchNorm in eval uses the running statistics; in training the batch's, over
every axis but the channel, with the biased variance. Training draws the
augmentation (the window permutation, of one whole-cloud window, then one
angle about z) and the head's dropout mask from one generator seeded from
(seed, step). The regulariser of the loss reads 64×64 identity transforms
(PointNet++ has no T-Net), so it is a constant. Every product runs under
``Precision``: float32 with TF32 off on the card, or the TF32 control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from portbench.reference.ampnet import (
    FP32,
    Adam,
    Precision,
    _Layers,
    is_parameter,
    loss_fn,
    step_generator,
    sub_seed,
)

NUM_FEATURES = 9
# (centres at most, radius, samples, MLP widths)
SA = ((1024, 0.1, 32, (32, 32, 64)), (256, 0.2, 32, (64, 64, 128)),
      (64, 0.4, 32, (128, 128, 256)))
FP = (("fp3", (256, 256)), ("fp2", (256, 128)), ("fp1", (128, 128, 128)))
HEAD = 128
DROPOUT = 0.5
DISTANCES = ("dot", "direct")


def centres(n: int) -> Tuple[int, int, int]:
    """The centres each set abstraction takes from a cloud of ``n`` points."""
    return min(SA[0][0], n), min(SA[1][0], n // 2), min(SA[2][0], n // 4)


# -- the parameters ---------------------------------------------------------------


def _bn(prefix: str, c: int):
    return [(f"{prefix}.weight", (c,), "bn_scale"), (f"{prefix}.bias", (c,), "bn_bias"),
            (f"{prefix}.running_mean", (c,), "bn_mean"),
            (f"{prefix}.running_var", (c,), "bn_var")]


def _mlp(prefix: str, cin: int, widths):
    out = []
    for i, c in enumerate(widths):
        out.append((f"{prefix}.mlp_convs.{i}.weight", (c, cin), "weight"))
        out += _bn(f"{prefix}.mlp_bns.{i}", c)
        cin = c
    return out


def parameter_spec(num_features: int = NUM_FEATURES, num_classes: int = 5) -> list:
    """[(key, shape, kind), ...] in the published module names."""
    spec, cin = [], num_features
    for level, (_, _, _, widths) in enumerate(SA):
        spec += _mlp(f"sa{level + 1}", cin + 3, widths)
        cin = widths[-1]
    skips = [SA[1][3][-1], SA[0][3][-1], 0]  # fine features beside FP3, FP2, FP1's input
    coarse = SA[2][3][-1]
    for (name, widths), skip in zip(FP, skips):
        spec += _mlp(name, skip + coarse, widths)
        coarse = widths[-1]
    spec += [("conv1.weight", (HEAD, coarse), "weight")] + _bn("bn1", HEAD)
    spec += [("conv2.weight", (num_classes, HEAD), "weight"),
             ("conv2.bias", (num_classes,), "bias")]
    return spec


# kind → (draw, a, b): normal with mean a and std b (std None: 1/sqrt(fan in)),
# or uniform on [a, b)
_DRAWS = {
    "weight": ("normal", 0.0, None),
    "bias": ("normal", 0.0, 0.05),
    "bn_scale": ("uniform", 0.8, 1.2),
    "bn_bias": ("normal", 0.0, 0.1),
    "bn_mean": ("normal", 0.0, 0.1),
    "bn_var": ("uniform", 0.5, 1.5),
}


def make_weights(seed: int, device, num_features: int = NUM_FEATURES,
                 num_classes: int = 5) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights on ``device``: one normal and one uniform draw
    from a generator on the device, cut into the parameters."""
    spec = parameter_spec(num_features, num_classes)
    sizes = {d: sum(math.prod(s) for _, s, kind in spec if _DRAWS[kind][0] == d)
             for d in ("normal", "uniform")}
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    pools = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen, device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for key, shape, kind in spec:
        draw, a, b = _DRAWS[kind]
        n = math.prod(shape)
        x = pools[draw][at[draw]: at[draw] + n].reshape(shape)
        at[draw] += n
        if draw == "normal":
            std = b if b is not None else 1.0 / math.sqrt(shape[1])
            out[key] = x * std + a
        else:
            out[key] = a + (b - a) * x
    return out


# -- sampling and grouping --------------------------------------------------------


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] int64 → [B, ..., C]."""
    rows = torch.arange(points.shape[0], device=points.device)
    return points[rows.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def farthest_points(xyz: torch.Tensor, count: int) -> torch.Tensor:
    """[B, N, 3] → [B, count] int64 indices, in float32 whatever ``xyz``'s
    dtype (pointnet2_ops samples in float32)."""
    xyz = xyz.float()
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    chosen = torch.zeros((b, count), dtype=torch.int64, device=xyz.device)
    nearest = torch.full((b, n), float("inf"), device=xyz.device)
    last = chosen[:, 0]
    for i in range(1, count):
        d = xyz - xyz[rows, last][:, None, :]
        dist = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        nearest = torch.minimum(nearest, dist)
        last = nearest.argmax(dim=1)
        chosen[:, i] = last
    return chosen


def square_distances(a: torch.Tensor, b: torch.Tensor, prec: Precision,
                     distance: str = "dot") -> torch.Tensor:
    """a [B, n, 3], b [B, m, 3] → [B, n, m] squared distances: |a|² + |b|² −
    2 a·b ('dot', the departure above) or (dx² + dy²) + dz² ('direct')."""
    if distance == "dot":
        a2 = (a * a).sum(-1, keepdim=True)
        b2 = (b * b).sum(-1)
        return a2 + b2[..., None, :] - 2 * prec.mm(a, b.transpose(-1, -2))
    if distance == "direct":
        d = a[:, :, None, :] - b[:, None, :, :]
        return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    raise ValueError(f"unknown distance {distance!r}; expected one of {DISTANCES}")


def ball_query(centre_xyz: torch.Tensor, xyz: torch.Tensor, radius: float, nsample: int,
               prec: Precision = FP32, distance: str = "dot",
               block: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """(members [B, S, nsample] int64, real [B, S] int64): each centre's
    lowest-index points within ``radius``, the first ``nsample`` by a
    running count of the points inside, padded with the first member; and
    how many of them are real. ``block`` centres at a time."""
    b, s, _ = centre_xyz.shape
    n = xyz.shape[1]
    point = torch.arange(n, device=xyz.device)
    members, real = [], []
    with torch.no_grad():
        for s0 in range(0, s, block):
            inside = square_distances(centre_xyz[:, s0:s0 + block], xyz, prec,
                                      distance) <= radius * radius
            rank = inside.cumsum(dim=-1)  # the 1-based place of each point inside
            slot = torch.where(inside & (rank <= nsample), rank - 1, nsample)
            got = torch.full((*slot.shape[:2], nsample + 1), -1, dtype=torch.int64,
                             device=xyz.device)
            got.scatter_(2, slot, point.expand_as(slot))  # slot nsample takes the rest
            got = got[..., :nsample]
            members.append(torch.where(got < 0, got[..., :1], got))
            real.append(rank[..., -1].clamp_max(nsample))
    return torch.cat(members, 1), torch.cat(real, 1)


def three_nearest(fine: torch.Tensor, coarse: torch.Tensor, prec: Precision = FP32,
                  distance: str = "dot", block: int = 2048):
    """(d² [B, N, 3], idx [B, N, 3]): each fine point's three nearest coarse
    points in ascending distance, ties to the lower index (a stable sort),
    ``block`` fine points at a time."""
    ds, idxs = [], []
    with torch.no_grad():
        for n0 in range(0, fine.shape[1], block):
            d2 = square_distances(fine[:, n0:n0 + block], coarse, prec, distance)
            d2, order = torch.sort(d2, dim=-1, stable=True)
            ds.append(d2[..., :3])
            idxs.append(order[..., :3])
    return torch.cat(ds, 1), torch.cat(idxs, 1)


# -- the network ------------------------------------------------------------------


def _mlp_run(h, sd, prefix: str, depth: int, L: _Layers):
    for i in range(depth):
        h = L.block(h, sd, f"{prefix}.mlp_convs.{i}.weight", f"{prefix}.mlp_bns.{i}")
    return h


def segment(points: torch.Tensor, weights: Dict[str, torch.Tensor], L: _Layers,
            distance: str = "dot", radii: Optional[Tuple[float, ...]] = None,
            shares: Optional[list] = None):
    """(logits [..., N, C], 64×64 identity transforms [..., 64, 64]) of
    ``points`` [..., N, F] (leading axes fold into the batch). ``radii``
    replaces the set abstractions' radii (a planted fault); ``shares``, when
    given, receives each level's mean share of real members per ball."""
    shape = points.shape
    x = points.reshape(-1, *shape[-2:])
    xyz = x[..., :3]
    level_xyz, level_feats = [xyz], [x]
    for level, (count, (_, radius, nsample, widths)) in enumerate(zip(centres(x.shape[1]), SA)):
        radius = radii[level] if radii is not None else radius
        pts, feats = level_xyz[-1], level_feats[-1]
        ctr = gather(pts, farthest_points(pts, count))
        members, real = ball_query(ctr, pts, radius, nsample, L.prec, distance)
        if shares is not None:
            shares.append(float(real.double().mean()) / nsample)
        grouped = torch.cat([gather(pts, members) - ctr[:, :, None], gather(feats, members)], -1)
        level_xyz.append(ctr)
        level_feats.append(_mlp_run(grouped, weights, f"sa{level + 1}", len(widths), L).amax(2))
    h = level_feats[3]
    for (name, widths), fine in zip(FP, (2, 1, 0)):
        d2, idx = three_nearest(level_xyz[fine], level_xyz[fine + 1], L.prec, distance)
        w = 1.0 / d2.clamp_min(1e-8)
        w = w / w.sum(dim=-1, keepdim=True)
        interp = (w[..., None] * gather(h, idx)).sum(dim=-2)
        h = interp if fine == 0 else torch.cat([level_feats[fine], interp], -1)
        h = _mlp_run(h, weights, name, len(widths), L)
    h = L.dropout(L.block(h, weights, "conv1.weight", "bn1"))
    logits = L.dense(h, weights, "conv2.weight", "conv2.bias")
    eye = torch.eye(64, dtype=logits.dtype, device=logits.device)
    return logits.reshape(*shape[:-1], -1), eye.expand(*shape[:-2], 64, 64)


def eval_logits(points: torch.Tensor, weights, prec: Precision = FP32,
                distance: str = "dot") -> torch.Tensor:
    """Eval-mode logits [..., N, C] of ``points`` [..., N, F]."""
    with prec, torch.no_grad():
        return segment(points, weights, _Layers(prec, train=False), distance)[0]


# -- training ---------------------------------------------------------------------


def augment(points: torch.Tensor, labels: torch.Tensor, gen: torch.Generator):
    """shuffle_windows (one permutation of the window axis: of one window,
    it still draws), then rotate_z (one angle in [0, 2π) about z, the
    rotation taken in the points' dtype)."""
    perm = torch.randperm(points.shape[1], generator=gen, device=points.device)
    points, labels = points[:, perm], labels[:, perm]
    angle = torch.rand((), generator=gen, device=points.device) * (2 * math.pi)
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, s, zero]), torch.stack([-s, c, zero]),
                       torch.stack([zero, zero, one])]).to(points.dtype)
    return torch.cat([points[..., :3] @ rot, points[..., 3:]], dim=-1), labels


def train_steps(weights, batches: List[dict], seed: int, first_step: int, recipe: dict,
                prec: Precision = FP32, distance: str = "dot",
                radii: Optional[Tuple[float, ...]] = None, shares: Optional[list] = None):
    """Runs ``len(batches)`` training steps (batches of whole clouds:
    points [B, 1, N, F], labels [B, 1, N]) from
    ``weights``; returns (losses, first step's gradients {key: tensor},
    parameters after the last step {key: tensor}). ``recipe``: lr,
    class_weights, reg_weight. ``shares`` receives the first step's shares
    of real ball members."""
    params = {k: v.detach().clone().requires_grad_(is_parameter(k)) for k, v in weights.items()}
    trained = {k: p for k, p in params.items() if p.requires_grad}
    opt = Adam(trained, recipe["lr"])
    device = next(iter(params.values())).device
    cw = torch.tensor(recipe["class_weights"], dtype=torch.float32, device=device)
    losses, first_grads = [], None
    with prec:
        for i, batch in enumerate(batches):
            gen = step_generator(seed, first_step + i, device)
            pts, lbl = augment(batch["points"], batch["labels"], gen)
            L = _Layers(prec, train=True, gen=gen, drop=DROPOUT)
            logits, t_feat = segment(pts, params, L, distance, radii,
                                     shares if i == 0 else None)
            loss = loss_fn(logits, t_feat, lbl, cw, recipe["reg_weight"])
            grads = dict(zip(trained, torch.autograd.grad(loss, list(trained.values()))))
            if first_grads is None:
                first_grads = {k: g.detach().clone() for k, g in grads.items()}
            with torch.no_grad():
                opt.update(trained, grads)
            losses.append(float(loss.detach()))
    return losses, first_grads, {k: p.detach() for k, p in trained.items()}
