"""Plain PyTorch reference of AMP-Net segmentation: the weights, the eval
forward (float32, or int8 / int4 for the quantized chains), the training
forward with its augmentation and dropout, the loss and Adam.

It imports nothing of the measured package. The parameters are keyed as the
published AMP-Net code keys its two state dicts (``base_pointnet`` and
``segmen_net``, ``pointnetAtt.py:7-209`` of
github.com/marionacaros/3D-semantic-segmentation-AMP-Net), which is also the
``.pth`` layout the measured server loads.

The architecture, written out from the paper's code:

* input T-Net on xyz: 1x1 convs 3→64→128→256 with BatchNorm and ReLU, a max
  over the points, FC 256→256→128 with BatchNorm and ReLU, FC 128→9 with a
  bias, plus the identity;
* [xyz · T_in ‖ all 9 features] (12 channels) → 64 → 64 (mlp_a);
* feature T-Net on those 64 channels (FC out 4096), local = h · T_feat;
* local → 64 → 128 → 128 → 256 and a max over the points (mlp_b): the window
  token;
* tokens + pos-enc of the window centroids (2→16, leaky ReLU 0.01, →256),
  8-head self-attention over the windows of a cloud (padded windows masked
  with the float32 minimum);
* per point [local ‖ attended token] (320) → 128 → 64 with BatchNorm and
  ReLU → 5 logits.

BatchNorm in eval uses the running statistics; in training the batch's, over
every axis but the channel (T-Net FC layers: over the windows), with the
biased variance. Training dropout (rate 0.3) acts on the attention weights
and after both head ReLUs, with masks ``rand < 0.7`` from one generator,
drawn in that order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

EPS = 1e-5
NUM_FEATURES = 9
POINT_DIM = 3
TNET_CONV = (64, 128, 256)
TNET_FC = (256, 128)
MLP_A = (64, 64)
MLP_B = (64, 128, 128, 256)
HEAD = (128, 64)
POS_HIDDEN = 16


# -- the parameters ---------------------------------------------------------------


def _bn(prefix: str, c: int):
    return [(f"{prefix}.weight", (c,), "bn_scale"), (f"{prefix}.bias", (c,), "bn_bias"),
            (f"{prefix}.running_mean", (c,), "bn_mean"),
            (f"{prefix}.running_var", (c,), "bn_var")]


def _tnet(prefix: str, d: int):
    out, cin = [], d
    for i, c in enumerate(TNET_CONV):
        out.append((f"{prefix}.conv_{i + 1}.weight", (c, cin, 1), "weight"))
        out += _bn(f"{prefix}.bn_{i + 1}", c)
        cin = c
    for i, c in enumerate(TNET_FC):
        out.append((f"{prefix}.fc_{i + 1}.weight", (c, cin), "weight"))
        out += _bn(f"{prefix}.bn_{i + 4}", c)
        cin = c
    out.append((f"{prefix}.fc_3.weight", (d * d, cin), "tnet_out"))
    out.append((f"{prefix}.fc_3.bias", (d * d,), "tnet_out"))
    return out


def parameter_spec(global_feat: int = 256, num_classes: int = 5) -> Dict[str, list]:
    """{group: [(key, shape, kind), ...]} in the published layout."""
    base = _tnet("input_transform", POINT_DIM) + _tnet("feature_transform", MLP_A[-1])
    cin = NUM_FEATURES + POINT_DIM
    for i, c in enumerate(MLP_A + MLP_B[:-1] + (global_feat,)):
        base.append((f"conv_{i + 1}.weight", (c, cin, 1), "weight"))
        base += _bn(f"bn_{i + 1}", c)
        cin = c
    seg = [("fc1.weight", (POS_HIDDEN, 2), "weight"), ("fc1.bias", (POS_HIDDEN,), "bias"),
           ("fc2.weight", (global_feat, POS_HIDDEN), "weight"),
           ("fc2.bias", (global_feat,), "bias"),
           ("attention.in_proj_weight", (3 * global_feat, global_feat), "weight"),
           ("attention.in_proj_bias", (3 * global_feat,), "bias"),
           ("attention.out_proj.weight", (global_feat, global_feat), "weight"),
           ("attention.out_proj.bias", (global_feat,), "bias")]
    cin = MLP_A[-1] + global_feat
    for i, c in enumerate(HEAD):
        seg.append((f"conv_{i + 2}.weight", (c, cin, 1), "weight"))
        seg.append((f"conv_{i + 2}.bias", (c,), "bias"))
        seg += _bn(f"bn_{i + 2}", c)
        cin = c
    seg.append(("conv_4.weight", (num_classes, cin, 1), "weight"))
    seg.append(("conv_4.bias", (num_classes,), "bias"))
    return {"base_pointnet": base, "segmen_net": seg}


# kind → (draw, a, b): normal with mean a and std b (std None: 1/sqrt(fan in)),
# or uniform on [a, b)
_DRAWS = {
    "weight": ("normal", 0.0, None),
    "bias": ("normal", 0.0, 0.05),
    "tnet_out": ("normal", 0.0, 0.01),
    "bn_scale": ("uniform", 0.8, 1.2),
    "bn_bias": ("normal", 0.0, 0.1),
    "bn_mean": ("normal", 0.0, 0.1),
    "bn_var": ("uniform", 0.5, 1.5),
}


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of a run's ``--seed`` (any whole number)."""
    return int(np.random.SeedSequence((int(seed), *tags)).generate_state(1, np.uint64)[0] >> 1)


def make_weights(seed: int, device, global_feat: int = 256,
                 num_classes: int = 5) -> Dict[str, Dict[str, torch.Tensor]]:
    """Seeded float32 weights on ``device``: one normal and one uniform draw
    from a generator on the device, cut into the parameters."""
    spec = parameter_spec(global_feat, num_classes)
    entries = [(g, k, s, kind) for g, items in spec.items() for k, s, kind in items]
    sizes = {d: sum(math.prod(s) for _, _, s, kind in entries if _DRAWS[kind][0] == d)
             for d in ("normal", "uniform")}
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    pools = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen, device=device)}
    at = {"normal": 0, "uniform": 0}
    out: Dict[str, Dict[str, torch.Tensor]] = {g: {} for g in spec}
    for g, k, shape, kind in entries:
        draw, a, b = _DRAWS[kind]
        n = math.prod(shape)
        x = pools[draw][at[draw]: at[draw] + n].reshape(shape)
        at[draw] += n
        if draw == "normal":
            std = b if b is not None else 1.0 / math.sqrt(math.prod(shape[1:]))
            x = x * std + a
        else:
            x = a + (b - a) * x
        out[g][k] = x
    return out


def is_parameter(key: str) -> bool:
    """Trained tensors; BatchNorm running statistics are not."""
    return not key.endswith(("running_mean", "running_var", "num_batches_tracked"))


def pth_payload(weights, number_of_points: int = 2048) -> dict:
    """The published checkpoint's dict: both state dicts on the host, with
    BatchNorm's ``num_batches_tracked``, and the trainer's plain fields."""
    sds = {}
    for g, sd in weights.items():
        sds[g] = {}
        for k, v in sd.items():
            sds[g][k] = v.detach().cpu().contiguous()
            if k.endswith("running_var"):
                sds[g][k.replace("running_var", "num_batches_tracked")] = torch.zeros(
                    (), dtype=torch.long)
    return {"task": "segmentation", "number_of_points": number_of_points, "epoch": 0, **sds}


# -- precision --------------------------------------------------------------------


class Precision:
    """How the reference multiplies: 'fp32' (TF32 off) or 'tf32' (the
    control of a float32 configuration: on the card cuBLAS's TF32, on the CPU
    the operands rounded to TF32's 10-bit mantissa). As a context it sets
    the card's TF32 switches and restores them after."""

    def __init__(self, matmul: str = "fp32"):
        if matmul not in ("fp32", "tf32"):
            raise ValueError(f"unknown matmul precision {matmul!r}")
        self.matmul = matmul
        self._saved = []

    def __enter__(self):
        self._saved.append((torch.backends.cuda.matmul.allow_tf32,
                            torch.backends.cudnn.allow_tf32))
        on = self.matmul == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved.pop()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.matmul == "tf32" and not a.is_cuda:  # rounded operands, gradients through
            a = a + (round_tf32(a) - a).detach()
            b = b + (round_tf32(b) - b).detach()
        return a @ b


FP32 = Precision()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, to nearest, ties away from zero."""
    bits = x.detach().float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


# -- layers -----------------------------------------------------------------------


def _conv_w(sd, key) -> torch.Tensor:
    """A 1x1 conv or linear weight as a [Cin, Cout] matrix."""
    w = sd[key]
    return (w[:, :, 0] if w.dim() == 3 else w).t()


def _bn_eval(h, sd, prefix):
    scale = sd[f"{prefix}.weight"] / torch.sqrt(sd[f"{prefix}.running_var"] + EPS)
    return (h - sd[f"{prefix}.running_mean"]) * scale + sd[f"{prefix}.bias"]


def _bn_train(h, sd, prefix):
    dims = tuple(range(h.dim() - 1))
    rows = float(h.numel() // h.shape[-1])
    mean = h.sum(dim=dims) / rows
    var = (h * h).sum(dim=dims) / rows - mean * mean
    return (h - mean) * torch.rsqrt(var + EPS) * sd[f"{prefix}.weight"] + sd[f"{prefix}.bias"]


class _Layers:
    """Dense, BatchNorm and dropout for one mode (eval or training)."""

    def __init__(self, prec: Precision, train: bool, gen: Optional[torch.Generator] = None,
                 drop: float = 0.0):
        self.prec, self.train, self.gen, self.drop = prec, train, gen, drop

    def dense(self, h, sd, key, bias_key=None):
        out = self.prec.mm(h, _conv_w(sd, key))
        return out + sd[bias_key] if bias_key else out

    def bn(self, h, sd, prefix):
        return _bn_train(h, sd, prefix) if self.train else _bn_eval(h, sd, prefix)

    def block(self, h, sd, conv, bn, bias_key=None):
        return torch.relu(self.bn(self.dense(h, sd, conv, bias_key), sd, bn))

    def dropout(self, h):
        if not self.train or self.drop <= 0:
            return h
        keep = 1.0 - self.drop
        mask = torch.rand(h.shape, generator=self.gen, device=h.device) < keep
        return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


def tnet(h, sd, prefix, d, L: _Layers):
    """[M, N, d] → [M, d, d]."""
    for i in range(3):
        h = L.block(h, sd, f"{prefix}.conv_{i + 1}.weight", f"{prefix}.bn_{i + 1}")
    g = h.amax(dim=1)
    for i in range(2):
        g = L.block(g, sd, f"{prefix}.fc_{i + 1}.weight", f"{prefix}.bn_{i + 4}")
    m = L.dense(g, sd, f"{prefix}.fc_3.weight", f"{prefix}.fc_3.bias")
    return m.reshape(-1, d, d) + torch.eye(d, device=m.device)


def fold(sd, conv, bn, bias_key=None):
    """(W' [Cin, Cout], b') of a conv followed by an eval BatchNorm."""
    s = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + EPS)
    w = _conv_w(sd, conv) * s[None, :]
    b = sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * s
    if bias_key:
        b = b + sd[bias_key] * s
    return w, b


def quant_block_windows(m: int, n: int, cmax: int) -> int:
    """Windows that share one activation scale in the int8 scheme: an 8 MiB
    budget of ``n`` rows of ``max(cmax, 128)`` float32 lanes twice, capped at
    8 and at ``m``, then halved (the scheme's own rule; 2 for mlp_a and 1 for
    mlp_b at 2,048 points)."""
    per_window = n * max(cmax, 128) * 4 * 2
    return max(1, min(8, m, max(1, (8 << 20) // per_window)) // 2)


def quantized_chain(x, layers, bits: int, pool: bool):
    """The int8 chain scheme at ``bits``: per output channel symmetric weight
    scales (absmax / qmax), one activation scale per block of windows and per
    layer (absmax / qmax, the block's zero-padding windows included),
    ``clip(round(h / s), ±qmax)`` with ties to even, an exact integer dot,
    ``acc · (s_x · s_w) + b`` and ReLU. ``layers``: [(W' [Cin, Cout], b')]."""
    qmax = float(2 ** (bits - 1) - 1)
    q_of = lambda t: t / torch.full_like(t, qmax)  # a true division, as the scheme
    m, n, cin = x.shape
    g = quant_block_windows(m, n, max(w.shape[1] for w, _ in layers))
    pad = -m % g
    if pad:
        x = torch.cat([x, x.new_zeros((pad, n, cin))], dim=0)
    h = x.reshape((m + pad) // g, g * n, cin)
    for w, b in layers:
        s_w = q_of(torch.clamp(w.abs().amax(dim=0), min=1e-12))
        wq = torch.clamp(torch.round(w / s_w[None, :]), -qmax, qmax)
        s_x = q_of(torch.clamp(h.abs().amax(dim=(1, 2), keepdim=True), min=1e-12))
        hq = torch.clamp(torch.round(h / s_x), -qmax, qmax)
        acc = (hq.double() @ wq.double()).float()  # exact: integer-valued operands
        h = torch.relu(acc * (s_x * s_w) + b)
    h = h.reshape(m + pad, n, -1)[:m]
    return h.amax(dim=1) if pool else h


def encoder(x, sd, L: _Layers, quant_bits: int = 0):
    """[M, N, 9] → (local [M, N, 64], global [M, G], T_feat [M, 64, 64]).
    ``quant_bits`` > 0 runs mlp_a and mlp_b as the int8 scheme (eval only)."""
    coords = x[..., :POINT_DIM]
    t_in = tnet(coords, sd, "input_transform", POINT_DIM, L)
    h = torch.cat([L.prec.mm(coords, t_in), x], dim=-1)
    n_b = len(MLP_B)
    if quant_bits:
        h = quantized_chain(h, [fold(sd, f"conv_{i + 1}.weight", f"bn_{i + 1}")
                                for i in range(len(MLP_A))], quant_bits, pool=False)
    else:
        for i in range(len(MLP_A)):
            h = L.block(h, sd, f"conv_{i + 1}.weight", f"bn_{i + 1}")
    t_feat = tnet(h, sd, "feature_transform", MLP_A[-1], L)
    local = L.prec.mm(h, t_feat)
    first = len(MLP_A) + 1
    if quant_bits:
        glob = quantized_chain(local, [fold(sd, f"conv_{i}.weight", f"bn_{i}")
                                       for i in range(first, first + n_b)], quant_bits, pool=True)
    else:
        h = local
        for i in range(first, first + n_b):
            h = L.block(h, sd, f"conv_{i}.weight", f"bn_{i}")
        glob = h.amax(dim=1)
    return local, glob, t_feat


def attention(tokens, sd, pad_mask, heads: int, L: _Layers):
    """Masked multi-head self-attention over [B, W, E] window tokens."""
    b, w, e = tokens.shape
    d = e // heads
    qkv = L.prec.mm(tokens, sd["attention.in_proj_weight"].t()) + sd["attention.in_proj_bias"]
    q, k, v = (t.reshape(b, w, heads, d).transpose(1, 2) for t in qkv.split(e, dim=-1))
    scores = L.prec.mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    if pad_mask is not None:
        scores = scores.masked_fill(pad_mask[:, None, None, :], torch.finfo(torch.float32).min)
    att = L.dropout(torch.softmax(scores, dim=-1))
    out = L.prec.mm(att, v).transpose(1, 2).reshape(b, w, e)
    return L.prec.mm(out, sd["attention.out_proj.weight"].t()) + sd["attention.out_proj.bias"]


def segment(points, centroids, pad_mask, weights, L: _Layers, heads: int = 8,
            quant_bits: int = 0):
    """Logits [B, W, N, C] of windows ``points`` [B, W, N, 9] with window
    centroids [B, W, 2] and a window padding mask [B, W] (or None)."""
    base, seg = weights["base_pointnet"], weights["segmen_net"]
    b, w, n, f = points.shape
    local, glob, t_feat = encoder(points.reshape(b * w, n, f), base, L, quant_bits)
    pe = torch.nn.functional.leaky_relu(L.dense(centroids, seg, "fc1.weight", "fc1.bias"), 0.01)
    tokens = glob.reshape(b, w, -1) + L.dense(pe, seg, "fc2.weight", "fc2.bias")
    ctx = attention(tokens, seg, pad_mask, heads, L)
    local = local.reshape(b, w, n, -1)
    h = torch.cat([local, ctx[:, :, None, :].expand(b, w, n, ctx.shape[-1])], dim=-1)
    for i in range(len(HEAD)):
        h = L.dropout(L.block(h, seg, f"conv_{i + 2}.weight", f"bn_{i + 2}", f"conv_{i + 2}.bias"))
    return L.dense(h, seg, "conv_4.weight", "conv_4.bias"), t_feat


def eval_logits(points, centroids, pad_mask, weights, prec: Precision = FP32,
                quant_bits: int = 0, block: int = 8):
    """Eval-mode logits, ``block`` clouds at a time (to bound memory);
    ``quant_bits`` 8 (or 4, the int8 control) runs mlp_a and mlp_b as the
    int8 scheme."""
    outs = []
    L = _Layers(prec, train=False)
    with prec, torch.no_grad():
        for s in range(0, points.shape[0], block):
            pm = None if pad_mask is None else pad_mask[s:s + block]
            outs.append(segment(points[s:s + block], centroids[s:s + block], pm, weights, L,
                                quant_bits=quant_bits)[0])
    return torch.cat(outs)


def standardize_head(weights, windows: torch.Tensor) -> None:
    """Scales and shifts the last layer (``conv_4``) in place so that each
    class's logit has mean 0 and standard deviation 1 over ``windows``
    [1, W, N, 9] (eval mode, float32). Random weights give one class the
    lead on every point on about half the seeds, which no trained
    segmenter does; once each class leads somewhere, the labels show what
    the tiling and the forward computed."""
    logits = eval_logits(windows, windows[..., :2].mean(dim=2), None, weights)
    logits = logits.reshape(-1, logits.shape[-1])
    mean, std = logits.mean(dim=0), logits.std(dim=0)
    seg = weights["segmen_net"]
    seg["conv_4.weight"] = seg["conv_4.weight"] / std[:, None, None]
    seg["conv_4.bias"] = (seg["conv_4.bias"] - mean) / std


# -- training ---------------------------------------------------------------------


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """Step ``step``'s augmentation and dropout generator: seeded from
    (seed, step) as ``SeedSequence`` states it."""
    s = np.random.SeedSequence((int(seed), int(step))).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def augment(points, labels, centroids, gen):
    """shuffle_windows (one permutation of the window axis of points, labels
    and centroids), then rotate_z (one angle in [0, 2π) about z, the
    centroids unturned)."""
    perm = torch.randperm(points.shape[1], generator=gen, device=points.device)
    points, labels, centroids = points[:, perm], labels[:, perm], centroids[:, perm]
    angle = torch.rand((), generator=gen, device=points.device) * (2 * math.pi)
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, s, zero]), torch.stack([-s, c, zero]),
                       torch.stack([zero, zero, one])])
    points = torch.cat([points[..., :3] @ rot, points[..., 3:]], dim=-1)
    return points, labels, centroids


def loss_fn(logits, t_feat, labels, class_weights, reg_weight: float):
    """Weighted CE over labels ≥ 0 (sum of w·ce over sum of w) plus
    ``reg_weight`` · ‖I − A·Aᵀ‖_F over every window's feature transform."""
    c = logits.shape[-1]
    lg = logits.reshape(-1, c)
    t = labels.reshape(-1).long()
    valid = t >= 0
    safe = torch.where(valid, t, torch.zeros_like(t))
    ce = torch.logsumexp(lg, dim=-1) - lg.gather(1, safe[:, None])[:, 0]
    w = class_weights[safe] * valid.float()
    data = (ce * w).sum() / w.sum().clamp_min(1e-12)
    a = t_feat.reshape(-1, t_feat.shape[-1], t_feat.shape[-1])
    diff = torch.eye(a.shape[-1], device=a.device) - a @ a.transpose(1, 2)
    return data + reg_weight * torch.sqrt(diff.square().sum() + 1e-12)


class Adam:
    """Adam (β 0.9 / 0.999, ε 1e-8, bias-corrected) over a dict of tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def update(self, params, grads) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(1e-8)
            params[k].data.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))


def train_steps(weights, batches: List[dict], seed: int, first_step: int, recipe: dict,
                prec: Precision = FP32):
    """Runs ``len(batches)`` training steps from ``weights``; returns
    (losses, first step's gradients {group/key: tensor}, parameters after the
    last step {group/key: tensor}). ``recipe``: dropout, lr, class_weights,
    reg_weight."""
    params = {f"{g}/{k}": v.detach().clone().requires_grad_(is_parameter(k))
              for g, sd in weights.items() for k, v in sd.items()}
    trained = {k: p for k, p in params.items() if p.requires_grad}
    opt = Adam(trained, recipe["lr"])
    device = next(iter(params.values())).device
    cw = torch.tensor(recipe["class_weights"], dtype=torch.float32, device=device)
    losses, first_grads = [], None
    with prec:
        for i, batch in enumerate(batches):
            gen = step_generator(seed, first_step + i, device)
            pts, lbl, cent = augment(batch["points"], batch["labels"], batch["centroids"], gen)
            pad = (lbl == -1).all(dim=-1)
            L = _Layers(prec, train=True, gen=gen, drop=recipe["dropout"])
            tree = {g: {k: params[f"{g}/{k}"] for k in sd} for g, sd in weights.items()}
            logits, t_feat = segment(pts, cent, pad, tree, L)
            loss = loss_fn(logits, t_feat, lbl, cw, recipe["reg_weight"])
            grads = torch.autograd.grad(loss, list(trained.values()))
            grads = dict(zip(trained.keys(), grads))
            if first_grads is None:
                first_grads = {k: g.detach().clone() for k, g in grads.items()}
            with torch.no_grad():
                opt.update(trained, grads)
            losses.append(float(loss))
    return losses, first_grads, {k: p.detach() for k, p in trained.items()}
