"""``python -m ampnet_tpu_torch`` — the port's command line, on the card
unless ``--device cpu``. Counterparts of ``ampnet_tpu/cli/main.py``:

    train   train the attention segmenter (``cmd_train``): best-val checkpoints
            under ``<out_path>/checkpoints/attention_segmentation_best``
    test    tiled evaluation with the IoU CSV (``cmd_test``)
    infer   label-free per-point predictions of ``.pkl`` clouds (``cmd_infer``)
    export  a checkpoint as a reference ``.pth`` (``cmd_export``)
    serve   a long-lived HTTP server (``cmd_serve``)

``test``, ``infer`` and ``serve`` take a reference ``.pth`` or one of the
port's checkpoint directories, or several of them comma-separated: members of
one signature (parameter names and shapes, and ``n_points``) stack in one
``TiledInferencer``, several groups average in an ``EnsembleInferencer``.
Options of the JAX command line that the port does not cover yet exit 1 with
the ROADMAP.md item that owns them.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from ampnet_tpu_torch.models.backends import BACKENDS

FAMILIES = "ROADMAP.md Queue 1, item 4 (other families and contexts)"
PARALLEL = "ROADMAP.md Queue 1, item 5 (parallel)"
TRAIN_REST = "ROADMAP.md Queue 1, item 7 (training options)"
WHOLE_TILE = "ROADMAP.md Queue 1, item 3b (whole-tile LAS inference, infer/full_tile.py)"


class Refused(ValueError):
    """A request the command line refuses: ``main`` prints it and exits 1."""


def _refuse_unported(checks) -> None:
    """Raise ``Refused`` for the first (hit, flag, item) that hits."""
    for hit, flag, item in checks:
        if hit:
            raise Refused(f"{flag} is not ported yet: {item}")


def _restore_reference(path: str, device):
    """(cfg, model) from a reference ``.pth``, with the hyperparameters the
    reference tester reads from the checkpoint (number_of_points) and the
    geometry read from the weights (point_dim, global_feat)."""
    from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig
    from ampnet_tpu_torch.core.weights import load_flax_variables, load_reference_pth
    from ampnet_tpu_torch.models.amp import AMPNetSegmenter

    variables, meta = load_reference_pth(path)
    cfg = AMPNetConfig(model=ModelConfig(
        context=meta["arch"], point_dim=meta["point_dim"], global_feat=meta["global_feat"],
    ))
    if meta.get("number_of_points"):
        cfg = cfg.replace(data=DataConfig(n_points=int(meta["number_of_points"])))
    model = AMPNetSegmenter(cfg.model, num_features=cfg.data.num_features)
    load_flax_variables(model, variables)
    return cfg, model.to(device)


def _restore_model(path: str, device):
    """(cfg, model, name) from one checkpoint: a port checkpoint directory
    (``meta.json`` + ``state.pt``) or a reference ``.pth``."""
    from ampnet_tpu_torch.core.checkpoint import is_checkpoint_dir, load_model

    if not os.path.exists(path):
        raise Refused(f"checkpoint not found: {path}")
    if os.path.isdir(path):
        if not is_checkpoint_dir(path):
            raise Refused(f"{path} is not one of the port's checkpoint directories "
                          "(meta.json + state.pt); JAX orbax directories cannot be read")
        cfg, model = load_model(path, device)
    elif path.endswith((".pth", ".pt")):
        cfg, model = _restore_reference(path, device)
    else:
        raise Refused(f"{path}: want a reference .pth or a checkpoint directory")
    return cfg, model, os.path.basename(os.path.normpath(path))


def _restore_groups(spec: str, device):
    """A comma-separated ``--model_checkpoint`` → ([(cfg, [model, ...]), ...],
    name). Members group by signature: ordered (state_dict key, shape) pairs
    and ``n_points``, what stacking on the device needs."""
    from ampnet_tpu_torch.infer.tiled import model_signature

    restored = [_restore_model(p, device) for p in spec.split(",") if p]
    if not restored:
        raise Refused("--model_checkpoint names no checkpoint")
    groups = {}
    for cfg, model, _ in restored:
        groups.setdefault((model_signature(model), cfg.data.n_points), (cfg, []))[1].append(model)
    groups = list(groups.values())
    ncs = {cfg.model.num_classes for cfg, _ in groups}
    if len(ncs) > 1:
        raise Refused(f"ensemble members disagree on num_classes: {sorted(ncs)}")
    return groups, "+".join(name for *_, name in restored)


def _make_seg_inferencer(groups, args, device, max_clusters):
    """One TiledInferencer per group (its members stacked), wrapped in an
    EnsembleInferencer when there are several groups."""
    from ampnet_tpu_torch.infer.tiled import EnsembleInferencer, TiledInferencer

    members = [
        TiledInferencer(models if len(models) > 1 else models[0], cfg,
                        max_clusters=max_clusters, backend=args.backend, tiler=args.tiler,
                        transfer_dtype=args.transfer_dtype, device=device)
        for cfg, models in groups
    ]
    return members[0] if len(members) == 1 else EnsembleInferencer(members)


def _refuse_other_families(args) -> None:
    """The values of --task, --arch and --num_devices that the port does not
    cover yet, on the commands that restore checkpoints."""
    task = getattr(args, "task", "segmentation")  # test and serve take --task
    devices = getattr(args, "num_devices", 1)  # serve takes --num_devices
    _refuse_unported([
        (task != "segmentation", f"--task {task}", FAMILIES),
        (args.arch != "attention", f"--arch {args.arch}", FAMILIES),
        (devices > 1, f"--num_devices {devices}", PARALLEL),
    ])


def _check_views(args) -> None:
    if not 1 <= args.tta <= 8:
        raise Refused(f"--tta must be in 1..8 (dihedral period), got {args.tta}")
    if args.tile_votes < 1:
        raise Refused(f"--tile_votes must be >= 1, got {args.tile_votes}")


def _check_figures(args, flags) -> None:
    """Every figure flag set needs matplotlib: refuse before any work."""
    from ampnet_tpu_torch.core.plotting import require_matplotlib

    for flag in flags:
        if getattr(args, flag):
            try:
                require_matplotlib(f"--{flag}")
            except ModuleNotFoundError as e:
                raise Refused(str(e)) from e


def make_server(args):
    """The InferenceServer that ``serve`` runs (not yet serving)."""
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.infer.server import InferenceServer

    _refuse_other_families(args)
    device = resolve_device(args.device)
    groups, name = _restore_groups(args.model_checkpoint, device)
    inferencer = _make_seg_inferencer(groups, args, device, args.max_clusters)
    return InferenceServer(
        inferencer, host=args.host, port=args.port, model_name=name,
        batch_window_ms=args.batch_window_ms, max_batch_clouds=args.max_batch_clouds,
    )


def cmd_serve(args) -> int:
    """Serve a model over HTTP: resident model, micro-batched requests."""
    server = make_server(args)
    if args.warmup:
        sizes = [int(s) for s in args.warmup.split(",") if s]
        batches = [int(b) for b in args.warmup_batches.split(",") if b] or [1]
        print(f"warming up bucket programs for sizes {sizes} "
              f"x micro-batches {batches}...", file=sys.stderr)
        server.warmup(sizes, batch_sizes=batches)
    host, port = server.address
    print(f"serving {server.model_name} on http://{host}:{port}  "
          f"(POST /v1/predict, GET /healthz, GET /v1/stats)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()
    return 0


def _load_lists(path_list_files: str):
    from ampnet_tpu_torch.data.io_utils import read_split_list

    out = {}
    for split in ("train", "val", "test"):
        p = os.path.join(path_list_files, f"{split}_seg_files.txt")
        out[split] = read_split_list(p) if os.path.exists(p) else []
    return out


def _refuse_train_options(args) -> None:
    """Refuse the train options this port does not cover yet."""
    _refuse_unported([
        (args.task != "segmentation", f"--task {args.task}", FAMILIES),
        (args.arch != "attention", f"--arch {args.arch}", FAMILIES),
        (args.num_devices > 1, f"--num_devices {args.num_devices}", PARALLEL),
        (bool(args.distill_from), "--distill_from", FAMILIES),
        (args.local_agg != "none", f"--local_agg {args.local_agg}", FAMILIES),
        (args.geom_features, "--geom_features", FAMILIES),
        (args.att_geom_tokens, "--att_geom_tokens", FAMILIES),
        (args.dtype != "float32", f"--dtype {args.dtype}", TRAIN_REST),
        (args.oversample_factor > 1, f"--oversample_factor {args.oversample_factor}", TRAIN_REST),
        (bool(args.seg_weighing), "--seg_weighing", TRAIN_REST),
    ])
    if args.grad_accum < 1 or args.batch_size % args.grad_accum:
        raise Refused(f"--batch_size {args.batch_size} must be divisible by --grad_accum "
                      f"{args.grad_accum} (equal micro-batches keep the accumulated gradient "
                      "exact)")


def cmd_train(args) -> int:
    """Train the attention segmenter; prints the last epoch's metrics as JSON."""
    import numpy as np
    import torch

    from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig, TrainConfig
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.data import schema as S
    from ampnet_tpu_torch.data.datasets import WindowedCloudDataset
    from ampnet_tpu_torch.data.device_cache import maybe_device_cache
    from ampnet_tpu_torch.data.pipeline import PaddedBatcher
    from ampnet_tpu_torch.models.amp import AMPNetSegmenter
    from ampnet_tpu_torch.train.trainer import Trainer

    _refuse_train_options(args)
    device = resolve_device(args.device)
    cfg = AMPNetConfig(
        data=DataConfig(n_points=args.number_of_points, max_windows=args.number_of_windows),
        model=ModelConfig(bn_mode=args.bn_mode),
        train=TrainConfig(batch_size=args.batch_size, learning_rate=args.learning_rate,
                          epochs=args.epochs, weighing_method=args.weighing_method,
                          seed=args.seed, grad_accum=args.grad_accum,
                          focal_gamma=args.focal_gamma,
                          async_checkpoint=args.ckpt_io != "sync"),
    )
    lists = _load_lists(args.path_list_files)
    if not lists["train"]:
        print(f"empty train list in {args.path_list_files}", file=sys.stderr)
        return 1
    noise = S.REFERENCE_NOISE_CLASSES if args.reference_noise_compat else S.DATASET_NOISE_CLASSES

    def batcher(split, seed):
        if not lists[split]:
            return None
        ds = WindowedCloudDataset(args.dataset_path, lists[split], noise_classes=noise)
        b = PaddedBatcher(ds, args.batch_size, n_points=args.number_of_points,
                          max_windows=args.number_of_windows, seed=seed,
                          drop_last=len(ds) >= args.batch_size,
                          pad_to_multiple=args.grad_accum)
        return maybe_device_cache(b, device, args.device_cache)

    model = AMPNetSegmenter(cfg.model, num_features=cfg.data.num_features,
                            generator=torch.Generator().manual_seed(cfg.train.seed))
    trainer = Trainer(cfg, model, batcher("train", cfg.train.seed),
                      batcher("val", cfg.train.seed + 1), args.out_path,
                      name="attention_segmentation", device=device)
    try:
        if args.model_checkpoint and not trainer.resume(args.model_checkpoint):
            print(f"no checkpoint {args.model_checkpoint!r} under {trainer.ckpt.directory}",
                  file=sys.stderr)
            return 1
        history = trainer.fit(args.epochs)
    finally:
        trainer.close()
    last = history["val"][-1] if history["val"] else history["train"][-1]
    print(json.dumps({k: v for k, v in last.items() if np.isfinite(v)}, indent=2))
    print(f"checkpoints + logs in {args.out_path}")
    return 0


def cmd_test(args) -> int:
    """Tiled evaluation of the test (else val) list: appends the summary row
    to ``<out_path>/IoU-results.csv`` and prints the summary as JSON."""
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.data.datasets import EvalCloudDataset
    from ampnet_tpu_torch.infer.tiled import evaluate_dataset

    _refuse_other_families(args)
    _check_views(args)
    _check_figures(args, ("plot", "analysis"))
    device = resolve_device(args.device)
    groups, name = _restore_groups(args.model_checkpoint, device)
    lists = _load_lists(args.path_list_files)
    ds = EvalCloudDataset(args.dataset_path, lists["test"] or lists["val"])
    inferencer = _make_seg_inferencer(groups, args, device, args.max_clusters)
    out = evaluate_dataset(
        inferencer, ds, out_csv=os.path.join(args.out_path, "IoU-results.csv"),
        model_name=name, plot_dir=os.path.join(args.out_path, "plots") if args.plot else None,
        tta=args.tta, tile_votes=args.tile_votes,
        analysis_dir=args.out_path if args.analysis else None,
    )
    print(json.dumps(out["summary"], indent=2))
    if "analysis" in out:
        print(f"error analysis -> {os.path.join(args.out_path, 'analysis.json')}",
              file=sys.stderr)
    return 0


def cmd_infer(args) -> int:
    """Per-point predictions of every ``.pkl`` cloud in ``dataset_path``:
    ``<stem>_preds.npy`` (int32), and with ``--save_probs`` also
    ``<stem>_probs.npy`` (float16) and ``<stem>_hist.png``."""
    import numpy as np

    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.data.datasets import InferenceCloudDataset
    from ampnet_tpu_torch.data.schema import normalize_xy_neg_one, select_model_features
    from ampnet_tpu_torch.infer.tiled import eval_chunks, predict_chunk

    _refuse_other_families(args)
    _check_views(args)
    _check_figures(args, ("save_probs",))
    if glob.glob(os.path.join(args.dataset_path, "*.las")):
        raise Refused(f"{args.dataset_path} holds .las tiles; whole-tile mode is not ported "
                      f"yet: {WHOLE_TILE}")
    device = resolve_device(args.device)
    groups, _ = _restore_groups(args.model_checkpoint, device)
    inferencer = _make_seg_inferencer(groups, args, device, None)
    files = [os.path.basename(f)
             for f in sorted(glob.glob(os.path.join(args.dataset_path, "*.pkl")))]
    ds = InferenceCloudDataset(args.dataset_path, files)
    os.makedirs(args.out_path, exist_ok=True)
    for idx in eval_chunks(len(ds), args.tta * args.tile_votes):
        chunk = [ds[i] for i in idx]
        feats = [normalize_xy_neg_one(select_model_features(s["points"])) for s in chunk]
        outs = predict_chunk(inferencer, feats, list(idx), args.tta, args.tile_votes,
                             return_probs=args.save_probs)
        for sample, out in zip(chunk, outs):
            stem = os.path.join(args.out_path, os.path.splitext(sample["name"])[0])
            if args.save_probs:
                from ampnet_tpu_torch.core.plotting import plot_class_histograms

                preds, probs = out
                np.save(stem + "_probs.npy", probs)
                plot_class_histograms(preds, probs, save_to=stem + "_hist.png",
                                      title=os.path.basename(stem))
            else:
                preds = out
            np.save(stem + "_preds.npy", preds)
    print(f"wrote predictions for {len(ds)} clouds to {args.out_path}")
    return 0


def cmd_export(args) -> int:
    """One checkpoint (a port directory or a ``.pth``) as a reference ``.pth``
    (utils/utils.py:422-438) with its number_of_points, batch_size and lr."""
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.core.weights import flax_variables, save_reference_pth

    _refuse_other_families(args)
    cfg, model, name = _restore_model(args.model_checkpoint, resolve_device(args.device))
    meta = {"number_of_points": cfg.data.n_points, "batch_size": cfg.train.batch_size,
            "lr": cfg.train.learning_rate}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_reference_pth(flax_variables(model), args.out, meta=meta)
    print(f"exported {name} (attention) -> {args.out}")
    return 0


def _add_checkpoint_options(s) -> None:
    s.add_argument("--model_checkpoint", required=True,
                   help="a reference .pth or a checkpoint directory written by train; "
                        "comma-separate several for a probability-averaging ensemble")
    s.add_argument("--arch", default="attention", help="attention only for now")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")


def _add_inference_options(s, default_backend: str) -> None:
    s.add_argument("--backend", choices=list(BACKENDS), default=default_backend)
    s.add_argument("--tiler", choices=["balanced", "fast"], default="balanced")
    s.add_argument("--transfer_dtype", choices=["float32", "float16", "int8"], default=None)


def _add_view_options(s) -> None:
    s.add_argument("--tta", type=int, default=1,
                   help="average class probabilities over N dihedral views per cloud "
                        "(1..8; 4 = the 90-degree rotations, 8 = + mirrors); 1 = off")
    s.add_argument("--tile_votes", type=int, default=1,
                   help="predict each view under N different tilings and average the "
                        "probabilities; 1 = off")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ampnet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("train", help="train the attention segmenter")
    s.add_argument("dataset_path", help="folder of kmeans_<name>.pt / .npz artifacts")
    s.add_argument("--path_list_files", default="train_test_files/RGBN_100x100",
                   help="folder of {train,val,test}_seg_files.txt")
    s.add_argument("--out_path", default="results")
    s.add_argument("--number_of_points", type=int, default=2048)
    s.add_argument("--number_of_windows", type=int, default=9)
    s.add_argument("--batch_size", type=int, default=32)
    s.add_argument("--epochs", type=int, default=500)
    s.add_argument("--learning_rate", type=float, default=1e-3)
    s.add_argument("--weighing_method", default="EFS", help="recorded in the checkpoint meta")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--model_checkpoint", default="",
                   help="resume from this checkpoint name (or directory) under "
                        "<out_path>/checkpoints")
    s.add_argument("--device_cache", choices=["auto", "on", "off"], default="auto",
                   help="keep the padded dataset resident on the card and gather batches "
                        "there (auto: when it fits in 4 GiB)")
    s.add_argument("--bn_mode", choices=["batch", "window"], default="batch")
    s.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batches per optimizer update (batch_size must divide evenly)")
    s.add_argument("--focal_gamma", type=float, default=0.0,
                   help="focal-loss exponent (0 = the reference's weighted CE)")
    s.add_argument("--ckpt_io", choices=["async", "sync"], default="async",
                   help="best-val checkpoint writes: 'async' snapshots on the card and "
                        "writes from a background thread; 'sync' blocks the epoch loop")
    s.add_argument("--reference_noise_compat", action="store_true",
                   help="drop class 14 (power lines) from the training data, as the "
                        "reference's loader does (datasets.py:339-350)")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    # the JAX command line's other options: refused unless at their defaults
    s.add_argument("--task", choices=["segmentation", "classification"],
                   default="segmentation")
    s.add_argument("--arch", choices=["attention", "gru", "baseline", "classic", "pointnet2"],
                   default="attention")
    s.add_argument("--num_devices", type=int, default=1)
    s.add_argument("--distill_from", default="")
    s.add_argument("--local_agg", choices=["none", "edge"], default="none")
    s.add_argument("--geom_features", action="store_true")
    s.add_argument("--att_geom_tokens", action="store_true")
    s.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    s.add_argument("--oversample_factor", type=int, default=1)
    s.add_argument("--seg_weighing", default="")
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser("test", help="tiled evaluation with the IoU CSV")
    s.add_argument("dataset_path", help="folder of 13-column .pkl clouds")
    _add_checkpoint_options(s)
    s.add_argument("--path_list_files", required=True,
                   help="folder of test_seg_files.txt (else val_seg_files.txt)")
    s.add_argument("--out_path", default="results")
    s.add_argument("--task", choices=["segmentation", "classification"],
                   default="segmentation")
    s.add_argument("--max_clusters", type=int, default=18)
    s.add_argument("--plot", action="store_true",
                   help="save pred-vs-truth scatters of the first clouds (needs matplotlib)")
    _add_inference_options(s, "xla")
    _add_view_options(s)
    s.add_argument("--analysis", action="store_true",
                   help="write analysis.json + confusion.png: per-class precision/recall, "
                        "boundary-vs-interior errors, worst clouds (needs matplotlib)")
    s.set_defaults(fn=cmd_test)

    s = sub.add_parser("infer", help="label-free per-point predictions of .pkl clouds")
    s.add_argument("dataset_path", help="folder of 13-column .pkl clouds")
    _add_checkpoint_options(s)
    s.add_argument("--out_path", default="predictions")
    _add_inference_options(s, "xla")
    s.add_argument("--save_probs", action="store_true",
                   help="also write <name>_probs.npy (float16 softmax) and a confidence "
                        "histogram <name>_hist.png (needs matplotlib)")
    _add_view_options(s)
    s.set_defaults(fn=cmd_infer)

    s = sub.add_parser("export", help="a checkpoint as a reference .pth")
    s.add_argument("--model_checkpoint", required=True,
                   help="a checkpoint directory written by train, or a .pth")
    s.add_argument("--out", required=True, help="output .pth path")
    s.add_argument("--arch", default="attention", help="attention only for now")
    s.add_argument("--device", default="cuda",
                   help="where the checkpoint is restored: cuda (default) or cpu")
    s.set_defaults(fn=cmd_export)

    s = sub.add_parser("serve", help="long-lived HTTP inference server")
    _add_checkpoint_options(s)
    s.add_argument("--task", choices=["segmentation", "classification"],
                   default="segmentation")
    s.add_argument("--num_devices", type=int, default=1, help="1 for now")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8421)
    s.add_argument("--max_clusters", type=int, default=None,
                   help="tiling cap (default: checkpoint config)")
    _add_inference_options(s, "folded")
    s.add_argument("--batch_window_ms", type=float, default=5.0,
                   help="micro-batching window for concurrent requests")
    s.add_argument("--max_batch_clouds", type=int, default=64)
    s.add_argument("--warmup", default="",
                   help="comma-separated cloud sizes to run once before serving, "
                        "e.g. 10000,50000")
    s.add_argument("--warmup_batches", default="1",
                   help="micro-batch cloud-counts to run per warmup size, e.g. 1,2,4")
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (Refused, NotImplementedError) as e:
        print(e, file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
