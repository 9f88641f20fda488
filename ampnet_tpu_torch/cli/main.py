"""``python -m ampnet_tpu_torch`` — the port's command line, on the card
unless ``--device cpu``. Counterparts of ``ampnet_tpu/cli/main.py``:

    train   train the attention segmenter (``cmd_train``): best-val checkpoints
            under ``<out_path>/checkpoints/attention_segmentation_best``
    serve   a long-lived HTTP server (``cmd_serve``) over a reference ``.pth``
            or one of the port's checkpoint directories

Options of the JAX command line that this slice does not cover exit 1 with the
ROADMAP.md item that owns them; ensembles wait for later slices too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ampnet_tpu_torch.models.backends import BACKENDS

FAMILIES = "ROADMAP.md Queue 1, item 4 (other families and contexts)"
PARALLEL = "ROADMAP.md Queue 1, item 5 (parallel)"
TRAIN_REST = "ROADMAP.md Queue 1, item 7 (training options)"


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


def make_server(args):
    """The InferenceServer that ``serve`` runs (not yet serving)."""
    from ampnet_tpu_torch.core.checkpoint import is_checkpoint_dir, load_model
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.infer.server import InferenceServer
    from ampnet_tpu_torch.infer.tiled import TiledInferencer

    path = args.model_checkpoint
    if os.path.isdir(path):
        if not is_checkpoint_dir(path):
            raise ValueError(f"{path} is not one of the port's checkpoint directories "
                             "(meta.json + state.pt); JAX orbax directories cannot be read")
        device = resolve_device(args.device)
        cfg, model = load_model(path, device)
    elif path.endswith((".pth", ".pt")):
        device = resolve_device(args.device)
        cfg, model = _restore_reference(path, device)
    else:
        raise ValueError(f"{path}: want a reference .pth or a checkpoint directory")
    inferencer = TiledInferencer(
        model, cfg, max_clusters=args.max_clusters, backend=args.backend,
        tiler=args.tiler, transfer_dtype=args.transfer_dtype, device=device,
    )
    return InferenceServer(
        inferencer, host=args.host, port=args.port,
        model_name=os.path.basename(os.path.normpath(path)),
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
    print(f"serving {os.path.basename(os.path.normpath(args.model_checkpoint))} on "
          f"http://{host}:{port}  "
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


def _train_refusal(args):
    """The message for an option this slice does not cover, else None."""
    refused = [
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
    ]
    for hit, flag, item in refused:
        if hit:
            return f"{flag} is not ported yet: {item}"
    if args.grad_accum < 1 or args.batch_size % args.grad_accum:
        return (f"--batch_size {args.batch_size} must be divisible by --grad_accum "
                f"{args.grad_accum} (equal micro-batches keep the accumulated gradient exact)")
    return None


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

    refusal = _train_refusal(args)
    if refusal:
        print(refusal, file=sys.stderr)
        return 1
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

    s = sub.add_parser("serve", help="long-lived HTTP inference server")
    s.add_argument("--model_checkpoint", required=True,
                   help="reference .pth checkpoint, or a checkpoint directory "
                        "<out_path>/checkpoints/<name> written by train")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8421)
    s.add_argument("--max_clusters", type=int, default=None,
                   help="tiling cap (default: checkpoint config)")
    s.add_argument("--backend", choices=list(BACKENDS), default="folded")
    s.add_argument("--tiler", choices=["balanced", "fast"], default="balanced")
    s.add_argument("--transfer_dtype", choices=["float32", "float16", "int8"], default=None)
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
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
