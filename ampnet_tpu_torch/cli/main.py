"""``python -m ampnet_tpu_torch`` — the port's command line.

This slice carries ``serve`` (counterpart of ``ampnet_tpu/cli/main.py``
``cmd_serve``): a long-lived HTTP server over a reference ``.pth``
checkpoint, on the card unless ``--device cpu``. Orbax checkpoint directories,
ensembles, ``--task classification`` and ``--num_devices`` wait for later
slices (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import argparse
import os
import sys

from ampnet_tpu_torch.models.backends import BACKENDS


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
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.infer.server import InferenceServer
    from ampnet_tpu_torch.infer.tiled import TiledInferencer

    if not args.model_checkpoint.endswith((".pth", ".pt")):
        raise ValueError("the port serves reference .pth checkpoints; orbax checkpoint "
                         "directories wait for the checkpoint slice (ROADMAP.md Queue 1)")
    device = resolve_device(args.device)
    cfg, model = _restore_reference(args.model_checkpoint, device)
    inferencer = TiledInferencer(
        model, cfg, max_clusters=args.max_clusters, backend=args.backend,
        tiler=args.tiler, transfer_dtype=args.transfer_dtype, device=device,
    )
    return InferenceServer(
        inferencer, host=args.host, port=args.port,
        model_name=os.path.basename(args.model_checkpoint),
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
    print(f"serving {os.path.basename(args.model_checkpoint)} on http://{host}:{port}  "
          f"(POST /v1/predict, GET /healthz, GET /v1/stats)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ampnet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="long-lived HTTP inference server")
    s.add_argument("--model_checkpoint", required=True,
                   help="reference .pth checkpoint (attention segmenter)")
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
