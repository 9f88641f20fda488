"""``python -m ampnet_tpu_torch`` — the port's command line, on the card
unless ``--device cpu``. Counterparts of ``ampnet_tpu/cli/main.py``:

    synth       synthetic LAS tiles from a seed (``cmd_synth``)
    preprocess  LAS tiles → windows → 13-column .pkl clouds + k-means
                artifacts + split lists (``cmd_preprocess``; host stages,
                the native min-cost-flow solver by default)
    fps         farthest-point subsampling of .pkl clouds (``cmd_fps``)
    train       train any ``--arch`` of the factory for ``--task`` segmentation or
                classification (``cmd_train``): best-val checkpoints under
                ``<out_path>/checkpoints/<arch>_<task>_best``; ``--num_devices
                N`` trains N data-parallel ranks (NCCL, or gloo on the CPU)
    test        tiled evaluation with the IoU CSV, or the classification CSVs
                (``cmd_test``)
    infer       label-free per-point predictions of ``.pkl`` clouds, or whole
                ``.las`` tiles labelled into classified LAS files (``cmd_infer``)
    export      a checkpoint as a reference ``.pth`` (``cmd_export``)
    serve       a long-lived HTTP server of per-point labels (sharded over
                ``--num_devices`` model replicas), or of one label per cloud
                under ``--task classification`` (``cmd_serve``)
    bench       steady-state windows/s of the flagship forward at 32 × 9 × 2048
                under ``AMPNET_BACKEND``, and the fp32 and bf16 train steps
                (``cmd_bench``, ``ampnet_tpu_torch/bench.py``; one JSON line
                on stdout, the detail on stderr)
    demo        synth → preprocess → train → test on synthetic tiles (``cmd_demo``)

``test``, ``infer`` and ``serve`` take a reference ``.pth`` or one of the
port's checkpoint directories, or several of them comma-separated: members of
one signature (parameter names and shapes, and ``n_points``) stack in one
``TiledInferencer``, several groups average in an ``EnsembleInferencer``.
The windowed families (attention, gru) tile a cloud into windows; baseline,
classic and pointnet2 evaluate the whole cloud as one window (k = 1). Only
the attention segmenter runs under the non-``xla`` backends, as in the JAX
package: the others are refused there, except that ``serve``'s default
``folded`` falls back to ``xla`` and says so. A checkpoint trained on the
geometric feature columns (``train --geom_features``) reads them on every
command: the datasets select them, the wire of ``serve`` carries them, and
whole-tile ``infer`` recomputes them. The edge block and the geometry tokens
run only under ``xla``, as in the JAX package. ``train`` takes every option
of the JAX command's ``train``: ``--dtype bfloat16`` (a checkpoint that
records it is evaluated in bfloat16 under ``--backend xla``; the other
backends take their dtype from their name), ``--oversample_factor`` /
``--oversample_classes`` (``rare_class_repeats``), ``--seg_weighing``
(``seg_class_weights``) and ``--epoch_dispatch``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import sys

from ampnet_tpu_torch.models.backends import BACKENDS

NON_XLA = ("non-xla backends (folded/bf16/fused/int8) support the attention segmenter only; "
           "use --backend xla")


class Refused(ValueError):
    """A request the command line refuses: ``main`` prints it and exits 1."""


def _restore_reference(path: str, device, arch: str, task: str):
    """(cfg, model) from a reference ``.pth`` (attention or GRU segmenter),
    with the hyperparameters the reference tester reads from the checkpoint
    (number_of_points) and the geometry read from the weights (point_dim,
    global_feat, gru_hidden)."""
    from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig
    from ampnet_tpu_torch.core.weights import load_flax_variables, load_reference_pth
    from ampnet_tpu_torch.models.factory import WINDOWED, build_model

    if task != "segmentation" or arch not in WINDOWED:
        raise Refused("torch checkpoint import supports the attention/gru segmenters")
    variables, meta = load_reference_pth(path)
    if meta["arch"] != arch:
        print(f"checkpoint is a {meta['arch']} model; using --arch {meta['arch']}",
              file=sys.stderr)
    cfg = AMPNetConfig(model=ModelConfig(
        context=meta["arch"], point_dim=meta["point_dim"], global_feat=meta["global_feat"],
        gru_hidden=meta.get("gru_hidden", 64),
    ))
    if meta.get("number_of_points"):
        cfg = cfg.replace(data=DataConfig(n_points=int(meta["number_of_points"])))
    model = build_model(cfg, meta["arch"])
    load_flax_variables(model, variables)
    return cfg, model.to(device)


def _restore_model(path: str, device, arch: str = "attention", task: str = "segmentation"):
    """(cfg, model, name) from one checkpoint: a port checkpoint directory
    (``meta.json`` + ``state.pt``; its recorded arch and task win over
    ``--arch``, and a task other than ``task`` is refused) or a reference
    ``.pth``."""
    from ampnet_tpu_torch.core.checkpoint import is_checkpoint_dir, load_model, read_meta

    if not os.path.exists(path):
        raise Refused(f"checkpoint not found: {path}")
    if os.path.isdir(path):
        if not is_checkpoint_dir(path):
            raise Refused(f"{path} is not one of the port's checkpoint directories "
                          "(meta.json + state.pt); JAX orbax directories cannot be read")
        recorded = read_meta(path).get("task", "segmentation")
        if recorded != task:
            raise Refused(f"{path} is a {recorded} checkpoint; this command wants --task {task}")
        cfg, model = load_model(path, device)
        if arch != "attention" and arch != cfg.model.context:
            print(f"checkpoint records arch {cfg.model.context!r}; ignoring --arch {arch!r}",
                  file=sys.stderr)
    elif path.endswith((".pth", ".pt")):
        cfg, model = _restore_reference(path, device, arch, task)
    else:
        raise Refused(f"{path}: want a reference .pth or a checkpoint directory")
    return cfg, model, os.path.basename(os.path.normpath(path))


def _restore_groups(args, device, task: str = "segmentation"):
    """A comma-separated ``--model_checkpoint`` → ([(cfg, [model, ...]), ...],
    name). Members group by signature: ordered (state_dict key, shape) pairs
    and ``n_points``, what stacking on the device needs."""
    from ampnet_tpu_torch.infer.tiled import model_signature

    restored = [_restore_model(p, device, args.arch, task)
                for p in args.model_checkpoint.split(",") if p]
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


def _check_backend(groups, backend: str) -> None:
    """The non-``xla`` backends evaluate attention parameters only."""
    if backend != "xla" and any(cfg.model.context != "attention" for cfg, _ in groups):
        raise Refused(NON_XLA)


def _data_parallel_devices(num_devices: int, device: str) -> list:
    """The devices of ``--num_devices N``: ``cuda:0`` .. ``cuda:N-1``, refused
    when fewer cards are visible (nothing falls back to fewer devices or to
    the CPU), or the CPU N times under ``--device cpu``."""
    import torch

    if torch.device(device).type != "cuda":
        return [device] * num_devices
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < num_devices:
        raise Refused(f"--num_devices {num_devices} needs {num_devices} CUDA devices; "
                      f"{have} visible")
    return [f"cuda:{i}" for i in range(num_devices)]


def _make_seg_inferencer(groups, args, device, max_clusters, backend: str, devices=None):
    """One TiledInferencer per group (its members stacked), wrapped in an
    EnsembleInferencer when there are several groups. The windowed families
    tile with ``max_clusters``; baseline, classic and pointnet2 evaluate the
    WHOLE cloud (the reference baseline tester feeds the full cloud at batch
    1, test_segmentation.py): one window, k = 1, replicate-padded to its
    capacity and the duplicates dropped on output. ``devices``: each
    bucket's clouds are sharded over them (``serve --num_devices``)."""
    from ampnet_tpu_torch.infer.tiled import EnsembleInferencer, TiledInferencer
    from ampnet_tpu_torch.models.factory import WINDOWED

    try:
        members = [
            TiledInferencer(models if len(models) > 1 else models[0], cfg,
                            max_clusters=max_clusters if cfg.model.context in WINDOWED else 1,
                            backend=backend, tiler=args.tiler,
                            transfer_dtype=args.transfer_dtype, device=device,
                            devices=devices)
            for cfg, models in groups
        ]
    except ValueError as e:  # a backend that cannot run the model (make_forward's gates)
        raise Refused(str(e)) from e
    return members[0] if len(members) == 1 else EnsembleInferencer(members)


def _extra_features(groups) -> int:
    """The members' geometric column count; members that disagree on it are
    refused (the JAX commands ``test`` and ``infer``)."""
    extras = {cfg.data.extra_features for cfg, _ in groups}
    if len(extras) > 1:
        raise Refused("ensemble members disagree on extra_features (geom columns); "
                      "mix only models trained on the same input schema")
    return extras.pop()


def _check_geom_k(k: int, flag: str = "--geom_k") -> None:
    # refused, not coerced to the default as the JAX command line does
    if k < 1:
        raise Refused(f"{flag} must be >= 1, got {k}")


def _refuse_ensemble(args, task: str) -> None:
    if "," in args.model_checkpoint and task == "classification":
        raise Refused("checkpoint ensembles support segmentation only")


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
    """The InferenceServer that ``serve`` runs (not yet serving): per-point
    labels, sharded over ``--num_devices`` replicas of the model, or under
    ``--task classification`` one label per cloud (``CloudClassifier``, one
    device: it ignores ``--num_devices``, as the JAX command does)."""
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.infer.server import InferenceServer

    devices = None
    if args.task != "classification" and args.num_devices > 1:
        devices = _data_parallel_devices(args.num_devices, args.device)
    _refuse_ensemble(args, args.task)
    device = resolve_device(devices[0] if devices else args.device)
    groups, name = _restore_groups(args, device, args.task)
    if args.task == "classification":
        from ampnet_tpu_torch.infer.classify import CloudClassifier

        ignored = [f for f, default in (("backend", "folded"), ("tiler", "balanced"),
                                        ("transfer_dtype", None), ("max_clusters", None),
                                        ("num_devices", 1))
                   if getattr(args, f) != default]
        if ignored:
            print(f"--task classification ignores: {', '.join('--' + f for f in ignored)}",
                  file=sys.stderr)
        cfg, models = groups[0]
        inferencer = CloudClassifier(models[0], cfg, device=device)
    else:
        backend = args.backend
        if backend == "folded" and any(cfg.model.context != "attention" for cfg, _ in groups):
            # the default backend falls back for the other families (the
            # folded head evaluates attention parameters), and says so
            print("backend 'folded' is attention-only; serving with 'xla'", file=sys.stderr)
            backend = "xla"
        _check_backend(groups, backend)
        inferencer = _make_seg_inferencer(groups, args, device, args.max_clusters, backend,
                                          devices)
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


def cmd_synth(args) -> int:
    """Write synthetic LAS tiles (with ground points so the HAG stage has work):
    the JAX command's draws in its order, so one seed writes the same bytes."""
    import numpy as np

    from ampnet_tpu_torch.data.las_io import LasCloud, write_las
    from ampnet_tpu_torch.data.synthetic import (
        make_terrain,
        synthetic_scene,
        synthetic_scene_hard,
    )

    os.makedirs(args.out_path, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for i in range(args.n_tiles):
        parts = []
        for _ in range(args.windows_per_tile):
            # landscape windows (no towers/lines) give classification datasets
            # genuine negatives, like the reference's 'pc_' windows
            pylons = 0 if rng.uniform() < args.landscape_fraction else 2
            npts = args.points_per_window
            if args.point_jitter > 0:
                # arbitrary-scale realism: per-window point counts vary lognormally
                npts = max(256, int(npts * rng.lognormal(0.0, args.point_jitter)))
            if args.scene == "hard":
                pylons = 0 if pylons == 0 else int(rng.integers(2, 4))
                parts.append(synthetic_scene_hard(rng, n_points=npts,
                                                  extent_m=args.window_size,
                                                  n_pylons=pylons))
            else:
                parts.append(synthetic_scene(rng, n_points=npts,
                                             extent_m=args.window_size,
                                             n_pylons=pylons))
        # place windows side by side in raw coordinates
        clouds = []
        for w, sc in enumerate(parts):
            c = sc.copy()
            c[:, 10] = sc[:, 0] * args.window_size + 430000 + w * args.window_size
            c[:, 11] = sc[:, 1] * args.window_size + 4590000 + i * args.window_size
            clouds.append(c)
        sc = np.concatenate(clouds)
        n = len(sc)
        if (sc[:, 3] == 2).any():
            # hard scenes carry their own density-thinned ground returns
            gx = gy = np.zeros(0)
            n_g = 0
        else:
            # ground points at z=0 (class 2) so HAG has a terrain reference
            n_g = n // 4
            gx = rng.uniform(sc[:, 10].min(), sc[:, 10].max(), n_g)
            gy = rng.uniform(sc[:, 11].min(), sc[:, 11].max(), n_g)
        x = np.concatenate([sc[:, 10], gx])
        y = np.concatenate([sc[:, 11], gy])
        z = np.concatenate([sc[:, 12], np.zeros(n_g)])
        if args.terrain_relief > 0:
            # smooth random terrain under everything; the HAG stage must recover
            # the height-above-ground that the labels were generated in
            terr = make_terrain(rng, args.terrain_relief,
                                args.window_size * max(args.windows_per_tile, 1))
            z = z + terr(x - x.min(), y - y.min())
        cloud = LasCloud(
            x=x,
            y=y,
            z=z,
            intensity=np.concatenate([sc[:, 4] * 5000, rng.uniform(0, 5000, n_g)]),
            classification=np.concatenate([sc[:, 3], np.full(n_g, 2)]).astype(np.int64),
            red=np.concatenate([sc[:, 5] * 65535, rng.uniform(0, 65535, n_g)]),
            green=np.concatenate([sc[:, 6] * 65535, rng.uniform(0, 65535, n_g)]),
            blue=np.concatenate([sc[:, 7] * 65535, rng.uniform(0, 65535, n_g)]),
            nir=np.concatenate([sc[:, 8] * 65535, rng.uniform(0, 65535, n_g)]),
        )
        write_las(os.path.join(args.out_path, f"tile{i}.las"), cloud, point_format=8)
    print(f"wrote {args.n_tiles} synthetic LAS tiles to {args.out_path}")
    return 0


def cmd_preprocess(args) -> int:
    """LAS tiles → 13-column window clouds, ``kmeans_*`` artifacts and the
    {train,val,test} split lists; exits 1 when no tile produced a window."""
    from ampnet_tpu_torch.preproc.pipeline import PreprocessParams, run_pipeline
    from ampnet_tpu_torch.preproc.splits import generate_split_lists

    _check_geom_k(args.geom_k)
    if args.assigner == "sinkhorn":  # on the card unless --device cpu: checked up front
        from ampnet_tpu_torch.core.device import resolve_device

        resolve_device(args.device)
    os.makedirs(args.out_path, exist_ok=True)
    tiles = sorted(glob.glob(os.path.join(args.in_path, "*.las")))
    if not tiles:
        print(f"no LAS tiles in {args.in_path}", file=sys.stderr)
        return 1
    params = PreprocessParams(
        out_path=args.out_path, dataset=args.dataset, window_size=args.window_size,
        max_z=args.max_z, min_points=args.min_points, n_points=args.n_points,
        max_windows=args.max_windows, hag_cell=args.hag_cell,
        artifact_format=args.artifact_format, assigner=args.assigner, device=args.device,
        geom_features=args.geom_features, geom_k=args.geom_k,
        geom_radius_norm=args.geom_radius_norm,
    )
    produced, errors = run_pipeline(tiles, params, workers=args.workers)
    for e in errors:
        # skip-and-continue robustness like the reference's imap_unordered
        # pools (2_preprocessing_filter_norm.py:131-132)
        print(e, file=sys.stderr)

    # stage 4: split lists — geographic block JSONs (the reference's evaluation
    # protocol, generate_train_test_lists.py:106-210) or a seeded random split
    blocks = None
    if args.blocks_json:
        blocks = {}
        for path in args.blocks_json:
            with open(path) as f:
                mapping = json.load(f)
            for split, names in mapping.items():
                blocks.setdefault(split, []).extend(names)
    assigned = generate_split_lists(
        produced, args.out_path, task="segmentation", blocks=blocks,
        fractions={"train": 0.7, "val": 0.15, "test": 0.15}, seed=args.seed,
    )
    if blocks and assigned.get("unmatched"):
        print(f"warning: {len(assigned['unmatched'])} windows matched no block in "
              f"{args.blocks_json} and joined no split", file=sys.stderr)
    msg = f"preprocessed {len(produced)} windows from {len(tiles)} tiles → {args.out_path}"
    if errors:
        msg += f" ({len(errors)} unreadable tiles skipped)"
    print(msg)
    if not produced:
        print("no windows produced — every input tile failed", file=sys.stderr)
        return 1
    return 0


def cmd_fps(args) -> int:
    """Offline FPS subsampling of large clouds (data_proc/sample_fps.py:12-34)
    by the native solver library."""
    from ampnet_tpu_torch.data.io_utils import load_cloud, save_cloud
    from ampnet_tpu_torch.native import fps_native

    files = sorted(glob.glob(os.path.join(args.in_path, "*.pkl")))
    os.makedirs(args.out_path, exist_ok=True)
    for f in files:
        pc = load_cloud(f)
        if pc.shape[0] > args.n_points:
            pc = pc[fps_native(pc[:, :3], args.n_points)]
        save_cloud(os.path.join(args.out_path, os.path.basename(f)), pc)
    print(f"fps-sampled {len(files)} clouds to <= {args.n_points} points → {args.out_path}")
    return 0


def _load_lists(path_list_files: str, task: str = "segmentation"):
    """The {train,val,test} lists: ``<split>_seg_files.txt``, or for
    classification ``<split>_files.txt`` (else the segmentation list)."""
    from ampnet_tpu_torch.data.io_utils import read_split_list

    tag = "seg_files" if task == "segmentation" else "files"
    out = {}
    for split in ("train", "val", "test"):
        p = os.path.join(path_list_files, f"{split}_{tag}.txt")
        if not os.path.exists(p) and task != "segmentation":
            p = os.path.join(path_list_files, f"{split}_seg_files.txt")
        out[split] = read_split_list(p) if os.path.exists(p) else []
    return out


def _refuse_train_options(args) -> None:
    """Refuse what the JAX command refuses before it reads the data (its
    messages), and what the port does besides (``--num_devices`` below 1,
    ``--grad_accum`` below 1, ``--geom_k`` below 1)."""
    if args.num_devices < 1:
        raise Refused(f"--num_devices must be >= 1, got {args.num_devices}")
    if args.grad_accum < 1 or args.batch_size % args.grad_accum:
        # ranks may hold unequal shares of a micro-batch (parallel/mesh.py::rank_rows)
        raise Refused(f"--batch_size {args.batch_size} must be divisible by --grad_accum "
                      f"{args.grad_accum} (equal micro-batches keep the accumulated "
                      "gradient exact)")
    if args.task == "classification" and args.arch == "pointnet2":
        raise Refused("pointnet2 supports segmentation only")
    if args.task == "classification" and args.grad_accum > 1:
        raise Refused("--grad_accum is segmentation-only (the classification step has no "
                      "accumulation path; its residuals are tiny)")
    if args.task == "classification" and args.focal_gamma > 0:
        raise Refused("--focal_gamma is segmentation-only (make_cls_step_fns builds its own "
                      "weighted-CE objective)")
    _check_geom_k(args.geom_k)
    _check_geom_k(args.local_agg_k, "--local_agg_k")
    if args.distill_from and args.task == "classification":
        raise Refused("--distill_from is segmentation-only (per-point soft targets)")


def seg_class_weights(train_ds, method: str, num_classes: int, beta: float,
                      max_samples: int = 512):
    """Data-driven CE class weights for segmentation (``--seg_weighing``):
    ``get_class_weights`` over the point counts of each class in the first
    ``max_samples`` train clouds (every count at least 1), as the JAX
    command computes them (``ampnet_tpu/cli/main.py::seg_class_weights``).
    Returns (weights or None for an unknown method, counts)."""
    import numpy as np

    from ampnet_tpu_torch.core.metrics import get_class_weights

    counts = np.zeros(num_classes, np.int64)
    for i in range(min(len(train_ds), max_samples)):
        lab = np.asarray(train_ds[i]["labels"]).ravel()
        counts += np.bincount(lab[lab >= 0], minlength=num_classes)[:num_classes]
    return get_class_weights(method, np.maximum(counts, 1).tolist(), beta=beta), counts


def rare_class_repeats(train_ds, factor: int, classes_spec: str, num_classes: int,
                       auto_share: float = 0.05):
    """Per-cloud epoch multiplicities for rare-class oversampling
    (``--oversample_factor`` / ``--oversample_classes``, the JAX command's
    ``rare_class_repeats``): a cloud holding any point of a target class
    appears ``factor`` times an epoch. ``classes_spec`` is a comma list of
    class ids or ``auto`` (the present classes under ``auto_share`` of the
    valid points). Returns (repeats [len(ds)] or None, rare classes, number
    of oversampled clouds)."""
    import numpy as np

    labels = [np.asarray(train_ds[i]["labels"]).ravel() for i in range(len(train_ds))]
    if classes_spec == "auto":
        counts = np.zeros(num_classes, np.int64)
        for lab in labels:
            counts += np.bincount(lab[(lab >= 0) & (lab < num_classes)],
                                  minlength=num_classes)[:num_classes]
        share = counts / max(counts.sum(), 1)
        rare = [c for c in range(num_classes) if 0 < share[c] < auto_share]  # absent: not rare
    else:
        rare = sorted({int(c) for c in classes_spec.split(",") if c.strip()})
        bad = [c for c in rare if not 0 <= c < num_classes]
        if bad:  # a ValueError, as the JAX command raises it
            raise ValueError(f"--oversample_classes ids out of range: {bad}")
    if not rare:
        return None, [], 0
    repeats = np.ones(len(labels), np.int64)
    for i, lab in enumerate(labels):
        if np.isin(lab, rare).any():
            repeats[i] = factor
    n_over = int((repeats > 1).sum())
    return (repeats if n_over else None), rare, n_over


def _restore_teacher(args, device):
    """The ``--distill_from`` checkpoints as teacher groups ``[(cfg, [model,
    ...]), ...]`` (``_restore_groups``: cross-family groups work), or None."""
    if not args.distill_from:
        return None
    teacher, _ = _restore_groups(argparse.Namespace(model_checkpoint=args.distill_from,
                                                    arch=args.arch), device)
    n_members = sum(len(models) for _, models in teacher)
    print(f"distilling from {n_members} teacher member(s) in {len(teacher)} group(s): "
          f"alpha={args.distill_alpha}, T={args.distill_temp}", file=sys.stderr)
    return teacher


def cmd_train(args) -> int:
    """Train ``--arch`` for ``--task``; prints the last epoch's metrics as JSON.
    The windowed families read the k-means artifacts through
    ``WindowedCloudDataset`` + ``PaddedBatcher``; baseline, classic and
    pointnet2 read whole clouds through ``CloudDataset`` +
    ``SingleCloudBatcher``. Classification trains with ``make_cls_step_fns``
    and class weights from the train split's tower/landscape counts. With
    ``--distill_from`` the batches carry the widest column set a teacher or
    the student reads, and the student reads its own prefix.

    ``--num_devices N`` (> 1) trains N ranks, one process each (``spawn``):
    NCCL on ``cuda:0`` .. ``cuda:N-1`` (fewer cards: exit 1), or gloo under
    ``--device cpu``. ``--batch_size`` is the global batch; each rank takes
    its rows of it, and the numbers are one device's on the global batch
    (``parallel/mesh.py``). Rank 0 alone prints and writes."""
    _refuse_train_options(args)
    if args.num_devices == 1:
        return _train(args)
    from torch.multiprocessing import ProcessExitedException, ProcessRaisedException

    from ampnet_tpu_torch.parallel.mesh import spawn_ranks

    devices = _data_parallel_devices(args.num_devices, args.device)
    try:
        spawn_ranks(_train_rank, args.num_devices,
                    device="cuda" if devices[0].startswith("cuda") else args.device,
                    args=(args,))
    except (ProcessExitedException, ProcessRaisedException) as e:
        print(f"a training rank failed: {e}", file=sys.stderr)
        return 1
    return 0


def _train_rank(dp, args) -> None:
    """One rank of ``train --num_devices``; a refusal or a non-zero exit
    ends the rank with that code."""
    try:
        rc = _train(args, dp)
    except Refused as e:
        print(e, file=sys.stderr)
        rc = 1
    if rc:
        raise SystemExit(rc)


def _train(args, dp=None) -> int:
    """``train`` in this process: the whole run, or rank ``dp.rank``'s part."""
    import numpy as np
    import torch

    from ampnet_tpu_torch.core.config import AMPNetConfig, DataConfig, ModelConfig, TrainConfig
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.core.metrics import get_class_weights
    from ampnet_tpu_torch.data import schema as S
    from ampnet_tpu_torch.data.datasets import CloudDataset, WindowedCloudDataset
    from ampnet_tpu_torch.data.device_cache import maybe_device_cache
    from ampnet_tpu_torch.data.pipeline import PaddedBatcher, SingleCloudBatcher
    from ampnet_tpu_torch.models.factory import WINDOWED, build_model
    from ampnet_tpu_torch.preproc.geomfeat import N_GEOM_FEATURES
    from ampnet_tpu_torch.train.cls_step import make_cls_step_fns
    from ampnet_tpu_torch.train.trainer import Trainer

    device = dp.device if dp is not None else resolve_device(args.device)
    cfg = AMPNetConfig(
        data=DataConfig(n_points=args.number_of_points, max_windows=args.number_of_windows,
                        extra_features=N_GEOM_FEATURES if args.geom_features else 0,
                        geom_radius_norm=args.geom_radius_norm, geom_k=args.geom_k),
        model=ModelConfig(context=args.arch, bn_mode=args.bn_mode, local_agg=args.local_agg,
                          local_agg_k=args.local_agg_k, att_geom_tokens=args.att_geom_tokens,
                          dtype=None if args.dtype == "float32" else args.dtype),
        train=TrainConfig(batch_size=args.batch_size, learning_rate=args.learning_rate,
                          epochs=args.epochs, weighing_method=args.weighing_method,
                          seed=args.seed, grad_accum=args.grad_accum,
                          focal_gamma=args.focal_gamma,
                          async_checkpoint=args.ckpt_io != "sync",
                          distill_alpha=args.distill_alpha if args.distill_from else 0.0,
                          distill_temp=args.distill_temp),
    )
    teacher = _restore_teacher(args, device)
    # the batch carries the widest column set any consumer reads: a geometric
    # teacher distilling into a plain student loads 15 columns, of which the
    # student reads its first 9 (train/step.py::_forward)
    batch_extra = cfg.data.extra_features
    if teacher is not None:
        teacher_extra = max(t_cfg.data.extra_features for t_cfg, _ in teacher)
        if teacher_extra > batch_extra:
            batch_extra = teacher_extra
            print(f"teacher reads {teacher_extra} extra geom columns; loading them for the "
                  f"teacher while the student trains on its own "
                  f"{cfg.data.num_features + cfg.data.extra_features}-column schema",
                  file=sys.stderr)
    lists = _load_lists(args.path_list_files, args.task)
    if not lists["train"]:
        print(f"empty train list in {args.path_list_files}", file=sys.stderr)
        return 1
    windowed = args.arch in WINDOWED
    noise = (S.REFERENCE_NOISE_CLASSES if windowed and args.reference_noise_compat
             else S.DATASET_NOISE_CLASSES)

    def dataset(split):
        if windowed:
            return WindowedCloudDataset(args.dataset_path, lists[split], task=args.task,
                                        noise_classes=noise, extra_features=batch_extra)
        return CloudDataset(args.dataset_path, lists[split], task=args.task,
                            number_of_points=args.number_of_points, extra_features=batch_extra)

    def batcher(ds, seed, repeats=None):
        if ds is None:
            return None
        # short batches pad to whole micro-batches and whole ranks, as JAX pads
        kw = dict(seed=seed, drop_last=len(ds) >= args.batch_size, repeats=repeats,
                  pad_to_multiple=math.lcm(args.num_devices, args.grad_accum))
        b = (PaddedBatcher(ds, args.batch_size, n_points=args.number_of_points,
                           max_windows=args.number_of_windows, **kw) if windowed
             else SingleCloudBatcher(ds, args.batch_size, n_points=args.number_of_points, **kw))
        return maybe_device_cache(b, device, args.device_cache)

    train_ds = dataset("train")
    val_ds = dataset("val") if lists["val"] else None
    say = dp is None or dp.rank == 0
    repeats = None
    osf = args.oversample_factor or 1
    if osf > 1:
        if args.task == "classification":
            print("--oversample_factor is segmentation-only (the cls trainer already balances "
                  "via class weights)", file=sys.stderr)
            return 1
        repeats, rare, n_over = rare_class_repeats(train_ds, osf, args.oversample_classes,
                                                   cfg.model.num_classes)
        if say and repeats is None:
            print("oversampling: no rare classes found (or no cloud contains one) — "
                  "continuing without", file=sys.stderr)
        elif say:
            print(f"oversampling x{osf}: {n_over}/{len(train_ds)} train clouds contain rare "
                  f"classes {rare}", file=sys.stderr)
    if args.task == "segmentation" and args.seg_weighing:
        cw, counts = seg_class_weights(train_ds, args.seg_weighing, cfg.model.num_classes,
                                       cfg.train.beta)
        if cw is None:
            print(f"unknown --seg_weighing {args.seg_weighing!r} (expected "
                  "EFS|INS|ISNS|sklearn)", file=sys.stderr)
            return 1
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, class_weights=tuple(float(x) for x in cw),
            weighing_method=args.seg_weighing))
        if say:
            print(f"seg class weights ({args.seg_weighing}, counts {counts.tolist()}): "
                  f"{[round(float(x), 5) for x in cw]}", file=sys.stderr)
    model = build_model(cfg, args.arch, args.task,
                        generator=torch.Generator().manual_seed(cfg.train.seed))
    step_fns = None
    if args.task == "classification":
        # tower / landscape counts of the train split (whole-cloud datasets
        # know them from the file names; 1 each otherwise, as in JAX)
        counts = [getattr(train_ds, "len_landscape", 1), getattr(train_ds, "len_towers", 1)]
        step_fns = make_cls_step_fns(cfg, get_class_weights(
            args.weighing_method, [max(c, 1) for c in counts], beta=cfg.train.beta), dp=dp)
    trainer = Trainer(cfg, model, batcher(train_ds, cfg.train.seed, repeats),
                      batcher(val_ds, cfg.train.seed + 1), args.out_path,
                      name=f"{args.arch}_{args.task}", task=args.task, device=device,
                      step_fns=step_fns, teacher=teacher, dp=dp,
                      epoch_dispatch=args.epoch_dispatch)
    try:
        if args.model_checkpoint and not trainer.resume(args.model_checkpoint):
            print(f"no checkpoint {args.model_checkpoint!r} under {trainer.ckpt.directory}",
                  file=sys.stderr)
            return 1
        history = trainer.fit(args.epochs)
    finally:
        trainer.close()
    if trainer.writer:
        last = history["val"][-1] if history["val"] else history["train"][-1]
        print(json.dumps({k: v for k, v in last.items() if np.isfinite(v)}, indent=2))
        print(f"checkpoints + logs in {args.out_path}")
    return 0


def cmd_test(args) -> int:
    """Tiled evaluation of the test (else val) list: appends the summary row
    to ``<out_path>/IoU-results.csv`` and prints the summary as JSON. Under
    ``--task classification`` it writes ``classification-results.csv`` and
    ``wrong_predictions.csv`` instead (``run_classification_test``)."""
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.data.datasets import EvalCloudDataset
    from ampnet_tpu_torch.infer.tiled import evaluate_dataset

    _refuse_ensemble(args, args.task)
    if args.task == "classification":
        return run_classification_test(args, resolve_device(args.device))
    _check_views(args)
    _check_figures(args, ("plot", "analysis"))
    device = resolve_device(args.device)
    groups, name = _restore_groups(args, device)
    extra = _extra_features(groups)
    _check_backend(groups, args.backend)
    lists = _load_lists(args.path_list_files)
    ds = EvalCloudDataset(args.dataset_path, lists["test"] or lists["val"], extra_features=extra)
    inferencer = _make_seg_inferencer(groups, args, device, args.max_clusters, args.backend)
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


def run_classification_test(args, device) -> int:
    """``test --task classification``: the checkpoint's eval step over the
    test (else val) list, batches of 4 in list order, with the dataset and
    batcher of the checkpoint's recorded arch (the JAX command's
    ``cmd_test``); prints the metrics as JSON."""
    from ampnet_tpu_torch.data.datasets import CloudDataset, WindowedCloudDataset
    from ampnet_tpu_torch.data.pipeline import PaddedBatcher, SingleCloudBatcher
    from ampnet_tpu_torch.infer.classify import evaluate_classification
    from ampnet_tpu_torch.models.factory import WINDOWED
    from ampnet_tpu_torch.train.cls_step import make_cls_step_fns
    from ampnet_tpu_torch.train.state import create_train_state

    cfg, model, name = _restore_model(args.model_checkpoint, device, args.arch, args.task)
    lists = _load_lists(args.path_list_files, args.task)
    files = lists["test"] or lists["val"]
    if cfg.model.context in WINDOWED:
        ds = WindowedCloudDataset(args.dataset_path, files, task=args.task,
                                  extra_features=cfg.data.extra_features)
        batcher = PaddedBatcher(ds, 4, n_points=cfg.data.n_points,
                                max_windows=cfg.data.max_windows, shuffle=False,
                                drop_last=False)
    else:
        ds = CloudDataset(args.dataset_path, files, task=args.task,
                          number_of_points=cfg.data.n_points,
                          extra_features=cfg.data.extra_features)
        batcher = SingleCloudBatcher(ds, 4, n_points=cfg.data.n_points, shuffle=False,
                                     drop_last=False)
    _, eval_step = make_cls_step_fns(cfg)
    out = evaluate_classification(create_train_state(cfg, model, device=device), eval_step,
                                  batcher, out_dir=args.out_path, model_name=name)
    print(json.dumps(out, indent=2))
    return 0


def cmd_infer(args) -> int:
    """Per-point predictions of every ``.pkl`` cloud in ``dataset_path``:
    ``<stem>_preds.npy`` (int32), and with ``--save_probs`` also
    ``<stem>_probs.npy`` (float16) and ``<stem>_hist.png``. A folder of
    ``.las`` tiles is labelled whole instead (``infer_las_tiles``)."""
    import numpy as np

    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.data.datasets import InferenceCloudDataset
    from ampnet_tpu_torch.data.schema import normalize_xy_neg_one, select_model_features
    from ampnet_tpu_torch.infer.tiled import eval_chunks, predict_chunk

    _check_views(args)
    las_tiles = sorted(glob.glob(os.path.join(args.dataset_path, "*.las")))
    if las_tiles and args.save_probs:
        raise Refused("--save_probs is not supported in whole-tile LAS mode (the output "
                      "is a classified LAS); run on .pkl clouds instead")
    _check_figures(args, ("save_probs",))
    device = resolve_device(args.device)
    groups, _ = _restore_groups(args, device)
    extra = _extra_features(groups)
    _check_backend(groups, args.backend)
    inferencer = _make_seg_inferencer(groups, args, device, None, args.backend)
    if las_tiles:
        return infer_las_tiles(inferencer, las_tiles, args)
    files = [os.path.basename(f)
             for f in sorted(glob.glob(os.path.join(args.dataset_path, "*.pkl")))]
    ds = InferenceCloudDataset(args.dataset_path, files)
    os.makedirs(args.out_path, exist_ok=True)
    for idx in eval_chunks(len(ds), args.tta * args.tile_votes):
        chunk = [ds[i] for i in idx]
        feats = [normalize_xy_neg_one(select_model_features(s["points"], extra))
                 for s in chunk]
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


def infer_las_tiles(inferencer, tiles, args) -> int:
    """Whole-tile mode of ``infer``: each tile's ``<name>_classified.las`` and
    one ``tile_metrics.json`` of every tile's metrics, under ``out_path``."""
    from ampnet_tpu_torch.infer.full_tile import classify_las_file

    os.makedirs(args.out_path, exist_ok=True)
    results = {}
    for t in tiles:
        name = os.path.splitext(os.path.basename(t))[0]
        results[name] = classify_las_file(
            inferencer, t, os.path.join(args.out_path, name + "_classified.las"),
            window_size=args.window_size, tta=args.tta, votes=args.tile_votes,
        )
    with open(os.path.join(args.out_path, "tile_metrics.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"classified {len(tiles)} LAS tiles → {args.out_path}")
    return 0


def cmd_export(args) -> int:
    """One segmenter checkpoint (a port directory or a ``.pth``) as a
    reference ``.pth`` (utils/utils.py:422-438) of its family, attention or
    gru (read from its parameters), with its number_of_points, batch_size and
    lr; the other families are refused with the JAX command's message."""
    from ampnet_tpu_torch.core.device import resolve_device
    from ampnet_tpu_torch.core.weights import flax_variables, reference_arch, save_reference_pth

    cfg, model, name = _restore_model(args.model_checkpoint, resolve_device(args.device),
                                      args.arch)
    variables = flax_variables(model)
    arch = reference_arch(variables)
    meta = {"number_of_points": cfg.data.n_points, "batch_size": cfg.train.batch_size,
            "lr": cfg.train.learning_rate}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_reference_pth(variables, args.out, meta=meta)
    print(f"exported {name} ({arch}) -> {args.out}")
    return 0


def cmd_bench(args) -> int:
    """The bench (``ampnet_tpu_torch/bench.py``) on ``--device``."""
    from ampnet_tpu_torch import bench

    return bench.main(args.device)


def cmd_demo(args) -> int:
    """End-to-end on synthetic data, each stage through its own command:
    synth → preprocess → train ``--arch`` → test (prints ``test``'s summary
    JSON); ``--geom_features`` preprocesses and trains with the geometric
    columns."""
    from ampnet_tpu_torch.core.device import resolve_device

    resolve_device(args.device)  # before any stage: the card unless --device cpu
    base, dev = args.out_path, ["--device", args.device]
    las, data, run = (os.path.join(base, d) for d in ("las", "data", "run"))
    npts = str(args.number_of_points)
    geom = ["--geom_features"] if args.geom_features else []
    max_clusters = max(6, args.points_per_window // args.number_of_points + 1)
    stages = [
        ["synth", "--out_path", las, "--n_tiles", str(args.n_tiles), "--windows_per_tile", "3",
         "--points_per_window", str(args.points_per_window), "--seed", "0"],
        ["preprocess", "--in_path", las, "--out_path", data, "--dataset", "SYNTH",
         "--min_points", "256", "--n_points", npts, "--max_windows", "5", "--seed", "0", *geom],
        ["train", data, "--path_list_files", data, "--out_path", run, "--arch", args.arch,
         "--number_of_points", npts, "--number_of_windows", "5", "--batch_size", "2",
         "--epochs", str(args.epochs), "--seed", "0", *geom, *dev],
        ["test", data, "--path_list_files", data, "--out_path", run, "--model_checkpoint",
         os.path.join(run, "checkpoints", f"{args.arch}_segmentation_best"), "--arch", args.arch,
         "--max_clusters", str(max_clusters), "--backend", args.backend, *dev],
    ]
    parser = build_parser()
    for argv in stages:
        stage = parser.parse_args(argv)
        rc = stage.fn(stage)
        if rc:
            return rc
    return 0


def _add_checkpoint_options(s) -> None:
    s.add_argument("--model_checkpoint", required=True,
                   help="a reference .pth or a checkpoint directory written by train; "
                        "comma-separate several for a probability-averaging ensemble")
    s.add_argument("--arch", default="attention",
                   help="attention | gru | baseline | classic | pointnet2; a checkpoint "
                        "directory's recorded arch wins")
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

    s = sub.add_parser("synth", help="generate synthetic LAS tiles")
    s.add_argument("--out_path", required=True)
    s.add_argument("--n_tiles", type=int, default=4)
    s.add_argument("--windows_per_tile", type=int, default=3)
    s.add_argument("--points_per_window", type=int, default=8000)
    s.add_argument("--window_size", type=float, default=100.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--scene", choices=["easy", "hard"], default="easy",
                   help="hard: class imbalance, building/pole confusers, "
                        "lines-through-canopy, density gradients + dropout holes, "
                        "sensor noise")
    s.add_argument("--terrain_relief", type=float, default=0.0,
                   help="metres of smooth terrain relief under the scene "
                        "(exercises the HAG stage; labels stay in HAG space)")
    s.add_argument("--point_jitter", type=float, default=0.0,
                   help="lognormal sigma on per-window point counts")
    s.add_argument("--landscape_fraction", type=float, default=0.0,
                   help="fraction of windows generated WITHOUT towers/power lines")
    s.set_defaults(fn=cmd_synth)

    s = sub.add_parser("preprocess", help="LAS tiles → windows → 13-col pkl + kmeans artifacts")
    s.add_argument("--in_path", required=True)
    s.add_argument("--out_path", required=True)
    s.add_argument("--dataset", default="DATA")
    s.add_argument("--window_size", type=float, default=100.0)
    s.add_argument("--max_z", type=float, default=100.0)
    s.add_argument("--min_points", type=int, default=1024)
    s.add_argument("--n_points", type=int, default=2048)
    s.add_argument("--max_windows", type=int, default=9)
    s.add_argument("--hag_cell", type=float, default=2.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--artifact_format", choices=["npz", "pt"], default="npz",
                   help="kmeans artifact format (.pt = reference-compatible torch)")
    s.add_argument("--workers", type=int, default=1,
                   help="host process-pool size over tiles (spawned workers)")
    s.add_argument("--assigner", choices=["exact_mcf", "sinkhorn"], default="exact_mcf",
                   help="balanced k-means assigner: exact_mcf = the native min-cost-flow "
                        "solver on the host (exact KMeansConstrained semantics); "
                        "sinkhorn = the port's balanced k-means on --device")
    s.add_argument("--device", default="cuda",
                   help="where --assigner sinkhorn runs: cuda (default) or cpu")
    s.add_argument("--blocks_json", nargs="+", default=None,
                   help="one or more {split: [block names]} JSONs; window names "
                        "containing a block name join that split instead of the "
                        "random split")
    s.add_argument("--geom_features", action="store_true",
                   help="append per-point covariance eigenfeatures (linearity, planarity, "
                        "scatter, verticality, axis_z, radius) computed at full density as "
                        "columns 13..18; pair with `train --geom_features`")
    s.add_argument("--geom_k", type=int, default=24,
                   help="k-NN neighbourhood size for --geom_features (>= 1)")
    s.add_argument("--geom_radius_norm", choices=["absolute", "median"], default="absolute",
                   help="radius-column normalisation: 'median' divides each point's k-th-NN "
                        "distance by the cloud's median (invariant to uniform density "
                        "changes); pair with the same flag on `train`")
    s.set_defaults(fn=cmd_preprocess)

    s = sub.add_parser("fps", help="farthest-point-sample clouds to a fixed size "
                                   "(data_proc/sample_fps.py)")
    s.add_argument("--in_path", required=True)
    s.add_argument("--out_path", required=True)
    s.add_argument("--n_points", type=int, default=8192)
    s.set_defaults(fn=cmd_fps)

    s = sub.add_parser("train", help="train a model (any --arch, either --task)")
    s.add_argument("dataset_path", help="folder of kmeans_<name>.pt / .npz artifacts")
    s.add_argument("--path_list_files", default="train_test_files/RGBN_100x100",
                   help="folder of {train,val,test}_seg_files.txt (classification: "
                        "{train,val,test}_files.txt, else the segmentation lists)")
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
    s.add_argument("--task", choices=["segmentation", "classification"],
                   default="segmentation")
    s.add_argument("--arch", choices=["attention", "gru", "baseline", "classic", "pointnet2"],
                   default="attention",
                   help="attention / gru: windowed k-means artifacts; baseline / classic / "
                        "pointnet2: whole .pkl clouds resampled to --number_of_points")
    s.add_argument("--geom_features", action="store_true",
                   help="feed the geometric eigenfeature columns (a dataset preprocessed "
                        "with `preprocess --geom_features`); recorded in the checkpoint, so "
                        "test / infer / serve read them too")
    s.add_argument("--geom_k", type=int, default=24,
                   help="the k-NN size the dataset's geom columns were preprocessed with "
                        "(>= 1): whole-tile infer recomputes the columns with it")
    s.add_argument("--geom_radius_norm", choices=["absolute", "median"], default="absolute",
                   help="the radius normalisation the dataset's geom columns were "
                        "preprocessed with: whole-tile infer recomputes the columns with it")
    s.add_argument("--local_agg", choices=["none", "edge"], default="none",
                   help="'edge': a kNN edge-feature block (DGCNN-style, residual) after "
                        "mlp_a in the window encoder")
    s.add_argument("--local_agg_k", type=int, default=16,
                   help="neighbours per point for --local_agg edge (>= 1)")
    s.add_argument("--att_geom_tokens", action="store_true",
                   help="add an encoded per-window [mean ‖ max] of the geom columns to the "
                        "attention tokens (needs --geom_features)")
    s.add_argument("--distill_from", default="",
                   help="teacher checkpoint(s), comma-separated like --model_checkpoint "
                        "ensembles (cross-family groups work): the frozen teachers run "
                        "inside the train step on the augmented batch")
    s.add_argument("--distill_alpha", type=float, default=0.5,
                   help="weight of the T^2*KL teacher term (with --distill_from): "
                        "(1-a)*CE + a*KL")
    s.add_argument("--distill_temp", type=float, default=2.0,
                   help="distillation softmax temperature (> 0)")
    s.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel ranks, one process each: NCCL on cuda:0..N-1, or "
                        "gloo with --device cpu; --batch_size is the global batch")
    s.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="compute dtype (parameters stay float32); recorded in the checkpoint, "
                        "so test / infer / serve --backend xla evaluate in it too")
    s.add_argument("--epoch_dispatch", choices=["auto", "off"], default="auto",
                   help="auto: run each epoch over the card-resident cache as one loop with "
                        "one metrics fetch; off: the per-step path")
    s.add_argument("--oversample_factor", type=int, default=1,
                   help="rare-class oversampling: train clouds holding a rare class appear N "
                        "times an epoch (1 = off)")
    s.add_argument("--oversample_classes", default="auto",
                   help="comma list of class ids to oversample, or 'auto' = the classes under "
                        "5%% of the valid train points")
    s.add_argument("--seg_weighing", default="",
                   help="data-driven CE class weights for segmentation (EFS|INS|ISNS|sklearn, "
                        "from the train label histogram); default: the fixed [1,2,2,1,1]")
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser("test", help="tiled evaluation with the IoU CSV")
    s.add_argument("dataset_path", help="folder of 13-column .pkl clouds")
    _add_checkpoint_options(s)
    s.add_argument("--path_list_files", required=True,
                   help="folder of test_seg_files.txt (else val_seg_files.txt); "
                        "classification: test_files.txt, else the segmentation lists")
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

    s = sub.add_parser("infer", help="label-free per-point predictions of .pkl clouds; "
                                     "with .las tiles in the folder, whole-tile LAS → LAS")
    s.add_argument("dataset_path", help="folder of 13-column .pkl clouds or of .las tiles")
    _add_checkpoint_options(s)
    s.add_argument("--out_path", default="predictions")
    s.add_argument("--window_size", type=float, default=100.0,
                   help="footprint of a window in metres (whole-tile LAS mode)")
    _add_inference_options(s, "xla")
    s.add_argument("--save_probs", action="store_true",
                   help="also write <name>_probs.npy (float16 softmax) and a confidence "
                        "histogram <name>_hist.png (needs matplotlib)")
    _add_view_options(s)
    s.set_defaults(fn=cmd_infer)

    s = sub.add_parser("export", help="an attention or gru segmenter checkpoint as a "
                                      "reference .pth")
    s.add_argument("--model_checkpoint", required=True,
                   help="a checkpoint directory written by train, or a .pth")
    s.add_argument("--out", required=True, help="output .pth path")
    s.add_argument("--arch", default="attention",
                   help="the family is read from the checkpoint's parameters")
    s.add_argument("--device", default="cuda",
                   help="where the checkpoint is restored: cuda (default) or cpu")
    s.set_defaults(fn=cmd_export)

    s = sub.add_parser("serve", help="long-lived HTTP inference server")
    _add_checkpoint_options(s)
    s.add_argument("--task", choices=["segmentation", "classification"],
                   default="segmentation",
                   help="segmentation: per-point labels; classification: one "
                        "tower/no-tower label (+ probabilities) per cloud")
    s.add_argument("--num_devices", type=int, default=1,
                   help="shard each bucket's clouds over replicas of the model on "
                        "cuda:0..N-1 (or the CPU N times with --device cpu)")
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

    s = sub.add_parser("bench", help="single-card throughput benchmark of the flagship "
                                     "forward (backend from AMPNET_BACKEND) and train steps")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("demo", help="synthetic end-to-end pipeline")
    s.add_argument("--out_path", default="/tmp/ampnet_demo")
    s.add_argument("--arch", choices=["attention", "gru", "baseline", "classic", "pointnet2"],
                   default="attention", help="the family the train stage trains")
    s.add_argument("--n_tiles", type=int, default=3)
    s.add_argument("--points_per_window", type=int, default=6000)
    s.add_argument("--number_of_points", type=int, default=512)
    s.add_argument("--epochs", type=int, default=3)
    s.add_argument("--backend", choices=list(BACKENDS), default="xla",
                   help="inference backend of the test stage")
    s.add_argument("--geom_features", action="store_true",
                   help="preprocess and train with the geometric eigenfeature columns")
    s.add_argument("--device", default="cuda",
                   help="where train and test run: cuda (default) or cpu")
    s.set_defaults(fn=cmd_demo)
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
