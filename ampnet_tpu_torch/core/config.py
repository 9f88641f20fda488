"""Typed configuration — the single source of truth for every constant.

The port's own copy of ``ampnet_tpu/core/config.py`` (the port imports nothing
of the JAX package): the same dataclasses, fields and JSON form, so a config
written by one package reads in the other.

The reference scatters its de-facto config across module-level constants and argparse
defaults (ATT_HEADS/GLOBAL_FEAT_SIZE at ``self-attention/train_pointnet-attention.py:25-26``,
N_POINTS/MAX_WINDOWS at ``pointNet/collate_fns.py:17-18``, MAX_CLUSTERS at
``self-attention/test_pointnet_att_segmen.py:39`` and ``utils/utils.py:483,494``,
HIDDEN_SIZE at ``rnn/train_pointnetGRU.py:28``, training defaults at
``self-attention/train_pointnet-attention.py:488-496``). Here they all live in frozen
dataclasses so a run is fully described by one `AMPNetConfig`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Dataset / batching geometry.

    Mirrors the reference's canonical 13-column schema
    (``data_proc/2_preprocessing_filter_norm.py:76-86``) and padded window batching
    (``pointNet/collate_fns.py:4-55``).
    """

    # points per window (reference N_POINTS, collate_fns.py:17)
    n_points: int = 2048
    # max windows per cloud at train time (reference MAX_WINDOWS, collate_fns.py:18)
    max_windows: int = 9
    # max clusters at test time (reference MAX_CLUSTERS=18 default, 25 alt;
    # utils/utils.py:483, test_pointnet_att_segmen.py:39)
    max_clusters_test: int = 18
    # number of input features fed to the model: [x,y,z,I,R,G,B,NIR,NDVI]
    # (datasets.py:359 drops col 3 = class from the 13/11-col array)
    num_features: int = 9
    # offline geometric eigenfeature columns appended after the 9 model
    # features (preproc/geomfeat.py via `ampnet preprocess --geom_features`;
    # 0 = the reference feature set). Carried in checkpoint meta so test/infer
    # rebuild the same input schema automatically.
    extra_features: int = 0
    # radius-column density normalization the geom columns were preprocessed
    # with ('absolute' | 'median', preproc/geomfeat.py::geometric_features);
    # recorded here so whole-tile LAS inference (infer/full_tile.py), which
    # RECOMPUTES the eigenfeatures from raw coordinates, reproduces the
    # training-time schema. 'median' is the density-shift-robust mode
    # (BASELINE.md density÷2 arm).
    geom_radius_norm: str = "absolute"
    # k-NN neighborhood size the geom columns were preprocessed with
    # (`preprocess --geom_k`); recorded for the same reason as
    # geom_radius_norm — whole-tile LAS inference recomputes the
    # eigenfeatures and must use the training-time neighborhood
    geom_k: int = 24
    # ASPRS-ish classes dropped at dataset load. NOTE: the reference also drops 14
    # (power lines) here, which makes the cables class unlearnable — see
    # data/schema.py DATASET_NOISE_CLASSES for the full account
    noise_classes: Tuple[int, ...] = (30, 7, 2, 8, 13)
    # classes dropped during offline preprocessing (2_preprocessing_filter_norm.py:41-48)
    preproc_drop_classes: Tuple[int, ...] = (2, 7, 8, 13, 24, 30)
    # HAG clip ceiling in metres (2_preprocessing_filter_norm.py:51-53)
    max_height_m: float = 100.0
    # ground-footprint window size in metres (1_get_windows_split.py CLI; paper 100/40)
    window_size_m: float = 100.0
    # columns used as k-means features in offline tiling: x, y, NDVI
    # (3_kmeans.py:78-82 uses [0,1,9] of 13 cols; utils.py:504 uses [0,1,8] of 11 cols)
    kmeans_feature_cols: Tuple[int, ...] = (0, 1, 9)


@dataclass(frozen=True)
class ModelConfig:
    """AMP-Net model family hyperparameters.

    Defaults mirror the primary AMP-Net run: 256-d global feature, 8 attention heads,
    64-d local features, 5 segmentation classes
    (``self-attention/train_pointnet-attention.py:25-26,110-118``).
    """

    num_classes: int = 5
    point_dim: int = 3  # coords fed through the input T-Net (train script uses 3)
    global_feat: int = 256
    local_feat: int = 64
    att_heads: int = 8
    dropout: float = 0.3
    # pluggable cross-window context: 'attention' | 'gru' | 'none'
    context: str = "attention"
    gru_hidden: int = 64  # rnn/train_pointnetGRU.py:28
    # BatchNorm momentum/eps matching torch defaults (nn.BatchNorm1d)
    bn_momentum: float = 0.9  # flax convention: ra = m*ra + (1-m)*x ; torch 0.1 ≡ 0.9 here
    bn_eps: float = 1e-5
    # 'batch' = reference-parity global batch statistics; 'window' = per-window
    # (instance-norm-style) statistics — train/eval symmetric, batch-independent
    # encodings. Measured (docs/design.md): no train-step speedup on this stack
    # and −8 mIoU at an 80-epoch synthetic budget — keep 'batch' unless you have
    # a reason.
    bn_mode: str = "batch"
    # compute dtype (params stay float32): None → float32; "bfloat16" halves
    # activation/residual HBM traffic — measured 69.3→44.2 ms/train-step (+57%
    # throughput) at the bench geometry on one v5e. A string so configs stay
    # JSON-serializable; flax canonicalizes it.
    dtype: Any = None
    # rematerialize the window encoder in the backward pass: its per-point
    # activations ([B*W, N, 64..256] × several layers) dominate residual HBM
    # traffic; recomputing them trades a cheap MXU-bound extra forward for
    # gigabytes of reads (jax.checkpoint / nn.remat)
    remat: bool = False
    # kNN edge-feature aggregation inside the window encoder: 'none' keeps the
    # reference's pointwise trunk (pointnetAtt.py:88-96); 'edge' adds a
    # DGCNN-style residual block (models/amp.py::EdgeLocalAggregation) that
    # targets the boundary errors the round-3 anatomy attributes ~72 % of
    # remaining tower mistakes to (BASELINE.md "Error anatomy")
    local_agg: str = "none"
    local_agg_k: int = 16
    # geometry-aware attention tokens (opt-in): pool the offline eigenfeature
    # columns (input cols 9..) per window [mean ‖ max] and add an encoded
    # summary to each attention token, so window KEYS/QUERIES carry structure
    # ("contains vertical-linear lattice") and not just centroid position —
    # the last structural lever the round-4 anatomy licenses (VERDICT r4 #8;
    # ref tokens see only pos-enc, pointnetAtt.py:183-190). 'false' keeps the
    # exact reference parameter tree.
    att_geom_tokens: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule of the AMP-Net trainer
    (``self-attention/train_pointnet-attention.py:127-149,488-496``)."""

    batch_size: int = 32
    learning_rate: float = 1e-3
    epochs: int = 500
    lr_milestones: Tuple[int, ...] = (150, 250, 350)
    lr_gamma: float = 0.5
    # weighted CE over the 5 seg classes (train_pointnet-attention.py:127)
    class_weights: Tuple[float, ...] = (1.0, 2.0, 2.0, 1.0, 1.0)
    # feature-transform orthogonality regularizer weight (…:467)
    reg_weight: float = 1e-3
    ignore_index: int = -1
    seed: int = 0
    # class-weighting scheme for classification: 'EFS'|'INS'|'ISNS'|'sklearn'|'none'
    weighing_method: str = "EFS"
    beta: float = 0.999  # EFS beta (…:495)
    # stop after this many epochs without val improvement; 0 = never (the
    # reference baseline/GRU trainers exit at 100, baseline/train_segmentation.py:266)
    early_stop_patience: int = 0
    # halve the LR after this many epochs without improvement; 0 = never
    # (reference adjust_learning_rate plateau decay, train_classification.py:159-160)
    plateau_patience: int = 0
    plateau_gamma: float = 0.5
    # augmentation recipe applied inside the jitted train step; the first two are
    # the reference's (train_pointnet-attention.py:390-405), the rest are the
    # utils.py:940-1032 extras
    augmentations: Tuple[str, ...] = ("shuffle_windows", "rotate_z")
    # data-parallel device count hint (1 = single chip); the mesh is built at runtime
    num_devices: int = 1
    # split each batch into K micro-batches with one accumulated optimizer
    # update — a memory lever for batches whose residuals exceed HBM
    # (train/step.py grad_accum path; docs/design.md batch-scaling study)
    grad_accum: int = 1
    # focal-loss exponent for segmentation CE (0 = plain weighted CE, the
    # reference objective); γ>0 fades well-classified points so the gradient
    # concentrates on hard/rare ones (train/losses.py::weighted_focal_parts)
    focal_gamma: float = 0.0
    # write best-val checkpoints from a background thread (device copies are
    # snapshotted on the loop, fetch + orbax write happen off the critical
    # path); False = the reference's inline-save behavior
    async_checkpoint: bool = True
    # knowledge distillation (train/distill.py): weight of the T²·KL teacher
    # term in the data loss — (1−α)·CE + α·KL; 0 disables. The teacher
    # checkpoints arrive separately (`ampnet train --distill_from a,b,...`)
    distill_alpha: float = 0.0
    distill_temp: float = 2.0


@dataclass(frozen=True)
class AMPNetConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            raise TypeError(o)

        return json.dumps(dataclasses.asdict(self), default=enc, indent=2)

    @staticmethod
    def from_json(s: str) -> "AMPNetConfig":
        raw = json.loads(s)

        def mk(cls, d):
            fields = {f.name for f in dataclasses.fields(cls)}
            kw = {}
            for k, v in d.items():
                if k not in fields:
                    continue
                kw[k] = tuple(v) if isinstance(v, list) else v
            return cls(**kw)

        return AMPNetConfig(
            data=mk(DataConfig, raw.get("data", {})),
            model=mk(ModelConfig, raw.get("model", {})),
            train=mk(TrainConfig, raw.get("train", {})),
        )

    def replace(self, **kw) -> "AMPNetConfig":
        return dataclasses.replace(self, **kw)
