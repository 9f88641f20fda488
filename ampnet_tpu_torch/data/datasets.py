"""Dataset classes over preprocessed artifacts, the port's own copies of
``ampnet_tpu/data/datasets.py``:

| here                   | reference              | artifact                      |
|------------------------|------------------------|-------------------------------|
| WindowedCloudDataset   | LidarKmeansDataset     | kmeans_<f>.pt [N, 13, W]      |
| CloudDataset           | LidarDataset /         | <f>.pkl [N, 11..13]           |
|                        | LidarDatasetExpanded   |                               |
| EvalCloudDataset       | LidarDataset4Test      | <f>.pkl, variable N + labels  |
| InferenceCloudDataset  | LidarInferenceDataset  | <f>.pkl raw, no labels        |

Samples are plain numpy; the batchers (data/pipeline.py) own resampling and
padding, so every tensor that reaches the device has a static shape. Under
``task="classification"`` a sample also carries ``cls_label`` (tower or not).
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from ampnet_tpu_torch.data import schema as S
from ampnet_tpu_torch.data.io_utils import load_cloud


def resample_points(pc: np.ndarray, n_points: int, rng: np.random.Generator) -> np.ndarray:
    """Fixed-size point resampling with the reference LidarDataset semantics
    (datasets.py:80-89): sample WITHOUT replacement above ``n_points``; below it
    keep every original point and append random duplicates."""
    n = pc.shape[0]
    if n > n_points:
        return pc[rng.choice(n, n_points, replace=False)]
    if n < n_points:
        return np.concatenate([pc, pc[rng.integers(0, n, n_points - n)]], axis=0)
    return pc


class WindowedCloudDataset:
    """Pre-tiled clouds ``[N, 13, W]`` (the offline k-means artifacts
    ``kmeans_<name>.pt``, or ``.npz`` under the same name).

    Drops noise-class point rows, remaps labels, selects the 9 model features,
    rescales x/y to [-1, 1] and computes per-window x/y centroids. Samples are
    window-major: points ``[W, N, 9]``, labels ``[W, N]``, centroids ``[W, 2]``.
    """

    def __init__(self, dataset_folder: str, files: Sequence[str], task: str = "segmentation",
                 noise_classes: Sequence[int] = S.DATASET_NOISE_CLASSES):
        self.task = task
        self.noise_classes = tuple(noise_classes)
        stems = [os.path.join(dataset_folder, "kmeans_" + os.path.splitext(f)[0]) for f in files]
        self.paths = [s + ".pt" if os.path.exists(s + ".pt") else s + ".npz" for s in stems]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        pc = S.drop_noise_points(load_cloud(self.paths[index]), self.noise_classes)
        raw_cls = pc[:, S.COL.CLASS, :]  # [N, W]
        feats = np.concatenate([pc[:, 0:3, :], pc[:, 4:10, :]], axis=1)  # [N, 9, W]
        feats[:, 0, :] = feats[:, 0, :] * 2 - 1
        feats[:, 1, :] = feats[:, 1, :] * 2 - 1
        points = np.ascontiguousarray(feats.transpose(2, 0, 1))  # [W, N, 9]
        sample = {
            "points": points.astype(np.float32),
            "labels": np.ascontiguousarray(S.remap_segmentation_labels(raw_cls).T).astype(
                np.int32),  # [W, N]
            "centroids": points[:, :, :2].mean(axis=1).astype(np.float32),  # [W, 2]
            "name": os.path.basename(self.paths[index]),
        }
        if self.task == "classification":
            sample["cls_label"] = S.classification_label(raw_cls)
        return sample


class CloudDataset:
    """Whole clouds resampled to ``number_of_points`` (the baseline scripts).

    ``feature_mode='nine'``: [x,y,z,I,R,G,B,NIR,NDVI] with x,y → [-1, 1] and
    noise-class points dropped (LidarDatasetExpanded, datasets.py:145-292);
    ``'seven'``: [x,y,z,I,G,B,NDVI] with the classification label from the
    file name (``tower_`` prefix, LidarDataset, datasets.py:9-142). The
    resampling draws from one ``default_rng(seed)`` in read order, as in the
    JAX dataset. (The JAX dataset's ``fixed_num_points`` and the legacy
    11-column ``constrained_sample`` are left out: no caller sets them.)"""

    def __init__(self, dataset_folder: str, files: Sequence[str], task: str = "segmentation",
                 number_of_points: int = 4096, feature_mode: str = "nine", seed: int = 0,
                 extra_features: int = 0):
        S.refuse_extra_features(extra_features)
        self.files = list(files)
        self.paths = [os.path.join(dataset_folder, f) for f in self.files]
        self.task = task
        self.n_points = number_of_points
        self.feature_mode = feature_mode
        self.rng = np.random.default_rng(seed)
        # filename-prefix classes (LidarDataset._init_mapping, datasets.py:36-45)
        self.class_of = {f: 1 if "tower_" in f else 0 for f in self.files}
        self.len_towers = sum(self.class_of.values())
        self.len_landscape = len(self.files) - self.len_towers

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        pc = load_cloud(self.paths[index])  # [N, >=10]
        if self.feature_mode == "nine":
            pc = S.drop_noise_points(pc, S.DATASET_NOISE_CLASSES)
        pc = resample_points(pc, self.n_points, self.rng)
        raw_cls = pc[:, S.COL.CLASS]
        if self.feature_mode == "nine":
            feats = S.select_model_features(pc)
            feats[:, 0] = feats[:, 0] * 2 - 1
            feats[:, 1] = feats[:, 1] * 2 - 1
        else:  # 'seven' (datasets.py:63)
            feats = np.concatenate([pc[:, 0:3], pc[:, 4:5], pc[:, 6:8], pc[:, 9:10]], axis=1)
        sample = {
            "points": feats.astype(np.float32),
            "labels": S.remap_segmentation_labels(raw_cls).astype(np.int32),
            "name": self.files[index],
        }
        if self.task == "classification":
            sample["cls_label"] = (np.int32(self.class_of[self.files[index]])
                                   if self.feature_mode == "seven"
                                   else S.classification_label(raw_cls))
        return sample


class EvalCloudDataset:
    """Variable-size clouds for evaluation: the 9 model features with x/y
    rescaled to [-1, 1], remapped labels and the raw class column
    (LidarDataset4Test, datasets.py:463-515). Noise classes are kept: the
    reference's tester evaluates every point."""

    def __init__(self, dataset_folder: str, files: Sequence[str], extra_features: int = 0):
        S.refuse_extra_features(extra_features)
        self.files = list(files)
        self.paths = [os.path.join(dataset_folder, f) for f in self.files]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        pc = load_cloud(self.paths[index])
        feats = S.select_model_features(pc)
        feats[:, 0] = feats[:, 0] * 2 - 1
        feats[:, 1] = feats[:, 1] * 2 - 1
        return {
            "points": feats.astype(np.float32),
            "labels": S.remap_segmentation_labels(pc[:, S.COL.CLASS]).astype(np.int32),
            "raw_class": pc[:, S.COL.CLASS].astype(np.int32),
            "name": self.files[index],
        }


class InferenceCloudDataset:
    """Label-free raw clouds (LidarInferenceDataset, datasets.py:518-565)."""

    def __init__(self, dataset_folder: str, files: Sequence[str]):
        self.files = list(files)
        self.paths = [os.path.join(dataset_folder, f) for f in self.files]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return {"points": load_cloud(self.paths[index]), "name": self.files[index]}
