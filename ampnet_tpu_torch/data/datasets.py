"""Windowed training clouds, the port's own copy of
``ampnet_tpu/data/datasets.py::WindowedCloudDataset`` (the reference's
LidarKmeansDataset, ``pointNet/datasets.py:295-460``).

Samples are plain numpy; the batchers (data/pipeline.py) own resampling and
padding, so every tensor that reaches the device has a static shape.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from ampnet_tpu_torch.data import schema as S
from ampnet_tpu_torch.data.io_utils import load_cloud


class WindowedCloudDataset:
    """Pre-tiled clouds ``[N, 13, W]`` (the offline k-means artifacts
    ``kmeans_<name>.pt``, or ``.npz`` under the same name).

    Drops noise-class point rows, remaps labels, selects the 9 model features,
    rescales x/y to [-1, 1] and computes per-window x/y centroids. Samples are
    window-major: points ``[W, N, 9]``, labels ``[W, N]``, centroids ``[W, 2]``.
    """

    def __init__(self, dataset_folder: str, files: Sequence[str],
                 noise_classes: Sequence[int] = S.DATASET_NOISE_CLASSES):
        self.noise_classes = tuple(noise_classes)
        stems = [os.path.join(dataset_folder, "kmeans_" + os.path.splitext(f)[0]) for f in files]
        self.paths = [s + ".pt" if os.path.exists(s + ".pt") else s + ".npz" for s in stems]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        pc = S.drop_noise_points(load_cloud(self.paths[index]), self.noise_classes)
        labels = S.remap_segmentation_labels(pc[:, S.COL.CLASS, :])  # [N, W]
        feats = np.concatenate([pc[:, 0:3, :], pc[:, 4:10, :]], axis=1)  # [N, 9, W]
        feats[:, 0, :] = feats[:, 0, :] * 2 - 1
        feats[:, 1, :] = feats[:, 1, :] * 2 - 1
        points = np.ascontiguousarray(feats.transpose(2, 0, 1))  # [W, N, 9]
        return {
            "points": points.astype(np.float32),
            "labels": np.ascontiguousarray(labels.T).astype(np.int32),  # [W, N]
            "centroids": points[:, :, :2].mean(axis=1).astype(np.float32),  # [W, 2]
            "name": os.path.basename(self.paths[index]),
        }
