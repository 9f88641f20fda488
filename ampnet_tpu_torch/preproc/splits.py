"""The port's own copy of ``ampnet_tpu/preproc/splits.py``.

Stage 4 — train/val/test split-list generation
(``data_proc/generate_train_test_lists.py:106-210``).

The reference assigns window files to splits by the geographic *block* their name
embeds (``<prefix><DATASET>_<block>_w<i>``), with per-dataset JSONs mapping block →
split. Same mechanism here, dataset-agnostic: a ``{split: [block substrings]}``
mapping, plus a seeded random fallback for data without block structure.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ampnet_tpu_torch.data.io_utils import write_split_list


def assign_by_blocks(
    files: Sequence[str], blocks: Dict[str, Sequence[str]]
) -> Dict[str, List[str]]:
    """blocks: {'train': [...block names...], 'val': [...], 'test': [...]}.
    A file joins the split of the first block name its filename contains."""
    out: Dict[str, List[str]] = {split: [] for split in blocks}
    unmatched = []
    for f in files:
        for split, names in blocks.items():
            if any(b in f for b in names):
                out[split].append(f)
                break
        else:
            unmatched.append(f)
    out["unmatched"] = unmatched
    return out


def assign_random(
    files: Sequence[str],
    fractions: Dict[str, float] = None,
    seed: int = 0,
) -> Dict[str, List[str]]:
    fractions = fractions or {"train": 0.8, "val": 0.1, "test": 0.1}
    rng = np.random.default_rng(seed)
    files = list(files)
    rng.shuffle(files)
    out, start = {}, 0
    splits = list(fractions)
    for i, split in enumerate(splits):
        stop = len(files) if i == len(splits) - 1 else start + int(len(files) * fractions[split])
        out[split] = sorted(files[start:stop])
        start = stop
    return out


def generate_split_lists(
    files: Sequence[str],
    out_dir: str,
    task: str = "segmentation",
    blocks: Optional[Dict[str, Sequence[str]]] = None,
    fractions: Optional[Dict[str, float]] = None,
    seed: int = 0,
) -> Dict[str, List[str]]:
    """Write ``{split}_{seg_files|files}.txt`` like the reference trainers read
    (train_pointnet-attention.py:52-60)."""
    assigned = (
        assign_by_blocks(files, blocks) if blocks else assign_random(files, fractions, seed)
    )
    tag = "seg_files" if task == "segmentation" else "files"
    for split in ("train", "val", "test"):
        if split in assigned:
            write_split_list(os.path.join(out_dir, f"{split}_{tag}.txt"), assigned[split])
    return assigned
