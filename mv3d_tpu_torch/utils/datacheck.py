"""Data integrity checks and train/validation splits.

Port of ``mv3d_tpu/utils/datacheck.py``: ``check_preprocessed_dir`` (a
preprocessed dump's subdirectories hold one tag set),
``check_kitti_object_dir``, ``split_train_val`` and
``write_split_files``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def check_preprocessed_dir(root: str,
                           subdirs: Sequence[str] = ("top", "gt_boxes3d",
                                                     "gt_labels")) -> Dict:
    """Verify that every dump subdir holds the same tag set.

    Returns {'ok': bool, 'counts': {subdir: n}, 'missing': {subdir: [tags]}}.
    """
    tag_sets = {}
    for sub in subdirs:
        tags = set()
        for f in glob.glob(os.path.join(root, sub, "*")):
            base = os.path.basename(f)
            for ext in (".npy.npz", ".npy", ".png"):
                if base.endswith(ext):
                    base = base[: -len(ext)]
                    break
            tags.add(base)
        tag_sets[sub] = tags
    union = set().union(*tag_sets.values()) if tag_sets else set()
    missing = {sub: sorted(union - tags) for sub, tags in tag_sets.items()}
    return {"ok": all(not m for m in missing.values()),
            "counts": {s: len(t) for s, t in tag_sets.items()},
            "missing": missing}


def split_train_val(tags: Sequence[str], train_fraction: float = 0.7,
                    seed: int = 0, by_drive: bool = True
                    ) -> Tuple[List[str], List[str]]:
    """Split frame tags into train/val.

    With ``by_drive`` frames of one drive (tag prefix before the trailing
    frame index) stay together.
    """
    rng = np.random.RandomState(seed)
    if by_drive:
        groups: Dict[str, List[str]] = {}
        for t in tags:
            key = t.rsplit("_", 1)[0] if "_" in t else t[:2]
            groups.setdefault(key, []).append(t)
        keys = sorted(groups)
        rng.shuffle(keys)
        n_train = int(round(train_fraction * len(keys)))
        train_keys = set(keys[:n_train])
        train = [t for k in sorted(train_keys) for t in groups[k]]
        val = [t for k in sorted(set(keys) - train_keys) for t in groups[k]]
        return train, val
    tags = list(tags)
    rng.shuffle(tags)
    n = int(round(train_fraction * len(tags)))
    return sorted(tags[:n]), sorted(tags[n:])


def write_split_files(train: Sequence[str], val: Sequence[str],
                      out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(train) + "\n")
    with open(os.path.join(out_dir, "val.txt"), "w") as f:
        f.write("\n".join(val) + "\n")


def check_kitti_object_dir(root: str, sub: str = "training",
                           require_labels: bool = True) -> Dict:
    """Validate a raw KITTI object-benchmark directory layout.

    Checks that ``<root>/<sub>/{velodyne,image_2[,label_2]}`` exist and hold
    the same frame-tag set.

    Returns {'ok': bool, 'counts': {subdir: n}, 'missing': {subdir: [tags]},
    'tags': sorted common tags}.
    """
    subdirs = ["velodyne", "image_2"] + (["label_2"] if require_labels else [])
    tag_sets = {}
    for s in subdirs:
        d = os.path.join(root, sub, s)
        if not os.path.isdir(d):
            return {"ok": False, "counts": {}, "missing": {s: ["<dir absent>"]},
                    "tags": []}
        tag_sets[s] = {os.path.splitext(os.path.basename(f))[0]
                       for f in os.listdir(d) if not f.startswith(".")}
    union = set().union(*tag_sets.values())
    missing = {s: sorted(union - t) for s, t in tag_sets.items()}
    ok = bool(union) and all(not m for m in missing.values())
    return {"ok": ok, "counts": {s: len(t) for s, t in tag_sets.items()},
            "missing": missing,
            "tags": sorted(set.intersection(*tag_sets.values()))}
