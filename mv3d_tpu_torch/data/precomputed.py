"""Dataset over offline-preprocessed view dumps.

Port of ``mv3d_tpu/data/precomputed.py``: reads the layout
:mod:`mv3d_tpu_torch.data.preprocess` writes (``top/*.npy.npz`` key
``top_view``, and ``top_view_aux`` for the ``s2d2p`` pair, ``front``,
``rgb`` PNGs through the port's reader, the gt arrays) and
stacks frames into view-based ``Trainer`` batches.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from ..config import Config, cfg as _default_cfg
from .kitti import read_image


class PrecomputedViewDataset:
    """Indexable precomputed-view dataset; ``load_views(i)`` returns a dict
    with top/front/rgb/gt arrays ready for the view-based train step."""

    def __init__(self, root: str, cfg: Config = _default_cfg,
                 tags: Optional[List[str]] = None):
        self.root = root
        self.cfg = cfg
        if tags is None:
            files = sorted(glob.glob(os.path.join(root, "top", "*.npy.npz")))
            tags = [os.path.basename(f)[: -len(".npy.npz")] for f in files]
        self.tags = tags

    def __len__(self):
        return len(self.tags)

    def load_views(self, i: int) -> Dict[str, np.ndarray]:
        tag = self.tags[i]
        out: Dict[str, np.ndarray] = {"tag": tag}
        with np.load(os.path.join(self.root, "top", tag + ".npy.npz")) as z:
            top = z["top_view"].astype(np.float32)
            if "top_view_aux" in z.files:
                top = (top, z["top_view_aux"].astype(np.float32))
            out["top"] = top
        front_path = os.path.join(self.root, "front", tag + ".npy.npz")
        if os.path.exists(front_path):
            with np.load(front_path) as z:
                out["front"] = z["front_view"].astype(np.float32)
        else:
            out["front"] = np.zeros(self.cfg.front_shape, np.float32)
        rgb_path = os.path.join(self.root, "rgb", tag + ".png")
        if os.path.exists(rgb_path):
            out["rgb"] = read_image(rgb_path).astype(np.float32)
        else:
            out["rgb"] = np.zeros(self.cfg.rgb_shape, np.float32)
        out["gt_boxes3d"] = np.load(
            os.path.join(self.root, "gt_boxes3d", tag + ".npy"))
        out["gt_labels"] = np.load(
            os.path.join(self.root, "gt_labels", tag + ".npy"))
        return out

    def load_batch(self, indices) -> Dict[str, np.ndarray]:
        """Stack and pad several frames into a view-based Trainer batch."""
        g = self.cfg.pipeline.max_gt
        frames = [self.load_views(i) for i in indices]
        b = len(frames)
        tops = [f["top"] for f in frames]
        batch = {
            "top": (tuple(np.stack(x) for x in zip(*tops))
                    if isinstance(tops[0], tuple) else np.stack(tops)),
            "front": np.stack([f["front"] for f in frames]),
            "rgb": np.stack([f["rgb"] for f in frames]),
            "gt_boxes3d": np.zeros((b, g, 8, 3), np.float32),
            "gt_labels": np.zeros((b, g), np.int32),
            "gt_mask": np.zeros((b, g), bool),
            "tags": [f["tag"] for f in frames],
        }
        for i, f in enumerate(frames):
            m = min(len(f["gt_boxes3d"]), g)
            batch["gt_boxes3d"][i, :m] = f["gt_boxes3d"][:m]
            batch["gt_labels"][i, :m] = f["gt_labels"][:m]
            batch["gt_mask"][i, :m] = True
        return batch
