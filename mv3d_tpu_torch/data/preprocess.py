"""Offline preprocessing: dump per-frame views and gt in the reference
layout.

Port of ``mv3d_tpu/data/preprocess.py``. Under ``out_dir``:

    rgb/<tag>.png            the camera frame, resized to cfg.rgb_shape
    top/<tag>.npy.npz        BEV view       (npz key 'top_view')
    front/<tag>.npy.npz      front view     (npz key 'front_view')
    top_image/<tag>.png      BEV visualization
    gt_boxes3d/<tag>.npy     (N, 8, 3) lidar gt corners
    gt_labels/<tag>.npy      (N,) labels

Frames are voxelized in batches on ``device`` by
:func:`mv3d_tpu_torch.ops.voxelize.lidar_to_top_batch` and
``lidar_to_front_batch``: on the card in ``"hwc"`` through the fused sweep
(K1), on the CPU through its plain version (the JAX ``Preprocessor``'s
``device=False`` numpy oracle, which it equals bit for bit). The views are
dumped in ``pipeline.view_layout`` (the ``s2d2p`` pair as two arrays, keys
``top_view`` and ``top_view_aux``). PNGs are written by
:mod:`mv3d_tpu_torch.utils.png`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Config, cfg as _default_cfg
from ..ops.voxelize import lidar_to_front_batch, lidar_to_top_batch
from ..utils.png import write_png
from ..utils.viz import draw_top_image
from .loader import prepare_rgb


def draw_front_image(front: np.ndarray) -> np.ndarray:
    """Channel-summed, normalized front image."""
    img = np.sum(front, axis=2)
    img = img - img.min()
    div = img.max() - img.min()
    img = img / div * 255 if div > 0 else img
    return np.dstack([img, img, img]).astype(np.uint8)


class Preprocessor:
    """Batched voxelization of a dataset into the dump layout, on
    ``device`` (the card by default)."""

    def __init__(self, out_dir: str, cfg: Config = _default_cfg,
                 batch_size: int = 4, device="cuda",
                 save_images: bool = True):
        from ..train.trainer import resolve_device
        self.out_dir = out_dir
        self.cfg = cfg
        self.batch_size = batch_size
        self.save_images = save_images
        self.device = resolve_device(device)
        for sub in ("rgb", "top", "front", "top_image", "gt_boxes3d",
                    "gt_labels"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    @torch.inference_mode()
    def _voxelize(self, points: np.ndarray, nums: np.ndarray):
        """(B, N, 4) padded points -> host top views (an array, or the
        pair of arrays in ``s2d2p``) and front views."""
        pts = torch.from_numpy(points).to(self.device)
        num = torch.from_numpy(nums).to(self.device)
        top = lidar_to_top_batch(pts, self.cfg, num)
        front = lidar_to_front_batch(pts, self.cfg, num)

        def host(t):
            return t.float().cpu().numpy()
        top = (tuple(host(t) for t in top) if isinstance(top, tuple)
               else host(top))
        return top, host(front)

    def run(self, dataset, indices: Optional[Sequence[int]] = None) -> int:
        """Process frames [indices] of a dataset exposing ``load_frame(i)``;
        returns how many were written."""
        n_pts = self.cfg.pipeline.max_points
        indices = (list(range(len(dataset))) if indices is None
                   else list(indices))
        done = 0
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start:start + self.batch_size]
            frames = [dataset.load_frame(i) for i in chunk]
            pts = np.full((len(frames), n_pts, 4), -1e9, np.float32)
            nums = np.zeros(len(frames), np.int32)
            for i, f in enumerate(frames):
                k = min(len(f.points), n_pts)
                pts[i, :k] = f.points[:k]
                nums[i] = k
            tops, fronts = self._voxelize(pts, nums)
            for i, f in enumerate(frames):
                top = (tuple(t[i] for t in tops) if isinstance(tops, tuple)
                       else tops[i])
                self._dump(f, top, fronts[i])
                done += 1
        return done

    def _dump(self, frame, top, front):
        tag = frame.tag
        o = self.out_dir
        views = ({"top_view": top[0], "top_view_aux": top[1]}
                 if isinstance(top, tuple) else {"top_view": top})
        np.savez_compressed(os.path.join(o, "top", tag + ".npy.npz"),
                            **views)
        np.savez_compressed(os.path.join(o, "front", tag + ".npy.npz"),
                            front_view=front)
        np.save(os.path.join(o, "gt_boxes3d", tag + ".npy"),
                frame.gt_boxes3d)
        np.save(os.path.join(o, "gt_labels", tag + ".npy"), frame.gt_labels)
        if frame.rgb is not None:
            write_png(os.path.join(o, "rgb", tag + ".png"),
                      prepare_rgb(frame.rgb, self.cfg))
        if self.save_images:
            write_png(os.path.join(o, "top_image", tag + ".png"),
                      draw_top_image(views["top_view"]))
