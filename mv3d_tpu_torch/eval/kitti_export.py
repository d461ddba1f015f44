"""Export detections to the KITTI object benchmark's txt format.

Port of ``mv3d_tpu/eval/kitti_export.py``: lidar-frame boxes and their
probabilities become per-frame ``<tag>.txt`` files in camera coordinates,
as the official KITTI evaluator reads them. The geometry goes through the
port's tensor functions on the CPU in f32; the lines are formatted from
f32 numpy values as the JAX package formats them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import Config, cfg as _default_cfg
from ..ops import boxes3d as box3d_ops


def detection_to_kitti_lines(boxes3d: np.ndarray, probs: np.ndarray,
                             cfg: Config = _default_cfg,
                             object_type: str = "Car",
                             top_k: Optional[int] = None) -> list:
    """(K, 8, 3) lidar boxes + (K,) scores -> KITTI label lines, highest
    score first (at most ``top_k``).

    Fields: type trunc occ alpha x1 y1 x2 y2 h w l x y z ry score. The
    camera-frame center is the bottom face's centroid mapped through the
    calibration, ``ry = -rz - pi/2`` (the inverse of
    :func:`mv3d_tpu_torch.data.kitti.kitti_label_to_lidar_box3d`), and the
    2D box the image-clipped envelope of the projected corners.
    """
    if len(boxes3d) == 0:
        return []
    order = np.argsort(-probs)
    if top_k:
        order = order[:top_k]
    boxes3d = np.asarray(boxes3d)[order]
    probs = np.asarray(probs)[order]

    boxes_t = torch.as_tensor(np.asarray(boxes3d, np.float32))
    trans, size, rot = (v.numpy() for v in
                        box3d_ops.boxes3d_decompose(boxes_t, cfg))
    cam = box3d_ops.lidar_to_camera_points(torch.from_numpy(trans),
                                           cfg).numpy()
    proj = box3d_ops.box3d_to_rgb_box(boxes_t, cfg).numpy()

    lines = []
    for i in range(len(boxes3d)):
        h, w, l = size[i]
        x, y, z = cam[i]
        ry = -rot[i, 2] - np.pi / 2
        x1, y1 = proj[i, :, 0].min(), proj[i, :, 1].min()
        x2, y2 = proj[i, :, 0].max(), proj[i, :, 1].max()
        x1 = max(0, min(x1, cfg.image_width - 1))
        x2 = max(0, min(x2, cfg.image_width - 1))
        y1 = max(0, min(y1, cfg.image_height - 1))
        y2 = max(0, min(y2, cfg.image_height - 1))
        lines.append(
            f"{object_type} 0.0 0 0.0 {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
            f"{h:.3f} {w:.3f} {l:.3f} {x:.3f} {y:.3f} {z:.3f} {ry:.3f} "
            f"{probs[i]:.4f}")
    return lines


def export_kitti_detections(detections: dict, out_dir: str,
                            cfg: Config = _default_cfg,
                            object_type: str = "Car",
                            top_k: Optional[int] = None):
    """Write {tag: (boxes3d, probs)} to ``<out_dir>/<tag>.txt`` files."""
    os.makedirs(out_dir, exist_ok=True)
    for tag, (boxes3d, probs) in detections.items():
        lines = detection_to_kitti_lines(boxes3d, probs, cfg, object_type,
                                         top_k)
        with open(os.path.join(out_dir, f"{tag}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
