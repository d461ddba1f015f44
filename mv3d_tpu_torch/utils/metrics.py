"""Training metrics and debug images.

Port of ``mv3d_tpu/utils/metrics.py``:

  * :class:`MetricsWriter` appends one JSON record per step to
    ``<log_dir>/metrics_<tag>.jsonl`` (the step, a wall-clock stamp, the
    scalars and extra fields such as the phase) and keeps running means;
    its records are the JAX writer's, line for line, apart from the
    stamps;
  * :func:`dump_debug_images` draws gt, detections and proposals on the
    BEV image and the camera frame (:mod:`mv3d_tpu_torch.utils.viz`) and
    writes them as PNGs (:mod:`mv3d_tpu_torch.utils.png`), whose pixels
    equal the JAX package's.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from . import viz
from .png import write_png


class MetricsWriter:
    """Append-only JSONL scalar log with running means."""

    def __init__(self, log_dir: str, tag: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"metrics_{tag}.jsonl")
        self._file = open(self.path, "a")
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def write(self, step: int, scalars: Dict[str, float], **extra):
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}, **extra}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        for k, v in scalars.items():
            self._sums[k] += float(v)
            self._counts[k] += 1

    def means(self) -> Dict[str, float]:
        return {k: self._sums[k] / max(self._counts[k], 1)
                for k in self._sums}

    def close(self):
        self._file.close()


def dump_debug_images(out_dir: str, step: int, top_view: np.ndarray,
                      rgb: Optional[np.ndarray] = None,
                      gt_boxes3d: Optional[np.ndarray] = None,
                      det_boxes3d: Optional[np.ndarray] = None,
                      proposals: Optional[np.ndarray] = None, cfg=None):
    """Draw gt (white), detections (magenta) and proposals (yellow, BEV
    only) on the BEV image of ``top_view`` and on ``rgb``; write
    ``top.png`` and ``camera.png`` under ``<out_dir>/<step:06d>/`` and
    return that directory."""
    from ..config import cfg as _default_cfg
    cfg = cfg or _default_cfg
    d = os.path.join(out_dir, f"{step:06d}")
    os.makedirs(d, exist_ok=True)

    top_img = viz.draw_top_image(np.asarray(top_view))
    if proposals is not None and len(proposals):
        top_img = viz.draw_boxes2d(top_img, np.asarray(proposals),
                                   color=(255, 255, 0))
    if gt_boxes3d is not None and len(gt_boxes3d):
        top_img = viz.draw_box3d_on_top(top_img, gt_boxes3d,
                                        color=(255, 255, 255), cfg=cfg)
    if det_boxes3d is not None and len(det_boxes3d):
        top_img = viz.draw_box3d_on_top(top_img, det_boxes3d,
                                        color=(255, 0, 255), cfg=cfg)
    write_png(os.path.join(d, "top.png"), top_img)

    if rgb is not None:
        cam = np.asarray(rgb)
        if cam.dtype != np.uint8:
            cam = np.clip(cam, 0, 255).astype(np.uint8)
        if gt_boxes3d is not None and len(gt_boxes3d):
            cam = viz.draw_rgb_projections(cam, gt_boxes3d,
                                           color=(255, 255, 255), cfg=cfg)
        if det_boxes3d is not None and len(det_boxes3d):
            cam = viz.draw_rgb_projections(cam, det_boxes3d,
                                           color=(255, 0, 255), cfg=cfg)
        write_png(os.path.join(d, "camera.png"), cam)
    return d
