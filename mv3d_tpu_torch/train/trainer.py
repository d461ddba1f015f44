"""User-facing inference API: ``MV3D``.

Port of the inference surface of ``mv3d_tpu/train/trainer.py::MV3D``:
``predict`` (views in) and ``predict_from_points`` (raw padded lidar
points in; voxelization and detection on the model's device). Weights come
from a seeded ``torch.Generator`` init or from a JAX variables tree
through :mod:`mv3d_tpu_torch.convert`.

Both methods take one frame or a batch and return the batch's fixed-shape
:class:`Detections` (boxes3d (B, R, 8, 3), probs (B, R), mask (B, R)) as
tensors on the model's device, where the JAX methods return frame 0's
masked numpy arrays: a server answers B requests from one call and reads
the live slots from ``mask``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from mv3d_tpu.config import Config, cfg as _default_cfg

from ..convert import load_variables
from ..models.mv3d_net import MV3DNet
from ..ops.detect import Detections
from ..ops.voxelize import lidar_to_front_batch, lidar_to_top_batch


class MV3D:
    """Model + weights on one device, with batched inference."""

    def __init__(self, cfg: Config = _default_cfg, device=None,
                 seed: int = 0,
                 variables: Optional[Mapping[str, Any]] = None):
        self.cfg = cfg
        self.device = torch.device(device if device is not None else "cpu")
        self.model = MV3DNet(cfg)
        if variables is None:
            self.model.init_weights(torch.Generator().manual_seed(seed))
        else:
            load_variables(self.model, variables)
        self.model.to(self.device).eval()

    def _batch(self, x, ndim: int, dtype=torch.float32) -> torch.Tensor:
        """Array or tensor -> tensor on the model's device, with a batch
        dimension added to a single frame."""
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        t = t.to(self.device, dtype)
        return t[None] if t.dim() == ndim - 1 else t

    @torch.inference_mode()
    def predict(self, top_view, front_view, rgb_image,
                score_threshold: Optional[float] = None) -> Detections:
        """Detection from precomputed NHWC views (single frame or batch)."""
        if score_threshold is None:
            score_threshold = self.cfg.rcnn.score_threshold
        top = self._batch(top_view, 4)
        rgb = self._batch(rgb_image, 4)
        front = (self._batch(front_view, 4)
                 if "front" in self.model.views else None)
        dets, _ = self.model.forward_inference(
            top, rgb, front, score_threshold=score_threshold)
        return dets

    @torch.inference_mode()
    def predict_from_points(self, points, num_points, rgb,
                            score_threshold: Optional[float] = None,
                            top_aux=None) -> Detections:
        """Detection from raw padded lidar points (N, 4) or (B, N, 4), their
        valid counts and the rgb image(s): voxelize, then detect."""
        if top_aux is not None:
            raise NotImplementedError(
                "host aux planes are not ported (ROADMAP A9)")
        if score_threshold is None:
            score_threshold = self.cfg.rcnn.score_threshold
        points = self._batch(points, 3)
        rgb = self._batch(rgb, 4)
        num = self._batch(num_points, 1, torch.int32)
        top, occ = lidar_to_top_batch(points, self.cfg, num,
                                      return_occ=True)
        front = (lidar_to_front_batch(points, self.cfg, num)
                 if "front" in self.model.views else None)
        dets, _ = self.model.forward_inference(
            top, rgb, front, score_threshold=score_threshold, top_occ=occ)
        return dets
