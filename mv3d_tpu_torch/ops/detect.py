"""Final detection post-processing, batched over frames.

Port of ``mv3d_tpu/ops/detect.py::rcnn_nms``: score threshold ->
corner-delta decode -> box regularisation -> BEV NMS, fixed-shape and
masked.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import Config, cfg as _default_cfg

from . import boxes3d as box3d_ops
from .nms import greedy_nms
from .proposal import batch_gather


class Detections(NamedTuple):
    boxes3d: torch.Tensor   # (B, R, 8, 3) decoded, regularised 3D boxes
    probs: torch.Tensor     # (B, R) class-1 probabilities
    mask: torch.Tensor      # (B, R) bool — live detections


def rcnn_nms(probs: torch.Tensor, deltas: torch.Tensor,
             rois3d: torch.Tensor, roi_mask: torch.Tensor,
             score_threshold: Optional[float] = None,
             nms_threshold: Optional[float] = None,
             cfg: Config = _default_cfg) -> Detections:
    """Decode + suppress fusion-head outputs into final 3D detections.

    Args:
      probs: (B, R, num_class) fusion softmax probabilities.
      deltas: (B, R, num_class, 8, 3) per-class corner deltas.
      rois3d: (B, R, 8, 3) the lifted 3D rois the deltas refer to.
      roi_mask: (B, R) bool validity of roi slots.
    """
    score_threshold = (cfg.rcnn.score_threshold if score_threshold is None
                       else score_threshold)
    nms_threshold = (cfg.rcnn.nms_thresh if nms_threshold is None
                     else nms_threshold)

    cls = 1   # class-one only, like the reference
    p = probs[..., cls].to(torch.float32)
    thr = torch.tensor(score_threshold, dtype=torch.float32, device=p.device)
    keep = roi_mask & (p > thr)

    d = deltas[:, :, cls].to(torch.float32)
    boxes3d = box3d_ops.box3d_transform_inv(rois3d, d)
    boxes3d = box3d_ops.regularise_box3d(boxes3d)
    top_boxes = box3d_ops.box3d_to_top_box(boxes3d, cfg)

    keep_idx, keep_mask = greedy_nms(top_boxes, p, keep, nms_threshold,
                                     p.shape[1])
    probs_kept = torch.where(keep_mask, batch_gather(p, keep_idx), 0.0)
    return Detections(boxes3d=batch_gather(boxes3d, keep_idx),
                      probs=probs_kept, mask=keep_mask)
