"""2D axis-aligned box geometry in the "+1" pixel convention.

Port of ``mv3d_tpu/ops/boxes.py``. Shapes are (..., 4) with
(x1, y1, x2, y2) in the last dimension.
"""

from __future__ import annotations

import torch


def box_transform_inv(et_boxes: torch.Tensor,
                      deltas: torch.Tensor) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to boxes."""
    et_ws = et_boxes[..., 2] - et_boxes[..., 0] + 1.0
    et_hs = et_boxes[..., 3] - et_boxes[..., 1] + 1.0
    et_cxs = et_boxes[..., 0] + 0.5 * et_ws
    et_cys = et_boxes[..., 1] + 0.5 * et_hs

    cxs = deltas[..., 0] * et_ws + et_cxs
    cys = deltas[..., 1] * et_hs + et_cys
    ws = torch.exp(deltas[..., 2]) * et_ws
    hs = torch.exp(deltas[..., 3]) * et_hs

    return torch.stack([cxs - 0.5 * ws, cys - 0.5 * hs,
                        cxs + 0.5 * ws, cys + 0.5 * hs], dim=-1)


def clip_boxes(boxes: torch.Tensor, width: float,
               height: float) -> torch.Tensor:
    """Clip boxes to [0, width-1] x [0, height-1]."""
    x1 = torch.clamp(boxes[..., 0], 0.0, width - 1.0)
    y1 = torch.clamp(boxes[..., 1], 0.0, height - 1.0)
    x2 = torch.clamp(boxes[..., 2], 0.0, width - 1.0)
    y2 = torch.clamp(boxes[..., 3], 0.0, height - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def filter_boxes_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """Mask of boxes with both sides >= min_size."""
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    return (ws >= min_size) & (hs >= min_size)
