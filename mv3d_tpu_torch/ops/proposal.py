"""RPN proposal generation, batched over frames.

Port of ``mv3d_tpu/ops/proposal.py::rpn_proposals``:
decode -> clip -> min-size mask -> top-k(pre_topn) -> greedy NMS(post_topn).
The top-k is a stable descending sort, which orders equal scores by
index as ``lax.top_k`` does (``torch.topk`` does not promise an order).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import Config, cfg as _default_cfg

from . import boxes as box_ops
from .nms import greedy_nms


class Proposals(NamedTuple):
    rois: torch.Tensor     # (B, post_topn, 5): (0, x1, y1, x2, y2)
    scores: torch.Tensor   # (B, post_topn)
    mask: torch.Tensor     # (B, post_topn) bool


def batch_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-frame gather along dim 1: x (B, K, ...) with idx (B, M)."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def rpn_proposals(scores: torch.Tensor, deltas: torch.Tensor,
                  anchors: torch.Tensor, inside_mask: torch.Tensor,
                  cfg: Config = _default_cfg,
                  nms_thresh: Optional[float] = None) -> Proposals:
    """NMS'd proposals from dense RPN outputs.

    Args:
      scores: (B, A, 2) softmaxed probabilities (col 1 = fg), or anything
              reshapeable to it.
      deltas: (B, A, 4) box regression output.
      anchors: (A, 4) static anchor boxes.
      inside_mask: (B, A) bool — anchors surviving the empty-anchor filter.
    """
    r = cfg.rpn
    nms_thresh = r.nms_thresh if nms_thresh is None else nms_thresh
    img_height, img_width = cfg.top.shape[:2]
    bsz = scores.shape[0]

    probs = scores.reshape(bsz, -1, 2)[..., 1]
    deltas = deltas.reshape(bsz, -1, 4)
    proposals = box_ops.box_transform_inv(anchors.to(torch.float32)[None],
                                          deltas)
    proposals = box_ops.clip_boxes(proposals, img_width, img_height)

    keep = inside_mask & box_ops.filter_boxes_mask(proposals, r.nms_min_size)
    masked_probs = torch.where(keep, probs, -1.0)

    pre_topn = min(r.nms_pre_topn, masked_probs.shape[1])
    top_scores, top_idx = torch.sort(masked_probs, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :pre_topn], top_idx[:, :pre_topn]
    top_boxes = batch_gather(proposals, top_idx)
    top_valid = top_scores > -0.5

    keep_idx, keep_mask = greedy_nms(top_boxes, top_scores, top_valid,
                                     nms_thresh, r.nms_post_topn)
    out_boxes = batch_gather(top_boxes, keep_idx)
    out_scores = torch.where(keep_mask, batch_gather(top_scores, keep_idx),
                             0.0)
    rois = torch.cat([torch.zeros_like(out_boxes[..., :1]), out_boxes],
                     dim=-1)
    rois = torch.where(keep_mask[..., None], rois, 0.0)
    return Proposals(rois=rois, scores=out_scores, mask=keep_mask)
