"""RPN and fusion target assignment, batched over frames (fixed-size,
masked, sampled by ranking uniform noise).

Port of ``mv3d_tpu/train/targets.py``: ``_rank_among``, ``rpn_target`` and
``fusion_target``. The JAX functions draw their uniform noise from a PRNG
key; here each takes its draws as tensors, which the caller makes from a
CPU ``torch.Generator`` and moves to the device, so the card and the CPU
sample the same anchors and rois (:func:`draw_noise`).

Ranks and the roi slot choice use stable sorts: ``jnp.argsort`` is
stable, and ``lax.top_k`` orders equal priorities by index. Every dead
fusion slot ties at -inf, and which ones fill the roi batch decides what
the fusion head's BatchNorm statistics see.

Nothing here stops gradients: the fusion targets and the sampled rois
are functions of the RPN's deltas (through the proposals), as in the JAX
step.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..config import Config, cfg as _default_cfg
from ..ops import boxes as box_ops
from ..ops import boxes3d as box3d_ops
from ..ops.proposal import batch_gather


def draw_noise(cfg: Config, batch_size: int, generator: torch.Generator,
               device=None) -> Dict[str, torch.Tensor]:
    """The per-frame uniform draws of one training step: ``rpn_pos`` and
    ``rpn_neg`` (B, A) for the RPN sampling, ``fus_fg`` and ``fus_fp``
    (B, P + G) for the fusion sampling, drawn on the CPU from
    ``generator`` and moved to ``device``."""
    a = cfg.num_anchors
    e = cfg.rpn.nms_post_topn + cfg.pipeline.max_gt
    shapes = {"rpn_pos": a, "rpn_neg": a, "fus_fg": e, "fus_fp": e}
    return {k: torch.rand(batch_size, n, generator=generator).to(device)
            for k, n in shapes.items()}


def _rank_among(mask: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Rank (0-based, by descending noise) of each element within ``mask``
    along the last dim; elements outside the mask get its length."""
    n = mask.shape[-1]
    keyed = torch.where(mask, noise, float("-inf"))
    order = torch.argsort(-keyed, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(n, device=mask.device)
                   .expand_as(order).contiguous())
    return torch.where(mask, ranks, n)


class RpnTargets(NamedTuple):
    cls_mask: torch.Tensor   # (B, A) bool — sampled (pos or neg) anchors
    labels: torch.Tensor     # (B, A) int64 — 0/1 where cls_mask
    pos_mask: torch.Tensor   # (B, A) bool — sampled positive anchors
    targets: torch.Tensor    # (B, A, 4) f32 — regression targets


def rpn_target(anchors: torch.Tensor, inside_mask: torch.Tensor,
               gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
               gt_mask: torch.Tensor, u_pos: torch.Tensor,
               u_neg: torch.Tensor, cfg: Config = _default_cfg
               ) -> RpnTargets:
    """Assign RPN training targets over the dense anchor set.

    Args:
      anchors: (A, 4) static anchors.
      inside_mask: (B, A) bool — anchors eligible for sampling.
      gt_boxes: (B, G, 4) padded top-view gt boxes.
      gt_labels: (B, G) class labels (1 = positive class).
      gt_mask: (B, G) bool validity of gt rows.
      u_pos, u_neg: (B, A) uniform draws for the positive/negative picks.
    """
    r = cfg.rpn
    anchors_f = anchors.to(torch.float32)
    gt_ok = gt_mask & (gt_labels == 1)

    ov = box_ops.bbox_overlaps(anchors_f[None], gt_boxes)     # (B, A, G)
    ov = torch.where(gt_ok[:, None, :], ov, -1.0)
    max_ov, argmax = ov.amax(dim=2), ov.argmax(dim=2)   # first max wins

    # per-gt best anchors (ties included) are forced positive
    gt_max = torch.where(inside_mask[..., None], ov, -1.0).amax(dim=1)
    force_pos = ((ov == gt_max[:, None, :]) & (gt_max[:, None, :] > 0.0)
                 & gt_ok[:, None, :]).any(dim=2)

    neg = inside_mask & (max_ov >= 0.0) & (max_ov < r.bg_thresh_hi)
    pos = inside_mask & (force_pos | (max_ov >= r.fg_thresh_lo))
    neg = neg & ~pos

    num_fg_cap = int(r.fg_fraction * r.batch_size)
    pos_keep = pos & (_rank_among(pos, u_pos) < num_fg_cap)
    neg_quota = r.batch_size - pos_keep.sum(dim=1, keepdim=True)
    neg_keep = neg & (_rank_among(neg, u_neg) < neg_quota)

    targets = box_ops.box_transform(
        anchors_f[None].expand(gt_boxes.shape[0], -1, -1),
        batch_gather(gt_boxes, argmax))
    return RpnTargets(cls_mask=pos_keep | neg_keep,
                      labels=pos_keep.to(torch.int64), pos_mask=pos_keep,
                      targets=targets)


class FusionTargets(NamedTuple):
    rois: torch.Tensor       # (B, R, 5) sampled rois (0, x1, y1, x2, y2)
    labels: torch.Tensor     # (B, R) int64 — 0 for background/fp slots
    targets: torch.Tensor    # (B, R, 8, 3) corner-delta targets
    mask: torch.Tensor       # (B, R) bool — live slots
    pos_mask: torch.Tensor   # (B, R) bool — positive slots
    rois3d: torch.Tensor     # (B, R, 8, 3) lifted 3D rois


def fusion_target(proposal_rois: torch.Tensor, proposal_mask: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_boxes3d: torch.Tensor,
                  gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                  u_fg: torch.Tensor, u_fp: torch.Tensor,
                  cfg: Config = _default_cfg) -> FusionTargets:
    """Sample fusion-stage rois and assign 3D corner-delta targets: gt
    boxes join the proposals, fg = IoU >= fg_thresh_lo (at most
    fg_fraction of the batch), fp = IoU in [bg_lo, bg_hi] fills the rest.

    Args:
      proposal_rois: (B, P, 5); proposal_mask: (B, P) bool.
      gt_boxes: (B, G, 4); gt_boxes3d: (B, G, 8, 3); gt_labels, gt_mask:
        (B, G).
      u_fg, u_fp: (B, P + G) uniform draws (``u_fg`` ranks the fg
        candidates and orders the kept fg slots, as in the JAX function).
    """
    rc = cfg.rcnn
    r = rc.batch_size
    bsz, p = proposal_mask.shape
    e = p + gt_boxes.shape[1]

    ext_boxes = torch.cat([proposal_rois[..., 1:5], gt_boxes], dim=1)
    ext_valid = torch.cat([proposal_mask, gt_mask], dim=1)

    ov = box_ops.bbox_overlaps(ext_boxes, gt_boxes)            # (B, E, G)
    ov = torch.where(gt_mask[:, None, :], ov, -1.0)
    max_ov, argmax = ov.amax(dim=2), ov.argmax(dim=2)
    labels_g = torch.gather(gt_labels.to(torch.int64), 1, argmax)

    fg = ext_valid & (max_ov >= rc.fg_thresh_lo)
    fp = ext_valid & (max_ov <= rc.bg_thresh_hi) & (max_ov >= rc.bg_thresh_lo)

    num_fg_cap = int(round(rc.fg_fraction * r))
    fg_keep = fg & (_rank_among(fg, u_fg) < num_fg_cap)

    # slot priority: kept fg in [2, 3), fp candidates in [1, 2); the top R
    # are all kept fg, then fp up to the quota
    priority = torch.where(fg_keep, 2.0 + u_fg,
                           torch.where(fp, 1.0 + u_fp, float("-inf")))
    if e < r:   # fewer candidates than roi slots: pad with dead entries
        priority = torch.cat([priority, priority.new_full(
            (bsz, r - e), float("-inf"))], dim=1)
    vals, idx = torch.sort(priority, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :r], torch.clamp(idx[:, :r], max=e - 1)
    slot_valid = vals > 0.0
    slot_is_fg = vals >= 2.0

    sel_boxes = batch_gather(ext_boxes, idx)
    rois = torch.cat([torch.zeros_like(sel_boxes[..., :1]), sel_boxes], -1)
    rois = torch.where(slot_valid[..., None], rois, 0.0)
    labels = torch.where(slot_is_fg & slot_valid,
                         batch_gather(labels_g, idx), 0)

    rois3d = box3d_ops.top_box_to_box3d(sel_boxes, cfg)
    gt3d = batch_gather(gt_boxes3d, batch_gather(argmax, idx))
    targets = box3d_ops.box3d_transform(rois3d, gt3d)
    targets = torch.where((labels != 0)[..., None, None], targets, 0.0)
    return FusionTargets(rois=rois, labels=labels, targets=targets,
                         mask=slot_valid, pos_mask=(labels != 0) & slot_valid,
                         rois3d=rois3d)
