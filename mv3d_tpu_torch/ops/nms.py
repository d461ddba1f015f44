"""Greedy non-max suppression: batched on fixed-size, masked tensors, and
on the host.

Port of ``mv3d_tpu/ops/nms.py``. ``greedy_nms`` and ``nms_select`` are
batched over frames: each of the ``max_out`` pick-and-suppress steps is a
(B, K) tensor op, with no host sync. Suppression rule: IoU in the "+1"
pixel convention, suppress when ``iou > threshold``, written
division-free as ``inter * (1 + t) > t * (area_i + area_j)``. Picks follow
``torch.argmax``, which returns the first maximum like ``jnp.argmax``.
``box_vote``, ``greedy_nms_np`` (the same rule and pick order) and the
multi-class ``non_max_suppress`` are host numpy, copied from the JAX
module (which imports jax).

:func:`nms_topk` keeps the same boxes as :func:`greedy_nms` in one
launch whatever ``max_out`` is: the scores are sorted (stably, so ties
keep the first maximum), then the operator ``mv3d::nms_topk`` sweeps the
sorted list until ``max_out`` are kept. Its CUDA implementation is the
kernel (:mod:`.nms_topk`, ``csrc/nms_topk.cu``); its CPU implementation
is :func:`nms_sorted_plain`, the same sweep in plain PyTorch ops. The
rule takes an ``offset``: 1 for the "+1" pixel convention above, 0 for
boxes in metres.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, iou_threshold: float, max_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over a fixed-size candidate set per frame.

    Args:
      boxes:  (B, K, 4) candidate boxes (x1, y1, x2, y2).
      scores: (B, K) candidate scores.
      valid:  (B, K) bool mask of live candidates.
    Returns:
      keep_idx:  (B, max_out) int64 candidate indices in descending-score
                 order (garbage where keep_mask is False).
      keep_mask: (B, max_out) bool — which slots hold real detections.
    """
    bsz, k = scores.shape
    dev = scores.device
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :]) + 1.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :]) + 1.0)
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    t = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    suppress_mat = (inter * (1.0 + t)
                    > t * (area[:, :, None] + area[:, None, :]))

    live = torch.where(valid, scores, NEG_INF)
    rows = torch.arange(bsz, device=dev)
    cols = torch.arange(k, device=dev)[None, :]
    keep_idx = torch.zeros(bsz, max_out, dtype=torch.int64, device=dev)
    keep_mask = torch.zeros(bsz, max_out, dtype=torch.bool, device=dev)
    for slot in range(max_out):
        best = torch.argmax(live, dim=1)                       # (B,)
        ok = live[rows, best] > NEG_INF / 2
        keep_idx[:, slot] = best
        keep_mask[:, slot] = ok
        # suppress the pick itself and everything overlapping it
        suppress = suppress_mat[rows, best] | (cols == best[:, None])
        live = torch.where(ok[:, None] & suppress, NEG_INF, live)
    return keep_idx, keep_mask


def nms_sorted_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     max_out: int, iou_threshold: float, offset: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over boxes (B, K, 4) already in descending score order
    (B, K), stopping at ``max_out`` kept; a score not > -inf ends a
    frame's valid boxes. Returns (keep (B, max_out) int32 sorted positions,
    0 past the count; count (B,) int32; visited (B,) int32: the position
    of the ``max_out``-th keep plus one, or the number of valid boxes).
    The suppression rule is :func:`greedy_nms`'s with ``offset`` in place
    of its "+1", in f32, each operation as there."""
    bsz, k = scores.shape
    boxes = boxes.to(torch.float32)
    t = torch.tensor(iou_threshold, dtype=torch.float32)
    keep = torch.zeros(bsz, max_out, dtype=torch.int32)
    count = torch.zeros(bsz, dtype=torch.int32)
    visited = torch.zeros(bsz, dtype=torch.int32)
    for b in range(bsz):
        n = int((scores[b] > -torch.inf).to(torch.int32).cumprod(0).sum())
        x1, y1, x2, y2 = boxes[b, :n].cpu().unbind(-1)
        area = (x2 - x1 + offset) * (y2 - y1 + offset)
        kept: list = []
        seen = n
        for i in range(n):
            if kept:
                j = torch.tensor(kept)
                iw = (torch.minimum(x2[j], x2[i]) - torch.maximum(x1[j], x1[i])
                      + offset)
                ih = (torch.minimum(y2[j], y2[i]) - torch.maximum(y1[j], y1[i])
                      + offset)
                inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
                if bool((inter * (1.0 + t) > t * (area[j] + area[i])).any()):
                    continue
            kept.append(i)
            if len(kept) == max_out:
                seen = i + 1
                break
        keep[b, :len(kept)] = torch.tensor(kept, dtype=torch.int32)
        count[b] = len(kept)
        visited[b] = seen
    return keep, count, visited


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, max_out: int, offset: float = 1.0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`greedy_nms`'s picks (with ``offset`` 1; 0 for boxes in
    metres) in a fixed number of launches: the live scores sorted
    descending, stably, then ``mv3d::nms_topk`` over the sorted boxes.
    NaN scores count as invalid. Returns (keep_idx (B, max_out) int64
    indices into the K candidates in pick order, 0 where keep_mask is
    False; keep_mask (B, max_out) bool; visited (B,) int32, the sorted
    candidates examined before ``max_out`` were kept, or the live ones)."""
    live = torch.where(valid & ~torch.isnan(scores), scores.float(),
                       -torch.inf)
    sorted_scores, order = torch.sort(live, dim=1, descending=True,
                                      stable=True)
    sorted_boxes = torch.gather(boxes.float(), 1,
                                order[..., None].expand(-1, -1, 4))
    pos, count, visited = torch.ops.mv3d.nms_topk.default(
        sorted_boxes.contiguous(), sorted_scores.contiguous(), max_out,
        float(iou_threshold), float(offset))
    keep_mask = (torch.arange(max_out, device=scores.device)[None]
                 < count[:, None])
    keep_idx = torch.gather(order, 1, pos.long())
    return torch.where(keep_mask, keep_idx, 0), keep_mask, visited


def nms_select(boxes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, iou_threshold: float, max_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS returning the kept (boxes (B, max_out, 4), scores
    (B, max_out), zero on empty slots, mask (B, max_out))."""
    keep_idx, keep_mask = greedy_nms(boxes, scores, valid, iou_threshold,
                                     max_out)
    kept = torch.gather(boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
    kept_scores = torch.gather(scores, 1, keep_idx)
    return kept, torch.where(keep_mask, kept_scores, 0.0), keep_mask


def box_vote(nms_dets, all_dets) -> np.ndarray:
    """Box voting on the host: each NMS survivor's box becomes the
    score-weighted mean of every box of ``all_dets`` overlapping it with
    IoU >= 0.5 ("+1" convention). dets are (K, 5) [x1, y1, x2, y2,
    score]."""
    nms_dets = np.asarray(nms_dets, np.float32)
    all_dets = np.asarray(all_dets, np.float32)
    out = nms_dets.copy()
    if len(all_dets) == 0:
        return out
    areas = ((all_dets[:, 2] - all_dets[:, 0] + 1) *
             (all_dets[:, 3] - all_dets[:, 1] + 1))
    for i, det in enumerate(nms_dets):
        iw = (np.minimum(det[2], all_dets[:, 2]) -
              np.maximum(det[0], all_dets[:, 0]) + 1)
        ih = (np.minimum(det[3], all_dets[:, 3]) -
              np.maximum(det[1], all_dets[:, 1]) + 1)
        inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
        a = (det[2] - det[0] + 1) * (det[3] - det[1] + 1)
        iou = inter / (a + areas - inter)
        sel = iou >= 0.5
        w = all_dets[sel, 4]
        out[i, :4] = ((w[:, None] * all_dets[sel, :4]).sum(0)
                      / max(w.sum(), 1e-12))
    return out


def greedy_nms_np(boxes, scores, iou_threshold: float) -> np.ndarray:
    """Greedy NMS on the host: keep indices (int64, descending score; the
    lowest index wins a tie), the suppression rule of :func:`greedy_nms`
    in f32."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    t = np.float32(iou_threshold)
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        iw = np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]) + 1.0
        ih = np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]) + 1.0
        inter = np.clip(iw, 0.0, None) * np.clip(ih, 0.0, None)
        suppress = inter * (1.0 + t) > t * (areas[i] + areas[rest])
        order = rest[~suppress]
    return np.asarray(keep, np.int64)


def non_max_suppress(boxes, scores, num_classes: int,
                     nms_after_thresh: float = 0.3,
                     nms_before_score_thresh: float = 0.05,
                     is_box_vote: bool = False,
                     max_per_image: int = 100) -> List[np.ndarray]:
    """Multi-class NMS on the host: per class but the background, a score
    gate, greedy NMS, optional box voting, then the ``max_per_image``
    best detections overall.

    Args:
      boxes: (N, num_classes * 4) per-class boxes.
      scores: (N, num_classes) per-class scores.
    Returns: per-class (K_c, 5) [x1, y1, x2, y2, score] arrays (class 0,
      the background, empty).
    """
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    nms_boxes = [np.zeros((0, 5), np.float32) for _ in range(num_classes)]
    for j in range(1, num_classes):
        inds = np.where(scores[:, j] > nms_before_score_thresh)[0]
        cls_scores = scores[inds, j]
        cls_boxes = boxes[inds, j * 4:(j + 1) * 4]
        cls_dets = np.hstack([cls_boxes, cls_scores[:, None]])
        if len(inds):
            keep = greedy_nms_np(cls_boxes, cls_scores, nms_after_thresh)
            kept = cls_dets[keep]
            cls_dets = box_vote(kept, cls_dets) if is_box_vote else kept
        nms_boxes[j] = cls_dets

    if max_per_image > 0:
        all_scores = np.hstack([nms_boxes[j][:, -1]
                                for j in range(1, num_classes)])
        if len(all_scores) > max_per_image:
            thresh = np.sort(all_scores)[-max_per_image]
            for j in range(1, num_classes):
                keep = nms_boxes[j][:, -1] >= thresh
                nms_boxes[j] = nms_boxes[j][keep]
    return nms_boxes
