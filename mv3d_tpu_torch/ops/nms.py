"""Batched greedy non-max suppression on fixed-size, masked tensors.

Port of ``mv3d_tpu/ops/nms.py::greedy_nms``, batched over frames: each of
the ``max_out`` pick-and-suppress steps is a (B, K) tensor op, with no
host sync. Suppression rule: IoU in the "+1" pixel convention, suppress
when ``iou > threshold``, written division-free as
``inter * (1 + t) > t * (area_i + area_j)``. Picks follow ``torch.argmax``,
which returns the first maximum like ``jnp.argmax``.
"""

from __future__ import annotations

from typing import Tuple

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
