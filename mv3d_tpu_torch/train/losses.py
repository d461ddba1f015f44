"""Masked RPN and fusion losses.

Port of ``mv3d_tpu/train/losses.py``. Masked means divide by
``max(count, 1)``, so an empty mask gives 0, not NaN. The RPN smooth-L1
keeps the reference's linear offset of 0 (its typo for 0.5); the fusion
loss uses 0.5. With a process ``group`` a masked mean's count is the sum
over the group's ranks, so each rank's value is its share of the global
mean.
"""

from __future__ import annotations

from typing import Tuple

import torch


def modified_smooth_l1(diffs: torch.Tensor, sigma: float = 3.0,
                       linear_offset: float = 0.5) -> torch.Tensor:
    """0.5*(sigma*x)^2 if |x| < 1/sigma^2 else |x| - offset/sigma^2."""
    sigma2 = sigma * sigma
    a = diffs.abs()
    quad = diffs * diffs * 0.5 * sigma2
    lin = a - linear_offset / sigma2
    return torch.where(a < 1.0 / sigma2, quad, lin)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor,
                 group=None) -> torch.Tensor:
    """Mean of ``values`` over ``mask`` along the last dim; with ``group``
    over the count of every rank of the group."""
    cnt = mask.to(values.dtype).sum(-1)
    if group is not None:
        torch.distributed.all_reduce(cnt, group=group)
    return torch.where(mask, values, 0.0).sum(-1) / torch.clamp(cnt, min=1.0)


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row sparse softmax cross-entropy over the last dim."""
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def rpn_loss(scores: torch.Tensor, deltas: torch.Tensor, tg
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame RPN losses, (B,) each: CE averaged over the sampled
    anchors; smooth-L1 (sigma 3, zero offset) summed over the 4 deltas and
    averaged over the positive anchors.

    Args:
      scores: (B, A, 2) anchor logits; deltas: (B, A, 4); tg: RpnTargets.
    """
    ce = _softmax_ce(scores.to(torch.float32), tg.labels)
    cls_loss = _masked_mean(ce, tg.cls_mask)
    diffs = deltas.to(torch.float32) - tg.targets
    sl1 = modified_smooth_l1(diffs, sigma=3.0, linear_offset=0.0).sum(-1)
    return cls_loss, _masked_mean(sl1, tg.pos_mask)


def fuse_loss(scores: torch.Tensor, deltas: torch.Tensor, tg, group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fusion-head losses over all R rois of the batch: CE with the
    positive mean added to the all-roi mean; smooth-L1 (sigma 3) on each
    roi's labelled-class (8, 3) corner deltas, over the positive rois.
    With ``group``, the rois of every rank of the group.

    Args:
      scores: (R, num_class) logits; deltas: (R, num_class, 8, 3);
      tg: FusionTargets with (R, ...) fields.
    """
    scores = scores.to(torch.float32)
    deltas = deltas.to(torch.float32)
    ce = _softmax_ce(scores, tg.labels)
    cls_loss = (_masked_mean(ce, tg.pos_mask, group) * (2.0 - 1.0)
                + _masked_mean(ce, tg.mask, group) * 1.0)
    picked = torch.gather(deltas, 1, tg.labels[:, None, None, None].expand(
        -1, 1, *deltas.shape[2:]))[:, 0]
    sl1 = modified_smooth_l1(picked - tg.targets, sigma=3.0,
                             linear_offset=0.5).sum(dim=(1, 2))
    return cls_loss, _masked_mean(sl1, tg.pos_mask, group)
