"""Training-time augmentation of raw lidar batches, before voxelization.

Port of ``mv3d_tpu/train/augment.py``: per frame, a mirror y -> -y with
probability ``train.aug_flip_prob`` and a yaw rotation theta ~ U(-a, a),
a = ``train.aug_rotate_rad``, applied alike to the points and the (G, 8, 3)
gt corners (a mirror re-permutes the corners to stay in canonical order).
RGB is untouched. With both knobs at 0, or on a batch of precomputed
views, the batch is returned as is and no draw is made.

The draws come from an explicit CPU ``torch.Generator`` (so the card and
the CPU augment alike from one seed); :func:`augment_frames` takes them as
tensors. With ``pipeline.host_aux_channels`` the host aux plane still
describes the un-augmented points, in both packages (ROADMAP queue C).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import Config

# corner permutation of a mirrored box (box3d_compose's canonical order)
_MIRROR_PERM = [1, 0, 3, 2, 5, 4, 7, 6]


def augment_frames(points: torch.Tensor, gt3d: torch.Tensor,
                   flip: torch.Tensor, theta: torch.Tensor):
    """(B, N, 4) points and (B, G, 8, 3) gt corners, per-frame ``flip``
    (B,) bool and yaw ``theta`` (B,) f32 -> the augmented pair."""

    def rigid(xyz):
        shape = (-1,) + (1,) * (xyz.dim() - 2)
        sy = torch.where(flip, -1.0, 1.0).to(xyz.dtype).reshape(shape)
        c = torch.cos(theta).to(xyz.dtype).reshape(shape)
        s = torch.sin(theta).to(xyz.dtype).reshape(shape)
        x, y = xyz[..., 0], xyz[..., 1] * sy
        return torch.cat([torch.stack([c * x - s * y, s * x + c * y], -1),
                          xyz[..., 2:]], dim=-1)

    points, gt3d = rigid(points), rigid(gt3d)
    mirrored = gt3d[..., _MIRROR_PERM, :]
    gt3d = torch.where(flip.reshape(-1, 1, 1, 1), mirrored, gt3d)
    return points, gt3d


def augment_batch(batch: Dict[str, torch.Tensor], cfg: Config,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Per-frame random flip/rotate of a raw-point training batch, with
    draws from ``generator`` (a CPU generator)."""
    t = cfg.train
    if (t.aug_flip_prob <= 0 and t.aug_rotate_rad <= 0) \
            or "points" not in batch or "top" in batch:
        return batch
    pts = batch["points"]
    b = pts.shape[0]
    flip = torch.zeros(b, dtype=torch.bool)
    theta = torch.zeros(b)
    if t.aug_flip_prob > 0:
        flip = torch.rand(b, generator=generator) < t.aug_flip_prob
    if t.aug_rotate_rad > 0:
        theta = ((torch.rand(b, generator=generator) * 2.0 - 1.0)
                 * t.aug_rotate_rad)
    out = dict(batch)
    out["points"], out["gt_boxes3d"] = augment_frames(
        pts, batch["gt_boxes3d"], flip.to(pts.device), theta.to(pts.device))
    return out
