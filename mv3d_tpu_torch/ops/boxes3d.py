"""3D box geometry and coordinate transforms on tensors.

Port of the inference- and training-path functions of
``mv3d_tpu/ops/boxes3d.py``.
Boxes3d are (..., 8, 3) corner arrays in lidar coordinates; corners 0-3 are
the bottom face, 4-7 the top face.
"""

from __future__ import annotations

import torch

from ..config import Config, cfg as _default_cfg

from .voxelize import check_dataset


def top_to_lidar_coords(xx, yy, cfg: Config = _default_cfg):
    """Top-view pixel (xx, yy) -> lidar (x, y) at cell centers."""
    t = cfg.top
    y = t.yn * t.y_div - (xx + 0.5) * t.y_div + t.y_min
    x = t.xn * t.x_div - (yy + 0.5) * t.x_div + t.x_min
    return x, y


def lidar_to_top_coords(x, y, cfg: Config = _default_cfg):
    """Lidar (x, y) -> top-view pixel (xx, yy); keeps the reference's
    ``Yn - floor(...)`` (no ``-1``)."""
    t = cfg.top
    div_y = torch.tensor(t.y_div, dtype=y.dtype, device=y.device)
    div_x = torch.tensor(t.x_div, dtype=x.dtype, device=x.device)
    xx = t.yn - torch.floor((y - t.y_min) / div_y).to(torch.int32)
    yy = t.xn - torch.floor((x - t.x_min) / div_x).to(torch.int32)
    return xx, yy


def top_box_to_box3d(boxes: torch.Tensor,
                     cfg: Config = _default_cfg) -> torch.Tensor:
    """Lift (..., 4) top-view boxes to (..., 8, 3) 3D boxes with the fixed
    z prior [box3d_z_min, box3d_z_max]."""
    x1, y1, x2, y2 = (boxes[..., 0], boxes[..., 1], boxes[..., 2],
                      boxes[..., 3])
    # corner order: (x1,y1), (x1,y2), (x2,y2), (x2,y1)
    xxs = torch.stack([x1, x1, x2, x2], dim=-1)
    yys = torch.stack([y1, y2, y2, y1], dim=-1)
    xs, ys = top_to_lidar_coords(xxs, yys, cfg)
    z_lo = torch.full_like(xs, cfg.model.box3d_z_min)
    z_hi = torch.full_like(xs, cfg.model.box3d_z_max)
    bottom = torch.stack([xs, ys, z_lo], dim=-1)
    top = torch.stack([xs, ys, z_hi], dim=-1)
    return torch.cat([bottom, top], dim=-2)


def box3d_to_top_box(boxes3d: torch.Tensor,
                     cfg: Config = _default_cfg) -> torch.Tensor:
    """Project (..., 8, 3) 3D boxes to enveloping (..., 4) top-view boxes."""
    us, vs = lidar_to_top_coords(boxes3d[..., 0:4, 0], boxes3d[..., 0:4, 1],
                                 cfg)
    return torch.stack([us.amin(-1), vs.amin(-1), us.amax(-1), vs.amax(-1)],
                       dim=-1).to(torch.float32)


def _affine(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``p @ m`` for a tiny ``m`` as products summed in index order: the same
    IEEE f32 operations on every device, where a matmul's summation order
    (and FMA) differs between the CPU and the card."""
    out = p[..., 0:1] * m[0]
    for k in range(1, m.shape[0]):
        out = out + p[..., k:k + 1] * m[k]
    return out


def box3d_to_rgb_box(boxes3d: torch.Tensor,
                     cfg: Config = _default_cfg) -> torch.Tensor:
    """Project (..., 8, 3) lidar boxes into image pixels (..., 8, 2),
    truncated to int32 (KITTI branch: [P|1] @ Mt, then @ Kt, then divide by
    depth).

    The truncation turns a last-bit difference into a one-pixel move, so
    the products are summed in a fixed order (:func:`_affine`) and the card
    gives the CPU's pixels bit for bit."""
    check_dataset(cfg)
    dev = boxes3d.device
    mt = torch.tensor(cfg.matrix_mt, dtype=torch.float32, device=dev)
    kt = torch.tensor(cfg.matrix_kt, dtype=torch.float32, device=dev)
    b = boxes3d.to(torch.float32)
    ps = torch.cat([b, torch.ones_like(b[..., :1])], dim=-1)
    qs = _affine(_affine(ps, mt)[..., :3], kt)
    pix = qs[..., :2] / qs[..., 2:3]
    return pix.to(torch.int32)       # truncates toward zero


def _rms_scale(boxes3d: torch.Tensor) -> torch.Tensor:
    """Per-box RMS corner spread: sqrt(sum((corners - center)^2) / 8)."""
    center = boxes3d.mean(dim=-2, keepdim=True)
    return torch.sqrt(((boxes3d - center) ** 2).sum(dim=(-1, -2)) / 8.0)


def box3d_transform(et_boxes3d: torch.Tensor,
                    gt_boxes3d: torch.Tensor) -> torch.Tensor:
    """Corner-delta regression targets, normalized by the RMS corner
    spread of the estimated boxes."""
    return (gt_boxes3d - et_boxes3d) / _rms_scale(et_boxes3d)[..., None, None]


def box3d_transform_inv(et_boxes3d: torch.Tensor,
                        deltas: torch.Tensor) -> torch.Tensor:
    """Invert :func:`box3d_transform`."""
    return et_boxes3d + _rms_scale(et_boxes3d)[..., None, None] * deltas


def regularise_box3d(boxes3d: torch.Tensor) -> torch.Tensor:
    """Re-orthogonalize predicted corners into an upright box: average the
    vertical edge length, collapse each bottom/top pair to its midpoint and
    re-extrude along z."""
    bottom = boxes3d[..., 0:4, :]
    top = boxes3d[..., 4:8, :]
    dis = torch.sqrt(((bottom - top) ** 2).sum(-1)).mean(-1)
    corners = (bottom + top) / 2.0
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=boxes3d.dtype,
                      device=boxes3d.device)
    half = (dis / 2.0)[..., None, None] * ez
    return torch.cat([corners - half, corners + half], dim=-2)
