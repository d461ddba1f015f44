"""3D box geometry and coordinate transforms on tensors.

Port of ``mv3d_tpu/ops/boxes3d.py``: the top-view, rgb, camera and
drawing front-view projections, the regression encodings, ``box3d_compose`` /
``boxes3d_decompose`` on tensors, and the host numpy 3D IoU
(``boxes3d_score_iou``) that the validation interleave scores with.
Boxes3d are (..., 8, 3) corner arrays in lidar coordinates; corners 0-3 are
the bottom face, 4-7 the top face.

AVOD's encodings (``avod/core/{anchor,box_4c,orientation}_encoder.py``),
written in the lidar frame over a flat ground plane at z = ``ground_z``:
an *anchor* is an axis-aligned box (cx, cy, z_bottom, dx, dy, dz); a
*box3d* (cx, cy, z_bottom, l, w, h, ry) has length l along the yaw ry;
``box_4c`` is (x1..x4, y1..y4, h1, h2), the four BEV corners and the
bottom and top heights above the ground; an orientation is the angle
vector (cos ry, sin ry).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import Config, cfg as _default_cfg

from .projection import DIDI_PROJ_MAT


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


_INT32 = torch.iinfo(torch.int32)


def trunc_to_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA converts: toward zero, out-of-range values
    saturated at the int32 limits, NaN to 0. (A plain ``.to(torch.int32)``
    turns them all into ``INT_MIN`` on the CPU: a corner on the camera
    plane would clamp to the wrong edge of the image.)"""
    high = x >= 2.0 ** 31              # INT_MAX is not an f32
    x = torch.where(torch.isnan(x) | high, 0.0, x).clamp(min=-2.0 ** 31)
    return torch.where(high, _INT32.max, x.to(torch.int32))


def box3d_to_rgb_box(boxes3d: torch.Tensor,
                     cfg: Config = _default_cfg) -> torch.Tensor:
    """Project (..., 8, 3) lidar boxes into image pixels (..., 8, 2),
    truncated to int32 (:func:`trunc_to_int32`).

    KITTI: [P|1] @ Mt, then @ Kt, then divide by depth. The other presets
    (didi): [P|1] through the calibrated 3x4 ``DIDI_PROJ_MAT``, divide by
    depth, shift into the cropped image (``image_crop_left/top``) and clamp
    to it; a box is zeroed when none of its corners has x > 0 or fewer
    than 2 corners fall inside the cropped image.

    The truncation turns a last-bit difference into a one-pixel move, so
    the products are summed in a fixed order (:func:`_affine`) and the card
    gives the CPU's pixels bit for bit."""
    dev = boxes3d.device
    b = boxes3d.to(torch.float32)
    ps = torch.cat([b, torch.ones_like(b[..., :1])], dim=-1)
    if cfg.dataset_type == "kitti":
        mt = torch.tensor(cfg.matrix_mt, dtype=torch.float32, device=dev)
        kt = torch.tensor(cfg.matrix_kt, dtype=torch.float32, device=dev)
        qs = _affine(_affine(ps, mt)[..., :3], kt)
        return trunc_to_int32(qs[..., :2] / qs[..., 2:3])
    p = torch.tensor(DIDI_PROJ_MAT.T, dtype=torch.float32, device=dev)
    qs = _affine(ps, p)
    pix = trunc_to_int32(qs[..., :2] / qs[..., 2:3])
    h, w, _ = cfg.rgb_shape
    # int32 arithmetic wraps in XLA: a saturated pixel shifted by the crop
    # wraps to the far side, as there (int64, then cut to 32 bits)
    u = (pix[..., 0].long() - cfg.image_crop_left).to(torch.int32)
    v = (pix[..., 1].long() - cfg.image_crop_top).to(torch.int32)
    in_range = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    out = torch.stack([u.clamp(0, w - 1), v.clamp(0, h - 1)], dim=-1)
    keep = ((b[..., 0] > 0).sum(-1) > 0) & (in_range.sum(-1) >= 2)
    return torch.where(keep[..., None, None], out, 0).to(torch.int32)


def lidar_to_front_coords(points: torch.Tensor, cfg: Config = _default_cfg
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 3) lidar points -> *drawing* front-view coordinates (c, r),
    f32: the reference's map (boxes3d.py:29-38) with its legacy ``/2``
    rescale, distinct from the voxelizer's projection
    (:func:`mv3d_tpu_torch.ops.voxelize.front_pixels`)."""
    f = cfg.front
    x, y, z = points[..., 0], points[..., 1], points[..., 2]

    def res(v):   # an f32 tensor on the points' device, not a Python float
        return torch.tensor(v, dtype=torch.float32, device=points.device)

    c = torch.trunc(torch.atan2(y, x) / res(f.angular_res))
    r = torch.trunc(torch.atan2(z, torch.sqrt(x ** 2 + y ** 2))
                    / res(f.vertical_res))
    return (c + f.c_offset) / 2.0, (r + f.r_offset) / 2.0


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


# -- lidar <-> camera --------------------------------------------------------

def _transform(points: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """(..., 3) points -> the first three rows of ``m @ [p, 1]``, summed in
    index order (:func:`_affine`), in the points' dtype."""
    mt = torch.as_tensor(m.T, dtype=points.dtype, device=points.device)
    hom = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return _affine(hom, mt)[..., :3]


def lidar_to_camera_points(points: torch.Tensor,
                           cfg: Config = _default_cfg) -> torch.Tensor:
    """(..., 3) lidar points -> camera coordinates (KITTI calibration)."""
    return _transform(points, cfg.r_rect @ cfg.velo_to_cam)


def camera_to_lidar_points(points: torch.Tensor,
                           cfg: Config = _default_cfg) -> torch.Tensor:
    """(..., 3) camera points -> lidar coordinates."""
    return _transform(points, np.linalg.inv(cfg.velo_to_cam)
                      @ np.linalg.inv(cfg.r_rect))


def box3d_to_camera_box3d(boxes3d: torch.Tensor,
                          cfg: Config = _default_cfg) -> torch.Tensor:
    """(..., 8, 3) lidar boxes -> camera-frame corners."""
    return lidar_to_camera_points(boxes3d, cfg)


# -- compose / decompose -----------------------------------------------------

def box3d_compose(translation, size, rotation,
                  cfg: Config = _default_cfg) -> torch.Tensor:
    """(tx, ty, tz), (h, w, l), (rx, ry, rz = yaw) -> (..., 8, 3) corners:
    the bottom face at z = 0 and the top at z = h, rotated by the yaw, then
    translated. Leading batch dimensions are allowed on all three."""
    translation, size, rotation = (
        torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x)
                        else x, dtype=torch.float32)
        for x in (translation, size, rotation))
    h, w, l = size[..., 0], size[..., 1], size[..., 2]
    zeros = torch.zeros_like(h)
    xs = torch.stack([-l / 2, -l / 2, l / 2, l / 2,
                      -l / 2, -l / 2, l / 2, l / 2], dim=-1)
    ys = torch.stack([w / 2, -w / 2, -w / 2, w / 2,
                      w / 2, -w / 2, -w / 2, w / 2], dim=-1)
    zs = torch.stack([zeros] * 4 + [h] * 4, dim=-1)
    yaw = rotation[..., 2]
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    corners = torch.stack([c * xs - s * ys, s * xs + c * ys, zs], dim=-1)
    return corners + translation[..., None, :]


def boxes3d_decompose(boxes3d: torch.Tensor, cfg: Config = _default_cfg
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., 8, 3) corners -> (translation, size = [h, w, l], rotation =
    [0, 0, yaw]), each (..., 3): the translation is the bottom face's
    centroid, l and w the longer and shorter bottom edges, the yaw along
    the longer one."""
    t = boxes3d[..., 0:4, :].mean(dim=-2)
    p0, p1, p2 = (boxes3d[..., i, 0:2] for i in range(3))
    dis1 = torch.sqrt(((p0 - p1) ** 2).sum(-1))
    dis2 = torch.sqrt(((p1 - p2) ** 2).sum(-1))
    length = torch.maximum(dis1, dis2)
    width = torch.minimum(dis1, dis2)
    height = torch.sqrt(((boxes3d[..., 0, :] - boxes3d[..., 4, :]) ** 2
                         ).sum(-1))
    yaw1 = torch.atan2(p1[..., 1] - p0[..., 1], p1[..., 0] - p0[..., 0])
    yaw2 = torch.atan2(p2[..., 1] - p1[..., 1], p2[..., 0] - p1[..., 0])
    yaw = torch.where(dis1 > dis2, yaw1, yaw2)
    zeros = torch.zeros_like(yaw)
    return (t, torch.stack([height, width, length], dim=-1),
            torch.stack([zeros, zeros, yaw], dim=-1))


# -- yaw-aware 3D IoU (host numpy; validation and evaluation) ---------------

def _polygon_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman clip of polygon ``subject`` by the convex
    ``clip``; both (K, 2), clockwise or counter-clockwise."""
    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) >= 0

    def intersect(p1, p2, a, b):
        dc = a - b
        dp = p1 - p2
        n1 = a[0] * b[1] - a[1] * b[0]
        n2 = p1[0] * p2[1] - p1[1] * p2[0]
        denom = dc[0] * dp[1] - dc[1] * dp[0]
        return np.array([(n1 * dp[0] - n2 * dc[0]) / denom,
                         (n1 * dp[1] - n2 * dc[1]) / denom])

    area2 = 0.0                       # make the clip polygon CCW
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        area2 += a[0] * b[1] - b[0] * a[1]
    if area2 < 0:
        clip = clip[::-1]

    output = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        input_list, output = output, []
        if not input_list:
            break
        s = input_list[-1]
        for p in input_list:
            if inside(p, a, b):
                if not inside(s, a, b):
                    output.append(intersect(s, p, a, b))
                output.append(p)
            elif inside(s, a, b):
                output.append(intersect(s, p, a, b))
            s = p
    return np.array(output) if output else np.zeros((0, 2))


def _polygon_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def box3d_intersection(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Intersection volume of two (3, 8) corner arrays (yaw-only
    rotation): the z overlap times the clipped bottom faces' area."""
    min_h_a, max_h_a = np.min(box_a[2]), np.max(box_a[2])
    min_h_b, max_h_b = np.min(box_b[2]), np.max(box_b[2])
    z_inter = max(0.0, min(max_h_a, max_h_b) - max(min_h_a, min_h_b))
    if z_inter == 0:
        return 0.0
    clipped = _polygon_clip(box_a[0:2, 0:4].T, box_b[0:2, 0:4].T)
    xy_inter = _polygon_area(clipped)
    if xy_inter == 0:
        return 0.0
    return float(z_inter * xy_inter)


def boxes3d_score_iou(gt_boxes3d: np.ndarray, pre_boxes3d: np.ndarray,
                      cfg: Config = _default_cfg) -> float:
    """Aggregate 3D IoU of predictions against ground truth: the sum of
    each gt box's best intersection over the union of the total
    volumes."""
    gt_boxes3d = np.asarray(gt_boxes3d)
    pre_boxes3d = np.asarray(pre_boxes3d)
    if pre_boxes3d.shape[0] == 0:
        return 0.0

    def volume(boxes):
        _, size, _ = boxes3d_decompose(torch.tensor(boxes,
                                                    dtype=torch.float32), cfg)
        return float(np.sum(np.prod(size.numpy(), axis=1)))

    gt_vol, pre_vol = volume(gt_boxes3d), volume(pre_boxes3d)
    inters = np.zeros((gt_boxes3d.shape[0], pre_boxes3d.shape[0]))
    for j in range(gt_boxes3d.shape[0]):
        for i in range(pre_boxes3d.shape[0]):
            inters[j, i] = box3d_intersection(gt_boxes3d[j].T,
                                              pre_boxes3d[i].T)
    inter = float(np.sum(np.max(inters, axis=1)))
    union = gt_vol + pre_vol - inter
    return inter / union if union > 0 else 0.0


# -- AVOD -------------------------------------------------------------------

def anchor_corners(anchors: torch.Tensor) -> torch.Tensor:
    """(..., 6) axis-aligned anchors -> (..., 8, 3) corners: the bottom face
    (+x, +y), (+x, -y), (-x, -y), (-x, +y) about the centre, then the
    top."""
    cx, cy, zb, dx, dy, dz = anchors.to(torch.float32).unbind(-1)
    hx, hy = dx / 2, dy / 2
    xs = torch.stack([cx + hx, cx + hx, cx - hx, cx - hx], dim=-1)
    ys = torch.stack([cy + hy, cy - hy, cy - hy, cy + hy], dim=-1)
    bottom = torch.stack([xs, ys, zb[..., None].expand_as(xs)], dim=-1)
    top = torch.stack([xs, ys, (zb + dz)[..., None].expand_as(xs)], dim=-1)
    return torch.cat([bottom, top], dim=-2)


def anchor_bev_boxes(anchors: torch.Tensor) -> torch.Tensor:
    """(..., 6) anchors -> (..., 4) BEV boxes (x1, y1, x2, y2) in metres,
    for the proposal NMS."""
    cx, cy, _, dx, dy, _ = anchors.to(torch.float32).unbind(-1)
    return torch.stack([cx - dx / 2, cy - dy / 2, cx + dx / 2, cy + dy / 2],
                       dim=-1)


def anchor_bev_norm(anchors: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., 6) anchors -> (..., 4) crop boxes (y1, x1, y2, x2) on the BEV
    map normalised by the grid's extent (row 0 at x_max, column 0 at
    y_max), as AVOD's ``project_to_bev`` normalises them."""
    t = cfg.top
    cx, cy, _, dx, dy, _ = anchors.to(torch.float32).unbind(-1)
    xr = torch.tensor(t.x_max - t.x_min, dtype=torch.float32,
                      device=anchors.device)
    yr = torch.tensor(t.y_max - t.y_min, dtype=torch.float32,
                      device=anchors.device)
    return torch.stack([(t.x_max - (cx + dx / 2)) / xr,
                        (t.y_max - (cy + dy / 2)) / yr,
                        (t.x_max - (cx - dx / 2)) / xr,
                        (t.y_max - (cy - dy / 2)) / yr], dim=-1)


def image_box_norm(corners: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., 8, 3) lidar corners -> (..., 4) crop boxes (y1, x1, y2, x2) on
    the image: the KITTI projection ([P|1] @ Mt @ Kt over depth, as
    :func:`box3d_to_rgb_box`, unrounded) enveloped and normalised by
    ``avod.calib_image_shape``, as AVOD's ``project_to_image_space``."""
    dev = corners.device
    b = corners.to(torch.float32)
    ps = torch.cat([b, torch.ones_like(b[..., :1])], dim=-1)
    mt = torch.tensor(cfg.matrix_mt, dtype=torch.float32, device=dev)
    kt = torch.tensor(cfg.matrix_kt, dtype=torch.float32, device=dev)
    qs = _affine(_affine(ps, mt)[..., :3], kt)
    u = qs[..., 0] / qs[..., 2]
    v = qs[..., 1] / qs[..., 2]
    h, w = cfg.avod.calib_image_shape
    hs = torch.tensor(float(h), dtype=torch.float32, device=dev)
    ws = torch.tensor(float(w), dtype=torch.float32, device=dev)
    return torch.stack([v.amin(-1) / hs, u.amin(-1) / ws,
                        v.amax(-1) / hs, u.amax(-1) / ws], dim=-1)


def anchor_decode(anchors: torch.Tensor, offsets: torch.Tensor
                  ) -> torch.Tensor:
    """AVOD's ``offset_to_anchor``: centre offsets scaled by the anchor's
    extents, log-extent offsets: (..., 6) x (..., 6) -> (..., 6)."""
    a = anchors.to(torch.float32)
    t = offsets.to(torch.float32)
    centre = t[..., :3] * a[..., 3:] + a[..., :3]
    extent = torch.exp(torch.log(a[..., 3:]) + t[..., 3:])
    return torch.cat([centre, extent], dim=-1)


def anchor_to_box4c(anchors: torch.Tensor, ground_z: float) -> torch.Tensor:
    """(..., 6) anchors -> (..., 10) box_4c: the BEV corners in
    :func:`anchor_corners`' order, then the bottom and top heights above
    the ground."""
    c = anchor_corners(anchors)
    h1 = anchors[..., 2].to(torch.float32) - ground_z
    h2 = h1 + anchors[..., 5].to(torch.float32)
    return torch.cat([c[..., :4, 0], c[..., :4, 1], h1[..., None],
                      h2[..., None]], dim=-1)


def box4c_to_box3d(box4c: torch.Tensor, ground_z: float) -> torch.Tensor:
    """(..., 10) box_4c -> (..., 7) box3d (cx, cy, z_bottom, l, w, h, ry):
    AVOD's ``box_4c_to_box_3d``. The longer of the two axes joining the
    midpoints of opposite sides (1-2 against 3-4, 1-4 against 2-3) gives
    the yaw; the corners' extents along it and across it give l and w
    and the centre (the middle of each extent)."""
    b = box4c.to(torch.float32)
    p = torch.stack([b[..., 0:4], b[..., 4:8]], dim=-1)        # (..., 4, 2)
    m12 = (p[..., 0, :] + p[..., 1, :]) / 2
    m23 = (p[..., 1, :] + p[..., 2, :]) / 2
    m34 = (p[..., 2, :] + p[..., 3, :]) / 2
    m14 = (p[..., 0, :] + p[..., 3, :]) / 2
    v1, v2 = m12 - m34, m14 - m23
    n1, n2 = torch.linalg.vector_norm(v1, dim=-1), torch.linalg.vector_norm(
        v2, dim=-1)
    first = (n1 > n2)[..., None]
    axis = torch.where(first, v1, v2)
    base = torch.where(first, m34, m23)
    u = axis / torch.where(first[..., 0], n1, n2)[..., None]
    o = torch.stack([-u[..., 1], u[..., 0]], dim=-1)
    rel = p - base[..., None, :]
    along = (rel * u[..., None, :]).sum(-1)
    across = (rel * o[..., None, :]).sum(-1)
    lo_l, hi_l = along.amin(-1), along.amax(-1)
    lo_w, hi_w = across.amin(-1), across.amax(-1)
    centre = (base + u * ((lo_l + hi_l) / 2)[..., None]
              + o * ((lo_w + hi_w) / 2)[..., None])
    ry = torch.atan2(u[..., 1], u[..., 0])
    zb = b[..., 8] + ground_z
    return torch.stack([centre[..., 0], centre[..., 1], zb, hi_l - lo_l,
                        hi_w - lo_w, b[..., 9] - b[..., 8], ry], dim=-1)


def box3d_to_box4c(box3d: torch.Tensor, ground_z: float) -> torch.Tensor:
    """(..., 7) box3d -> (..., 10) box_4c: AVOD's ``box_3d_to_box_4c``. The
    yaw is split into its nearest multiple of 90 degrees, which turns the
    box into an axis-aligned extent (l and w swapped at odd multiples),
    and the rest, by which the extent's corners (in
    :func:`anchor_corners`' order) are turned about the centre."""
    b = box3d.to(torch.float32)
    cx, cy, zb, length, width, height, ry = b.unbind(-1)
    half_pi = torch.pi / 2
    quarter = torch.round(ry / half_pi)
    odd = torch.remainder(quarter, 2) == 1
    # ry = 0 lays the length along x here
    dx = torch.where(odd, width, length)
    dy = torch.where(odd, length, width)
    rest = ry - quarter * half_pi
    hx, hy = dx / 2, dy / 2
    lx = torch.stack([hx, hx, -hx, -hx], dim=-1)
    ly = torch.stack([hy, -hy, -hy, hy], dim=-1)
    c, s = torch.cos(rest)[..., None], torch.sin(rest)[..., None]
    xs = c * lx - s * ly + cx[..., None]
    ys = s * lx + c * ly + cy[..., None]
    h1 = zb - ground_z
    return torch.cat([xs, ys, h1[..., None], (h1 + height)[..., None]],
                     dim=-1)


def align_orientation(box3d: torch.Tensor, angle_vector: torch.Tensor
                      ) -> torch.Tensor:
    """``box_4ca``: the box's yaw turned to within 45 degrees of the
    predicted angle vector's (cos, sin), the footprint unchanged: by 90
    degrees with l and w swapped where the two lie 45-135 degrees apart, by
    180 degrees where farther."""
    b = box3d.to(torch.float32)
    pred = torch.atan2(angle_vector[..., 1].float(),
                       angle_vector[..., 0].float())
    ry = b[..., 6]
    diff = torch.remainder(pred - ry + torch.pi, 2 * torch.pi) - torch.pi
    size = diff.abs()
    swap = (size > torch.pi / 4) & (size < 3 * torch.pi / 4)
    flip = size >= 3 * torch.pi / 4
    turn = torch.where(swap, torch.sign(diff) * (torch.pi / 2),
                       torch.where(flip, torch.pi, 0.0))
    length = torch.where(swap, b[..., 4], b[..., 3])
    width = torch.where(swap, b[..., 3], b[..., 4])
    return torch.stack([b[..., 0], b[..., 1], b[..., 2], length, width,
                        b[..., 5], ry + turn], dim=-1)


def box3d_corners(box3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) box3d -> (..., 8, 3) corners: the bottom face (+l/2, +w/2),
    (+l/2, -w/2), (-l/2, -w/2), (-l/2, +w/2) turned by ry about the centre,
    then the top face h above it."""
    b = box3d.to(torch.float32)
    cx, cy, zb, length, width, height, ry = b.unbind(-1)
    hl, hw = (length / 2)[..., None], (width / 2)[..., None]
    sl = torch.tensor([1.0, 1.0, -1.0, -1.0], device=b.device)
    sw = torch.tensor([1.0, -1.0, -1.0, 1.0], device=b.device)
    lx, ly = hl * sl, hw * sw
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    xs = c * lx - s * ly + cx[..., None]
    ys = s * lx + c * ly + cy[..., None]
    bottom = torch.stack([xs, ys, zb[..., None].expand_as(xs)], dim=-1)
    top = torch.stack([xs, ys, (zb + height)[..., None].expand_as(xs)],
                      dim=-1)
    return torch.cat([bottom, top], dim=-2)
