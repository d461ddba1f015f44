"""A plain reference of AVOD's forward pass, raw (points, rgb) frames in,
per frame (boxes3d (K, 8, 3), probs (K,)) out, in plain PyTorch.

AVOD: Ku, Mozifian, Lee, Harakeh, Waslander, "Joint 3D Proposal
Generation and Object Detection from View Aggregation", IROS 2018
(arXiv:1712.02294), section III; github.com/kujason/avod,
``avod/configs/avod_cars_example.config``. It imports nothing of the
program under test and nothing of JAX: it reads the configuration tree
(``dataclasses.asdict`` of the program's configuration, or its JSON) by
key, voxelizes by scatter, crops by per-sample bilinear reads, and
suppresses with a plain greedy loop. It computes in
``model.compute_dtype`` (f32 for the checks, TF32 off by the caller),
BatchNorm in f32 rounded once to that dtype.

Its weights have the program's ``state_dict`` names and shapes, so both
load the same tensors. It runs the RPN's heads on the non-empty anchors
only, as AVOD feeds them, so a FLOP count of it counts AVOD's work.

Departures from AVOD (each shared with the program, whose results this
reproduces; AVOD works in the camera frame over a fitted ground plane):

  * the lidar frame (x forward, y left, z up) over a flat ground at
    ``avod.ground_z``; the BEV grid is ``top`` (rows from x_max, columns
    from y_max); a point on a height slice's boundary counts in the lower
    slice at height 1, and above the top slice in the top slice (the
    clamp), as in the program's voxelizer;
  * the empty-anchor filter sums the point counts over the cells whose
    centres an anchor's footprint holds, leaving out the map's last row
    and column (the program's integral image);
  * an anchor's offsets and ``box_4c`` are written in the lidar frame,
    anchors at ``anchor_rotations`` 0 lying along y;
  * the box fit from ``box_4c`` centres the box across its width;
  * the final NMS is on the boxes' enveloping top-view pixel boxes in the
    "+1" pixel convention, before the score threshold;
  * no image mean subtraction, no dropout (inference).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# KITTI's calibration (lidar -> camera -> pixels), the matrices the
# program's configuration carries
KITTI_MT = np.array(
    [[2.34773698e-04, 1.04494074e-02, 9.99945389e-01, 0.00000000e+00],
     [-9.99944155e-01, 1.05653536e-02, 1.24365378e-04, 0.00000000e+00],
     [-1.05634778e-02, -9.99889574e-01, 1.04513030e-02, 0.00000000e+00],
     [5.93721868e-02, -7.51087914e-02, -2.72132796e-01, 1.00000000e+00]])
KITTI_KT = np.array([[721.5377, 0.0, 0.0], [0.0, 721.5377, 0.0],
                     [609.5593, 172.854, 1.0]])


@dataclasses.dataclass(frozen=True)
class Spec:
    """What the reference reads of a configuration tree."""
    x_min: float
    x_max: float
    y_min: float
    y_max: float
    z_min: float
    z_max: float
    x_div: float
    y_div: float
    z_div: float
    image_h: int
    image_w: int
    max_points: int
    compute_dtype: str
    view_dtype: str
    num_class: int
    remove_empty_thresh: float
    rpn_nms_thresh: float
    rpn_topn: int
    final_nms_thresh: float
    vgg_conv: Tuple[Tuple[int, int], ...]
    density_log_base: float
    ground_z: float
    calib_image_shape: Tuple[int, int]
    anchor_stride: float
    anchor_sizes: Tuple[Tuple[float, float, float], ...]
    anchor_rotations: Tuple[float, ...]
    rpn_crop: int
    rpn_fc: Tuple[int, ...]
    rcnn_crop: int
    rcnn_fc: Tuple[int, ...]
    final_topn: int

    @property
    def xn(self) -> int:
        return int((self.x_max - self.x_min) // self.x_div) + 1

    @property
    def yn(self) -> int:
        return int((self.y_max - self.y_min) // self.y_div) + 1

    @property
    def zn(self) -> int:
        return int((self.z_max - self.z_min) / self.z_div)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def _tup(v):
    return tuple(_tup(x) for x in v) if isinstance(v, (list, tuple)) else v


def spec_from_tree(tree: Dict[str, Any]) -> Spec:
    """The reference's :class:`Spec` from a configuration tree (nested
    dicts: ``top``, ``model``, ``pipeline``, ``rpn``, ``rcnn``, ``avod``,
    ``image_width``/``image_height``)."""
    if "avod" not in tree:
        raise ValueError("not an AVOD configuration: the tree has no "
                         "\"avod\" settings")
    t, m, p, a = tree["top"], tree["model"], tree["pipeline"], tree["avod"]
    crops = (tree.get("image_crop_top", 0) + tree.get("image_crop_bottom", 0),
             tree.get("image_crop_left", 0) + tree.get("image_crop_right", 0))
    return Spec(
        x_min=t["x_min"], x_max=t["x_max"], y_min=t["y_min"],
        y_max=t["y_max"], z_min=t["z_min"], z_max=t["z_max"],
        x_div=t["x_div"], y_div=t["y_div"], z_div=t["z_div"],
        image_h=tree["image_height"] - crops[0],
        image_w=tree["image_width"] - crops[1],
        max_points=p["max_points"], compute_dtype=m["compute_dtype"],
        view_dtype=p["top_view_dtype"], num_class=m["num_class"],
        remove_empty_thresh=p["remove_empty_thresh"],
        rpn_nms_thresh=tree["rpn"]["nms_thresh"],
        rpn_topn=tree["rpn"]["nms_post_topn"],
        final_nms_thresh=tree["rcnn"]["nms_thresh"],
        vgg_conv=_tup(a["vgg_conv"]),
        density_log_base=a["density_log_base"], ground_z=a["ground_z"],
        calib_image_shape=_tup(a["calib_image_shape"]),
        anchor_stride=a["anchor_stride"],
        anchor_sizes=_tup(a["anchor_sizes"]),
        anchor_rotations=_tup(a["anchor_rotations"]),
        rpn_crop=a["rpn_crop"], rpn_fc=_tup(a["rpn_fc"]),
        rcnn_crop=a["rcnn_crop"], rcnn_fc=_tup(a["rcnn_fc"]),
        final_topn=a["final_topn"])


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 0-dim constant on ``like``'s device (dividing by it, not by a
    Python float, rounds the same on every device)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# -- the BEV ------------------------------------------------------------------

def bev(points: torch.Tensor, num: torch.Tensor, s: Spec
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 4) padded points and (B,) counts -> the (B, Xn, Yn, Zn + 1)
    BEV (max height above each slice's floor in slice units, then
    ``min(1, log(count + 1) / log(density_log_base))``) in the view dtype,
    and the (B, Xn, Yn) f32 point counts. Scatter max and scatter add."""
    bsz, n, _ = points.shape
    xn, yn, zn = s.xn, s.yn, s.zn
    p = points.to(torch.float32)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    keep = ((x > _c(s.x_min, p)) & (x < _c(s.x_max, p))
            & (y > _c(s.y_min, p)) & (y < _c(s.y_max, p))
            & (z > _c(s.z_min, p)) & (z < _c(s.z_max, p))
            & (torch.arange(n, device=p.device)[None] < num[:, None]))
    qx = torch.floor((x - _c(s.x_min, p)) / _c(s.x_div, p))
    qy = torch.floor((y - _c(s.y_min, p)) / _c(s.y_div, p))
    qz = (z - _c(s.z_min, p)) / _c(s.z_div, p)
    qx = torch.where(keep, qx, 0.0).to(torch.int64)
    qy = torch.where(keep, qy, 0.0).to(torch.int64)
    qz = torch.where(keep, qz, 0.0)
    sl = torch.clamp(torch.floor(qz), max=zn - 1)
    frac = qz - sl
    on_floor = (frac == 0.0) & (sl >= 1)
    sl = torch.where(on_floor, sl - 1, sl).to(torch.int64)
    val = torch.where(on_floor, 1.0, frac)
    cell = (xn - 1 - qx) * yn + (yn - 1 - qy)
    frame = torch.arange(bsz, device=p.device)[:, None]
    heights = torch.zeros(bsz * xn * yn * zn, device=p.device)
    heights.scatter_reduce_(
        0, ((frame * xn * yn + cell) * zn + sl)[keep],
        val[keep], "amax")
    counts = torch.zeros(bsz * xn * yn, device=p.device)
    counts.index_add_(0, (frame * xn * yn + cell)[keep],
                      torch.ones_like(val[keep]))
    counts = counts.reshape(bsz, xn, yn)
    density = torch.clamp(torch.log(counts + 1.0)
                          / _c(math.log(s.density_log_base), counts), max=1.0)
    vd = getattr(torch, s.view_dtype)
    out = torch.cat([heights.reshape(bsz, xn, yn, zn).to(vd),
                     density[..., None].to(vd)], dim=-1)
    return out, counts


# -- anchors and boxes --------------------------------------------------------

def anchors(s: Spec) -> Tuple[torch.Tensor, np.ndarray]:
    """(A, 6) anchors (cx, cy, z_bottom, dx, dy, dz), grid row-major from
    (x_max, y_max), each size at each rotation; and per anchor its (row
    lo, row hi, col lo, col hi) cells (half-open), the cells whose centres
    its footprint holds."""
    gh = int(round((s.x_max - s.x_min) / s.anchor_stride))
    gw = int(round((s.y_max - s.y_min) / s.anchor_stride))
    step = int(round(s.anchor_stride / s.x_div))
    out, cells = [], []
    for i in range(gh):
        for j in range(gw):
            cx = s.x_max - s.anchor_stride * i
            cy = s.y_max - s.anchor_stride * j
            for length, width, height in s.anchor_sizes:
                for rot in s.anchor_rotations:
                    dx, dy = ((length, width) if rot % 180.0 == 90.0
                              else (width, length))
                    out.append((cx, cy, s.ground_z, dx, dy, height))
                    hr, hc = dx / 2.0 / s.x_div, dy / 2.0 / s.y_div
                    cells.append((step * i + math.ceil(-hr - 0.5),
                                  step * i + math.ceil(hr - 0.5),
                                  step * j + math.ceil(-hc - 0.5),
                                  step * j + math.ceil(hc - 0.5)))
    return (torch.tensor(np.asarray(out, np.float64), dtype=torch.float32),
            np.asarray(cells, np.int64))


def non_empty(counts: torch.Tensor, cells: np.ndarray, s: Spec
              ) -> torch.Tensor:
    """(B, Xn, Yn) counts -> (B, A) anchors whose cells hold more than
    ``remove_empty_thresh`` points (the last row and column left out)."""
    c = counts.to(torch.float64).clone()
    c[:, -1, :] = 0.0
    c[:, :, -1] = 0.0
    integral = F.pad(c.cumsum(1).cumsum(2), (1, 0, 1, 0))
    h, w = c.shape[1:]
    cl = torch.as_tensor(cells, device=c.device)
    r0, r1 = cl[:, 0].clamp(0, h), cl[:, 1].clamp(0, h)
    c0, c1 = cl[:, 2].clamp(0, w), cl[:, 3].clamp(0, w)
    total = (integral[:, r1, c1] - integral[:, r0, c1]
             - integral[:, r1, c0] + integral[:, r0, c0])
    return total > s.remove_empty_thresh


def corners_of(a: torch.Tensor) -> torch.Tensor:
    """(N, 6) axis-aligned boxes -> (N, 8, 3): bottom (+x,+y), (+x,-y),
    (-x,-y), (-x,+y), then top."""
    cx, cy, zb, dx, dy, dz = a.unbind(-1)
    xs = torch.stack([cx + dx / 2, cx + dx / 2, cx - dx / 2, cx - dx / 2], 1)
    ys = torch.stack([cy + dy / 2, cy - dy / 2, cy - dy / 2, cy + dy / 2], 1)
    z0 = zb[:, None].expand_as(xs)
    z1 = (zb + dz)[:, None].expand_as(xs)
    return torch.cat([torch.stack([xs, ys, z0], -1),
                      torch.stack([xs, ys, z1], -1)], 1)


def bev_boxes(a: torch.Tensor, s: Spec) -> torch.Tensor:
    """(N, 6) -> (N, 4) crop boxes (y1, x1, y2, x2) of the BEV map,
    normalised by the grid's extent."""
    cx, cy, _, dx, dy, _ = a.unbind(-1)
    xr, yr = _c(s.x_max - s.x_min, a), _c(s.y_max - s.y_min, a)
    return torch.stack([(s.x_max - (cx + dx / 2)) / xr,
                        (s.y_max - (cy + dy / 2)) / yr,
                        (s.x_max - (cx - dx / 2)) / xr,
                        (s.y_max - (cy - dy / 2)) / yr], -1)


def image_boxes(corners: torch.Tensor, s: Spec) -> torch.Tensor:
    """(N, 8, 3) lidar corners -> (N, 4) crop boxes of the image: the
    KITTI projection's envelope, normalised by ``calib_image_shape``."""
    dev = corners.device
    ps = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
    mt = torch.tensor(KITTI_MT, dtype=torch.float32, device=dev)
    kt = torch.tensor(KITTI_KT, dtype=torch.float32, device=dev)

    def times(p, m):       # products summed in index order
        out = p[..., 0:1] * m[0]
        for k in range(1, m.shape[0]):
            out = out + p[..., k:k + 1] * m[k]
        return out

    q = times(times(ps, mt)[..., :3], kt)
    u, v = q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
    h, w = s.calib_image_shape
    hs, ws = _c(float(h), corners), _c(float(w), corners)
    return torch.stack([v.amin(-1) / hs, u.amin(-1) / ws,
                        v.amax(-1) / hs, u.amax(-1) / ws], -1)


def crops(fmap: torch.Tensor, boxes: torch.Tensor, size: int
          ) -> torch.Tensor:
    """(H, W, C) map x (N, 4) normalised (y1, x1, y2, x2) boxes -> (N, size,
    size, C) f32 bilinear samples, TensorFlow's ``crop_and_resize`` (0
    outside the map)."""
    h, w, _ = fmap.shape
    m = fmap.to(torch.float32)
    grid = torch.arange(size, dtype=torch.float32, device=m.device)
    y1, x1, y2, x2 = boxes.to(torch.float32).unbind(-1)

    def at(lo, hi, n):
        ext = _c(n - 1, lo)
        if size == 1:
            return ((lo + hi) * 0.5 * ext)[:, None]
        return lo[:, None] * ext + grid * ((hi - lo) * ext
                                           / _c(size - 1, lo))[:, None]

    ys = torch.nan_to_num(at(y1, y2, h), nan=-1.0)
    xs = torch.nan_to_num(at(x1, x2, w), nan=-1.0)
    ok = (((ys >= 0) & (ys <= h - 1))[:, :, None]
          & ((xs >= 0) & (xs <= w - 1))[:, None, :])
    yf, xf = torch.floor(ys), torch.floor(xs)
    ya = yf.clamp(0, h - 1).long()[:, :, None]
    yb = torch.ceil(ys).clamp(0, h - 1).long()[:, :, None]
    xa = xf.clamp(0, w - 1).long()[:, None, :]
    xb = torch.ceil(xs).clamp(0, w - 1).long()[:, None, :]
    dy = (ys - yf)[:, :, None, None]
    dx = (xs - xf)[:, None, :, None]
    top = m[ya, xa] + (m[ya, xb] - m[ya, xa]) * dx
    bottom = m[yb, xa] + (m[yb, xb] - m[yb, xa]) * dx
    return torch.where(ok[..., None], top + (bottom - top) * dy, 0.0)


def greedy(boxes: np.ndarray, offset: float, thresh: float, max_out: int
           ) -> List[int]:
    """Positions kept by greedy NMS over (N, 4) boxes already in descending
    score order: a box is kept unless a kept one overlaps it, ``inter *
    (1 + t) > t * (area_i + area_j)`` in f32, until ``max_out`` are
    kept."""
    b = np.asarray(boxes, np.float32)
    off, t = np.float32(offset), np.float32(thresh)
    area = (b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off)
    kept: List[int] = []
    for i in range(len(b)):
        if kept:
            k = np.asarray(kept)
            iw = np.minimum(b[k, 2], b[i, 2]) - np.maximum(b[k, 0], b[i, 0]) \
                + off
            ih = np.minimum(b[k, 3], b[i, 3]) - np.maximum(b[k, 1], b[i, 1]) \
                + off
            inter = np.maximum(iw, np.float32(0)) * np.maximum(
                ih, np.float32(0))
            if (inter * (np.float32(1) + t) > t * (area[k] + area[i])).any():
                continue
        kept.append(i)
        if len(kept) == max_out:
            break
    return kept


def decode_anchors(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """AVOD's ``offset_to_anchor`` on (N, 6)."""
    return torch.cat([t[:, :3] * a[:, 3:] + a[:, :3],
                      torch.exp(torch.log(a[:, 3:]) + t[:, 3:])], 1)


def box4c_of(a: torch.Tensor, g: float) -> torch.Tensor:
    """(N, 6) axis-aligned boxes -> (N, 10) box_4c (x1..x4, y1..y4, h1,
    h2) over the ground at z = g."""
    c = corners_of(a)
    h1 = a[:, 2] - g
    return torch.cat([c[:, :4, 0], c[:, :4, 1], h1[:, None],
                      (h1 + a[:, 5])[:, None]], 1)


def box3d_of(b: torch.Tensor, g: float) -> torch.Tensor:
    """(N, 10) box_4c -> (N, 7) (cx, cy, z_bottom, l, w, h, ry): the longer
    midpoint axis gives ry, the corners' extents along and across it give
    l, w and the centre."""
    p = torch.stack([b[:, 0:4], b[:, 4:8]], -1)                 # (N, 4, 2)
    m12, m23 = (p[:, 0] + p[:, 1]) / 2, (p[:, 1] + p[:, 2]) / 2
    m34, m14 = (p[:, 2] + p[:, 3]) / 2, (p[:, 0] + p[:, 3]) / 2
    v1, v2 = m12 - m34, m14 - m23
    n1 = torch.linalg.vector_norm(v1, dim=1)
    n2 = torch.linalg.vector_norm(v2, dim=1)
    first = n1 > n2
    u = (torch.where(first[:, None], v1, v2)
         / torch.where(first, n1, n2)[:, None])
    base = torch.where(first[:, None], m34, m23)
    o = torch.stack([-u[:, 1], u[:, 0]], 1)
    along = ((p - base[:, None]) * u[:, None]).sum(-1)
    across = ((p - base[:, None]) * o[:, None]).sum(-1)
    lo_a, hi_a = along.amin(1), along.amax(1)
    lo_c, hi_c = across.amin(1), across.amax(1)
    centre = (base + u * ((lo_a + hi_a) / 2)[:, None]
              + o * ((lo_c + hi_c) / 2)[:, None])
    return torch.stack([centre[:, 0], centre[:, 1], b[:, 8] + g,
                        hi_a - lo_a, hi_c - lo_c, b[:, 9] - b[:, 8],
                        torch.atan2(u[:, 1], u[:, 0])], 1)


def turned(b: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """``box_4ca``: yaw to within 45 degrees of the angle vector's, the
    footprint kept (90 degrees with l and w swapped, or 180)."""
    pred = torch.atan2(ang[:, 1], ang[:, 0])
    diff = torch.remainder(pred - b[:, 6] + math.pi, 2 * math.pi) - math.pi
    a = diff.abs()
    swap = (a > math.pi / 4) & (a < 3 * math.pi / 4)
    turn = torch.where(swap, torch.sign(diff) * (math.pi / 2),
                       torch.where(a >= 3 * math.pi / 4, math.pi, 0.0))
    return torch.stack([b[:, 0], b[:, 1], b[:, 2],
                        torch.where(swap, b[:, 4], b[:, 3]),
                        torch.where(swap, b[:, 3], b[:, 4]), b[:, 5],
                        b[:, 6] + turn], 1)


def corners_3d(b: torch.Tensor) -> torch.Tensor:
    """(N, 7) -> (N, 8, 3): bottom (+l/2, +w/2), (+l/2, -w/2), (-l/2,
    -w/2), (-l/2, +w/2) turned by ry, then the top."""
    sl = torch.tensor([1.0, 1.0, -1.0, -1.0], device=b.device)
    sw = torch.tensor([1.0, -1.0, -1.0, 1.0], device=b.device)
    lx, ly = (b[:, 3:4] / 2) * sl, (b[:, 4:5] / 2) * sw
    c, s_ = torch.cos(b[:, 6:7]), torch.sin(b[:, 6:7])
    xs = c * lx - s_ * ly + b[:, 0:1]
    ys = s_ * lx + c * ly + b[:, 1:2]
    z0 = b[:, 2:3].expand_as(xs)
    z1 = (b[:, 2:3] + b[:, 5:6]).expand_as(xs)
    return torch.cat([torch.stack([xs, ys, z0], -1),
                      torch.stack([xs, ys, z1], -1)], 1)


def pixel_boxes(corners: torch.Tensor, s: Spec) -> torch.Tensor:
    """(N, 8, 3) -> (N, 4) enveloping top-view pixel boxes of the bottom
    face (column ``yn - floor((y - y_min) / y_div)``, row likewise)."""
    y, x = corners[:, :4, 1], corners[:, :4, 0]
    u = s.yn - torch.floor((y - s.y_min) / _c(s.y_div, y)).to(torch.int32)
    v = s.xn - torch.floor((x - s.x_min) / _c(s.x_div, x)).to(torch.int32)
    return torch.stack([u.amin(1), v.amin(1), u.amax(1), v.amax(1)],
                       1).to(torch.float32)


# -- the network --------------------------------------------------------------

# True inside ``h100bench/reference/avod.py::fused_epilogues``: products
# of bf16 inputs and weights are left in f32, unrounded, as a kernel that
# fuses the next step into the product's epilogue leaves them
KEEP_F32_PRODUCTS = False


def _product(op, x, w, dt, *args):
    """``op(x, w, *args)`` on ``x`` and ``w`` rounded to ``dt``, in ``dt``
    (or in f32 on the rounded values, with ``KEEP_F32_PRODUCTS``)."""
    x, w = x.to(dt), w.to(dt)
    args = tuple(a.to(dt) if torch.is_tensor(a) else a for a in args)
    if KEEP_F32_PRODUCTS and dt == torch.bfloat16:
        x, w = x.float(), w.float()
        args = tuple(a.float() if torch.is_tensor(a) else a for a in args)
    return op(x, w, *args)


class ConvBnRelu(nn.Module):
    """A bias-free conv (or a TensorFlow SAME stride-2 transposed conv) and
    BatchNorm + ReLU."""

    def __init__(self, in_c: int, out_c: int, k: int, up: bool = False):
        super().__init__()
        self.up = up
        if up:
            self.ConvTranspose_0 = nn.ConvTranspose2d(in_c, out_c, k, 2,
                                                      bias=False)
        else:
            self.Conv_0 = nn.Conv2d(in_c, out_c, k, padding=k // 2,
                                    bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(out_c)

    def forward(self, x, dt):
        if self.up:
            y = _product(F.conv_transpose2d, x, self.ConvTranspose_0.weight,
                         dt, None, 2)
        else:
            w = self.Conv_0.weight
            y = _product(F.conv2d, x, w, dt, None, 1, w.shape[-1] // 2)
        y = F.relu(self.BatchNorm_0(y.float())).to(dt)
        if self.up:
            y = y[:, :, :2 * x.shape[2], :2 * x.shape[3]]
        return y


class Pyramid(nn.Module):
    def __init__(self, in_c: int, vgg_conv):
        super().__init__()
        self.blocks = [n for n, _ in vgg_conv]
        widths = [c for _, c in vgg_conv]
        prev = in_c
        for b, (n, c) in enumerate(vgg_conv, 1):
            for j in range(1, n + 1):
                setattr(self, f"conv{b}_{j}", ConvBnRelu(prev, c, 3))
                prev = c
        for lvl in range(len(widths) - 1, 0, -1):
            setattr(self, f"upconv{lvl}",
                    ConvBnRelu(prev, widths[lvl - 1], 3, up=True))
            prev = widths[max(lvl - 2, 0)]
            setattr(self, f"fusion{lvl}",
                    ConvBnRelu(2 * widths[lvl - 1], prev, 3))

    def forward(self, x, dt):
        skips = []
        for b, n in enumerate(self.blocks, 1):
            if b > 1:
                x = F.max_pool2d(x, 2)
            for j in range(1, n + 1):
                x = getattr(self, f"conv{b}_{j}")(x, dt)
            skips.append(x)
        for lvl in range(len(self.blocks) - 1, 0, -1):
            up = getattr(self, f"upconv{lvl}")(x, dt)
            x = getattr(self, f"fusion{lvl}")(torch.cat([skips[lvl - 1], up],
                                                        1), dt)
        return x


class Rpn(nn.Module):
    def __init__(self, s: Spec):
        super().__init__()
        ch = s.vgg_conv[0][1]
        self.bev_bottleneck = ConvBnRelu(ch, 1, 1)
        self.img_bottleneck = ConvBnRelu(ch, 1, 1)
        for head, out in (("cls", 2), ("reg", 6)):
            sizes = [s.rpn_crop ** 2, *s.rpn_fc, out]
            for i in range(len(sizes) - 1):
                setattr(self, f"{head}_fc{6 + i}",
                        nn.Linear(sizes[i], sizes[i + 1]))
        self.depth = len(s.rpn_fc) + 1


class SecondStage(nn.Module):
    def __init__(self, s: Spec):
        super().__init__()
        sizes = [s.rcnn_crop ** 2 * s.vgg_conv[0][1], *s.rcnn_fc]
        for i in range(len(s.rcnn_fc)):
            setattr(self, f"fc{6 + i}", nn.Linear(sizes[i], sizes[i + 1]))
        self.depth = len(s.rcnn_fc)
        self.cls_out = nn.Linear(sizes[-1], s.num_class)
        self.off_out = nn.Linear(sizes[-1], 10)
        self.ang_out = nn.Linear(sizes[-1], 2)


def _dense(layer: nn.Linear, x, dt, relu: bool):
    y = _product(F.linear, x, layer.weight, dt, layer.bias)
    return F.relu(y) if relu else y


class AvodReference(nn.Module):
    """AVOD's network at ``spec`` with the program's parameter names; its
    conv and dense weights held in the compute dtype."""

    def __init__(self, spec: Spec):
        super().__init__()
        self.spec = spec
        self.bev_pyramid = Pyramid(spec.zn + 1, spec.vgg_conv)
        self.img_pyramid = Pyramid(3, spec.vgg_conv)
        self.rpn = Rpn(spec)
        self.second_stage = SecondStage(spec)
        a, cells = anchors(spec)
        self.register_buffer("anchors", a, persistent=False)
        self.cells = cells
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                m.to(spec.dtype)

    def features(self, top: torch.Tensor, rgb: torch.Tensor):
        """The (B, H, W, 32) maps of the BEV and the image, and the RPN's
        (B, H, W, 1) bottleneck maps of each."""
        s, dt, r = self.spec, self.spec.dtype, self.rpn
        pad = -s.xn % 2 ** (len(s.vgg_conv) - 1)
        x = F.pad(top.permute(0, 3, 1, 2).float(), (0, 0, pad, 0))
        bev_map = self.bev_pyramid(x, dt)[:, :, pad:]
        img_map = self.img_pyramid(rgb.permute(0, 3, 1, 2), dt)
        maps = (bev_map, img_map, r.bev_bottleneck(bev_map, dt),
                r.img_bottleneck(img_map, dt))
        return tuple(m.permute(0, 2, 3, 1) for m in maps)

    def rpn_scores(self, maps, f: int, idx: torch.Tensor):
        """Frame ``f``'s objectness and decoded proposals for the anchors
        ``idx`` (the RPN's heads on those alone)."""
        s, dt, r = self.spec, self.spec.dtype, self.rpn
        a = self.anchors[idx]
        fused = (crops(maps[2][f], bev_boxes(a, s), s.rpn_crop)
                 + crops(maps[3][f], image_boxes(corners_of(a), s),
                         s.rpn_crop)) / 2
        out = []
        for head in ("cls", "reg"):
            h = fused.reshape(len(idx), -1)
            for i in range(r.depth):
                h = _dense(getattr(r, f"{head}_fc{6 + i}"), h, dt,
                           i < r.depth - 1)
            out.append(h.float())
        score = torch.softmax(out[0], -1)[:, 1]
        return score, decode_anchors(a, out[1])

    def second(self, maps, f: int, props: torch.Tensor):
        """Frame ``f``'s class-1 probabilities and (N, 8, 3) boxes of the
        (N, 6) proposals."""
        s, dt, st = self.spec, self.spec.dtype, self.second_stage
        fused = (crops(maps[0][f], bev_boxes(props, s), s.rcnn_crop)
                 + crops(maps[1][f], image_boxes(corners_of(props), s),
                         s.rcnn_crop)) / 2
        h = fused.reshape(len(props), -1)
        for i in range(st.depth):
            h = _dense(getattr(st, f"fc{6 + i}"), h, dt, True)
        cls = _dense(st.cls_out, h, dt, False).float()
        off = _dense(st.off_out, h, dt, False).float()
        ang = _dense(st.ang_out, h, dt, False).float()
        probs = torch.softmax(cls, -1)[:, 1]
        b3 = turned(box3d_of(box4c_of(props, s.ground_z) + off, s.ground_z),
                    ang)
        return probs, corners_3d(b3)

    def ranked(self, maps, counts, f: int):
        """Frame ``f``'s non-empty anchors' objectness, descending (ties in
        anchor order), and their proposals in that order."""
        inside = non_empty(counts[f:f + 1], self.cells, self.spec)[0]
        idx = torch.nonzero(inside)[:, 0]
        score, props = self.rpn_scores(maps, f, idx)
        order = torch.sort(score, descending=True, stable=True)[1]
        return score[order], props[order]

    def detect_frame(self, maps, counts, f: int, score_threshold: float):
        s = self.spec
        _, props = self.ranked(maps, counts, f)
        boxes = torch.stack([props[:, 0] - props[:, 3] / 2,
                             props[:, 1] - props[:, 4] / 2,
                             props[:, 0] + props[:, 3] / 2,
                             props[:, 1] + props[:, 4] / 2], 1)
        keep = greedy(boxes.cpu().numpy(), 0.0, s.rpn_nms_thresh, s.rpn_topn)
        props = props[torch.as_tensor(keep, dtype=torch.long,
                                      device=props.device)]
        probs, corners = self.second(maps, f, props)
        order = torch.sort(probs, descending=True, stable=True)[1]
        final = greedy(pixel_boxes(corners[order], s).cpu().numpy(), 1.0,
                       s.final_nms_thresh, s.final_topn)
        pick = order[torch.as_tensor(final, dtype=torch.long,
                                     device=order.device)]
        live = probs[pick] > score_threshold
        return corners[pick][live], probs[pick][live]


def inputs(frames: Sequence[Tuple[np.ndarray, np.ndarray]], batch: int,
           s: Spec, device) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Raw frames as one padded batch: each cloud over the bucket cut to
    ``max_points`` evenly spaced rows (row ``i * n // max_points``), padded
    with rows at -1e9; images as float32; empty frames fill the batch."""
    n = s.max_points
    pts = np.full((batch, n, 4), -1e9, np.float32)
    num = np.zeros(batch, np.int64)
    rgb = np.zeros((batch, s.image_h, s.image_w, 3), np.float32)
    for i, (p, r) in enumerate(frames):
        p = np.asarray(p, np.float32)
        if len(p) > n:
            p = p[np.arange(n) * len(p) // n]
        pts[i, :len(p)] = p
        num[i] = len(p)
        rgb[i] = np.asarray(r, np.float32)
    return (torch.from_numpy(pts).to(device), torch.from_numpy(num).to(device),
            torch.from_numpy(rgb).to(device))


@torch.no_grad()
def detect(net: AvodReference, frames, batch: int, score_threshold: float
           ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Raw (points, rgb) frames -> per frame (boxes3d (K, 8, 3), probs (K,))
    of the detections above ``score_threshold``."""
    dev = net.anchors.device
    pts, num, rgb = inputs(frames, batch, net.spec, dev)
    top, counts = bev(pts, num, net.spec)
    maps = net.features(top, rgb)
    out = []
    for f in range(len(frames)):
        b, p = net.detect_frame(maps, counts, f, score_threshold)
        out.append((b.float().cpu().numpy(), p.float().cpu().numpy()))
    return out


@torch.no_grad()
def candidates(net: AvodReference, frames, batch: int, pool: int = 3
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per frame the second stage's box and class-1 probability for the
    ``pool * rpn_topn`` best-scored proposals of the non-empty anchors,
    before the proposal NMS: every box the final NMS could be offered
    under another rounding of the objectness."""
    dev = net.anchors.device
    pts, num, rgb = inputs(frames, batch, net.spec, dev)
    top, counts = bev(pts, num, net.spec)
    maps = net.features(top, rgb)
    out = []
    for f in range(len(frames)):
        _, props = net.ranked(maps, counts, f)
        props = props[:pool * net.spec.rpn_topn]
        p, b = net.second(maps, f, props)
        out.append((b.float().cpu().numpy(), p.float().cpu().numpy()))
    return out


@torch.no_grad()
def calibrate(net: AvodReference, frames, batch: int
              ) -> Dict[str, torch.Tensor]:
    """Each BatchNorm's running mean and biased variance set to its input's
    over one batch of ``frames`` (a train-mode pass normalises every layer
    with its batch's statistics, so each sees what it will see in eval
    mode); returns the weights on the CPU. A random network's features are
    otherwise unnormalised and its scores flat."""
    seen = {}

    def hook(module, args, _):
        x = args[0].float()
        var, mean = torch.var_mean(x, dim=[0, 2, 3], correction=0)
        seen[module] = (mean, var)

    bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
    handles = [m.register_forward_hook(hook) for m in bns]
    try:
        net.train()
        detect(net, frames, batch, 0.0)
    finally:
        net.eval()
        for h in handles:
            h.remove()
    for m, (mean, var) in seen.items():
        m.running_mean.copy_(mean)
        m.running_var.copy_(var)
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}
