"""Debug drawing: gt, proposal and detection boxes on the BEV and camera
images, without PIL.

Port of ``mv3d_tpu/utils/viz.py``. The JAX package draws its segments with
PIL's ``ImageDraw.line(width=1)``; :func:`draw_lines` sets the same pixels
in numpy: each float end point is truncated toward zero, the segment is
walked by Bresenham's integer algorithm from its first end point (its
last point excluded), then the end point itself is set, and points off
the image are dropped. Segments are drawn in order, so a later one wins
where they cross.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from ..config import Config, cfg as _default_cfg
from ..ops import boxes3d as box3d_ops

Segment = Tuple[Tuple[float, float], Tuple[float, float]]


def _ceil_div(p: int, q: int) -> int:
    return -((-p) // q)


def _walk_range(c0: int, step: int, lo: int, hi: int, n: int):
    """Steps i in [0, n) with lo <= c0 + step * i < hi (step +-1)."""
    if step > 0:
        return max(0, lo - c0), min(n, hi - c0)
    return max(0, c0 - hi + 1), min(n, c0 - lo + 1)


def _carry_range(c0: int, step: int, lo: int, hi: int, minor: int,
                 major: int, n: int):
    """Steps i in [0, n) with lo <= c0 + step * k(i) < hi, where
    k(i) = (2 * minor * i + major) // (2 * major) is nondecreasing."""
    a, b = ((lo - c0, hi - 1 - c0) if step > 0
            else (c0 - hi + 1, c0 - lo))
    if minor == 0:
        return (0, n) if a <= 0 <= b else (0, 0)
    return (max(0, _ceil_div(2 * major * a - major, 2 * minor)),
            min(n, _ceil_div(2 * major * b + major, 2 * minor)))


def line_pixels(x0: int, y0: int, x1: int, y1: int, width: int,
                height: int) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels inside a ``width`` x ``height`` image of one width-1
    segment between integer end points, in the order PIL sets them:
    Bresenham's walk from (x0, y0) along the major axis (``max(|dx|,
    |dy|)`` steps; after ``i`` steps the minor coordinate has moved by
    ``(2 * minor * i + major) // (2 * major)``, the count of the walk's
    error-term carries), then (x1, y1). Only the steps that land in the
    image are made, so a far end point costs nothing."""
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx = 1 if x1 >= x0 else -1
    sy = 1 if y1 >= y0 else -1
    n = max(dx, dy)
    if dx > dy:
        ranges = (_walk_range(x0, sx, 0, width, n),
                  _carry_range(y0, sy, 0, height, dy, dx, n))
    else:
        ranges = (_walk_range(y0, sy, 0, height, n),
                  _carry_range(x0, sx, 0, width, dx, max(dy, 1), n))
    i = np.arange(max(r[0] for r in ranges), min(r[1] for r in ranges),
                  dtype=np.int64)
    if dx > dy:
        xs = x0 + sx * i
        ys = y0 + sy * ((2 * dy * i + dx) // (2 * dx))
    else:
        ys = y0 + sy * i
        xs = x0 + sx * ((2 * dx * i + dy) // max(2 * dy, 1))
    if 0 <= x1 < width and 0 <= y1 < height:
        xs, ys = np.append(xs, x1), np.append(ys, y1)
    return xs, ys


def draw_lines(img: np.ndarray, segments: Iterable[Segment], color
               ) -> np.ndarray:
    """A copy of ``img`` (H, W, C) uint8 with each segment drawn in
    ``color`` at width 1."""
    out = np.array(img, copy=True)
    h, w = out.shape[:2]
    color = np.asarray(color, out.dtype)[:out.shape[2]]
    for (x0, y0), (x1, y1) in segments:
        xs, ys = line_pixels(int(float(x0)), int(float(y0)),
                             int(float(x1)), int(float(y1)), w, h)
        out[ys, xs] = color
    return out


def draw_top_image(top: np.ndarray) -> np.ndarray:
    """Normalized channel-sum BEV image."""
    img = np.sum(top, axis=2)
    img = img - img.min()
    div = img.max() - img.min()
    img = img / div * 255 if div > 0 else img
    return np.dstack([img] * 3).astype(np.uint8)


def draw_boxes2d(image: np.ndarray, boxes: np.ndarray,
                 color=(255, 255, 0)) -> np.ndarray:
    """Draw (N, 4) [x1, y1, x2, y2] boxes."""
    segs = []
    for b in np.asarray(boxes):
        x1, y1, x2, y2 = b[:4]
        segs += [((x1, y1), (x2, y1)), ((x2, y1), (x2, y2)),
                 ((x2, y2), (x1, y2)), ((x1, y2), (x1, y1))]
    return draw_lines(image, segs, color)


def _as_boxes(boxes3d) -> torch.Tensor:
    return torch.as_tensor(np.asarray(boxes3d, np.float32))


def draw_box3d_on_top(image: np.ndarray, boxes3d: np.ndarray,
                      color=(255, 255, 255),
                      cfg: Config = _default_cfg) -> np.ndarray:
    """Draw 3D boxes' bottom faces on the BEV image."""
    if len(boxes3d) == 0:
        return image
    b = _as_boxes(boxes3d)
    us, vs = (v.numpy() for v in box3d_ops.lidar_to_top_coords(
        b[:, 0:4, 0], b[:, 0:4, 1], cfg))
    segs = [((us[n, k], vs[n, k]), (us[n, (k + 1) % 4], vs[n, (k + 1) % 4]))
            for n in range(len(us)) for k in range(4)]
    return draw_lines(image, segs, color)


def draw_rgb_projections(image: np.ndarray, boxes3d: np.ndarray,
                         color=(255, 0, 255),
                         cfg: Config = _default_cfg) -> np.ndarray:
    """Draw 3D wireframes projected into the camera image."""
    if len(boxes3d) == 0:
        return image
    proj = box3d_ops.box3d_to_rgb_box(_as_boxes(boxes3d), cfg).numpy()
    segs = []
    for q in proj:
        for k in range(4):
            j = (k + 1) % 4
            segs += [(tuple(q[k]), tuple(q[j])),
                     (tuple(q[k + 4]), tuple(q[j + 4])),
                     (tuple(q[k]), tuple(q[k + 4]))]
    return draw_lines(image, segs, color)
