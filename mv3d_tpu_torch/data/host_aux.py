"""Host-side point preparation for the loader: crop + pad, and the BEV
[intensity, density] aux plane; and the host voxelizers of one frame.

The port's own numpy copies of ``mv3d_crop_pad``,
``mv3d_lidar_to_top_aux``, ``mv3d_lidar_to_top`` and
``mv3d_lidar_to_front`` (``mv3d_tpu/native/voxelize.cc``), whose
semantics are those of the numpy oracle ``mv3d_tpu/ops/voxelize_ref.py``:
strict-inequality crops in f32, intensity of the first point of largest
``qz`` in each cell (earliest index on ties), and density
``min(1, log(count + 1) / log 32)``. This is host code: the loader's
prefetch thread runs it while the card trains, and the device computes
only the height channels (:mod:`mv3d_tpu_torch.ops.voxelize_heights`).
The didi presets drop the capture car's own returns (the center-car
filter) in both, as the native library does for them. Where a cropped
cloud holds more than ``max_points``, ``crop_pad`` keeps an evenly spaced
subset, not the native library's first ``max_points``
(:func:`within_budget`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import Config, cfg as _default_cfg
from ..ops.voxelize import CENTER_CAR_DATASETS, check_dataset


def crop_mask(points: np.ndarray, cfg: Config = _default_cfg) -> np.ndarray:
    """(N, >=3) -> (N,) strict-bound crop mask, compared in f32, with the
    center-car filter of the didi presets."""
    check_dataset(cfg)
    t = cfg.top
    f = np.float32
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    m = ((x > f(t.x_min)) & (x < f(t.x_max)) &
         (y > f(t.y_min)) & (y < f(t.y_max)) &
         (z > f(t.z_min)) & (z < f(t.z_max)))
    if cfg.dataset_type in CENTER_CAR_DATASETS:
        m &= (np.abs(x) > f(4.7 / 2)) | (np.abs(y) > f(2.1 / 2))
    return m


def within_budget(points: np.ndarray, max_points: int) -> np.ndarray:
    """The rows of ``points`` that a budget of ``max_points`` keeps: all
    of them where they fit, else ``max_points`` evenly spaced over them
    (row ``i * n // max_points`` for ``i < max_points``), in order. The
    loader (``crop_pad``, after the crop) and the served model
    (``ServingModel.predict_batch``, on the raw cloud: the model crops on
    its device) cut to their budgets here.

    The JAX package (and its native library) keeps the first
    ``max_points``, which drops whatever a file holds last: a scan's last
    sectors, or all of a cloud written after its ground points (the
    rehearsal's fixture), so its views lose every return of the dropped
    region. Within the budget the two agree."""
    n = len(points)
    if n <= max_points:
        return points
    return points[np.arange(max_points) * n // max_points]


def crop_pad(points: np.ndarray, max_points: int,
             cfg: Config = _default_cfg, pad_val: float = -1e9
             ) -> Tuple[np.ndarray, int]:
    """Crop to the grid bounds and pad to (max_points, 4): the surviving
    points in order (an evenly spaced subset where more than
    ``max_points`` survive, :func:`within_budget`), then rows of
    ``(pad_val, pad_val, pad_val, 0)``. Returns (padded, n_kept)."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    kept = within_budget(points[crop_mask(points, cfg)], max_points)
    out = np.full((max_points, 4), pad_val, np.float32)
    out[:, 3] = 0.0
    out[:len(kept)] = kept[:, :4]
    return out, len(kept)


def _quantize(points: np.ndarray, cfg: Config):
    """Crop (N, 4) points and quantize the survivors: (cell, qz, refl),
    cells in the top view's flipped row-major order (row Xn-1-qx, col
    Yn-1-qy), f32 arithmetic as the native library's."""
    t = cfg.top
    xn, yn = t.xn, t.yn
    points = np.ascontiguousarray(points, dtype=np.float32)
    p = points[crop_mask(points, cfg)]
    f = np.float32
    qx = np.floor((p[:, 0] - f(t.x_min)) / f(t.x_div)).astype(np.int64)
    qy = np.floor((p[:, 1] - f(t.y_min)) / f(t.y_div)).astype(np.int64)
    qz = (p[:, 2] - f(t.z_min)) / f(t.z_div)
    row, col = xn - 1 - qx, yn - 1 - qy
    inside = (row >= 0) & (row < xn) & (col >= 0) & (col < yn)
    return (row * yn + col)[inside], qz[inside], p[inside, 3]


def _aux_cells(cell, qz, refl, n_cells: int) -> np.ndarray:
    """(n_cells, 2) [intensity, density]: the reflectance of each cell's
    first point of largest ``qz`` (earliest index on ties) and
    ``min(1, log(count + 1) / log 32)``."""
    f = np.float32
    aux = np.zeros((n_cells, 2), np.float32)
    count = np.bincount(cell, minlength=n_cells).astype(np.float32)
    occupied = count > 0
    aux[occupied, 1] = np.minimum(
        f(1.0), np.log(count[occupied] + f(1.0)) / np.log(f(32.0)))
    if len(cell):
        # per cell, the first point in (largest qz, lowest index) order
        order = np.lexsort((np.arange(len(cell)), -qz, cell))
        first = np.ones(len(order), dtype=bool)
        first[1:] = cell[order][1:] != cell[order][:-1]
        best = order[first]
        aux[cell[best], 0] = refl[best]
    return aux


def lidar_to_top_aux(points: np.ndarray, cfg: Config = _default_cfg
                     ) -> np.ndarray:
    """(N, 4) lidar points -> (Xn, Yn, 2) [intensity, density] plane,
    f32, with the top view's flipped indexing (row Xn-1-qx, col Yn-1-qy).
    Points are cropped here (strict bounds, the center-car filter)."""
    t = cfg.top
    return _aux_cells(*_quantize(points, cfg),
                      t.xn * t.yn).reshape(t.xn, t.yn, 2)


def lidar_to_top(points: np.ndarray, cfg: Config = _default_cfg
                 ) -> np.ndarray:
    """(N, 4) lidar points -> (Xn, Yn, Zn+2) f32 top view on the host: the
    port's copy of the native ``mv3d_lidar_to_top``. Slice ``s`` of a cell
    holds the max of ``qz - s`` over its points (the top slice takes the
    points above it), a point exactly on a slice floor also sets the slice
    below to 1.0 (the inclusive [z, z+1] interval), then the intensity and
    density channels of :func:`lidar_to_top_aux`."""
    t = cfg.top
    zn, n_cells = t.zn, t.xn * t.yn
    cell, qz, refl = _quantize(points, cfg)
    s = np.minimum(np.floor(qz).astype(np.int64), zn - 1)
    frac = qz - s.astype(np.float32)
    heights = np.zeros(n_cells * zn, np.float32)
    np.maximum.at(heights, cell * zn + s, frac)
    exact = (frac == 0.0) & (s >= 1)
    np.maximum.at(heights, cell[exact] * zn + s[exact] - 1, np.float32(1.0))
    return np.concatenate([heights.reshape(n_cells, zn),
                           _aux_cells(cell, qz, refl, n_cells)],
                          axis=1).reshape(t.xn, t.yn, zn + 2)


def lidar_to_front(points: np.ndarray, cfg: Config = _default_cfg
                   ) -> np.ndarray:
    """(N, 4) lidar points -> (width, height, 3) f32 front view on the
    host: the port's copy of the native ``mv3d_lidar_to_front``. Points
    are cropped to the grid bounds (no center-car filter: the front view
    keeps the capture car's returns); each pixel sums (height above
    ground, the distance with reflectance in the norm, reflectance) in
    point order and multiplies by ``1 / count`` where it holds more than
    one point."""
    t, fr = cfg.top, cfg.front
    f = np.float32
    p = np.ascontiguousarray(points, dtype=np.float32)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    m = ((x > f(t.x_min)) & (x < f(t.x_max)) & (y > f(t.y_min))
         & (y < f(t.y_max)) & (z > f(t.z_min)) & (z < f(t.z_max)))
    x, y, z, r = p[m, 0], p[m, 1], p[m, 2], p[m, 3]
    # (int) truncation toward zero
    pc = (np.arctan2(y, x) / f(fr.angular_res)).astype(np.int32)
    pr = (np.arctan2(z, np.sqrt(x * x + y * y))
          / f(fr.vertical_res)).astype(np.int32)
    keep = (pc > fr.c_min) & (pc < fr.c_max) & (pr > fr.r_min) & (
        pr < fr.r_max)
    cc, rr = pc + fr.c_offset, pr + fr.r_offset
    keep &= (cc >= 0) & (cc < fr.width) & (rr >= 0) & (rr < fr.height)
    pix = (cc * fr.height + rr)[keep].astype(np.int64)
    x, y, z, r = x[keep], y[keep], z[keep], r[keep]
    h = z + f(fr.velodyne_height)
    vals = np.stack([np.where(h > 0, h, f(0.0)),
                     np.sqrt(x * x + y * y + z * z + r * r), r], axis=1)
    n_pix = fr.width * fr.height
    front = np.zeros((n_pix, 3), np.float32)
    np.add.at(front, pix, vals)
    count = np.bincount(pix, minlength=n_pix)
    many = count > 1
    front[many] *= (f(1.0) / count[many].astype(np.float32))[:, None]
    return front.reshape(fr.width, fr.height, 3)
