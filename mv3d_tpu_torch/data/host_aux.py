"""Host-side point preparation for the loader: crop + pad, and the BEV
[intensity, density] aux plane.

The port's own numpy copies of ``mv3d_crop_pad`` and
``mv3d_lidar_to_top_aux`` (``mv3d_tpu/native/voxelize.cc``), whose
semantics are those of the numpy oracle ``mv3d_tpu/ops/voxelize_ref.py``:
strict-inequality crops in f32, intensity of the first point of largest
``qz`` in each cell (earliest index on ties), and density
``min(1, log(count + 1) / log 32)``. This is host code: the loader's
prefetch thread runs it while the card trains, and the device computes
only the height channels (:mod:`mv3d_tpu_torch.ops.voxelize_heights`).
The didi presets drop the capture car's own returns (the center-car
filter) in both, as the native library does for them.
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


def crop_pad(points: np.ndarray, max_points: int,
             cfg: Config = _default_cfg, pad_val: float = -1e9
             ) -> Tuple[np.ndarray, int]:
    """Crop to the grid bounds and pad to (max_points, 4): the first
    ``max_points`` surviving points in order, then rows of
    ``(pad_val, pad_val, pad_val, 0)``. Returns (padded, n_kept)."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    kept = points[crop_mask(points, cfg)][:max_points]
    out = np.full((max_points, 4), pad_val, np.float32)
    out[:, 3] = 0.0
    out[:len(kept)] = kept[:, :4]
    return out, len(kept)


def lidar_to_top_aux(points: np.ndarray, cfg: Config = _default_cfg
                     ) -> np.ndarray:
    """(N, 4) lidar points -> (Xn, Yn, 2) [intensity, density] plane,
    f32, with the top view's flipped indexing (row Xn-1-qx, col Yn-1-qy).
    Points are cropped here (strict bounds, the center-car filter)."""
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
    cell = (row * yn + col)[inside]
    qz, refl = qz[inside], p[inside, 3]

    aux = np.zeros((xn * yn, 2), np.float32)
    count = np.bincount(cell, minlength=xn * yn).astype(np.float32)
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
    return aux.reshape(xn, yn, 2)
