"""Quantized point transfer for thin host->device links (serving option).

Port of ``mv3d_tpu/ops/quantize.py``. A (N, 4) f32 cloud costs 16 bytes a
point on the host->device link; the quantized form ships

  * xyz as uint16 fixed point over the top grid's crop bounds plus one
    division of margin, 6 bytes a point;
  * reflectance as uint8 / 255, 1 byte a point,

and the device dequantizes before voxelizing: 7/16 of the bytes.
Positions move by at most half a step (x ~0.6 mm, y ~0.5 mm, z ~0.04 mm on
the KITTI grid), so a point that close to a cell boundary may land one
cell over: a documented deviation, taken only where a serving artifact is
exported with ``quantized=True``. Padding rows clip to the upper margin,
outside the strict crop.

:func:`_bounds` and :func:`quantize_points` are the JAX package's numpy
code; :func:`dequantize_points` works on tensors on the points' device and
multiplies by f32 tensors there, never by Python floats (see the division
note in :mod:`mv3d_tpu_torch.ops.voxelize`), so it is bit-equal to the JAX
function on every device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import Config, cfg as _default_cfg

QMAX = 65535


def _bounds(cfg: Config) -> Tuple[np.ndarray, np.ndarray]:
    """Per-axis [lo, hi] quantization range: crop bounds + one division of
    margin, so in-crop points never clip and QMAX maps outside the crop."""
    t = cfg.top
    lo = np.array([t.x_min - t.x_div, t.y_min - t.y_div, t.z_min - t.z_div],
                  np.float32)
    hi = np.array([t.x_max + t.x_div, t.y_max + t.y_div, t.z_max + t.z_div],
                  np.float32)
    return lo, hi


def quantize_points(points: np.ndarray, cfg: Config = _default_cfg,
                    bounds: Tuple[np.ndarray, np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: (..., N, 4) f32 -> (xyz_q (..., N, 3) uint16,
    refl_q (..., N) uint8). Out-of-range points (padding rows too) clip to
    the margin bounds, which the strict crop rejects.

    ``bounds``: explicit (lo, hi) ranges, as a serving host reads them from
    an artifact's ``meta.json`` instead of a config."""
    points = np.asarray(points, np.float32)
    lo, hi = (np.asarray(bounds[0], np.float32),
              np.asarray(bounds[1], np.float32)) if bounds else _bounds(cfg)
    scale = (hi - lo) / QMAX
    q = np.clip(np.rint((points[..., :3] - lo) / scale), 0, QMAX
                ).astype(np.uint16)
    r = np.clip(np.rint(points[..., 3] * 255.0), 0, 255).astype(np.uint8)
    return q, r


def dequantize_points(xyz_q: torch.Tensor, refl_q: torch.Tensor,
                      cfg: Config = _default_cfg) -> torch.Tensor:
    """Device side: the quantized pair -> (..., N, 4) f32 points on
    ``xyz_q``'s device."""
    lo, hi = _bounds(cfg)
    scale = (hi - lo) / QMAX
    dev = xyz_q.device
    xyz = (xyz_q.to(torch.float32) * torch.from_numpy(scale).to(dev)
           + torch.from_numpy(lo).to(dev))
    refl = refl_q.to(dev, torch.float32) * torch.tensor(
        1.0 / 255.0, dtype=torch.float32, device=dev)
    return torch.cat([xyz, refl[..., None]], dim=-1)
