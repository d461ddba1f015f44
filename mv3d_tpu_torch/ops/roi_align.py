"""Bilinear ROI-align, batched over frames.

Port of ``mv3d_tpu/ops/roi_align.py::roi_align`` (the gather variant, the
default): a fixed grid of ``samples x samples`` taps per bin, averaged.
Taps outside the map read the clamped edge cell with the unclamped
fractional weight, as the JAX gather does. ROIs are in view coordinates
(x1, y1, x2, y2), x across the feature width, scaled by ``spatial_scale``.
Bin sizes divide by a device tensor: CUDA divides by a Python scalar as a
reciprocal multiply, and a last-bit change in a far-out ROI's bin moves
its taps' fractional weights.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .voxelize import f32c


def _tap_axes(rois: torch.Tensor, spatial_scale: float,
              pooled: Tuple[int, int], samples: int):
    """Separable tap coordinates: ys (..., ph, s) and xs (..., pw, s)."""
    ph, pw = pooled
    x1 = rois[..., 0] * spatial_scale
    y1 = rois[..., 1] * spatial_scale
    x2 = rois[..., 2] * spatial_scale
    y2 = rois[..., 3] * spatial_scale
    # malformed ROIs snap to >= 1-cell extent
    bin_w = torch.clamp(x2 - x1, min=1.0) / f32c(pw, rois)
    bin_h = torch.clamp(y2 - y1, min=1.0) / f32c(ph, rois)
    dev = rois.device
    iy = ((torch.arange(samples, dtype=torch.float32, device=dev) + 0.5)
          / f32c(samples, rois))
    py = torch.arange(ph, dtype=torch.float32, device=dev)
    px = torch.arange(pw, dtype=torch.float32, device=dev)
    ys = (y1[..., None, None]
          + (py[:, None] + iy[None, :]) * bin_h[..., None, None])
    xs = (x1[..., None, None]
          + (px[:, None] + iy[None, :]) * bin_w[..., None, None])
    return ys, xs


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              spatial_scale: float, pooled: Tuple[int, int] = (6, 6),
              samples: int = 2) -> torch.Tensor:
    """(B, H, W, C) features x (B, R, 4) rois -> (B, R, ph, pw, C) f32,
    the mean of ``samples**2`` bilinear taps per bin."""
    bsz, h, w, c = features.shape
    r = rois.shape[1]
    ph, pw = pooled
    ys, xs = _tap_axes(rois.to(torch.float32), spatial_scale, pooled,
                       samples)
    # broadcast to the (B, R, ph, pw, s, s) tap grid
    ys = ys[:, :, :, None, :, None].expand(bsz, r, ph, pw, samples, samples)
    xs = xs[:, :, None, :, None, :].expand(bsz, r, ph, pw, samples, samples)

    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = (ys - y0)[..., None]
    wx1 = (xs - x0)[..., None]
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)

    flat = features.reshape(bsz, h * w, c)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(bsz, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(yi.shape + (c,))

    vals = (tap(y0i, x0i) * (1 - wy1) * (1 - wx1)
            + tap(y0i, x1i) * (1 - wy1) * wx1
            + tap(y1i, x0i) * wy1 * (1 - wx1)
            + tap(y1i, x1i) * wy1 * wx1)
    return vals.mean(dim=(4, 5))
