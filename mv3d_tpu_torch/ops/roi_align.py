"""Bilinear ROI-align, batched over frames.

Port of ``mv3d_tpu/ops/roi_align.py``'s two variants: :func:`roi_align`
(the gather variant, the default) and :func:`roi_align_matmul`
(``model.roi_align_impl="matmul"``). Both average a fixed grid of
``samples x samples`` taps per bin; :func:`roi_pool_max` takes the
maximum of the gather variant's taps instead. They differ at the edge:
the gather variant reads the clamped edge cell with the unclamped
fractional weight, as the JAX gather does; the matmul variant clamps the
tap itself to [0, dim-1] first, as the JAX einsums do. ROIs are in view coordinates
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


def _bilinear_taps(features: torch.Tensor, rois: torch.Tensor,
                   spatial_scale: float, pooled: Tuple[int, int],
                   samples: int) -> torch.Tensor:
    """(B, H, W, C) x (B, R, 4) -> (B, R, ph, pw, s, s, C) bilinear taps,
    each reading the clamped edge cells with its unclamped weights."""
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

    return (tap(y0i, x0i) * (1 - wy1) * (1 - wx1)
            + tap(y0i, x1i) * (1 - wy1) * wx1
            + tap(y1i, x0i) * wy1 * (1 - wx1)
            + tap(y1i, x1i) * wy1 * wx1)


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              spatial_scale: float, pooled: Tuple[int, int] = (6, 6),
              samples: int = 2) -> torch.Tensor:
    """(B, H, W, C) features x (B, R, 4) rois -> (B, R, ph, pw, C) f32,
    the mean of ``samples**2`` bilinear taps per bin."""
    return _bilinear_taps(features, rois, spatial_scale, pooled,
                          samples).mean(dim=(4, 5))


def roi_pool_max(features: torch.Tensor, rois: torch.Tensor,
                 spatial_scale: float, pooled: Tuple[int, int] = (6, 6),
                 samples: int = 4) -> torch.Tensor:
    """(B, H, W, C) features x (B, R, 4) rois -> (B, R, ph, pw, C), the
    maximum of ``samples**2`` bilinear taps per bin."""
    return _bilinear_taps(features, rois, spatial_scale, pooled,
                          samples).amax(dim=(4, 5))


def roi_align_matmul(features: torch.Tensor, rois: torch.Tensor,
                     spatial_scale: float, pooled: Tuple[int, int] = (6, 6),
                     samples: int = 2) -> torch.Tensor:
    """(B, H, W, C) features x (B, R, 4) rois -> (B, R, ph, pw, C) in the
    features' dtype: ROI-align as two contractions with tent-weight
    matrices. A tap at y, clamped to [0, H-1], samples
    ``sum_h relu(1 - |y - h|) * F[h]``, and the taps are separable in y
    and x:

        B[b,r,p,s,w,c] = sum_h WY[b,r,p,s,h] * F[b,h,w,c]
        out[b,r,p,q,c] = mean_{s,t} sum_w WX[b,r,q,t,w] * B[b,r,p,s,w,c]

    The weights are computed in f32 and cast to the features' dtype, as
    the JAX package does; the contractions are ``torch.einsum``."""
    _, h, w, _ = features.shape
    ys, xs = _tap_axes(rois.to(torch.float32), spatial_scale, pooled,
                       samples)
    ys = torch.clamp(ys, 0.0, float(h - 1))
    xs = torch.clamp(xs, 0.0, float(w - 1))
    dev, dtype = features.device, features.dtype
    wy = torch.relu(1.0 - torch.abs(
        ys[..., None] - torch.arange(h, dtype=torch.float32, device=dev)))
    wx = torch.relu(1.0 - torch.abs(
        xs[..., None] - torch.arange(w, dtype=torch.float32, device=dev)))
    big = torch.einsum("brpsh,bhwc->brpswc", wy.to(dtype), features)
    out = torch.einsum("brqtw,brpswc->brpqstc", wx.to(dtype), big)
    return out.mean(dim=(4, 5))


def crop_and_resize(features: torch.Tensor, boxes: torch.Tensor,
                    crop: int) -> torch.Tensor:
    """(B, H, W, C) features x (B, R, 4) boxes -> (B, R, crop, crop, C)
    f32: TensorFlow's ``tf.image.crop_and_resize`` (bilinear, extrapolation
    value 0), the crops of AVOD. A box is (y1, x1, y2, x2) normalised so
    that 0 and 1 are the map's first and last rows and columns; sample
    (i, j) reads the map at ``y1 * (H - 1) + i * (y2 - y1) * (H - 1) /
    (crop - 1)`` (the box's middle where crop is 1) and likewise in x, a
    sample outside the map reads 0. The four taps are row gathers of the
    (B*H*W, C) map, interpolated in f32 in TensorFlow's order (across x on
    the top and bottom rows, then down y)."""
    bsz, h, w, c = features.shape
    r = boxes.shape[1]
    dev = features.device
    y1, x1, y2, x2 = boxes.to(torch.float32).unbind(-1)
    steps = torch.arange(crop, dtype=torch.float32, device=dev)

    def axis(lo, hi, size):
        extent = f32c(size - 1, lo)
        if crop == 1:
            return ((lo + hi) * 0.5 * extent)[..., None]
        scale = (hi - lo) * extent / f32c(crop - 1, lo)
        return lo[..., None] * extent + steps * scale[..., None]

    # a box projected from behind the camera may hold NaN: it reads 0
    ys = torch.nan_to_num(axis(y1, y2, h), nan=-1.0)   # (B, R, crop)
    xs = torch.nan_to_num(axis(x1, x2, w), nan=-1.0)
    inside = (((ys >= 0) & (ys <= h - 1))[..., :, None]
              & ((xs >= 0) & (xs <= w - 1))[..., None, :])
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0)[..., :, None, None]
    wx = (xs - x0)[..., None, :, None]
    yt = torch.clamp(y0, 0, h - 1).to(torch.int64)
    yb = torch.clamp(torch.ceil(ys), 0, h - 1).to(torch.int64)
    xl = torch.clamp(x0, 0, w - 1).to(torch.int64)
    xr = torch.clamp(torch.ceil(xs), 0, w - 1).to(torch.int64)
    flat = features.reshape(bsz * h * w, c)
    frame = (torch.arange(bsz, device=dev) * (h * w)).reshape(bsz, 1, 1, 1)

    def tap(yi, xi):
        idx = frame + yi[..., :, None] * w + xi[..., None, :]
        return flat[idx].to(torch.float32)             # (B, R, crop, crop, C)

    top_left, top_right = tap(yt, xl), tap(yt, xr)
    bottom_left, bottom_right = tap(yb, xl), tap(yb, xr)
    top = top_left + (top_right - top_left) * wx
    bottom = bottom_left + (bottom_right - bottom_left) * wx
    out = top + (bottom - top) * wy
    return torch.where(inside[..., None], out, 0.0).reshape(
        bsz, r, crop, crop, c)
