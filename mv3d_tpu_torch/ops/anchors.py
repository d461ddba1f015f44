"""Anchor generation and the empty-anchor filter.

Port of ``mv3d_tpu/ops/anchors.py``. The anchor set is built once in numpy
(``make_bases``, ``mv3d_car_bases``, ``make_anchors`` and ``anchor_setup``
are copied: the JAX module imports jax, which the machine that runs the
port lacks). The model's filter is ``non_empty_anchor_mask_structured``'s
``mode="window"`` on a full-resolution occupancy map, and
``_non_empty_anchor_mask_folded``'s decision on the folded occupancy of the
``s2d2``/``s2d2p`` views (:func:`non_empty_anchor_mask_folded`);
:func:`non_empty_anchor_mask` is the general one over any anchor list.

The window sums use an exclusive integral image in float64. Counts sum
exactly there, so the mask matches the JAX package bit for bit on the
count occupancy. (A conv or avg-pool would run in TF32 on CUDA, whose
10-bit mantissa cannot hold counts up to 65,536.)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import Config, cfg as _default_cfg
from .voxelize import unfold_occ4


def _bases_given_ws_hs(ws, hs, cx, cy):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack((cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                      cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)))


def make_bases(base_size=16, ratios=(0.5, 1, 2),
               scales=(8, 16, 32)) -> np.ndarray:
    """Ratio x scale anchor bases around a ``base_size`` reference box
    (reference ``make_bases``, rpn_target_op.py:53-64)."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    size = w * h
    ws_r = np.round(np.sqrt(size / ratios))
    hs_r = np.round(ws_r * ratios)
    ratio_bases = _bases_given_ws_hs(ws_r, hs_r, cx, cy)

    out = []
    for rb in ratio_bases:
        w = rb[2] - rb[0] + 1
        h = rb[3] - rb[1] + 1
        cx = rb[0] + 0.5 * (w - 1)
        cy = rb[1] + 0.5 * (h - 1)
        out.append(_bases_given_ws_hs(w * scales, h * scales, cx, cy))
    return np.vstack(out)


def mv3d_car_bases() -> np.ndarray:
    """The 4 hard-coded MV3D car bases (reference mv3d.py:186-191)."""
    return np.array([
        [4.5, 2.5, 10.5, 12.5],
        [2.5, 4.5, 12.5, 10.5],
        [-0.5, -12.0, 15.5, 27.0],
        [-12.0, -0.5, 27.0, 15.5],
    ])


def make_anchors(bases: np.ndarray, stride: int,
                 image_shape: Tuple[int, int],
                 feature_shape: Tuple[int, int],
                 allowed_border: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Shift bases over the stride grid; returns (anchors (A,4) int32,
    inside_mask (A,) bool). x spans the feature width, y the height."""
    H, W = feature_shape
    img_height, img_width = image_shape

    shift_x = np.arange(0, W) * stride
    shift_y = np.arange(0, H) * stride
    shift_x, shift_y = np.meshgrid(shift_x, shift_y)
    shifts = np.vstack((shift_x.ravel(), shift_y.ravel(),
                        shift_x.ravel(), shift_y.ravel())).transpose()

    B = len(bases)
    HW = len(shifts)
    anchors = (bases.reshape((1, B, 4)) +
               shifts.reshape((1, HW, 4)).transpose((1, 0, 2)))
    anchors = anchors.reshape((HW * B, 4)).astype(np.int32)

    inside = ((anchors[:, 0] >= -allowed_border) &
              (anchors[:, 1] >= -allowed_border) &
              (anchors[:, 2] < img_width + allowed_border) &
              (anchors[:, 3] < img_height + allowed_border))
    return anchors, inside


def anchor_setup(cfg: Config = _default_cfg) -> Tuple[np.ndarray, np.ndarray]:
    """The full static anchor set for the configured top view, with the
    reference's "use all" inside mask."""
    bases = mv3d_car_bases()
    feat = cfg.top_feature_shape()
    anchors, _ = make_anchors(bases, cfg.model.rpn_stride,
                              cfg.top.shape[:2], feat)
    inside = np.ones(len(anchors), dtype=bool)
    return anchors, inside


def non_empty_anchor_mask(top_view: torch.Tensor, anchors,
                          threshold: float = 0.0) -> torch.Tensor:
    """(..., H, W, C) BEV view x (A, 4) int anchors (x1, y1, x2, y2; x
    across W) -> (..., A) mask of anchors whose footprint holds mass >
    ``threshold``: the reference's empty-box kernel sums
    ``view[y1:y2, x1:x2, :]`` with each corner clamped into [0, dim-1]
    (an exclusive upper bound), here by an exclusive integral image in
    float64 and four gathers."""
    h, w = top_view.shape[-3], top_view.shape[-2]
    occ = top_view.to(torch.float64).sum(-1)
    s = torch.nn.functional.pad(occ.cumsum(-2).cumsum(-1), (1, 0, 1, 0))
    a = torch.as_tensor(anchors).to(top_view.device, torch.int64)
    x1 = a[:, 0].clamp(0, w - 1)
    y1 = a[:, 1].clamp(0, h - 1)
    x2 = torch.maximum(a[:, 2].clamp(0, w - 1), x1)
    y2 = torch.maximum(a[:, 3].clamp(0, h - 1), y1)
    rect = (s[..., y2, x2] - s[..., y1, x2] - s[..., y2, x1]
            + s[..., y1, x1])
    return rect > threshold


def non_empty_anchor_mask_structured(occ: torch.Tensor, bases: np.ndarray,
                                     stride: int,
                                     feature_shape: Tuple[int, int],
                                     threshold: float = 0.0) -> torch.Tensor:
    """(B, H, W) occupancy -> (B, A) mask of anchors whose clamped footprint
    holds mass > ``threshold``, in make_anchors' order (grid-major,
    base-minor).

    Same semantics as the JAX ``mode="window"``: the last row and column
    are zeroed (the reference's corner clamp into [0, dim-1] with an
    exclusive upper bound excludes them exactly when a window sticks out),
    then each anchor sums rows [y1 + i*s, y2 + i*s) and columns
    [x1 + j*s, x2 + j*s) intersected with the map."""
    bsz, h, w = occ.shape
    gh, gw = feature_shape
    dev = occ.device
    occ_z = occ.to(torch.float64).clone()
    occ_z[:, h - 1, :] = 0.0
    occ_z[:, :, w - 1] = 0.0
    # exclusive integral image: s[b, i, j] = sum(occ_z[b, :i, :j])
    s = torch.zeros(bsz, h + 1, w + 1, dtype=torch.float64, device=dev)
    s[:, 1:, 1:] = occ_z.cumsum(1).cumsum(2)
    gi = torch.arange(gh, device=dev) * stride
    gj = torch.arange(gw, device=dev) * stride

    masks = []
    for b in bases:
        x1, y1, x2, y2 = (int(b[0]), int(b[1]), int(b[2]), int(b[3]))
        if y2 <= y1 or x2 <= x1:          # degenerate base: empty rect
            masks.append(torch.zeros(bsz, gh, gw, dtype=torch.bool,
                                     device=dev))
            continue
        ylo = torch.clamp(gi + y1, 0, h)[:, None]
        yhi = torch.clamp(gi + y2, 0, h)[:, None]
        xlo = torch.clamp(gj + x1, 0, w)[None, :]
        xhi = torch.clamp(gj + x2, 0, w)[None, :]
        rect = (s[:, yhi, xhi] - s[:, ylo, xhi]
                - s[:, yhi, xlo] + s[:, ylo, xlo])          # (B, gh, gw)
        masks.append(rect > threshold)
    return torch.stack(masks, dim=-1).reshape(bsz, -1)


def non_empty_anchor_mask_folded(occ4: torch.Tensor, bases: np.ndarray,
                                 stride: int,
                                 feature_shape: Tuple[int, int],
                                 threshold: float,
                                 full_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, h2, w, 4) folded occupancy (sub = u*2 + v for the full-res cell
    (2i+u, 2j+v), the folded voxelizers' ``return_occ``) -> (B, A) mask.

    The JAX package sums each window by row/column parity on the folded map
    to skip the relayout; here the map is unfolded (:func:`unfold_occ4`
    drops the padded columns) and filtered at full resolution, which gives
    the same decisions for the count occupancy (integer sums are exact in
    both)."""
    h, w = full_hw
    return non_empty_anchor_mask_structured(
        unfold_occ4(occ4, h, w), bases, stride, feature_shape, threshold)
