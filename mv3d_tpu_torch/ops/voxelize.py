"""Lidar voxelization into the BEV ("top") and cylindrical front views.

Port of ``mv3d_tpu/ops/voxelize.py`` for the standard ``view_layout="hwc"``
view. Semantics are bit-identical to the JAX package and to its numpy
oracle ``mv3d_tpu/ops/voxelize_ref.py``: strict crops, the inclusive
slice-boundary redirect, first-max-point intensity and log-count density.

Without a host aux plane the top view runs through one kernel, the fused
sweep (:mod:`mv3d_tpu_torch.ops.voxelize_sweep`). With one (``aux``, the
(B, Xn, Yn, 2) intensity/density plane the loader computes on the host
when ``pipeline.host_aux_channels`` is set) only the height channels are
computed on the device, by the heights scatter-max kernel
(:mod:`mv3d_tpu_torch.ops.voxelize_heights`). In the JAX package the
``pipeline`` options ``use_pallas_fused``, ``use_pallas_heights``,
``voxel_order`` and ``sweep_kernel`` only choose a TPU formulation (XLA
scatters, a sorted Pallas sweep, its loop body, how points are grouped) of
these functions, so the port computes each through its one kernel
whatever they say. Options that change the result's layout raise
``NotImplementedError``: the folded ``s2d2``/``s2d2p`` views (ROADMAP A9 /
B2), and non-KITTI datasets (ROADMAP A1).

Quantization divides by a 0-dim tensor on the points' device, never by a
Python float: PyTorch's CUDA division by a CPU scalar multiplies by its
reciprocal, which moves boundary points by one cell.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config, cfg as _default_cfg

from .voxelize_heights import scatter_max_batched
from .voxelize_sweep import scatter_top_fused_batched


def f32c(x: float, like: torch.Tensor) -> torch.Tensor:
    """f32 0-dim constant on ``like``'s device (a Python float in JAX is a
    weakly-typed f32 constant; see the module note on division)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def check_dataset(cfg: Config) -> None:
    if cfg.dataset_type != "kitti":
        raise NotImplementedError(
            f"dataset_type={cfg.dataset_type!r}: only the KITTI preset is "
            f"ported (didi crop/center-car filter and projection: ROADMAP A1)")


def check_view_layout(cfg: Config) -> None:
    if cfg.pipeline.view_layout != "hwc":
        raise NotImplementedError(
            f"view_layout={cfg.pipeline.view_layout!r}: the folded views "
            f"are not ported (ROADMAP A9 / B2)")


def _crop_mask(points: torch.Tensor, cfg: Config,
               num_points: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, N, 4) -> (B, N) strict-bound crop + padding mask."""
    check_dataset(cfg)
    t = cfg.top
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    m = ((x > f32c(t.x_min, x)) & (x < f32c(t.x_max, x)) &
         (y > f32c(t.y_min, y)) & (y < f32c(t.y_max, y)) &
         (z > f32c(t.z_min, z)) & (z < f32c(t.z_max, z)))
    if num_points is not None:
        idx = torch.arange(points.shape[-2], device=points.device)
        m &= idx < num_points.to(points.device).reshape(-1, 1)
    return m


def _top_prep(points: torch.Tensor, cfg: Config,
              num_points: Optional[torch.Tensor]):
    """Per-point quantization (row-major cells) of a (B, N, 4) batch.

    Returns (valid, cell, flat, val, refl), each (B, N): crop mask, cell id
    (dump cell ``n_cells`` for invalid points), ``flat = cell*zn + s_eff``
    with the inclusive-boundary redirect applied (dump ``n_cells*zn``), the
    slice height value and reflectance."""
    t = cfg.top
    xn, yn, zn = t.xn, t.yn, t.zn
    n_cells = xn * yn
    points = points.to(torch.float32)
    valid = _crop_mask(points, cfg, num_points)

    def q(col, lo, div):
        return (points[..., col] - f32c(lo, points)) / f32c(div, points)

    # invalid points may quantize outside int32: zero them before the cast
    qx = torch.where(valid, torch.floor(q(0, t.x_min, t.x_div)), 0.0)
    qy = torch.where(valid, torch.floor(q(1, t.y_min, t.y_div)), 0.0)
    qz = torch.where(valid, q(2, t.z_min, t.z_div), 0.0)
    qx, qy = qx.to(torch.int32), qy.to(torch.int32)
    refl = points[..., 3]

    row = xn - 1 - qx
    col = yn - 1 - qy
    s = torch.clamp(torch.floor(qz), max=zn - 1).to(torch.int32)
    frac = qz - s.to(torch.float32)
    exact = (frac == 0.0) & (s >= 1)
    s_eff = torch.where(exact, s - 1, s)
    val = torch.where(valid, torch.where(exact, 1.0, frac), 0.0)

    cell = torch.where(valid, row * yn + col, n_cells)
    flat = torch.where(valid, cell * zn + s_eff, n_cells * zn)
    return valid, cell, flat, val, refl


def _occ_from_cells(heights2d, intensity, density, counts, cfg: Config):
    """Per-cell occupancy mass for the empty-anchor filter: at the default
    threshold 0.0 the point count has the channel sum's zero-set (see the
    JAX twin), otherwise the true channel sum."""
    if cfg.pipeline.remove_empty_thresh == 0.0:
        return counts
    return heights2d.to(torch.float32).sum(-1) + intensity + density


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, one channel after another: XLA's order on
    the CPU, and the same on every device (``torch.sum`` vectorizes)."""
    out = x[..., 0]
    for c in range(1, x.shape[-1]):
        out = out + x[..., c]
    return out


def lidar_to_top_batch(points: torch.Tensor, cfg: Config = _default_cfg,
                       num_points: Optional[torch.Tensor] = None,
                       aux: Optional[torch.Tensor] = None,
                       return_occ: bool = False):
    """(B, N, 4) -> (B, Xn, Yn, Zn+2) top view; with ``return_occ`` also the
    (B, Xn, Yn) occupancy the anchor filter reads.

    Channels 0..Zn-1: per-slice max height above the slice floor (z-cell
    units); Zn: reflectance of the highest point; Zn+1:
    ``min(1, log(count+1)/log 32)``. Rows/cols are flipped like the
    reference (top[Xn-1-qx, Yn-1-qy]).

    With ``aux`` (B, Xn, Yn, 2), the host's [intensity, density] plane,
    only the heights are computed here; the view is then f32 whatever
    ``top_view_dtype`` says, and the occupancy is the f32 sum of all its
    channels, as in the JAX package's aux branch."""
    check_view_layout(cfg)
    t = cfg.top
    xn, yn, zn = t.xn, t.yn, t.zn
    n_cells = xn * yn
    bsz = points.shape[0]
    _, _, flat, val, refl = _top_prep(points, cfg, num_points)
    if aux is not None:
        heights = scatter_max_batched(flat, val, n_cells * zn)
        top = torch.cat([heights.reshape(bsz, xn, yn, zn),
                         aux.to(heights.device, torch.float32)], dim=-1)
        return (top, _sum_in_order(top)) if return_occ else top
    heights, counts, intensity = scatter_top_fused_batched(
        flat, val, torch.where(flat < n_cells * zn, refl, 0.0), n_cells, zn)
    density = torch.clamp(torch.log(counts + 1.0) / f32c(math.log(32), counts),
                          max=1.0)
    view_dtype = getattr(torch, cfg.pipeline.top_view_dtype)
    heights2d = heights.reshape(bsz, n_cells, zn).to(view_dtype)
    top = torch.cat([heights2d, intensity[..., None].to(view_dtype),
                     density[..., None].to(view_dtype)], dim=2)
    top = top.reshape(bsz, xn, yn, zn + 2)
    if not return_occ:
        return top
    occ = _occ_from_cells(heights2d, intensity, density, counts, cfg)
    return top, occ.reshape(bsz, xn, yn)


def lidar_to_front_batch(points: torch.Tensor, cfg: Config = _default_cfg,
                         num_points: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(B, N, 4) -> (B, width, height, 3) cylindrical front view: per-pixel
    mean of (height above ground, distance, intensity), with the reference's
    reflectance-in-norm distance quirk.

    The per-pixel sums use ``index_add_``, which on CUDA sums in atomic
    order: means differ from the CPU's in the last bits there."""
    f = cfg.front
    bsz = points.shape[0]
    n_pix = f.width * f.height
    points = points.to(torch.float32)
    valid = _crop_mask(points, cfg, num_points)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]

    # int() truncation toward zero, as the f32 -> int32 cast
    pc = (torch.atan2(y, x) / f32c(f.angular_res, x)).to(torch.int32)
    pr = (torch.atan2(z, torch.sqrt(x ** 2 + y ** 2))
          / f32c(f.vertical_res, x)).to(torch.int32)
    valid &= (pc > f.c_min) & (pc < f.c_max) & (pr > f.r_min) & (pr < f.r_max)
    pc = pc + f.c_offset
    pr = pr + f.r_offset
    valid &= (pc >= 0) & (pc < f.width) & (pr >= 0) & (pr < f.height)
    pix = torch.where(valid, pc * f.height + pr, n_pix).to(torch.int64)

    height = torch.clamp(z + f32c(f.velodyne_height, z), min=0.0)
    distance = torch.sqrt(torch.sum(points[..., :4] ** 2, dim=-1))
    vals = torch.stack([height, distance, points[..., 3],
                        torch.ones_like(height)], dim=-1)
    vals = torch.where(valid[..., None], vals, 0.0)

    frame = torch.arange(bsz, device=points.device)[:, None] * (n_pix + 1)
    acc = torch.zeros(bsz * (n_pix + 1), 4, dtype=torch.float32,
                      device=points.device)
    acc.index_add_(0, (frame + pix).reshape(-1), vals.reshape(-1, 4))
    acc = acc.reshape(bsz, n_pix + 1, 4)[:, :n_pix]
    front = acc[..., :3] / torch.clamp(acc[..., 3:4], min=1.0)
    return front.reshape(bsz, f.width, f.height, 3)


def pad_points(points, max_points: int) -> Tuple[np.ndarray, int]:
    """Pad/truncate an (N, 4) host point cloud to (max_points, 4); padding
    rows sit far outside every crop bound."""
    n = min(len(points), max_points)
    out = np.full((max_points, 4), -1e9, dtype=np.float32)
    out[:n] = points[:n]
    return out, n
