"""Lidar voxelization into the BEV ("top") and cylindrical front views.

Port of ``mv3d_tpu/ops/voxelize.py``. Semantics are bit-identical to the
JAX package and to its numpy oracle ``mv3d_tpu/ops/voxelize_ref.py``:
strict crops, the didi presets' center-car filter on the top view only,
the inclusive slice-boundary redirect, first-max-point intensity and
log-count density.

The top view comes in the three layouts of ``pipeline.view_layout``:

  * ``"hwc"``: (B, Xn, Yn, Zn+2). Without a host aux plane it runs through
    the fused sweep (:mod:`mv3d_tpu_torch.ops.voxelize_sweep`, K1). With
    one (``aux``, the (B, Xn, Yn, 2) intensity/density plane the loader
    computes on the host when ``pipeline.host_aux_channels`` is set) only
    the height channels are computed on the device, by the heights
    scatter-max (:mod:`mv3d_tpu_torch.ops.voxelize_heights`, K3).
  * ``"s2d2"``: the 2x2-folded view (B, Xn/2, Yn/2, 4*(Zn+2)) of
    :func:`fold_view_s2d2`, through K1 with the cells numbered in folded
    order, so the sweep's output is the folded view without a relayout.
  * ``"s2d2p"``: the lane-padded pair of :func:`fold_view_s2d2p`, heights
    (B, Xn/2, W2P, 128) and aux (B, Xn/2, W2P, 8), through the lane-padded
    sweep (:mod:`mv3d_tpu_torch.ops.voxelize_padded`, K2).

The folded layouts return the folded (B, Xn/2, W, 4) occupancy
(:func:`unfold_occ4` relays it out) and take no host aux plane. In the JAX
package the ``pipeline`` options ``use_pallas_fused``,
``use_pallas_heights`` and ``sweep_kernel`` only choose a TPU formulation
(XLA scatters, a sorted Pallas sweep, its loop body) of these functions,
so the port computes each through its one kernel whatever they say.
``voxel_order`` chooses how the TPU sweep's points are put in order; the
port's sweeps use order-independent atomics and need none, so it follows
the JAX routing only where that reaches a TPU kernel: on the ``"hwc"`` and
``"s2d2"`` branches without a host aux plane and with
``use_pallas_fused``, ``"pallas-sort"`` and ``"bitonic"`` sort each
frame's (flat, val, refl) by ``flat``, stably, through the bitonic sort
(:mod:`mv3d_tpu_torch.ops.sort_bitonic`, K4; its plain network on the
CPU) ahead of K1 when N is a power of two (``"pallas-sort"`` raises below
256 points, as the TPU kernel asserts). Otherwise nothing is sorted: N
not a power of two, where JAX takes ``lax.sort``, ``"sort"`` and
``"bin"``, and without ``use_pallas_fused``, where JAX scatters with XLA.
A stable sort keeps equal ``flat`` in their order, so the view is
bit-equal to the unsorted one.

Where the grid's z range is not a whole number of slices (the didi
presets: 3.7 / 0.3 = 12.33 slices in 12), the top slice takes the points
above it too, so its height value reaches 1.33.

Quantization divides by a 0-dim tensor on the points' device, never by a
Python float: PyTorch's CUDA division by a CPU scalar multiplies by its
reciprocal, which moves boundary points by one cell.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config, cfg as _default_cfg

from .sort_bitonic import bitonic_sort_batched
from .voxelize_heights import scatter_max_batched
from .voxelize_padded import LANES, scatter_top_padded_batched
from .voxelize_sweep import scatter_top_fused_batched

VIEW_LAYOUTS = ("hwc", "s2d2", "s2d2p")
VOXEL_ORDERS = ("sort", "bin", "pallas-sort", "bitonic")


def f32c(x: float, like: torch.Tensor) -> torch.Tensor:
    """f32 0-dim constant on ``like``'s device (a Python float in JAX is a
    weakly-typed f32 constant; see the module note on division)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


DATASETS = ("kitti", "didi", "didi2", "test")
# the datasets whose capture car's own returns are cropped from the top view
CENTER_CAR_DATASETS = ("didi", "didi2", "test")


def check_dataset(cfg: Config) -> None:
    if cfg.dataset_type not in DATASETS:
        raise ValueError(f"dataset_type={cfg.dataset_type!r}: expected one "
                         f"of {DATASETS}")


def check_view_layout(cfg: Config) -> None:
    if cfg.pipeline.view_layout not in VIEW_LAYOUTS:
        raise ValueError(f"view_layout={cfg.pipeline.view_layout!r}: "
                         f"expected one of {VIEW_LAYOUTS}")


def order_points(flat: torch.Tensor, val: torch.Tensor, refl: torch.Tensor,
                 cfg: Config):
    """The sweep's (B, N) inputs in ``pipeline.voxel_order``: sorted by
    ``flat``, stably, for ``"pallas-sort"``/``"bitonic"`` at a power-of-two
    N with ``use_pallas_fused``; as they are otherwise (see the module
    note)."""
    order = cfg.pipeline.voxel_order
    if order not in VOXEL_ORDERS:
        raise ValueError(f"voxel_order={order!r}: expected one of "
                         f"{VOXEL_ORDERS}")
    n = flat.shape[-1]
    if (order not in ("pallas-sort", "bitonic")
            or not cfg.pipeline.use_pallas_fused or n < 1 or n & (n - 1)):
        return flat, val, refl
    if order == "pallas-sort" and n < 256:
        raise ValueError(f"voxel_order='pallas-sort' sorts at least 256 "
                         f"points per frame, got {n}")
    return bitonic_sort_batched(flat, val, refl)


def folded_pad_width(yn: int) -> int:
    """Padded folded width w2p of the lane-padded "s2d2p" layout: yn/2
    rounded up to a multiple of 16, as the JAX package pads it."""
    return -(-(yn // 2) // 16) * 16


def _crop_mask(points: torch.Tensor, cfg: Config,
               num_points: Optional[torch.Tensor],
               filter_center_car: bool = True) -> torch.Tensor:
    """(B, N, 4) -> (B, N) strict-bound crop + padding mask; with
    ``filter_center_car`` (the top view) the didi presets also drop the
    capture car's 4.7 x 2.1 m box around the origin (the front view keeps
    it, as in the JAX package)."""
    check_dataset(cfg)
    t = cfg.top
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    m = ((x > f32c(t.x_min, x)) & (x < f32c(t.x_max, x)) &
         (y > f32c(t.y_min, y)) & (y < f32c(t.y_max, y)) &
         (z > f32c(t.z_min, z)) & (z < f32c(t.z_max, z)))
    if filter_center_car and cfg.dataset_type in CENTER_CAR_DATASETS:
        m &= ((x.abs() > f32c(4.7 / 2, x)) | (y.abs() > f32c(2.1 / 2, y)))
    if num_points is not None:
        idx = torch.arange(points.shape[-2], device=points.device)
        m &= idx < num_points.to(points.device).reshape(-1, 1)
    return m


def _top_prep(points: torch.Tensor, cfg: Config,
              num_points: Optional[torch.Tensor], s2d=False):
    """Per-point quantization of a (B, N, 4) batch.

    Returns (valid, cell, flat, val, refl), each (B, N): crop mask, cell id
    (dump cell ``n_cells`` for invalid points), ``flat = cell*zn + s_eff``
    with the inclusive-boundary redirect applied (dump ``n_cells*zn``), the
    slice height value and reflectance.

    ``s2d=True`` numbers the cells in the folded 2x2 order (supercell-major,
    (dy, dx)-minor) instead of row-major. ``s2d="pad"`` also lane-pads:
    ``flat = sc*128 + sub*zn + s_eff`` over the (Xn/2, W2P) supercell grid,
    and ``cell`` is the folded cell ``sc*4 + sub`` (dump ``n_sc*128`` and
    ``n_sc*4``)."""
    t = cfg.top
    xn, yn, zn = t.xn, t.yn, t.zn
    n_cells = xn * yn
    if s2d and (xn % 2 or yn % 2):
        raise ValueError(f"the folded layouts need an even grid, got "
                         f"{xn}x{yn}")
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

    if s2d == "pad":
        w2p = folded_pad_width(yn)
        n_sc = (xn // 2) * w2p
        supercell = (row // 2) * w2p + col // 2
        sub = (row % 2) * 2 + col % 2
        cell = torch.where(valid, supercell * 4 + sub, n_sc * 4)
        flat = torch.where(valid, supercell * LANES + sub * zn + s_eff,
                           n_sc * LANES)
        return valid, cell, flat, val, refl
    if s2d:
        supercell = (row // 2) * (yn // 2) + col // 2
        cell_id = supercell * 4 + (row % 2) * 2 + col % 2
    else:
        cell_id = row * yn + col
    cell = torch.where(valid, cell_id, n_cells)
    flat = torch.where(valid, cell * zn + s_eff, n_cells * zn)
    return valid, cell, flat, val, refl


def fold_view_s2d2(view: torch.Tensor) -> torch.Tensor:
    """Standard (..., H, W, Zn+2) top view -> the folded "s2d2" layout
    (..., H/2, W/2, 4*(Zn+2)): [heights (dy, dx, s) -> 4*Zn] +
    [intensity (dy, dx) -> 4] + [density (dy, dx) -> 4] (a fixed channel
    permutation of ``space_to_depth``, the JAX package's order)."""
    *lead, h, w, c = view.shape
    zn = c - 2
    v = view.reshape(*lead, h // 2, 2, w // 2, 2, c)
    v = v.movedim(-4, -3)                       # (..., h2, w2, 2, 2, c)
    heights = v[..., :zn].reshape(*lead, h // 2, w // 2, 4 * zn)
    inten = v[..., zn].reshape(*lead, h // 2, w // 2, 4)
    dens = v[..., zn + 1].reshape(*lead, h // 2, w // 2, 4)
    return torch.cat([heights, inten, dens], dim=-1)


def fold_view_s2d2p(view: torch.Tensor):
    """Standard (..., H, W, Zn+2) top view -> the lane-padded "s2d2p" pair:
    heights (..., H/2, W2P, 128) with lanes ``sub*zn + s`` (zeros above
    4*Zn and in the padded columns) and aux (..., H/2, W2P, 8) =
    [intensity x4, density x4]; :func:`fold_view_s2d2` padded."""
    *_, w, c = view.shape
    zn = c - 2
    wpad = folded_pad_width(w) - w // 2
    folded = fold_view_s2d2(view)
    heights = F.pad(folded[..., :4 * zn], (0, LANES - 4 * zn, 0, wpad))
    aux = F.pad(folded[..., 4 * zn:], (0, 0, 0, wpad))
    return heights, aux


def unfold_occ4(occ4: torch.Tensor, xn: int, yn: int) -> torch.Tensor:
    """Folded (..., h2, w2p, 4) occupancy (sub = u*2 + v for the full-res
    cell (2i+u, 2j+v)) -> full-res (..., xn, yn)."""
    *lead, h2, w2p, _ = occ4.shape
    v = occ4.reshape(*lead, h2, w2p, 2, 2).movedim(-2, -3)
    return v.reshape(*lead, xn, 2 * w2p)[..., :yn]


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


def _density(counts: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.log(counts + 1.0) / f32c(math.log(32), counts),
                       max=1.0)


def lidar_to_top_batch(points: torch.Tensor, cfg: Config = _default_cfg,
                       num_points: Optional[torch.Tensor] = None,
                       aux: Optional[torch.Tensor] = None,
                       return_occ: bool = False):
    """(B, N, 4) -> the top view in ``pipeline.view_layout``; with
    ``return_occ`` also the occupancy the anchor filter reads: (B, Xn, Yn)
    for ``"hwc"``, folded (B, Xn/2, W, 4) for ``"s2d2"`` (W = Yn/2) and
    ``"s2d2p"`` (W = W2P).

    ``"hwc"`` channels 0..Zn-1: per-slice max height above the slice floor
    (z-cell units); Zn: reflectance of the highest point; Zn+1:
    ``min(1, log(count+1)/log 32)``. Rows/cols are flipped like the
    reference (top[Xn-1-qx, Yn-1-qy]). The folded layouts hold the same
    values in :func:`fold_view_s2d2` / :func:`fold_view_s2d2p` order; the
    ``"s2d2p"`` view is the (heights, aux) pair.

    With ``aux`` (B, Xn, Yn, 2), the host's [intensity, density] plane
    (``"hwc"`` only), only the heights are computed here; the view is then
    f32 whatever ``top_view_dtype`` says, and the occupancy is the f32 sum
    of all its channels, as in the JAX package's aux branch."""
    check_view_layout(cfg)
    layout = cfg.pipeline.view_layout
    if aux is not None and layout != "hwc":
        raise ValueError("the folded view layouts compute all channels on "
                         "the device; they take no host aux plane")
    if layout == "s2d2p":
        return _top_s2d2p(points, cfg, num_points, return_occ)
    t = cfg.top
    xn, yn, zn = t.xn, t.yn, t.zn
    n_cells = xn * yn
    bsz = points.shape[0]
    _, _, flat, val, refl = _top_prep(points, cfg, num_points,
                                      s2d=layout == "s2d2")
    if aux is not None:
        heights = scatter_max_batched(flat, val, n_cells * zn)
        top = torch.cat([heights.reshape(bsz, xn, yn, zn),
                         aux.to(heights.device, torch.float32)], dim=-1)
        return (top, _sum_in_order(top)) if return_occ else top
    flat, val, refl = order_points(
        flat, val, torch.where(flat < n_cells * zn, refl, 0.0), cfg)
    # heights come in the view dtype (the f32 max rounded once), as the
    # JAX caller asks for them; the occupancy sums them in that dtype too
    view_dtype = getattr(torch, cfg.pipeline.top_view_dtype)
    heights, counts, intensity = scatter_top_fused_batched(
        flat, val, refl, n_cells, zn, heights_dtype=view_dtype)
    density = _density(counts)
    heights2d = heights.reshape(bsz, n_cells, zn)
    if layout == "s2d2":
        # cells are in folded order: the reshapes assemble the folded view
        h2, w2 = xn // 2, yn // 2
        top = torch.cat([heights2d.reshape(bsz, h2, w2, 4 * zn),
                         intensity.reshape(bsz, h2, w2, 4).to(view_dtype),
                         density.reshape(bsz, h2, w2, 4).to(view_dtype)],
                        dim=-1)
        occ_shape = (bsz, h2, w2, 4)
    else:
        top = torch.cat([heights2d, intensity[..., None].to(view_dtype),
                         density[..., None].to(view_dtype)], dim=2)
        top = top.reshape(bsz, xn, yn, zn + 2)
        occ_shape = (bsz, xn, yn)
    if not return_occ:
        return top
    occ = _occ_from_cells(heights2d, intensity, density, counts, cfg)
    return top, occ.reshape(occ_shape)


def lidar_to_bev_avod(points: torch.Tensor, cfg: Config,
                      num_points: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 4) -> AVOD's BEV (B, Xn, Yn, Zn + 1) in ``top_view_dtype``
    and the (B, Xn, Yn) f32 point counts the anchor filter reads.

    Channels 0..Zn-1: per-slice max height above the slice floor in slice
    units, as :func:`lidar_to_top_batch`'s (the grid's z range is AVOD's
    height band above the ground); Zn: ``min(1, log(count + 1) /
    log(avod.density_log_base))`` (log 16). No intensity channel. The
    fused sweep (K1) computes the heights and counts; its intensity
    output goes unused."""
    t = cfg.top
    xn, yn, zn = t.xn, t.yn, t.zn
    n_cells = xn * yn
    bsz = points.shape[0]
    _, _, flat, val, refl = _top_prep(points, cfg, num_points)
    flat, val, refl = order_points(
        flat, val, torch.where(flat < n_cells * zn, refl, 0.0), cfg)
    view_dtype = getattr(torch, cfg.pipeline.top_view_dtype)
    heights, counts, _ = scatter_top_fused_batched(
        flat, val, refl, n_cells, zn, heights_dtype=view_dtype)
    density = torch.clamp(torch.log(counts + 1.0) / f32c(
        math.log(cfg.avod.density_log_base), counts), max=1.0)
    bev = torch.cat([heights.reshape(bsz, n_cells, zn),
                     density[..., None].to(view_dtype)], dim=2)
    return (bev.reshape(bsz, xn, yn, zn + 1),
            counts.reshape(bsz, xn, yn))


def _top_s2d2p(points: torch.Tensor, cfg: Config,
               num_points: Optional[torch.Tensor], return_occ: bool):
    """The ``"s2d2p"`` branch of :func:`lidar_to_top_batch`: the lane-padded
    sweep's heights blocks are the (B, h2, w2p, 128) stem input, and its
    count/intensity become the (B, h2, w2p, 8) aux plane. The sweep writes
    heights in the view dtype (the f32 max rounded once) unless the
    occupancy needs the f32 heights (``remove_empty_thresh != 0``)."""
    t = cfg.top
    xn, yn, zn = t.xn, t.yn, t.zn
    h2, w2p = xn // 2, folded_pad_width(yn)
    n_sc = h2 * w2p
    bsz = points.shape[0]
    _, _, flat, val, refl = _top_prep(points, cfg, num_points, s2d="pad")
    view_dtype = getattr(torch, cfg.pipeline.top_view_dtype)
    count_occ = cfg.pipeline.remove_empty_thresh == 0.0
    heights_b, counts, inten = scatter_top_padded_batched(
        flat, val, torch.where(flat < n_sc * LANES, refl, 0.0), n_sc, zn,
        heights_dtype=view_dtype if count_occ else torch.float32)
    heights = heights_b.reshape(bsz, h2, w2p, LANES).to(view_dtype)
    inten4 = inten.reshape(bsz, h2, w2p, 4)
    dens4 = _density(counts).reshape(bsz, h2, w2p, 4)
    top = (heights, torch.cat([inten4, dens4], dim=-1).to(view_dtype))
    if not return_occ:
        return top
    if count_occ:
        return top, counts.reshape(bsz, h2, w2p, 4)
    hv = heights_b.reshape(bsz, h2, w2p, LANES)
    h4 = torch.stack([hv[..., s * zn:(s + 1) * zn].sum(-1)
                      for s in range(4)], dim=-1)
    return top, h4 + inten4 + dens4


def front_pixels(points: torch.Tensor, cfg: Config = _default_cfg,
                 num_points: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, 4) f32 -> (B, N) int64 front-view pixel of each point
    (column * height + row), ``width * height`` where the point is cropped
    or falls outside the view."""
    f = cfg.front
    valid = _crop_mask(points, cfg, num_points, filter_center_car=False)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    # int() truncation toward zero, as the f32 -> int32 cast
    pc = (torch.atan2(y, x) / f32c(f.angular_res, x)).to(torch.int32)
    pr = (torch.atan2(z, torch.sqrt(x ** 2 + y ** 2))
          / f32c(f.vertical_res, x)).to(torch.int32)
    valid &= (pc > f.c_min) & (pc < f.c_max) & (pr > f.r_min) & (pr < f.r_max)
    pc = pc + f.c_offset
    pr = pr + f.r_offset
    valid &= (pc >= 0) & (pc < f.width) & (pr >= 0) & (pr < f.height)
    return torch.where(valid, pc * f.height + pr,
                       f.width * f.height).to(torch.int64)


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
    pix = front_pixels(points, cfg, num_points)
    valid = pix < n_pix
    z = points[..., 2]

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


def _one_frame(points, num_points):
    """A single frame's (N, 4) points and optional point count as the
    batched functions' (1, N, 4) and (1,) tensors."""
    points = torch.as_tensor(points)[None]
    if num_points is not None:
        num_points = torch.as_tensor(num_points, device=points.device
                                     ).reshape(1)
    return points, num_points


def lidar_to_top(points: torch.Tensor, cfg: Config = _default_cfg,
                 num_points=None, aux: Optional[torch.Tensor] = None,
                 return_occ: bool = False):
    """(N, 4) padded lidar points -> (Xn, Yn, Zn+2) f32 top view of one
    frame in the standard layout, whatever ``view_layout`` and
    ``top_view_dtype`` say (as the JAX package's single-frame function);
    with ``return_occ`` also the (Xn, Yn) occupancy.

    :func:`lidar_to_top_batch` at B=1: the fused sweep (K1) computes every
    channel, or with ``aux`` (the host's (Xn, Yn, 2) [intensity, density]
    plane) the heights scatter-max (K3) computes the heights alone."""
    one = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, view_layout="hwc", top_view_dtype="float32"))
    points, num_points = _one_frame(points, num_points)
    out = lidar_to_top_batch(points, one, num_points,
                             None if aux is None else aux[None], return_occ)
    return (out[0][0], out[1][0]) if return_occ else out[0]


def lidar_to_front(points: torch.Tensor, cfg: Config = _default_cfg,
                   num_points=None) -> torch.Tensor:
    """(N, 4) padded lidar points -> (width, height, 3) front view of one
    frame (:func:`lidar_to_front_batch` at B=1)."""
    points, num_points = _one_frame(points, num_points)
    return lidar_to_front_batch(points, cfg, num_points)[0]


def pad_points(points, max_points: int) -> Tuple[np.ndarray, int]:
    """Pad/truncate an (N, 4) host point cloud to (max_points, 4); padding
    rows sit far outside every crop bound."""
    n = min(len(points), max_points)
    out = np.full((max_points, 4), -1e9, dtype=np.float32)
    out[:n] = points[:n]
    return out, n
