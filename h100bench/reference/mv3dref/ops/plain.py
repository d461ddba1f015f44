"""The plain PyTorch versions of the port's four kernels, under the names
:mod:`.voxelize` calls: the copy computes every view with these, on any
device, and launches no kernel.

Copied from the plain halves of ``mv3d_tpu_torch/ops/voxelize_sweep.py``
(``sweep_plain``, ``scatter_top_fused_plain``),
``mv3d_tpu_torch/ops/voxelize_padded.py`` (``scatter_top_padded_plain``),
``mv3d_tpu_torch/ops/voxelize_heights.py`` (``scatter_max_plain``); the
sort (K4) is left out, since the copy does not sort (``.voxelize``'s
``order_points``).
"""

from __future__ import annotations

from typing import Tuple

import torch

HEIGHTS_DTYPES = (torch.float32, torch.bfloat16)
LANES = 128          # heights lanes per supercell
_KEY_LOW = 0xFFFFFFFF

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def check_heights_dtype(heights_dtype: torch.dtype) -> None:
    if heights_dtype not in HEIGHTS_DTYPES:
        raise TypeError(f"heights_dtype {heights_dtype}: expected one of "
                        f"{HEIGHTS_DTYPES}")


def check_inputs(flat, hval, refl):
    if flat.dim() != 2 or hval.shape != flat.shape or refl.shape != flat.shape:
        raise ValueError(f"expected matching (B, N) inputs, got "
                         f"{tuple(flat.shape)}, {tuple(hval.shape)}, "
                         f"{tuple(refl.shape)}")
    if flat.dtype != torch.int32 or hval.dtype != torch.float32 \
            or refl.dtype != torch.float32:
        raise TypeError(f"expected int32/float32/float32, got {flat.dtype}, "
                        f"{hval.dtype}, {refl.dtype}")
    if not (flat.device == hval.device == refl.device):
        raise ValueError("inputs lie on different devices")


def sweep_plain(slot: torch.Tensor, cell: torch.Tensor, s_eff: torch.Tensor,
                live: torch.Tensor, hval: torch.Tensor, refl: torch.Tensor,
                n_slots: int, n_cells: int) -> Triple:
    """Scatter-amax for heights, index_add for counts, and an int64
    scatter-amax on the packed (qz bits, ~index) key for the intensity
    winner (the highest ``qz = s_eff + v``, the lowest index on ties).
    Dead points scatter identities (max with 0, add 0, key 0) at slot and
    cell 0."""
    bsz, n = slot.shape
    dev = slot.device
    slot, cell, s_eff = (torch.where(live, x, 0) for x in (slot, cell, s_eff))
    frame = torch.arange(bsz, device=dev, dtype=torch.int64)[:, None]

    heights = torch.zeros(bsz * n_slots, dtype=torch.float32, device=dev)
    heights.scatter_reduce_(0, (frame * n_slots + slot).reshape(-1),
                            torch.where(live, hval, 0.0).reshape(-1), "amax")
    cidx = (frame * n_cells + cell).reshape(-1)
    cnt = torch.zeros(bsz * n_cells, dtype=torch.int32, device=dev)
    cnt.index_add_(0, cidx, live.to(torch.int32).reshape(-1))

    qz = s_eff.to(torch.float32) + hval
    qz_bits = qz.view(torch.int32).to(torch.int64) & _KEY_LOW
    idx = torch.arange(n, device=dev, dtype=torch.int64)[None, :]
    key = torch.where(live, (qz_bits << 32) | (_KEY_LOW - idx), 0)
    best = torch.zeros(bsz * n_cells, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, cidx, key.reshape(-1), "amax")
    best = best.reshape(bsz, n_cells)
    winner = _KEY_LOW - (best & _KEY_LOW)
    won = torch.gather(refl, 1, torch.where(best > 0, winner, 0))
    intensity = torch.where(best > 0, won, 0.0)
    return (heights.reshape(bsz, n_slots),
            cnt.reshape(bsz, n_cells).to(torch.float32), intensity)


def scatter_top_fused_batched(flat: torch.Tensor, hval: torch.Tensor,
                              refl: torch.Tensor, n_cells: int, zn: int,
                              heights_dtype: torch.dtype = torch.float32
                              ) -> Triple:
    """(B, N) ``flat = cell*zn + s_eff`` -> heights (B, n_cells*zn),
    count and intensity (B, n_cells)."""
    check_inputs(flat, hval, refl)
    check_heights_dtype(heights_dtype)
    n_flat = n_cells * zn
    f = flat.to(torch.int64)
    live = (f >= 0) & (f < n_flat)
    cell = f // zn
    heights, count, intensity = sweep_plain(
        f, cell, f - cell * zn, live, hval, refl, n_flat, n_cells)
    return heights.to(heights_dtype), count, intensity


def scatter_top_padded_batched(flat: torch.Tensor, hval: torch.Tensor,
                               refl: torch.Tensor, n_sc: int, zn: int,
                               heights_dtype: torch.dtype = torch.float32
                               ) -> Triple:
    """(B, N) ``flat = sc*128 + sub*zn + s_eff`` -> heights
    (B, n_sc*128), count and intensity (B, n_sc*4); lanes >= 4*zn and
    ids >= n_sc*128 are padding."""
    check_inputs(flat, hval, refl)
    if not 0 < 4 * zn <= LANES:
        raise ValueError(f"the lane-padded sweep needs 0 < 4*zn <= {LANES}, "
                         f"got zn={zn}")
    check_heights_dtype(heights_dtype)
    f = flat.to(torch.int64)
    lane = f & (LANES - 1)
    sub = lane // zn
    live = (f >= 0) & (f < n_sc * LANES) & (sub < 4)
    heights, count, intensity = sweep_plain(
        f, (f >> 7) * 4 + sub, lane - sub * zn, live, hval, refl,
        n_sc * LANES, n_sc * 4)
    return heights.to(heights_dtype), count, intensity


def scatter_max_batched(flat: torch.Tensor, val: torch.Tensor,
                        n_flat: int) -> torch.Tensor:
    """An int32 scatter-amax of the values' bits into a zeroed
    (B, n_flat) buffer; padding and values that are not > 0 scatter 0 at
    slot 0."""
    bsz, _ = flat.shape
    f = flat.to(torch.int64)
    live = (f >= 0) & (f < n_flat) & (val > 0)
    frame = torch.arange(bsz, device=flat.device,
                         dtype=torch.int64)[:, None] * n_flat
    idx = frame + torch.where(live, f, 0)
    bits = torch.where(live, val, 0.0).view(torch.int32)
    out = torch.zeros(bsz * n_flat, dtype=torch.int32, device=flat.device)
    out.scatter_reduce_(0, idx.reshape(-1), bits.reshape(-1), "amax")
    return out.view(torch.float32).reshape(bsz, n_flat)
