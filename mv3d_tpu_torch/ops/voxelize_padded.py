"""Lane-padded BEV voxelizer sweep: a hand-written Hopper kernel and its
plain twin.

Port of ``mv3d_tpu/ops/voxelize_pallas.py::scatter_top_padded_batched``
(body ``_fused_kernel_grouped`` with ``lane_pad=True``), the voxelizer of
the ``view_layout="s2d2p"`` serving configuration. Points come quantized
to ``flat = sc*128 + sub*zn + s_eff`` over the 2x2-folded supercells ``sc``
of the (h2, w2p) grid, ``sub = dy*2 + dx``; per frame it computes

  * ``heights[flat]``   the max height value per slot, zero where no point
    lands (lanes 4*zn..127 and the padded columns stay zero), so the
    (B, n_sc*128) output is the (B, h2, w2p, 128) conv-stem input;
  * ``count[cell]``     the number of points in folded cell
    ``cell = sc*4 + sub``;
  * ``intensity[cell]`` the reflectance of the point with the largest
    ``qz = s_eff + v``, the lowest original index winning ties.

Entries with ``flat >= n_sc*128``, or in a lane ``>= 4*zn``, are padding.
Heights come in f32 or bf16; bf16 is the f32 max rounded once
(round-to-nearest is monotone, so it commutes with max).

The kernel (``mv3d_tpu_torch/csrc/voxelize_padded.cu``) bins the points by
output tile (a counting sort: histogram and ranks, scan, placement) and
sweeps each tile of ``tile_sc`` supercells in shared memory, writing every
output byte once (see its note); :func:`tile_plan` sizes the tiles. The
plain version decodes the same way and runs the sweeps' shared arithmetic
(:func:`.voxelize_sweep.sweep_plain`), then rounds heights once.

Dispatch: a tensor on the CPU goes to :func:`scatter_top_padded_plain`; a
CUDA tensor goes to the kernel, which raises if it cannot be built or
launched. There is no fallback. ``scatter_top_padded_batched.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from .cuda_build import CSRC, check_launch, launch, load_library
from .voxelize_sweep import check_heights_dtype, check_inputs, sweep_plain

SOURCE = os.path.join(CSRC, "voxelize_padded.cu")
LANES = 128          # heights lanes per supercell
TILE_SC = 64         # supercells per tile of the kernel's sweep


def tile_plan(n_sc: int, heights_dtype: torch.dtype = torch.float32
              ) -> Tuple[int, int, int]:
    """The kernel's tiles for ``n_sc`` supercells: (supercells per tile,
    number of tiles, shared-memory bytes of one tile). Tiles cover the
    supercells in order, the last one possibly partial. A tile holds its
    heights as f32 in shared memory whatever ``heights_dtype`` (bf16 is
    the f32 max rounded once at the store), its 64-bit winners and its
    int32 counts: 560 bytes per supercell, 35,840 at 64 supercells
    (``mv3d_voxelize_padded_smem`` in the source)."""
    check_heights_dtype(heights_dtype)
    if n_sc < 1:
        raise ValueError(f"n_sc={n_sc}: no supercell to tile")
    tile_sc = min(TILE_SC, n_sc)
    smem = tile_sc * (LANES * 4 + 4 * 8 + 4 * 4)
    return tile_sc, -(-n_sc // tile_sc), smem


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.mv3d_voxelize_padded
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    fn.argtypes = [p, p, p, i64, i64, i64, i32, i32, i32, p, p, p, p, p]
    fn.restype = ctypes.c_int
    lib.mv3d_voxelize_padded_smem.argtypes = [i32]
    lib.mv3d_voxelize_padded_smem.restype = i64
    if lib.mv3d_voxelize_padded_smem(TILE_SC) != tile_plan(TILE_SC)[2]:
        raise RuntimeError("voxelize_padded.cu and tile_plan disagree")
    return lib


def _check_shape(n_sc: int, zn: int, heights_dtype: torch.dtype) -> None:
    if not 0 < 4 * zn <= LANES:
        raise ValueError(f"the lane-padded sweep needs 0 < 4*zn <= {LANES}, "
                         f"got zn={zn}")
    if n_sc * LANES >= 2 ** 31:
        raise ValueError(f"n_sc={n_sc}: flat ids must fit in int32")
    check_heights_dtype(heights_dtype)


def scatter_top_padded_kernel(flat: torch.Tensor, hval: torch.Tensor,
                              refl: torch.Tensor, n_sc: int, zn: int,
                              heights_dtype: torch.dtype = torch.float32
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors (no fallback)."""
    check_inputs(flat, hval, refl)
    _check_shape(n_sc, zn, heights_dtype)
    if flat.device.type != "cuda":
        raise ValueError(f"the lane-padded sweep kernel needs CUDA tensors, "
                         f"got {flat.device}")
    bsz, n = flat.shape
    if bsz > 65535:
        raise ValueError(f"the lane-padded sweep kernel takes at most 65,535 "
                         f"frames, got {bsz}")
    lib = _library()
    tile_sc, n_tiles, _ = tile_plan(n_sc, heights_dtype)
    flat, hval, refl = (t.contiguous() for t in (flat, hval, refl))
    dev = flat.device
    # the sweep writes every output byte: no fill
    heights = torch.empty(bsz, n_sc * LANES, dtype=heights_dtype, device=dev)
    count = torch.empty(bsz, n_sc * 4, dtype=torch.float32, device=dev)
    intensity = torch.empty(bsz, n_sc * 4, dtype=torch.float32, device=dev)
    # bin histogram and starts, the points' ranks and the bins, in one
    # int32 scratch
    work = torch.empty(bsz * (2 * n_tiles + 1 + 2 * n), dtype=torch.int32,
                       device=dev)
    err = launch(lib.mv3d_voxelize_padded, dev, flat.data_ptr(),
                 hval.data_ptr(), refl.data_ptr(), bsz, n, n_sc, zn,
                 int(heights_dtype == torch.bfloat16), tile_sc,
                 heights.data_ptr(), count.data_ptr(), intensity.data_ptr(),
                 work.data_ptr())
    check_launch(err, "lane-padded voxelize sweep")
    scatter_top_padded_batched.launches += 1
    return heights, count, intensity


def scatter_top_padded_plain(flat: torch.Tensor, hval: torch.Tensor,
                             refl: torch.Tensor, n_sc: int, zn: int,
                             heights_dtype: torch.dtype = torch.float32
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The same function in plain PyTorch ops, on any device."""
    check_inputs(flat, hval, refl)
    _check_shape(n_sc, zn, heights_dtype)
    f = flat.to(torch.int64)
    lane = f & (LANES - 1)
    sub = lane // zn
    live = (f >= 0) & (f < n_sc * LANES) & (sub < 4)
    heights, count, intensity = sweep_plain(
        f, (f >> 7) * 4 + sub, lane - sub * zn, live, hval, refl,
        n_sc * LANES, n_sc * 4)
    return heights.to(heights_dtype), count, intensity


def scatter_top_padded_batched(flat: torch.Tensor, hval: torch.Tensor,
                               refl: torch.Tensor, n_sc: int, zn: int,
                               heights_dtype: torch.dtype = torch.float32
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(B, N) int32 ``flat``, f32 ``hval``/``refl`` -> heights
    (B, n_sc*128) in ``heights_dtype``, count (B, n_sc*4) and intensity
    (B, n_sc*4) in f32.

    CPU tensors take the plain version; CUDA tensors take the kernel."""
    if flat.device.type == "cpu":
        return scatter_top_padded_plain(flat, hval, refl, n_sc, zn,
                                        heights_dtype)
    if flat.device.type == "cuda":
        return scatter_top_padded_kernel(flat, hval, refl, n_sc, zn,
                                         heights_dtype)
    raise ValueError(f"no lane-padded voxelizer sweep for device "
                     f"{flat.device}")


scatter_top_padded_batched.launches = 0
