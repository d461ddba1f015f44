"""Fused BEV voxelizer sweep: a hand-written Hopper kernel and its plain twin.

Port of ``mv3d_tpu/ops/voxelize_pallas.py::scatter_top_fused_batched``,
whose default TPU body is ``_fused_kernel_grouped``. For pre-quantized
points ``flat = cell*zn + s_eff`` with height value ``v`` and reflectance it
computes, per frame:

  * ``heights[flat]``    the max ``v`` per (cell, slice);
  * ``count[cell]``      the number of points in the cell;
  * ``intensity[cell]``  the reflectance of the point with the largest
    ``qz = s_eff + v``; on ties the lowest original index wins (the
    oracle's ``lexsort``, ``mv3d_tpu/ops/voxelize_ref.py``).

Entries with ``flat >= n_cells*zn`` are padding. Heights come in f32 or
bf16 (``heights_dtype``, as the JAX function takes it); bf16 is the f32
max rounded once (round-to-nearest is monotone, so it commutes with max).

The kernel (``mv3d_tpu_torch/csrc/voxelize_sweep.cu``) bins the points by
output tile (a counting sort: histogram and ranks, scan, placement) over
the batch's cells taken as one array, and sweeps the tiles with persistent
blocks: each tile is accumulated in shared memory (int-bits atomicMax for
heights, atomicAdd for count, a 64-bit atomicMax on a packed (qz, ~index)
key for the winner), and written once by asynchronous bulk copies that
overlap the next tile's work. :func:`tile_plan` sizes the tiles. Max and
integer add are order-independent, so it is bit-exact and deterministic.
What bounds it on an H100 is writing the 48 MB f32 (24 MB bf16) heights
plane per frame once; fusing the view assembly
(``mv3d_tpu/ops/voxelize.py`` lidar_to_top_batch's concat) into the sweep
would change its function beyond the JAX one's.

Dispatch: a tensor on the CPU goes to :func:`scatter_top_fused_plain`; a
CUDA tensor goes to the kernel, which raises if it cannot be built or
launched. There is no fallback. ``scatter_top_fused_batched.launches``
counts kernel launches.

The shared library is built by nvcc at first use, from the source in this
checkout, into ``mv3d_tpu_torch/_build/`` (:mod:`.cuda_build`).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from .cuda_build import CSRC, check_launch, launch, load_library

SOURCE = os.path.join(CSRC, "voxelize_sweep.cu")
HEIGHTS_DTYPES = (torch.float32, torch.bfloat16)
TILE_CELLS = 256     # cells per tile of the kernel's sweep, at most
SMEM_LIMIT = 232448  # dynamic shared memory one H100 block may use

_KEY_LOW = 0xFFFFFFFF


def check_heights_dtype(heights_dtype: torch.dtype) -> None:
    if heights_dtype not in HEIGHTS_DTYPES:
        raise TypeError(f"heights_dtype {heights_dtype}: expected one of "
                        f"{HEIGHTS_DTYPES}")


def tile_plan(total_cells: int, zn: int) -> Tuple[int, int, int]:
    """The kernel's tiles over ``total_cells`` = B * n_cells cells taken
    as one array: (cells per tile, number of tiles, dynamic shared memory
    of a sweep block in bytes). Tiles cover the cells in order, the last
    one possibly partial. A tile is a power of two of at least 8 cells, so
    every tile starts on a 16-byte boundary of each output (heights in f32
    or bf16, count, intensity), as bulk copies need. A block holds two
    tile buffers of f32 heights, 64-bit winners, int32 counts and f32
    intensity, for f32 and bf16 heights alike (bf16 is rounded in place;
    ``mv3d_voxelize_sweep_smem`` in the source): 2 * 116 * 256 = 59,392 B
    at zn = 25, three blocks to an H100 SM. The tile halves from
    ``TILE_CELLS`` until the block fits in shared memory."""
    if total_cells < 1 or zn < 1:
        raise ValueError(f"no cell to tile: {total_cells} cells, zn={zn}")
    per_cell = zn * 4 + 16
    tile = TILE_CELLS
    while 2 * tile * per_cell > SMEM_LIMIT:
        if tile == 8:
            raise ValueError(f"zn={zn}: a tile of 8 cells does not fit in "
                             f"one block's shared memory")
        tile //= 2
    return tile, -(-total_cells // tile), 2 * tile * per_cell


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.mv3d_voxelize_sweep
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    fn.argtypes = [p, p, p, i64, i64, i64, i32, i32, i32, p, p, p, p, p]
    fn.restype = ctypes.c_int
    lib.mv3d_voxelize_sweep_smem.argtypes = [i32, i32]
    lib.mv3d_voxelize_sweep_smem.restype = i64
    for zn in (25, 200):
        tile, _, smem = tile_plan(1, zn)
        if lib.mv3d_voxelize_sweep_smem(tile, zn) != smem:
            raise RuntimeError("voxelize_sweep.cu and tile_plan disagree")
    return lib


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


def scatter_top_fused_kernel(flat: torch.Tensor, hval: torch.Tensor,
                             refl: torch.Tensor, n_cells: int, zn: int,
                             heights_dtype: torch.dtype = torch.float32
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors (no fallback)."""
    check_inputs(flat, hval, refl)
    check_heights_dtype(heights_dtype)
    if flat.device.type != "cuda":
        raise ValueError(f"the sweep kernel needs CUDA tensors, got "
                         f"{flat.device}")
    bsz, n = flat.shape
    if 5 * bsz * n >= 2 ** 31 or n_cells * zn >= 2 ** 31 or bsz > 65535:
        raise ValueError(f"the sweep kernel takes at most 65,535 frames and "
                         f"indexes points and slots in int32: {bsz} x {n} "
                         f"points, {n_cells} x {zn} slots")
    tile, n_tiles, _ = tile_plan(bsz * n_cells, zn)
    lib = _library()
    flat, hval, refl = (t.contiguous() for t in (flat, hval, refl))
    dev = flat.device
    # the sweep writes every output byte: no fill
    heights = torch.empty(bsz, n_cells * zn, dtype=heights_dtype,
                          device=dev)
    # separate allocations: each plane must start on a 16-byte boundary
    count = torch.empty(bsz, n_cells, dtype=torch.float32, device=dev)
    intensity = torch.empty(bsz, n_cells, dtype=torch.float32, device=dev)
    # bin histogram and starts, the points' ranks and their four-word
    # records, in one int32 scratch
    work = torch.empty(2 * n_tiles + 1 + 5 * bsz * n, dtype=torch.int32,
                       device=dev)
    err = launch(lib.mv3d_voxelize_sweep, dev, flat.data_ptr(),
                 hval.data_ptr(), refl.data_ptr(), bsz, n, n_cells, zn,
                 int(heights_dtype == torch.bfloat16), tile,
                 heights.data_ptr(), count.data_ptr(), intensity.data_ptr(),
                 work.data_ptr())
    check_launch(err, "voxelize sweep")
    scatter_top_fused_batched.launches += 1
    return heights, count, intensity


def sweep_plain(slot: torch.Tensor, cell: torch.Tensor, s_eff: torch.Tensor,
                live: torch.Tensor, hval: torch.Tensor, refl: torch.Tensor,
                n_slots: int, n_cells: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sweeps' arithmetic in plain PyTorch ops, on decoded (B, N) int64
    height ``slot``, ``cell`` and ``s_eff`` of the ``live`` points:
    scatter-amax for heights, index_add for counts, and an int64
    scatter-amax on the kernels' packed (qz bits, ~index) key for the
    intensity winner. Dead points scatter identities (max with 0, add 0,
    key 0) at slot and cell 0."""
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


def scatter_top_fused_plain(flat: torch.Tensor, hval: torch.Tensor,
                            refl: torch.Tensor, n_cells: int, zn: int,
                            heights_dtype: torch.dtype = torch.float32
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The same function in plain PyTorch ops, on any device
    (:func:`sweep_plain` on ``cell = flat // zn``, heights rounded once to
    ``heights_dtype``)."""
    check_inputs(flat, hval, refl)
    check_heights_dtype(heights_dtype)
    n_flat = n_cells * zn
    f = flat.to(torch.int64)
    live = (f >= 0) & (f < n_flat)
    cell = f // zn
    heights, count, intensity = sweep_plain(
        f, cell, f - cell * zn, live, hval, refl, n_flat, n_cells)
    return heights.to(heights_dtype), count, intensity


def scatter_top_fused_batched(flat: torch.Tensor, hval: torch.Tensor,
                              refl: torch.Tensor, n_cells: int, zn: int,
                              heights_dtype: torch.dtype = torch.float32
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(B, N) int32 ``flat``, f32 ``hval``/``refl`` -> heights
    (B, n_cells*zn) in ``heights_dtype``, count (B, n_cells) and intensity
    (B, n_cells) in f32.

    CPU tensors take the plain version; CUDA tensors take the kernel."""
    if flat.device.type == "cpu":
        return scatter_top_fused_plain(flat, hval, refl, n_cells, zn,
                                       heights_dtype)
    if flat.device.type == "cuda":
        return scatter_top_fused_kernel(flat, hval, refl, n_cells, zn,
                                        heights_dtype)
    raise ValueError(f"no voxelizer sweep for device {flat.device}")


scatter_top_fused_batched.launches = 0
