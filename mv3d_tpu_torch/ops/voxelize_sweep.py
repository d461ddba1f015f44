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

Entries with ``flat >= n_cells*zn`` are padding.

The kernel (``mv3d_tpu_torch/csrc/voxelize_sweep.cu``) replaces the TPU's
sort + tiled sweep with global atomics: a point pass (int-bits atomicMax for
heights, atomicAdd for count, a 64-bit atomicMax on a packed (qz, ~index)
key for the winner) and a cell pass (count to f32, winner's reflectance).
Max and integer add are order-independent, so it is bit-exact and
deterministic. What bounds it on an H100 is zero-filling and writing the
48 MB heights volume per frame against ~65k scattered atomics; fusing the
view assembly (``mv3d_tpu/ops/voxelize.py`` lidar_to_top_batch's concat)
into the cell pass is later performance work.

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

from .cuda_build import CSRC, check_launch, load_library

SOURCE = os.path.join(CSRC, "voxelize_sweep.cu")

_KEY_LOW = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.mv3d_voxelize_sweep
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, p, i64, i64, i64, ctypes.c_int32,
                   p, p, p, p, p, p]
    fn.restype = ctypes.c_int
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
                             refl: torch.Tensor, n_cells: int, zn: int
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors (no fallback)."""
    check_inputs(flat, hval, refl)
    if flat.device.type != "cuda":
        raise ValueError(f"the sweep kernel needs CUDA tensors, got "
                         f"{flat.device}")
    lib = _library()
    flat, hval, refl = (t.contiguous() for t in (flat, hval, refl))
    bsz, n = flat.shape
    dev = flat.device
    heights = torch.zeros(bsz, n_cells * zn, dtype=torch.float32, device=dev)
    count = torch.empty(bsz, n_cells, dtype=torch.float32, device=dev)
    intensity = torch.empty(bsz, n_cells, dtype=torch.float32, device=dev)
    cnt = torch.zeros(bsz, n_cells, dtype=torch.int32, device=dev)
    best = torch.zeros(bsz, n_cells, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mv3d_voxelize_sweep(
            flat.data_ptr(), hval.data_ptr(), refl.data_ptr(), bsz, n,
            n_cells, zn, heights.data_ptr(), count.data_ptr(),
            intensity.data_ptr(), cnt.data_ptr(), best.data_ptr(), stream)
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
                            refl: torch.Tensor, n_cells: int, zn: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The same function in plain PyTorch ops, on any device
    (:func:`sweep_plain` on ``cell = flat // zn``)."""
    check_inputs(flat, hval, refl)
    n_flat = n_cells * zn
    f = flat.to(torch.int64)
    live = (f >= 0) & (f < n_flat)
    cell = f // zn
    return sweep_plain(f, cell, f - cell * zn, live, hval, refl, n_flat,
                       n_cells)


def scatter_top_fused_batched(flat: torch.Tensor, hval: torch.Tensor,
                              refl: torch.Tensor, n_cells: int, zn: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(B, N) int32 ``flat``, f32 ``hval``/``refl`` -> heights
    (B, n_cells*zn), count (B, n_cells), intensity (B, n_cells), all f32.

    CPU tensors take the plain version; CUDA tensors take the kernel."""
    if flat.device.type == "cpu":
        return scatter_top_fused_plain(flat, hval, refl, n_cells, zn)
    if flat.device.type == "cuda":
        return scatter_top_fused_kernel(flat, hval, refl, n_cells, zn)
    raise ValueError(f"no voxelizer sweep for device {flat.device}")


scatter_top_fused_batched.launches = 0
