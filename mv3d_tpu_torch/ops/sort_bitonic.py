"""Stable key sort with two payloads: hand-written Hopper kernels and their
plain twin.

Port of ``mv3d_tpu/ops/sort_pallas.py::bitonic_sort_pallas`` (body
``_sort_kernel``): each row of a (B, n) int32 ``key``, n a power of two, is
sorted ascending and stably, and two f32 payloads move with it; the result
equals ``lax.sort((key, iota, p1, p2), num_keys=2)`` with the iota dropped.
The voxelizer runs it on each frame's (flat, val, refl) at
``pipeline.voxel_order="pallas-sort"`` or ``"bitonic"``
(:func:`mv3d_tpu_torch.ops.voxelize.lidar_to_top_batch`).

Two kernels, chosen by the row length n (a rule on the shape, not a
fallback):

  * n <= ``RADIX_CAPACITY`` (65,536, the serving path's rows and every
    size below): ``mv3d_tpu_torch/csrc/sort_radix.cu``, a stable LSD radix
    sort in one launch, one 8-CTA thread-block cluster per row holding the
    row in registers and distributed shared memory; 8-bit digit passes
    over the bits that vary in the row (3 for voxel ids below 2**24).
    ``bitonic_sort_batched.launches`` counts its calls.
  * longer rows: ``mv3d_tpu_torch/csrc/sort_bitonic.cu``, a bitonic
    network on the unique 64-bit word ``(key ^ 0x80000000) << 32 | index``
    (stages with pair distance below 4,096 in shared memory, the longer
    ones as one launch each). ``bitonic_network_kernel.launches`` counts
    its calls.

Dispatch: a tensor on the CPU goes to the plain radix twin
(:func:`mv3d_tpu_torch.ops.sort.radix_sort_stable`); a CUDA tensor goes to
a kernel, which raises if it cannot be built or launched (a refused
cluster launch included). There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from .cuda_build import CSRC, check_launch, load_library
from .sort import radix_sort_stable

RADIX_SOURCE = os.path.join(CSRC, "sort_radix.cu")
SOURCE = os.path.join(CSRC, "sort_bitonic.cu")
# rows of at most this many elements take the cluster radix sort (8 CTAs
# of 1,024 threads holding 8 elements each); sort_radix.cu states it too
RADIX_CAPACITY = 65536
# the bitonic kernel sorts rows of at most this many elements in shared
# memory alone
CHUNK = 4096


@functools.lru_cache(maxsize=None)
def _radix_library() -> ctypes.CDLL:
    lib = load_library(RADIX_SOURCE)
    fn = lib.mv3d_sort_radix
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, p, i64, i64, p, p, p, p]
    fn.restype = ctypes.c_int
    for name in ("mv3d_sort_radix_capacity", "mv3d_sort_radix_smem"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if lib.mv3d_sort_radix_capacity() != RADIX_CAPACITY:
        raise RuntimeError("sort_radix.cu and RADIX_CAPACITY disagree")
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.mv3d_sort_bitonic
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, p, i64, i64, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return lib


def _check_inputs(key: torch.Tensor, p1: torch.Tensor,
                  p2: torch.Tensor) -> None:
    if key.dim() != 2 or p1.shape != key.shape or p2.shape != key.shape:
        raise ValueError(f"expected matching (B, n) inputs, got "
                         f"{tuple(key.shape)}, {tuple(p1.shape)}, "
                         f"{tuple(p2.shape)}")
    if key.dtype != torch.int32 or p1.dtype != torch.float32 \
            or p2.dtype != torch.float32:
        raise TypeError(f"expected int32/float32/float32, got {key.dtype}, "
                        f"{p1.dtype}, {p2.dtype}")
    if not (key.device == p1.device == p2.device):
        raise ValueError("inputs lie on different devices")
    n = key.shape[1]
    if n < 1 or n & (n - 1) or n >= 2 ** 31:
        raise ValueError(f"the bitonic sort needs a power-of-two row length "
                         f"below 2**31, got {n}")


def _cuda_inputs(key, p1, p2):
    _check_inputs(key, p1, p2)
    if key.device.type != "cuda":
        raise ValueError(f"the sort kernel needs CUDA tensors, got "
                         f"{key.device}")
    return tuple(t.contiguous() for t in (key, p1, p2))


def radix_sort_kernel(key: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the cluster radix sort on CUDA rows of at most
    ``RADIX_CAPACITY`` elements (one launch per call; no fallback)."""
    key, p1, p2 = _cuda_inputs(key, p1, p2)
    bsz, n = key.shape
    if n > RADIX_CAPACITY or bsz > 65535:
        raise ValueError(f"the radix sort kernel takes at most 65,535 rows "
                         f"of at most {RADIX_CAPACITY}, got {bsz} x {n}")
    lib = _radix_library()
    out_key = torch.empty_like(key)
    out_p1 = torch.empty_like(p1)
    out_p2 = torch.empty_like(p2)
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream(key.device).cuda_stream
        err = lib.mv3d_sort_radix(
            key.data_ptr(), p1.data_ptr(), p2.data_ptr(), bsz, n,
            out_key.data_ptr(), out_p1.data_ptr(), out_p2.data_ptr(), stream)
    check_launch(err, "radix sort")
    bitonic_sort_batched.launches += 1
    return out_key, out_p1, out_p2


def bitonic_network_kernel(key: torch.Tensor, p1: torch.Tensor,
                           p2: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Launch the bitonic network kernel on CUDA tensors (no fallback);
    the wrapper sends it rows longer than ``RADIX_CAPACITY``."""
    key, p1, p2 = _cuda_inputs(key, p1, p2)
    lib = _library()
    bsz, n = key.shape
    out_key = torch.empty_like(key)
    out_p1 = torch.empty_like(p1)
    out_p2 = torch.empty_like(p2)
    word = torch.empty(bsz if n > CHUNK else 0, n, dtype=torch.int64,
                       device=key.device)
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream(key.device).cuda_stream
        err = lib.mv3d_sort_bitonic(
            key.data_ptr(), p1.data_ptr(), p2.data_ptr(), bsz, n,
            out_key.data_ptr(), out_p1.data_ptr(), out_p2.data_ptr(),
            word.data_ptr(), stream)
    check_launch(err, "bitonic sort")
    bitonic_network_kernel.launches += 1
    return out_key, out_p1, out_p2


def bitonic_sort_kernel(key: torch.Tensor, p1: torch.Tensor,
                        p2: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the sort kernel for CUDA tensors (no fallback): the cluster
    radix sort for rows of at most ``RADIX_CAPACITY`` elements, the
    bitonic network for longer ones."""
    _check_inputs(key, p1, p2)
    if key.shape[1] <= RADIX_CAPACITY:
        return radix_sort_kernel(key, p1, p2)
    return bitonic_network_kernel(key, p1, p2)


def bitonic_sort_plain(key: torch.Tensor, p1: torch.Tensor,
                       p2: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch ops, on any device: the radix
    twin :func:`mv3d_tpu_torch.ops.sort.radix_sort_stable`."""
    _check_inputs(key, p1, p2)
    return radix_sort_stable(key, (p1, p2))


def bitonic_sort_batched(key: torch.Tensor, p1: torch.Tensor,
                         p2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, n) int32 ``key`` and f32 ``p1``/``p2`` -> the three sorted by
    ``key`` along each row, stably. CPU tensors take the plain radix twin;
    CUDA tensors take a kernel (:func:`bitonic_sort_kernel`)."""
    if key.device.type == "cpu":
        return bitonic_sort_plain(key, p1, p2)
    if key.device.type == "cuda":
        return bitonic_sort_kernel(key, p1, p2)
    raise ValueError(f"no bitonic sort for device {key.device}")


bitonic_sort_batched.launches = 0
bitonic_network_kernel.launches = 0
