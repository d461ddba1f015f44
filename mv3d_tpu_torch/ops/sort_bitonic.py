"""Stable key sort with two payloads: hand-written Hopper kernels and their
plain twin.

Port of ``mv3d_tpu/ops/sort_pallas.py::bitonic_sort_pallas`` (body
``_sort_kernel``): each row of a (B, n) int32 ``key``, n a power of two, is
sorted ascending and stably, and two f32 payloads move with it; the result
equals ``lax.sort((key, iota, p1, p2), num_keys=2)`` with the iota dropped.
The voxelizer runs it on each frame's (flat, val, refl) at
``pipeline.voxel_order="pallas-sort"`` or ``"bitonic"``
(:func:`mv3d_tpu_torch.ops.voxelize.lidar_to_top_batch`).

Two routes, chosen by the row length n (a rule on the shape, not a
fallback):

  * n <= ``RADIX_CAPACITY`` (65,536, the serving path's rows and every
    size below): ``mv3d_tpu_torch/csrc/sort_radix.cu``, a stable LSD radix
    sort in one launch, one 8-CTA thread-block cluster per row holding the
    row in registers and distributed shared memory; 8-bit digit passes
    over the bits that vary in the row (3 for voxel ids below 2**24).
    ``bitonic_sort_batched.launches`` counts its launches.
  * longer rows (n = 65,536 * 2**k): the (B, n) row is 2**k contiguous
    blocks of 65,536, sorted as B * 2**k rows in one launch of the same
    radix kernel (each block with its own pass plan), then k launches of
    ``mv3d_tpu_torch/csrc/sort_merge.cu``, each merging pairs of sorted
    runs stably (merge path, the left run first on equal keys) into runs
    twice as long, ping-ponging between the output and one scratch of the
    rows' size. ``merge_pass_kernel.launches`` counts the merge launches.

Dispatch: a tensor on the CPU goes to the plain radix twin
(:func:`mv3d_tpu_torch.ops.sort.radix_sort_stable`); a CUDA tensor goes to
the kernels, which raise if they cannot be built or launched (a refused
cluster launch included). There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Sequence, Tuple

import torch

from .cuda_build import CSRC, check_launch, launch, load_library
from .sort import radix_sort_stable

RADIX_SOURCE = os.path.join(CSRC, "sort_radix.cu")
MERGE_SOURCE = os.path.join(CSRC, "sort_merge.cu")
# rows of at most this many elements take the cluster radix sort (8 CTAs
# of 1,024 threads holding 8 elements each); sort_radix.cu states it too.
# Longer rows are sorted in blocks of this many, then merged.
RADIX_CAPACITY = 65536


@functools.lru_cache(maxsize=None)
def _radix_library() -> ctypes.CDLL:
    lib = load_library(RADIX_SOURCE)
    fn = lib.mv3d_sort_radix
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, p, i64, i64, p, p, p, p]
    fn.restype = ctypes.c_int
    for name in ("mv3d_sort_radix_capacity", "mv3d_sort_radix_smem",
                 "mv3d_sort_radix_max_clusters"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if lib.mv3d_sort_radix_capacity() != RADIX_CAPACITY:
        raise RuntimeError("sort_radix.cu and RADIX_CAPACITY disagree")
    return lib


@functools.lru_cache(maxsize=None)
def _merge_library() -> ctypes.CDLL:
    lib = load_library(MERGE_SOURCE)
    fn = lib.mv3d_sort_merge
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, p, i64, i64, i64, p, p, p, p]
    fn.restype = ctypes.c_int
    lib.mv3d_sort_merge_tile.argtypes = []
    lib.mv3d_sort_merge_tile.restype = ctypes.c_int
    if RADIX_CAPACITY % lib.mv3d_sort_merge_tile():
        raise RuntimeError("sort_merge.cu's tile does not divide "
                           "RADIX_CAPACITY")
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


Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _ptrs(ts: Sequence[torch.Tensor]) -> List[int]:
    return [t.data_ptr() for t in ts]


def _radix_launch(src: Sequence[int], rows: int, n: int, dst: Sequence[int],
                  device: torch.device) -> None:
    """One launch of the radix kernel on ``rows`` contiguous rows of ``n``
    (key, p1, p2) at the addresses ``src``, into ``dst``."""
    if n > RADIX_CAPACITY or rows > 65535:
        raise ValueError(f"the radix sort kernel takes at most 65,535 rows "
                         f"of at most {RADIX_CAPACITY}, got {rows} x {n}")
    err = launch(_radix_library().mv3d_sort_radix, device, *src, rows, n,
                 *dst)
    check_launch(err, "radix sort")
    bitonic_sort_batched.launches += 1


def radix_sort_kernel(key: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor
                      ) -> Triple:
    """Launch the cluster radix sort on CUDA rows of at most
    ``RADIX_CAPACITY`` elements (one launch per call; no fallback)."""
    src = _cuda_inputs(key, p1, p2)
    out = tuple(torch.empty_like(t) for t in src)
    _radix_launch(_ptrs(src), *src[0].shape, _ptrs(out), src[0].device)
    return out


def merge_pass_kernel(src: Sequence[int], bsz: int, n: int, run: int,
                      dst: Sequence[int], device: torch.device) -> None:
    """One launch of the merge kernel: ``bsz`` contiguous CUDA rows of
    ``n`` (key, p1, p2) at the addresses ``src``, made of sorted runs of
    ``run`` elements (a multiple of its 2,048-element tile; n a multiple
    of ``2 * run``), merged pairwise and stably into ``dst``."""
    if n % (2 * run):
        raise ValueError(f"rows of {n} are no whole pairs of runs of {run}")
    err = launch(_merge_library().mv3d_sort_merge, device, *src, bsz, n, run,
                 *dst)
    check_launch(err, "merge pass")
    merge_pass_kernel.launches += 1


def merge_sort_kernel(key: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor
                      ) -> Triple:
    """Sort CUDA rows longer than ``RADIX_CAPACITY`` (n = 65,536 * 2**k):
    the rows' blocks in one radix launch, then k merge launches,
    ping-ponging between the output and one scratch (int32 key and the
    payloads' bits) so that the last pass writes the output (no
    fallback)."""
    src = _cuda_inputs(key, p1, p2)
    bsz, n = src[0].shape
    if n <= RADIX_CAPACITY:
        raise ValueError(f"rows of {n} take the radix sort alone")
    dev = src[0].device
    passes = (n // RADIX_CAPACITY).bit_length() - 1
    out = tuple(torch.empty_like(t) for t in src)
    scratch = torch.empty(3 * bsz * n, dtype=torch.int32, device=dev)
    base, step = scratch.data_ptr(), bsz * n * 4
    bufs = [_ptrs(out), [base, base + step, base + 2 * step]]
    if passes % 2:
        bufs.reverse()
    _radix_launch(_ptrs(src), bsz * (n // RADIX_CAPACITY), RADIX_CAPACITY,
                  bufs[0], dev)
    run = RADIX_CAPACITY
    for p in range(passes):
        merge_pass_kernel(bufs[p % 2], bsz, n, run, bufs[1 - p % 2], dev)
        run *= 2
    return out


def bitonic_sort_kernel(key: torch.Tensor, p1: torch.Tensor,
                        p2: torch.Tensor) -> Triple:
    """Launch the sort kernels for CUDA tensors (no fallback): the cluster
    radix sort for rows of at most ``RADIX_CAPACITY`` elements, radix
    blocks plus merge passes for longer ones."""
    _check_inputs(key, p1, p2)
    if key.shape[1] <= RADIX_CAPACITY:
        return radix_sort_kernel(key, p1, p2)
    return merge_sort_kernel(key, p1, p2)


def bitonic_sort_plain(key: torch.Tensor, p1: torch.Tensor,
                       p2: torch.Tensor) -> Triple:
    """The same function in plain PyTorch ops, on any device: the radix
    twin :func:`mv3d_tpu_torch.ops.sort.radix_sort_stable` (for rows of
    any length; the blocks and merges of long rows in plain ops,
    :func:`mv3d_tpu_torch.ops.sort.merge_sort_stable`, give the same)."""
    _check_inputs(key, p1, p2)
    return radix_sort_stable(key, (p1, p2))


def bitonic_sort_batched(key: torch.Tensor, p1: torch.Tensor,
                         p2: torch.Tensor) -> Triple:
    """(B, n) int32 ``key`` and f32 ``p1``/``p2`` -> the three sorted by
    ``key`` along each row, stably. CPU tensors take the plain twin;
    CUDA tensors take the kernels (:func:`bitonic_sort_kernel`)."""
    if key.device.type == "cpu":
        return bitonic_sort_plain(key, p1, p2)
    if key.device.type == "cuda":
        return bitonic_sort_kernel(key, p1, p2)
    raise ValueError(f"no bitonic sort for device {key.device}")


bitonic_sort_batched.launches = 0
merge_pass_kernel.launches = 0
