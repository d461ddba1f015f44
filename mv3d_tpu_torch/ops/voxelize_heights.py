"""Heights-only BEV scatter-max: a hand-written Hopper kernel and its plain
twin.

Port of ``mv3d_tpu/ops/voxelize_pallas.py::scatter_max_sorted`` (body
``_kernel``), the height channels of the top view when the host computes
the intensity/density plane (``pipeline.host_aux_channels``, the default
training configuration). For each frame, pre-quantized points
``flat = cell*zn + s_eff`` with non-negative values ``v`` give a zeroed
(n_flat,) f32 buffer holding the max ``v`` per index; entries with
``flat >= n_flat`` are padding and are dropped.

The kernel (``mv3d_tpu_torch/csrc/voxelize_heights.cu``) replaces the
TPU's sort + windowed VMEM sweep with a zero fill and one pass of
``atomicMax`` on the int bits of the values: non-negative f32 values order
like their bits, so the result is bit-exact and deterministic. It is bound
by writing the 48 MB/frame output (see the source's note).

Dispatch: a tensor on the CPU goes to :func:`scatter_max_plain`, which
repeats the kernel's arithmetic (an int32 scatter-amax on the value bits);
a CUDA tensor goes to the kernel, which raises if it cannot be built or
launched. There is no fallback. ``scatter_max_batched.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .cuda_build import CSRC, check_launch, launch, load_library

SOURCE = os.path.join(CSRC, "voxelize_heights.cu")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.mv3d_voxelize_heights
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, p, i64, i64, i64, p, p]
    fn.restype = ctypes.c_int
    return lib


def _check_inputs(flat: torch.Tensor, val: torch.Tensor) -> None:
    if flat.dim() != 2 or val.shape != flat.shape:
        raise ValueError(f"expected matching (B, N) inputs, got "
                         f"{tuple(flat.shape)}, {tuple(val.shape)}")
    if flat.dtype != torch.int32 or val.dtype != torch.float32:
        raise TypeError(f"expected int32/float32, got {flat.dtype}, "
                        f"{val.dtype}")
    if flat.device != val.device:
        raise ValueError("inputs lie on different devices")


def scatter_max_kernel(flat: torch.Tensor, val: torch.Tensor,
                       n_flat: int) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (no fallback)."""
    _check_inputs(flat, val)
    if flat.device.type != "cuda":
        raise ValueError(f"the heights kernel needs CUDA tensors, got "
                         f"{flat.device}")
    lib = _library()
    flat, val = flat.contiguous(), val.contiguous()
    bsz, n = flat.shape
    out = torch.empty(bsz, n_flat, dtype=torch.float32, device=flat.device)
    err = launch(lib.mv3d_voxelize_heights, flat.device, flat.data_ptr(),
                 val.data_ptr(), bsz, n, n_flat, out.data_ptr())
    check_launch(err, "voxelize heights")
    scatter_max_batched.launches += 1
    return out


def scatter_max_plain(flat: torch.Tensor, val: torch.Tensor,
                      n_flat: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch ops, on any device: an
    int32 scatter-amax of the values' bits into a zeroed buffer. Padding
    and values that are not > 0 scatter 0 (the identity) at slot 0."""
    _check_inputs(flat, val)
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


def scatter_max_batched(flat: torch.Tensor, val: torch.Tensor,
                        n_flat: int) -> torch.Tensor:
    """(B, N) int32 ``flat`` and f32 ``val`` -> (B, n_flat) f32 per-index
    maxima over a zero fill. CPU tensors take the plain version; CUDA
    tensors take the kernel."""
    if flat.device.type == "cpu":
        return scatter_max_plain(flat, val, n_flat)
    if flat.device.type == "cuda":
        return scatter_max_kernel(flat, val, n_flat)
    raise ValueError(f"no heights scatter-max for device {flat.device}")


scatter_max_batched.launches = 0
