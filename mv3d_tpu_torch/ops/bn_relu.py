"""Eval-mode BatchNorm + ReLU in one pass: a hand-written Hopper kernel and
its plain version.

The epilogue of every conv and dense layer of the served trunks, ROI
towers and fusion head (``models/backbone.py::bn_relu`` in eval mode):
``relu(batch_norm(x in f32, running statistics))`` rounded once to the
input's dtype, the compute dtype (bf16 or f32). It replaces no TPU
kernel: on the TPU, XLA fused the JAX package's cast -> BatchNorm -> ReLU
-> cast chain into one pass; in PyTorch the chain is four device passes
with f32 intermediates, 28 bytes an element where the function needs 4
in bf16 (read once, written once).

The kernel (``mv3d_tpu_torch/csrc/bn_relu.cu``) is that one pass. It is
bound by HBM bytes: each block builds a (scale, shift) table of the
channels in shared memory from the BatchNorm's four vectors, then streams
16-byte vectors of the input through one FMA and a compare each element.
The output takes the input's memory format (``empty_like``), and
:func:`layout` reads from the strides how the input's elements map onto
the dense output: rows of ``row_len`` elements ``ld`` apart (one row where
the input is dense; the split stem's cropped view is row-strided) and the
channel's extent ``inner`` in the output (1 channels-last, H*W NCHW), from
which it picks 8 channels a vector (channels-last, as every served path
hands it) or one element at a time. Nothing forks on a model or a knob:
the shape decides.

Dispatch: :func:`bn_relu` calls the operator ``mv3d::bn_relu``
(:mod:`.library`), whose CPU implementation is :func:`bn_relu_plain`,
exactly the composition the model ran before the kernel, and whose CUDA
implementation is :func:`bn_relu_kernel`, which raises on what the kernel
does not take. There is no fallback. Its gradient is
:func:`bn_relu_backward`, with respect to the input and the affine terms;
the running statistics take none, as in PyTorch's BatchNorm.
``bn_relu.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch
import torch.nn.functional as F

from .cuda_build import CSRC, check_launch, launch, load_library

SOURCE = os.path.join(CSRC, "bn_relu.cu")
DTYPES = (torch.bfloat16, torch.float32)
MAX_CHANNELS = 48 * 1024 // 8        # (scale, shift) f32 pairs in 48 KB
MAX_ELEMENTS = 2 ** 31 - 1           # the kernel indexes in 32 bits
EIGHT_CHANNELS, SCALAR = 0, 1      # the kernel's modes


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.mv3d_bn_relu
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p, p, i32, p, p, p, p, ctypes.c_float,
                   i64, i64, i64, i64, i64, i32, i64, p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_inputs(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor) -> None:
    if x.dim() < 2:
        raise ValueError(f"expected an (N, C, ...) input, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"expected a bf16 or f32 input, got {x.dtype}")
    c = x.shape[1]
    for t in (weight, bias, mean, var):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"expected f32 ({c},) BatchNorm vectors, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("inputs lie on different devices")


def layout(x: torch.Tensor, out: torch.Tensor) -> Tuple[int, int, int]:
    """(row_len, ld, inner) of ``x`` against its dense output ``out``:
    ``out``'s element ``o`` is ``x``'s element ``o % row_len`` of row
    ``o // row_len``, rows ``ld`` elements apart, and its channel is
    ``(o // inner) % C``. Raises where ``x``'s elements do not form such
    rows (more than one stride breaks the run)."""
    dims = sorted((d for d in range(x.dim()) if x.shape[d] != 1),
                  key=lambda d: out.stride(d))
    row_len, ld, rows = 1, None, 1
    for d in dims:
        if ld is None and x.stride(d) == row_len:
            row_len *= x.shape[d]
        elif ld is None:
            ld, rows = x.stride(d), x.shape[d]
        elif x.stride(d) == ld * rows:
            rows *= x.shape[d]
        else:
            raise ValueError(f"the bn_relu kernel takes rows with one "
                             f"stride; got strides {x.stride()} for shape "
                             f"{tuple(x.shape)}")
    inner = out.stride(1) if x.shape[1] > 1 else 1
    return row_len, (row_len if ld is None else ld), inner


def mode(x: torch.Tensor, row_len: int, ld: int, inner: int) -> int:
    """The kernel's mode: 8 channels a vector (channels-last, C % 8 == 0,
    16-byte aligned rows of whole vectors), else one element at a time."""
    aligned = (x.data_ptr() % 16 == 0 and row_len % 8 == 0
               and ld % 8 == 0)
    if aligned and inner == 1 and x.shape[1] % 8 == 0:
        return EIGHT_CHANNELS
    return SCALAR


def bn_relu_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (no fallback)."""
    check_inputs(x, weight, bias, mean, var)
    if x.device.type != "cuda":
        raise ValueError(f"the bn_relu kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.shape[1] > MAX_CHANNELS or x.numel() > MAX_ELEMENTS:
        raise ValueError(f"the bn_relu kernel takes at most {MAX_CHANNELS} "
                         f"channels and {MAX_ELEMENTS} elements, got "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    if not x.numel():
        return out
    row_len, ld, inner = layout(x, out)
    params = [t.contiguous() for t in (weight, bias, mean, var)]
    lib = _library()
    err = launch(lib.mv3d_bn_relu, x.device, x.data_ptr(), out.data_ptr(),
                 int(x.dtype == torch.bfloat16),
                 *(t.data_ptr() for t in params), float(eps), x.shape[1],
                 inner, x.numel(), row_len, ld, mode(x, row_len, ld, inner),
                 _sm_count(x.device.index if x.device.index is not None
                           else torch.cuda.current_device()))
    check_launch(err, "bn_relu")
    bn_relu.launches += 1
    return out


def bn_relu_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  mean: torch.Tensor, var: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """The composition the kernel replaces, on any device: cast to f32,
    eval-mode BatchNorm on the running statistics, ReLU, cast back."""
    check_inputs(x, weight, bias, mean, var)
    return F.relu(F.batch_norm(x.to(torch.float32), mean, var, weight, bias,
                               False, 0.0, eps)).to(x.dtype)


def bn_relu_backward(grad: torch.Tensor, x: torch.Tensor,
                     weight: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor, out: torch.Tensor,
                     eps: float) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``out = bn_relu(x, ...)`` with respect to ``x``,
    ``weight`` and ``bias``, as autograd takes them through
    :func:`bn_relu_plain`: ``grad`` in f32 passes the ReLU where ``out``
    is not <= 0, then the affine of the running statistics; ``x``'s in
    its dtype. Plain PyTorch on any device (the model's eval-mode
    fine-tuning and attribution; no served path takes a gradient)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    dims = [d for d in range(x.dim()) if d != 1]
    g = torch.where(out <= 0, 0.0, grad.to(torch.float32))
    invstd = torch.rsqrt(var + eps)
    grad_x = (g * (weight * invstd).reshape(shape)).to(x.dtype)
    grad_weight = (g * (x.to(torch.float32) - mean.reshape(shape))).sum(
        dims) * invstd
    return grad_x, grad_weight, g.sum(dims)


def bn_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor,
            eps: float) -> torch.Tensor:
    """``relu(batch_norm(x))`` in f32 on the running statistics, in
    ``x``'s dtype: the operator ``mv3d::bn_relu``, whose CPU
    implementation is the plain version and CUDA one the kernel."""
    return torch.ops.mv3d.bn_relu.default(x, weight, bias, mean, var,
                                          float(eps))


bn_relu.launches = 0
