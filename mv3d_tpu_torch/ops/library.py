"""The port's kernels as PyTorch operators, in the ``mv3d`` namespace.

  * ``mv3d::voxelize_sweep``   K1, :mod:`.voxelize_sweep`;
  * ``mv3d::voxelize_padded``  K2, :mod:`.voxelize_padded`;
  * ``mv3d::scatter_max``      K3, :mod:`.voxelize_heights`;
  * ``mv3d::stable_sort``      K4, :mod:`.sort_bitonic` (the radix kernel
    for rows up to 65,536, radix blocks plus merge passes above that);
  * ``mv3d::bn_relu``          eval-mode BatchNorm + ReLU in one pass,
    :mod:`.bn_relu` (the epilogue of the model's conv and dense layers);
  * ``mv3d::nms_topk``         greedy NMS of score-sorted boxes up to
    ``max_out`` kept, :mod:`.nms_topk` (AVOD's proposal and final NMS).

Each operator has a CUDA implementation (the kernel's ctypes launch, which
counts its launches as before), a CPU implementation (the kernel's plain
version) and a fake one that gives the outputs' shapes and dtypes, so that
``torch.export`` records the operator itself in a program. The dispatcher,
not Python, then picks the kernel or the plain version at run time from
the tensors' device: a program traced on the CPU and moved to the card
launches the kernels there. Any other device raises (no implementation).
``mv3d::bn_relu`` also has a gradient (:func:`.bn_relu.bn_relu_backward`),
so that an eval-mode model stays differentiable.

The ``*_batched`` wrappers of the kernel modules and :func:`.bn_relu.bn_relu`
call these operators; importing :mod:`mv3d_tpu_torch.ops` registers them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import (bn_relu, nms, nms_topk, sort_bitonic, voxelize_heights,
               voxelize_padded, voxelize_sweep)

NAMESPACE = "mv3d"
OPS = ("voxelize_sweep", "voxelize_padded", "scatter_max", "stable_sort",
       "bn_relu", "nms_topk")

_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("voxelize_sweep(Tensor flat, Tensor hval, Tensor refl, "
            "int n_cells, int zn, ScalarType heights_dtype) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.define("voxelize_padded(Tensor flat, Tensor hval, Tensor refl, "
            "int n_sc, int zn, ScalarType heights_dtype) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.define("scatter_max(Tensor flat, Tensor val, int n_flat) -> Tensor")
_LIB.define("stable_sort(Tensor key, Tensor p1, Tensor p2) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.define("bn_relu(Tensor x, Tensor weight, Tensor bias, Tensor mean, "
            "Tensor var, float eps) -> Tensor")
_LIB.define("nms_topk(Tensor boxes, Tensor scores, int max_out, "
            "float iou_threshold, float offset) -> (Tensor, Tensor, Tensor)")


def _fresh(outs, inputs: Sequence[torch.Tensor]):
    """``outs`` with a copy in place of any output that shares an input's
    storage (the plain sort returns its inputs where no digit varies): an
    operator's outputs must not alias its inputs."""
    held = {t.untyped_storage().data_ptr() for t in inputs}
    one = torch.is_tensor(outs)
    outs = [o.clone() if o.untyped_storage().data_ptr() in held else o
            for o in ((outs,) if one else outs)]
    return outs[0] if one else tuple(outs)


def _plain(fn, n_tensors: int):
    def impl(*args):
        return _fresh(fn(*args), args[:n_tensors])
    impl.__name__ = fn.__name__
    return impl


_LIB.impl("voxelize_sweep", voxelize_sweep.scatter_top_fused_kernel, "CUDA")
_LIB.impl("voxelize_sweep",
          _plain(voxelize_sweep.scatter_top_fused_plain, 3), "CPU")
_LIB.impl("voxelize_padded", voxelize_padded.scatter_top_padded_kernel,
          "CUDA")
_LIB.impl("voxelize_padded",
          _plain(voxelize_padded.scatter_top_padded_plain, 3), "CPU")
_LIB.impl("scatter_max", voxelize_heights.scatter_max_kernel, "CUDA")
_LIB.impl("scatter_max", _plain(voxelize_heights.scatter_max_plain, 2),
          "CPU")
_LIB.impl("stable_sort", sort_bitonic.bitonic_sort_kernel, "CUDA")
_LIB.impl("stable_sort", _plain(sort_bitonic.bitonic_sort_plain, 3), "CPU")
_LIB.impl("bn_relu", bn_relu.bn_relu_kernel, "CUDA")
_LIB.impl("bn_relu", _plain(bn_relu.bn_relu_plain, 5), "CPU")
_LIB.impl("nms_topk", nms_topk.nms_topk_kernel, "CUDA")
_LIB.impl("nms_topk", nms.nms_sorted_plain, "CPU")


Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@torch.library.register_fake(f"{NAMESPACE}::voxelize_sweep")
def _sweep_fake(flat, hval, refl, n_cells: int, zn: int,
                heights_dtype: torch.dtype) -> Triple:
    voxelize_sweep.check_inputs(flat, hval, refl)
    voxelize_sweep.check_heights_dtype(heights_dtype)
    bsz = flat.shape[0]
    return (flat.new_empty(bsz, n_cells * zn, dtype=heights_dtype),
            hval.new_empty(bsz, n_cells), hval.new_empty(bsz, n_cells))


@torch.library.register_fake(f"{NAMESPACE}::voxelize_padded")
def _padded_fake(flat, hval, refl, n_sc: int, zn: int,
                 heights_dtype: torch.dtype) -> Triple:
    voxelize_sweep.check_inputs(flat, hval, refl)
    voxelize_padded.check_shape(n_sc, zn, heights_dtype)
    bsz = flat.shape[0]
    return (flat.new_empty(bsz, n_sc * voxelize_padded.LANES,
                           dtype=heights_dtype),
            hval.new_empty(bsz, n_sc * 4), hval.new_empty(bsz, n_sc * 4))


@torch.library.register_fake(f"{NAMESPACE}::scatter_max")
def _heights_fake(flat, val, n_flat: int) -> torch.Tensor:
    voxelize_heights.check_inputs(flat, val)
    return val.new_empty(flat.shape[0], n_flat)


@torch.library.register_fake(f"{NAMESPACE}::stable_sort")
def _sort_fake(key, p1, p2) -> Triple:
    sort_bitonic.check_inputs(key, p1, p2)
    return (torch.empty_like(key, memory_format=torch.contiguous_format),
            torch.empty_like(p1, memory_format=torch.contiguous_format),
            torch.empty_like(p2, memory_format=torch.contiguous_format))


@torch.library.register_fake(f"{NAMESPACE}::bn_relu")
def _bn_relu_fake(x, weight, bias, mean, var, eps: float) -> torch.Tensor:
    bn_relu.check_inputs(x, weight, bias, mean, var)
    return torch.empty_like(x)


@torch.library.register_fake(f"{NAMESPACE}::nms_topk")
def _nms_topk_fake(boxes, scores, max_out: int, iou_threshold: float,
                   offset: float) -> Triple:
    nms_topk.check_inputs(boxes, scores, max_out)
    bsz = scores.shape[0]
    return (scores.new_empty(bsz, max_out, dtype=torch.int32),
            scores.new_empty(bsz, dtype=torch.int32),
            scores.new_empty(bsz, dtype=torch.int32))


def _bn_relu_setup(ctx, inputs, output) -> None:
    x, weight, bias, mean, var, eps = inputs
    if mean.requires_grad or var.requires_grad:
        raise RuntimeError("mv3d::bn_relu is not differentiable with respect "
                           "to the running statistics")
    ctx.eps = eps
    ctx.save_for_backward(x, weight, mean, var, output)


def _bn_relu_backward(ctx, grad):
    return (*bn_relu.bn_relu_backward(grad, *ctx.saved_tensors, ctx.eps),
            None, None, None)


torch.library.register_autograd(f"{NAMESPACE}::bn_relu", _bn_relu_backward,
                                setup_context=_bn_relu_setup)
