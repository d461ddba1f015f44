"""Greedy NMS of score-sorted boxes up to ``max_out`` kept: a hand-written
Hopper kernel.

AVOD's proposal layer suppresses up to 89,600 BEV boxes a frame at IoU 0.8
down to 300, and its detection layer 300 at 0.01 down to 100. The
batched :func:`.nms.greedy_nms` takes ``max_out`` sequential (B, K) steps
of a few launches each (about 1,200 launches a request at the proposal
layer's sizes, and (B, K, K) intermediates of 32 GB a frame); the kernel (``mv3d_tpu_torch/csrc/nms_topk.cu``) is one
launch for the batch, one block a frame, sweeping the sorted list in
tiles: each tile's boxes against the boxes kept so far, the tile's own
suppression bitmask, then one warp's in-order walk that keeps a box not
yet removed and ORs in its row. It stops at the ``max_out``-th keep, so
its work follows the boxes it visits, not K. Its picks are
:func:`.nms.nms_sorted_plain`'s, to the index.

Dispatch: :func:`.nms.nms_topk` sorts and calls the operator
``mv3d::nms_topk`` (:mod:`.library`), whose CPU implementation is
:func:`.nms.nms_sorted_plain` and whose CUDA implementation is
:func:`nms_topk_kernel`, which raises on what the kernel does not take.
There is no fallback. ``nms_topk_kernel.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from .cuda_build import CSRC, check_launch, launch, load_library

SOURCE = os.path.join(CSRC, "nms_topk.cu")
SMEM_LIMIT = 232448  # dynamic shared memory one H100 block may use


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.mv3d_nms_topk
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    fn.argtypes = [p, p, i64, i64, i32, ctypes.c_float, ctypes.c_float,
                   p, p, p, p]
    fn.restype = ctypes.c_int
    lib.mv3d_nms_topk_smem.argtypes = [i32]
    lib.mv3d_nms_topk_smem.restype = i64
    return lib


def check_inputs(boxes: torch.Tensor, scores: torch.Tensor,
                 max_out: int) -> None:
    if scores.dim() != 2 or boxes.shape != scores.shape + (4,):
        raise ValueError(f"expected (B, K, 4) boxes and (B, K) scores, got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"expected f32 boxes and scores, got {boxes.dtype}, "
                        f"{scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError("inputs lie on different devices")
    if max_out < 1:
        raise ValueError(f"max_out must be >= 1, got {max_out}")


def nms_topk_kernel(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
                    iou_threshold: float, offset: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors (no fallback); the outputs of
    :func:`.nms.nms_sorted_plain`."""
    check_inputs(boxes, scores, max_out)
    if boxes.device.type != "cuda":
        raise ValueError(f"the NMS kernel needs CUDA tensors, got "
                         f"{boxes.device}")
    bsz, k = scores.shape
    lib = _library()
    if k >= 2 ** 31 or lib.mv3d_nms_topk_smem(max_out) > SMEM_LIMIT:
        raise ValueError(f"the NMS kernel takes K < 2**31 and keeps at most "
                         f"what one block's shared memory holds; got K={k}, "
                         f"max_out={max_out}")
    boxes, scores = boxes.contiguous(), scores.contiguous()
    dev = boxes.device
    keep = torch.empty(bsz, max_out, dtype=torch.int32, device=dev)
    count = torch.empty(bsz, dtype=torch.int32, device=dev)
    visited = torch.empty(bsz, dtype=torch.int32, device=dev)
    err = launch(lib.mv3d_nms_topk, dev, boxes.data_ptr(), scores.data_ptr(),
                 bsz, k, max_out, float(iou_threshold), float(offset),
                 keep.data_ptr(), count.data_ptr(), visited.data_ptr())
    check_launch(err, "nms_topk")
    nms_topk_kernel.launches += 1
    return keep, count, visited


nms_topk_kernel.launches = 0
