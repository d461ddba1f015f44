"""The ``avod`` family's reference: AVOD's served function (Ku et al., IROS
2018, arXiv:1712.02294), raw (points, rgb) frames in, per frame the live
(boxes3d (K, 8, 3), probs (K,)) out, and what the harness needs to know
of AVOD to draw, check and read a cell of it.

The network is ``avodref/plain.py``: scatter voxelization, plain bilinear
crops, the RPN's heads on the non-empty anchors only, plain greedy NMS,
each departure from AVOD in its docstring. It restates what a served
artifact promises: a cloud over the point bucket is cut to ``max_points``
evenly spaced rows, the batch padded with empty frames, the rgb taken as
float32.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import torch

from .avodref import plain
from .avodref.plain import (AvodReference, Spec, calibrate,  # noqa: F401
                            candidates, detect)

# the check's reference computes in f32 (TF32 off) where the program
# computes in bf16: a sound program reads the gap of its own rounding
CHECK_OVERRIDES = {"model": {"compute_dtype": "float32"},
                   "pipeline": {"top_view_dtype": "float32"}}
# the control: the program's own int8 path, the precision below the bf16
# the configuration states, on every conv, transposed conv and FC layer of
# both pyramids, the RPN and the second stage but the heads' last layers
CONTROL_OVERRIDES = {"model": {"quant": "int8"}}
# name suffix -> standard deviation of a head's last layer, as Faster
# R-CNN's heads start (``harness/weights.py``): the scores and the RPN's
# offsets at 0.01, the box_4c offsets at 0.001 (metres, as a trained
# head's), the angle vector at 0.01
HEAD_STD = {".cls_fc8.weight": 0.01, ".reg_fc8.weight": 0.01,
            ".cls_out.weight": 0.01, ".off_out.weight": 0.001,
            ".ang_out.weight": 0.01}


def config_from_dict(tree: Dict[str, Any]) -> Spec:
    """The reference's :class:`Spec` of a configuration tree."""
    return plain.spec_from_tree(tree)


def network(cfg: Spec) -> AvodReference:
    """The network at ``cfg`` on the CPU, with placeholder weights (its
    ``state_dict`` is the layout the benchmark draws)."""
    return AvodReference(cfg)


def build(cfg: Spec, weights: Dict[str, torch.Tensor], device
          ) -> AvodReference:
    net = network(cfg)
    net.load_state_dict(weights)
    return net.to(device).eval()


def drive(cfg: Spec) -> Tuple[Dict[str, float], Tuple[int, int, int]]:
    """The area the traffic's scenes fill (the BEV grid) and the camera's
    (H, W, 3) shape."""
    return ({"x_min": cfg.x_min, "x_max": cfg.x_max, "y_min": cfg.y_min,
             "y_max": cfg.y_max}, (cfg.image_h, cfg.image_w, 3))


def rule(cfg: Spec, score_threshold: float) -> Dict[str, Any]:
    """The fields of ``harness/compare.Rule``: the score threshold, the
    final NMS threshold and the BEV grid its top-view pixel boxes are
    rounded to."""
    return {"score_threshold": float(score_threshold),
            "nms_thresh": float(cfg.final_nms_thresh),
            "grid": {"x_min": cfg.x_min, "y_min": cfg.y_min,
                     "x_div": cfg.x_div, "y_div": cfg.y_div, "xn": cfg.xn,
                     "yn": cfg.yn}}


def sizes(cfg: Spec, batch: int) -> Dict[str, Any]:
    """The sizes the per-layer readers take from a traced run's record: the
    batch, the point bucket, the BEV's cells and view dtype (the fused
    sweep, ``metrics/voxelize_sweep_roofline.py``), and each NMS call's
    candidates and kept boxes a frame (``metrics/nms_topk_roofline.py``):
    the proposal NMS over every anchor, the final NMS over the
    proposals."""
    n_anchors = len(plain.anchors(cfg)[0])
    return {"batch": batch, "points": cfg.max_points, "xn": cfg.xn,
            "yn": cfg.yn, "zn": cfg.zn, "top_view_dtype": cfg.view_dtype,
            "nms_calls": [[n_anchors, cfg.rpn_topn],
                          [cfg.rpn_topn, cfg.final_topn]]}


def fused_epilogues():
    """A context in which the reference's bf16 convolutions and dense
    layers return their f32 products (bf16 inputs and weights, f32
    accumulation, no rounding of the output): the witness of a sound
    change that rounds differently (``readings.py``)."""
    @contextlib.contextmanager
    def ctx():
        kept = plain.KEEP_F32_PRODUCTS
        plain.KEEP_F32_PRODUCTS = True
        try:
            yield
        finally:
            plain.KEEP_F32_PRODUCTS = kept
    return ctx()
