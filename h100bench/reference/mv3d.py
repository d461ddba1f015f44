"""The ``mv3d`` family's reference: MV3D's served function, raw (points,
rgb) frames in, per frame the live (boxes3d (K, 8, 3), probs (K,)) out,
and what the harness needs to know of MV3D to draw, check and read a
cell of it (the check's precision, the control, the heads' initial
scales, the comparison's rule, the drive's shape, the readers' sizes).

It restates what a served artifact promises (``mv3d_tpu_torch/serving/
export.py``): a cloud over the point bucket is cut to ``max_points``
evenly spaced rows of the raw cloud (row ``i * n // max_points``), padded
with rows at -1e9 and ``num_points`` valid rows; the rgb is taken as
float32; the frames run as one batch through the voxelizer (plain
scatter versions), the trunks, the RPN and proposal layer, ROI pooling,
the fusion head and the final NMS, in the configuration's compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .mv3dref.config import Config
from .mv3dref.models.backbone import BatchNorm
from .mv3dref.models.mv3d_net import MV3DNet
from .mv3dref.ops import boxes as box_ops
from .mv3dref.ops import boxes3d as box3d_ops
from .mv3dref.ops.proposal import batch_gather
from .mv3dref.ops.voxelize import lidar_to_front_batch, lidar_to_top_batch


# the check's reference computes in f32 (TF32 off) where the program
# computes in bf16: a sound program reads the gap of its own rounding
CHECK_OVERRIDES = {"model": {"compute_dtype": "float32"},
                   "pipeline": {"top_view_dtype": "float32"}}
# the control: the program's own int8 path, the precision below the bf16
# the configuration states
CONTROL_OVERRIDES = {"model": {"quant": "int8"}}
# name suffix -> standard deviation of a head's last layer, as Faster
# R-CNN's heads start (``harness/weights.py``)
HEAD_STD = {".rpn_score.weight": 0.01, ".rpn_delta.weight": 0.01,
            ".score.weight": 0.01, ".box_3.weight": 0.001}


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def config_from_dict(d: Dict[str, Any], like=None) -> Config:
    """The copy's :class:`Config` from a JSON tree (lists become the
    tuples they were; fields left out keep their defaults)."""
    like = Config() if like is None else like
    names = {f.name for f in dataclasses.fields(like)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"unknown config fields {sorted(unknown)}")
    kw = {}
    for name, v in d.items():
        old = getattr(like, name)
        kw[name] = (config_from_dict(v, old) if dataclasses.is_dataclass(old)
                    else _tuples(v) if isinstance(old, tuple) else v)
    return dataclasses.replace(like, **kw)


def network(cfg: Config) -> MV3DNet:
    """The network at ``cfg`` on the CPU, with placeholder weights (its
    ``state_dict`` is the layout the benchmark draws)."""
    return MV3DNet(cfg)


def build(cfg: Config, weights: Dict[str, torch.Tensor], device) -> MV3DNet:
    net = network(cfg)
    net.load_state_dict(weights)
    return net.to(device).eval()


def drive(cfg: Config) -> Tuple[Dict[str, float], Tuple[int, int, int]]:
    """What the traffic's drive is laid out by: the area its scenes fill
    (the top view's grid) and the camera's (H, W, 3) shape."""
    t = cfg.top
    return ({"x_min": t.x_min, "x_max": t.x_max, "y_min": t.y_min,
             "y_max": t.y_max}, cfg.rgb_shape)


def rule(cfg: Config, score_threshold: float) -> Dict[str, Any]:
    """The fields of the check's ``harness/compare.Rule``: the score
    threshold, the final NMS threshold and the top-view grid the final
    NMS rounds boxes to."""
    t = cfg.top
    return {"score_threshold": float(score_threshold),
            "nms_thresh": float(cfg.rcnn.nms_thresh),
            "grid": {"x_min": t.x_min, "y_min": t.y_min, "x_div": t.x_div,
                     "y_div": t.y_div, "xn": t.xn, "yn": t.yn}}


def sizes(cfg: Config, batch: int) -> Dict[str, Any]:
    """The sizes the per-layer readers take from a traced run's record
    (``metrics/voxelize_padded_roofline.py``): the batch, the point
    bucket, the top view's cells and its dtype."""
    t, pipe = cfg.top, cfg.pipeline
    return {"batch": batch, "points": pipe.max_points, "xn": t.xn,
            "yn": t.yn, "zn": t.zn, "top_view_dtype": pipe.top_view_dtype}


def within_budget(points: np.ndarray, max_points: int) -> np.ndarray:
    n = len(points)
    if n <= max_points:
        return points
    return points[np.arange(max_points) * n // max_points]


def _views(net: MV3DNet, frames: Sequence[Tuple[np.ndarray, np.ndarray]],
           batch_size: int):
    """The frames as one batch of ``batch_size`` (padded with empty
    frames) -> the network's top view, its occupancy, the rgb batch and
    the front view (None where the network has no front view)."""
    cfg = net.cfg
    dev = net.anchors.device
    n = cfg.pipeline.max_points
    h, w, c = cfg.rgb_shape
    pts = np.full((batch_size, n, 4), -1e9, np.float32)
    num = np.zeros(batch_size, np.int32)
    rgbs = np.zeros((batch_size, h, w, c), np.float32)
    for i, (p, r) in enumerate(frames):
        p = within_budget(np.asarray(p, np.float32), n)
        pts[i, : p.shape[0]] = p
        num[i] = p.shape[0]
        rgbs[i] = np.asarray(r, np.float32)
    points = torch.from_numpy(pts).to(dev)
    num_t = torch.from_numpy(num).to(dev)
    top, occ = lidar_to_top_batch(points, cfg, num_t, return_occ=True)
    front = (lidar_to_front_batch(points, cfg, num_t)
             if "front" in net.views else None)
    return top, occ, torch.from_numpy(rgbs).to(dev), front


@torch.no_grad()
def detect(net: MV3DNet, frames: Sequence[Tuple[np.ndarray, np.ndarray]],
           batch_size: int, score_threshold: float
           ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The frames as one batch of ``batch_size`` (padded with empty
    frames) -> per frame (boxes3d, probs) of the live detections."""
    top, occ, rgb, front = _views(net, frames, batch_size)
    dets, _ = net.forward_inference(top, rgb, front,
                                    score_threshold=score_threshold,
                                    top_occ=occ)
    boxes = dets.boxes3d.float().cpu().numpy()
    probs = dets.probs.float().cpu().numpy()
    mask = dets.mask.cpu().numpy()
    return [(boxes[i][mask[i]], probs[i][mask[i]])
            for i in range(len(frames))]


@torch.no_grad()
def candidates(net: MV3DNet, frames: Sequence[Tuple[np.ndarray, np.ndarray]],
               batch_size: int, pool: int = 2, chunk: int = 125
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per frame, every box the final NMS could be offered under another
    rounding: the fusion head's decoded box (regularised) and class-1
    probability for each of the ``pool * nms_pre_topn`` best-scored
    proposals of the non-empty anchors, before the proposal layer's
    min-size filter, its cut of logits at -0.5, its ranking cut and its
    NMS, ``chunk`` proposals at a time (the head treats each ROI alone).
    A near-tie at any of those steps that goes the other way changes
    which of these the head sees; a rounding change does not lift a
    proposal from below twice the cut into it."""
    cfg = net.cfg
    r = cfg.rpn
    top, occ, rgb, front = _views(net, frames, batch_size)
    outs = net.extract_features(top, rgb, front)
    rpn = outs["rpn"]
    logits = rpn["scores"].reshape(batch_size, -1, 2)[..., 1]
    props = box_ops.box_transform_inv(
        net.anchors.to(torch.float32)[None],
        rpn["deltas"].reshape(batch_size, -1, 4))
    props = box_ops.clip_boxes(props, *cfg.top.shape[:2][::-1])
    inside = net.anchor_mask(top, occ)
    masked = torch.where(inside, logits.float(), -torch.inf)
    n = min(pool * r.nms_pre_topn, masked.shape[1])
    score, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    score, idx = score[:, :n], idx[:, :n]
    boxes = batch_gather(props, idx)
    out_b, out_p = [], []
    for at in range(0, n, chunk):
        b = boxes[:, at:at + chunk]
        rois3d = box3d_ops.top_box_to_box3d(b, cfg)
        fuse = net.fuse_rois(outs, rois3d, b)
        d = fuse["deltas"][:, :, 1].to(torch.float32)
        out_b.append(box3d_ops.regularise_box3d(
            box3d_ops.box3d_transform_inv(rois3d, d)))
        out_p.append(fuse["probs"][..., 1].to(torch.float32))
    valid = (score > -torch.inf).cpu().numpy()
    b3 = torch.cat(out_b, 1).cpu().numpy()
    p = torch.cat(out_p, 1).cpu().numpy()
    return [(b3[i][valid[i]], p[i][valid[i]]) for i in range(len(frames))]


@torch.no_grad()
def calibrate(net: MV3DNet, frames: Sequence[Tuple[np.ndarray, np.ndarray]],
              batch_size: int) -> Dict[str, torch.Tensor]:
    """Set each BatchNorm's running mean and (biased) variance to those
    of its input over one batch of ``frames``, and return the network's
    weights with them (on the CPU).

    A trained network's statistics describe the data it sees; the flax
    init's identity statistics leave the random trunks' features
    unnormalized, and with them the RPN's raw foreground logits share one
    offset per seed, below the proposal layer's -0.5 cut on some seeds:
    such a network proposes nothing and every answer is empty. In train
    mode each BatchNorm normalizes by its batch's statistics, so one pass
    gives every layer the input it sees in eval mode with the calibrated
    statistics."""
    seen = {}

    def hook(module, inputs, _):
        x = inputs[0].float()
        var, mean = torch.var_mean(x, dim=[0] + list(range(2, x.dim())),
                                   correction=0)
        seen[module] = (mean, var)

    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    handles = [m.register_forward_hook(hook) for m in bns]
    try:
        net.train()
        detect(net, frames, batch_size, 0.0)
    finally:
        net.eval()
        for h in handles:
            h.remove()
    for m, (mean, var) in seen.items():   # the unused front trunk keeps
        m.running_mean.copy_(mean)          # its identity statistics
        m.running_var.copy_(var)
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}


def fused_epilogues():
    """A context in which the reference's bf16 convolutions and dense
    layers return their f32 products (bf16 inputs and weights, f32
    accumulation, no rounding of the output), as a kernel that fuses the
    BatchNorm into the product's epilogue would leave them: the witness
    of a sound change that rounds differently (``readings.py``)."""
    import contextlib

    from .mv3dref.models import backbone

    def unrounded(forward):
        def call(self, x):
            if self.compute_dtype != torch.bfloat16:
                return forward(self, x)
            r = lambda t: None if t is None else t.to(torch.bfloat16).float()
            if isinstance(self, backbone.Linear):
                return torch.nn.functional.linear(r(x), r(self.weight),
                                                  r(self.bias))
            return self._conv_forward(r(x), r(self.weight), r(self.bias))
        return call

    @contextlib.contextmanager
    def ctx():
        kept = backbone.Conv2d.forward, backbone.Linear.forward
        backbone.Conv2d.forward = unrounded(kept[0])
        backbone.Linear.forward = unrounded(kept[1])
        try:
            yield
        finally:
            backbone.Conv2d.forward, backbone.Linear.forward = kept
    return ctx()
