"""MV3DNet — the assembled multi-view detector, inference only.

Port of ``mv3d_tpu/models/mv3d_net.py``: ``project_to_rgb_roi``,
``enlarge_rois``, ``project_to_front_roi``, ``MV3DNet.__init__``,
``anchor_mask`` (occupancy path), ``extract_features``, ``pool_rois``
(with the siamese context pooling) and ``forward_inference``. Every
per-frame stage the JAX package ``vmap``s is written batched over the
leading dimension. Conv and dense layers compute in
``model.compute_dtype`` and BatchNorm in f32, as the JAX ``dtype``
arguments say; the conv and dense weights are held in the compute dtype.

Trunks a configuration does not use are not run: with ``use_front=False``
(the default) the front view and ``FrontFeatureNet`` are skipped, as XLA
drops them from the JAX program; their weights are kept, so that the
network's ``state_dict`` is the program's.

The top view comes in any ``pipeline.view_layout``: ``"hwc"``, the
folded ``"s2d2"`` view (the trunk's stem skips ``space_to_depth``) or the
lane-padded ``"s2d2p"`` (heights, aux) pair (the trunk's split stem);
``anchor_mask`` reads the folded occupancy of the folded layouts. The
training step and the int8 path are not copied: no cell runs them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config, cfg as _default_cfg

from ..ops import boxes3d as box3d_ops
from ..ops.anchors import (anchor_setup, non_empty_anchor_mask_folded,
                           non_empty_anchor_mask_structured)
from ..ops.detect import Detections, rcnn_nms
from ..ops.proposal import Proposals, rpn_proposals
from ..ops.roi_align import roi_align, roi_align_matmul
from ..ops.voxelize import check_dataset, check_view_layout, f32c
from .backbone import COMPUTE_LAYERS
from .nets import FrontFeatureNet, FusionHead, RgbFeatureNet, TopRPN


def project_to_rgb_roi(rois3d: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., 8, 3) -> (..., 4) enveloping image-space boxes."""
    proj = box3d_ops.box3d_to_rgb_box(rois3d, cfg).to(torch.float32)
    return torch.stack([proj[..., 0].amin(-1), proj[..., 1].amin(-1),
                        proj[..., 0].amax(-1), proj[..., 1].amax(-1)],
                       dim=-1)


def enlarge_rois(rois: torch.Tensor, ratio: float) -> torch.Tensor:
    """Scale (..., 4) boxes about their centers by ``ratio``."""
    cx = (rois[..., 0] + rois[..., 2]) / 2.0
    cy = (rois[..., 1] + rois[..., 3]) / 2.0
    w = (rois[..., 2] - rois[..., 0]) * ratio
    h = (rois[..., 3] - rois[..., 1]) * ratio
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def project_to_front_roi(rois3d: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., 8, 3) -> (..., 4) front-view boxes as (r1, c1, r2, c2), with
    the voxelizer's own pixel mapping."""
    f = cfg.front
    x, y, z = rois3d[..., 0], rois3d[..., 1], rois3d[..., 2]
    c = torch.trunc(torch.atan2(y, x) / f32c(f.angular_res, x)) + f.c_offset
    r = torch.trunc(torch.atan2(z, torch.sqrt(x ** 2 + y ** 2))
                    / f32c(f.vertical_res, x)) + f.r_offset
    return torch.stack([r.amin(-1), c.amin(-1), r.amax(-1), c.amax(-1)],
                       dim=-1).to(torch.float32)

class MV3DNet(nn.Module):
    """Owns the four subnet modules and the static anchors."""

    def __init__(self, cfg: Config = _default_cfg):
        super().__init__()
        self.cfg = cfg
        m = cfg.model
        check_dataset(cfg)
        check_view_layout(cfg)
        if m.roi_align_impl not in ("gather", "matmul"):
            raise ValueError(f"roi_align_impl {m.roi_align_impl!r}")
        if m.quant != "none":
            raise ValueError(f"quant {m.quant!r}: the reference has no int8 "
                             f"path")
        if m.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {m.compute_dtype!r}")
        s2d_top = 2 if m.stem_space_to_depth else 0
        s2d_rgb = 4 if m.stem_space_to_depth else 0
        t = cfg.top
        layout = cfg.pipeline.view_layout
        folded = layout in ("s2d2", "s2d2p")
        if folded and not (s2d_top == 2 and t.xn % 2 == 0
                           and t.yn % 2 == 0):
            raise ValueError("folded view layouts require "
                             "stem_space_to_depth and even grid dims")
        padded = layout == "s2d2p"
        if padded and 4 * t.zn > 128:
            raise ValueError("view_layout=s2d2p requires 4*zn <= 128 "
                             "heights lanes")
        reps = tuple(m.backbone_repetitions)
        if m.rpn_stride != 4 * 2 ** (len(reps) - 1):
            raise ValueError(f"backbone_repetitions {reps} imply stride "
                             f"{4 * 2 ** (len(reps) - 1)}, not "
                             f"model.rpn_stride={m.rpn_stride}")

        self.views = ["top"]
        if m.use_front and not m.use_top_only:
            self.views.append("front")
        if not m.use_top_only:
            self.views.append("rgb")

        kw = dict(repetitions=reps, block=m.backbone_block,
                  upsample=m.upsample_features, quant=m.quant)
        self.top_rpn = TopRPN(t.channels, len(m.bases), s2d_factor=s2d_top,
                              input_prefolded=folded, split_stem=padded,
                              crop_w=t.yn // 2 if padded else 0, **kw)
        self.rgb_net = RgbFeatureNet(3, s2d_factor=s2d_rgb,
                                     basenet=m.rgb_basenet, **kw)
        self.front_net = FrontFeatureNet(3, s2d_factor=s2d_top, **kw)
        self.fusion = FusionHead(cfg, self.views)

        anchors_np, _ = anchor_setup(cfg)
        self.register_buffer("anchors", torch.from_numpy(anchors_np),
                             persistent=False)
        self._bases_np = np.asarray(m.bases)
        self._feat_shape = cfg.top_feature_shape()

        dtype = getattr(torch, m.compute_dtype)
        for mod in self.modules():
            if isinstance(mod, COMPUTE_LAYERS):
                mod.compute_dtype = dtype
                mod.to(dtype)

    def anchor_mask(self, top, occ: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """(B, A) empty-anchor filter. ``occ`` is the voxelizer's
        ``return_occ`` output: (B, Xn, Yn), or folded (B, Xn/2, W, 4) for
        the folded layouts. Without it the view's channel sum is used: per
        sub-cell lane-group sums for the ``s2d2p`` pair and the ``s2d2``
        view, which are the folded occupancy."""
        t = self.cfg.top
        zn = t.zn
        if occ is None and isinstance(top, (tuple, list)):
            heights, aux = (x.to(torch.float32) for x in top)
            h4 = torch.stack([heights[..., s * zn:(s + 1) * zn].sum(-1)
                              for s in range(4)], dim=-1)
            occ = h4 + aux[..., :4] + aux[..., 4:]
        elif occ is None and tuple(top.shape[1:3]) == (t.xn // 2,
                                                       t.yn // 2):
            v = top.to(torch.float32)
            h4 = v[..., :4 * zn].reshape(*v.shape[:3], 4, zn).sum(-1)
            occ = h4 + v[..., 4 * zn:4 * zn + 4] + v[..., 4 * zn + 4:]
        elif occ is None:
            occ = top.to(torch.float32).sum(-1)
        args = (self._bases_np, self.cfg.model.rpn_stride, self._feat_shape,
                self.cfg.pipeline.remove_empty_thresh)
        if occ.dim() == 4:
            return non_empty_anchor_mask_folded(occ, *args,
                                                full_hw=(t.xn, t.yn))
        return non_empty_anchor_mask_structured(occ, *args)

    def extract_features(self, top, rgb, front) -> Dict[str, torch.Tensor]:
        """Run the trunks of the configured views (in the modules' mode:
        train mode uses and updates batch statistics)."""
        out = {"rpn": self.top_rpn(top)}
        if "rgb" in self.views:
            out["rgb_features"] = self.rgb_net(rgb)
        if "front" in self.views:
            out["front_features"] = self.front_net(front)
        return out

    def pool_rois(self, feats: Dict[str, torch.Tensor], rois3d: torch.Tensor,
                  top_rois: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Batched multi-view ROI align; with ``use_siamese_fusion`` also
        each view's ``{view}_ctx`` pooling over the rois enlarged by
        ``roi_enlarge_ratio``.

        Args:
          feats: view name -> (B, H, W, C) feature map.
          rois3d: (B, R, 8, 3) lifted rois.
          top_rois: (B, R, 4) top-view boxes (x1, y1, x2, y2).
        """
        m = self.cfg.model
        align = roi_align_matmul if m.roi_align_impl == "matmul" \
            else roi_align
        rois = {"top": top_rois}
        if "rgb" in self.views:
            rois["rgb"] = project_to_rgb_roi(rois3d, self.cfg)
        if "front" in self.views:
            rois["front"] = project_to_front_roi(rois3d, self.cfg)
        if m.use_siamese_fusion:
            # the context branch pools the same maps over enlarged rois
            rois.update({name + "_ctx": enlarge_rois(r, m.roi_enlarge_ratio)
                         for name, r in list(rois.items())})
        return {name: align(feats[name.removesuffix("_ctx")], r,
                            1.0 / m.pool_stride(name.removesuffix("_ctx")),
                            m.roi_pool_size)
                for name, r in rois.items()}

    def forward_inference(self, top: torch.Tensor, rgb: torch.Tensor,
                          front: Optional[torch.Tensor],
                          score_threshold: Optional[float] = None,
                          nms_thresh: Optional[float] = None,
                          top_occ: Optional[torch.Tensor] = None
                          ) -> Tuple[Detections, Proposals]:
        """Batched NHWC views -> final 3D detections and the proposals."""
        cfg = self.cfg
        outs = self.extract_features(top, rgb, front)
        rpn = outs["rpn"]
        inside = self.anchor_mask(top, top_occ)
        props = rpn_proposals(rpn["scores"], rpn["deltas"], self.anchors,
                              inside, cfg, nms_thresh=nms_thresh)
        boxes = props.rois[..., 1:5]
        rois3d = box3d_ops.top_box_to_box3d(boxes, cfg)
        fuse = self.fuse_rois(outs, rois3d, boxes)
        dets = rcnn_nms(fuse["probs"], fuse["deltas"], rois3d, props.mask,
                        score_threshold=score_threshold, cfg=cfg)
        return dets, props

    def fuse_rois(self, outs: Dict[str, torch.Tensor], rois3d: torch.Tensor,
                  top_rois: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The fusion head on (B, R) rois: ``outs`` is
        :meth:`extract_features`' output, ``rois3d`` (B, R, 8, 3) and
        ``top_rois`` (B, R, 4) the rois in 3D and on the top view.
        Returns the head's outputs as (B, R, ...)."""
        feats = {"top": outs["rpn"]["features"]}
        if "rgb_features" in outs:
            feats["rgb"] = outs["rgb_features"]
        if "front_features" in outs:
            feats["front"] = outs["front_features"]
        pooled = self.pool_rois(feats, rois3d, top_rois)
        b, r = rois3d.shape[:2]
        fuse = self.fusion({k: v.reshape((b * r,) + v.shape[2:])
                            for k, v in pooled.items()})
        return {k: v.reshape((b, r) + v.shape[1:]) for k, v in fuse.items()}
