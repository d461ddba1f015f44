"""MV3DNet — the assembled multi-view detector, inference path.

Port of ``mv3d_tpu/models/mv3d_net.py``: ``project_to_rgb_roi``,
``project_to_front_roi``, ``MV3DNet.__init__``, ``anchor_mask`` (occupancy
path), ``extract_features`` (inference), ``pool_rois`` and
``forward_inference``. Every per-frame stage the JAX package ``vmap``s is
written batched over the leading dimension.

The four subnets keep the JAX package's names (``top_view_rpn``,
``image_feature``, ``front_feature``, ``fusion``); ``MV3DNet.subnets`` maps
them to modules for :mod:`mv3d_tpu_torch.convert`. With
``model.compute_dtype="bfloat16"`` the conv and dense weights are held in
bf16 and BatchNorm stays f32, as the JAX ``dtype`` arguments say.

Trunks a configuration does not use are not run: with ``use_front=False``
(the default) the front view and ``FrontFeatureNet`` are skipped, as XLA
drops them from the JAX program.

Not ported (``NotImplementedError``): ``roi_align_impl="matmul"`` and
``quant="int8"`` (ROADMAP A4 / A9), plus the options the modules below
reject.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mv3d_tpu.config import Config, cfg as _default_cfg

from ..ops import boxes3d as box3d_ops
from ..ops.anchors import anchor_setup, non_empty_anchor_mask_structured
from ..ops.detect import Detections, rcnn_nms
from ..ops.proposal import Proposals, rpn_proposals
from ..ops.roi_align import roi_align
from ..ops.voxelize import check_dataset, check_view_layout, f32c
from .nets import (FRONT_FEATURE, FUSION, IMAGE_FEATURE, TOP_VIEW_RPN,
                   FrontFeatureNet, FusionHead, RgbFeatureNet, TopRPN)


def project_to_rgb_roi(rois3d: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(..., 8, 3) -> (..., 4) enveloping image-space boxes."""
    proj = box3d_ops.box3d_to_rgb_box(rois3d, cfg).to(torch.float32)
    return torch.stack([proj[..., 0].amin(-1), proj[..., 1].amin(-1),
                        proj[..., 0].amax(-1), proj[..., 1].amax(-1)],
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
        if m.roi_align_impl != "gather":
            raise NotImplementedError(
                f"roi_align_impl={m.roi_align_impl!r}: only the gather "
                f"ROI-align is ported (ROADMAP A4, roi_align_matmul)")
        if m.quant != "none":
            raise NotImplementedError(
                f"quant={m.quant!r}: int8 serving is not ported "
                f"(ROADMAP A9)")
        if m.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {m.compute_dtype!r}")
        s2d_top = 2 if m.stem_space_to_depth else 0
        s2d_rgb = 4 if m.stem_space_to_depth else 0
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
                  upsample=m.upsample_features)
        self.top_rpn = TopRPN(cfg.top.channels, len(m.bases),
                              s2d_factor=s2d_top, **kw)
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
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                mod.to(dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (a CPU generator, so a seed
        gives the same weights on every device): LeCun-normal conv/dense
        kernels and zero biases (flax's defaults, untruncated), identity
        BatchNorm."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = mod.weight
                std = w[0].numel() ** -0.5
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()

    @property
    def subnets(self) -> Dict[str, nn.Module]:
        return {TOP_VIEW_RPN: self.top_rpn, IMAGE_FEATURE: self.rgb_net,
                FRONT_FEATURE: self.front_net, FUSION: self.fusion}

    def anchor_mask(self, top: torch.Tensor,
                    occ: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, A) empty-anchor filter. ``occ`` is the voxelizer's
        ``return_occ`` output; without it the view's channel sum is used."""
        if occ is None:
            occ = top.to(torch.float32).sum(-1)
        return non_empty_anchor_mask_structured(
            occ, self._bases_np, self.cfg.model.rpn_stride,
            self._feat_shape, self.cfg.pipeline.remove_empty_thresh)

    def extract_features(self, top, rgb, front) -> Dict[str, torch.Tensor]:
        """Run the trunks of the configured views (inference)."""
        out = {"rpn": self.top_rpn(top)}
        if "rgb" in self.views:
            out["rgb_features"] = self.rgb_net(rgb)
        if "front" in self.views:
            out["front_features"] = self.front_net(front)
        return out

    def pool_rois(self, feats: Dict[str, torch.Tensor], rois3d: torch.Tensor,
                  top_rois: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Batched multi-view ROI align.

        Args:
          feats: view name -> (B, H, W, C) feature map.
          rois3d: (B, R, 8, 3) lifted rois.
          top_rois: (B, R, 4) top-view boxes (x1, y1, x2, y2).
        """
        m = self.cfg.model
        rois = {"top": top_rois}
        if "rgb" in self.views:
            rois["rgb"] = project_to_rgb_roi(rois3d, self.cfg)
        if "front" in self.views:
            rois["front"] = project_to_front_roi(rois3d, self.cfg)
        return {name: roi_align(feats[name], r, 1.0 / m.pool_stride(name),
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
        feats = {"top": rpn["features"]}
        if "rgb_features" in outs:
            feats["rgb"] = outs["rgb_features"]
        if "front_features" in outs:
            feats["front"] = outs["front_features"]
        pooled = self.pool_rois(feats, rois3d, boxes)

        b, r = props.rois.shape[:2]
        flat = {k: v.reshape((b * r,) + v.shape[2:])
                for k, v in pooled.items()}
        fuse = self.fusion(flat)
        probs = fuse["probs"].reshape(b, r, -1)
        deltas = fuse["deltas"].reshape(b, r, cfg.model.num_class, 8, 3)
        dets = rcnn_nms(probs, deltas, rois3d, props.mask,
                        score_threshold=score_threshold, cfg=cfg)
        return dets, props
