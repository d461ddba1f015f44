"""MV3DNet — the assembled multi-view detector: inference and training.

Port of ``mv3d_tpu/models/mv3d_net.py``: ``project_to_rgb_roi``,
``enlarge_rois``, ``project_to_front_roi``, ``MV3DNet.__init__``,
``anchor_mask`` (occupancy path), ``extract_features``, ``pool_rois``
(with the siamese context pooling), ``forward_inference``,
``forward_train`` and ``total_loss``. Every per-frame stage the JAX
package ``vmap``s is written batched over the leading dimension.

The four subnets keep the JAX package's names (``top_view_rpn``,
``image_feature``, ``front_feature``, ``fusion``); ``MV3DNet.subnets`` maps
them to modules for :mod:`mv3d_tpu_torch.convert`. Conv and dense layers
compute in ``model.compute_dtype`` and BatchNorm in f32, as the JAX
``dtype`` arguments say. For inference the conv and dense weights are held
in the compute dtype; :meth:`MV3DNet.master_weights_f32` holds them in f32
for training (flax keeps f32 params and casts at each use), and the Adam
moments follow the parameters' dtype.

With ``train.remat`` each trunk that runs in train mode with gradients is
wrapped in ``torch.utils.checkpoint`` (as the JAX package wraps it in
``jax.checkpoint``): its activations are recomputed in the backward pass.
The recompute runs with the BatchNorm running statistics frozen, so they
are updated once a step, and with the random state the forward had.

Trunks a configuration does not use are not run: with ``use_front=False``
(the default) the front view and ``FrontFeatureNet`` are skipped, as XLA
drops them from the JAX program.

The top view comes in any ``pipeline.view_layout``: ``"hwc"``, the
folded ``"s2d2"`` view (the trunk's stem skips ``space_to_depth``) or the
lane-padded ``"s2d2p"`` (heights, aux) pair (the trunk's split stem);
``anchor_mask`` reads the folded occupancy of the folded layouts.

Every dataset preset (``kitti``, ``didi``, ``didi2``) and model option
of the JAX package is ported. With ``quant="int8"`` the eval-mode forward
runs the int8 products of :mod:`mv3d_tpu_torch.ops.quantized`; the int8
layers hold their weights in f32 for inference too, since the JAX package
quantizes its f32 parameters.

With a process ``group`` set on the model and its layers (by
:func:`mv3d_tpu_torch.parallel.mesh.global_batch`), ``forward_train`` is
one rank's share of a data-parallel step: its losses are the rank's
shares of the global losses, which sum over the group's ranks to the
global batch's.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import Config, cfg as _default_cfg

from ..ops import boxes3d as box3d_ops
from ..ops.anchors import (anchor_setup, non_empty_anchor_mask_folded,
                           non_empty_anchor_mask_structured)
from ..ops.detect import Detections, rcnn_nms
from ..ops.proposal import Proposals, rpn_proposals
from ..ops.roi_align import roi_align, roi_align_matmul
from ..ops.voxelize import check_dataset, check_view_layout, f32c
from ..train import losses as loss_lib
from ..train import targets as target_lib
from ..utils.profiling import stage
from .backbone import (COMPUTE_LAYERS, BatchNorm, Conv2d, Linear,
                       Upsample2D)
from .nets import (FRONT_FEATURE, FUSION, IMAGE_FEATURE, SUBNET_NAMES,
                   TOP_VIEW_RPN, FrontFeatureNet, FusionHead, RgbFeatureNet,
                   TopRPN)


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


@contextlib.contextmanager
def _frozen_batch_stats(module: nn.Module):
    """Run ``module``'s BatchNorm layers without updating their running
    statistics (train mode still normalizes with the batch's)."""
    layers = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in layers:
        m.update_stats = False
    try:
        yield
    finally:
        for m in layers:
            m.update_stats = True


class MV3DNet(nn.Module):
    """Owns the four subnet modules and the static anchors."""

    # the data-parallel process group of the losses (see the module doc)
    group = None

    def __init__(self, cfg: Config = _default_cfg):
        super().__init__()
        self.cfg = cfg
        m = cfg.model
        check_dataset(cfg)
        check_view_layout(cfg)
        if m.roi_align_impl not in ("gather", "matmul"):
            raise ValueError(f"roi_align_impl {m.roi_align_impl!r}")
        if m.quant not in ("none", "int8"):
            raise ValueError(f"quant {m.quant!r}: expected 'none' or 'int8'")
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
                if getattr(mod, "quant", "none") == "none":
                    mod.to(dtype)

    def master_weights_f32(self) -> "MV3DNet":
        """Hold the conv and dense weights in f32 (training's master
        weights); they still compute in the compute dtype."""
        for mod in self.modules():
            if isinstance(mod, COMPUTE_LAYERS):
                mod.float()
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from ``generator`` (a CPU generator, so a seed
        gives the same weights on every device): LeCun-normal conv/dense
        kernels and zero biases (flax's defaults, untruncated), identity
        BatchNorm, the deconvs of ``Upsample2D`` bilinear (their flax
        init)."""
        for mod in self.modules():
            if isinstance(mod, Upsample2D):
                mod.init_bilinear()
            elif isinstance(mod, (Conv2d, Linear)):
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

    def _trunk(self, module: nn.Module, x):
        """``module(x)``; rematerialized under ``train.remat`` in train
        mode with gradients (the replay keeps the BatchNorm statistics and
        restores the forward's random state)."""
        if not (self.cfg.train.remat and self.training
                and torch.is_grad_enabled()):
            return module(x)
        return checkpoint(module, x, use_reentrant=False,
                          preserve_rng_state=True,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _frozen_batch_stats(module)))

    def extract_features(self, top, rgb, front) -> Dict[str, torch.Tensor]:
        """Run the trunks of the configured views (in the modules' mode:
        train mode uses and updates batch statistics), each in its stage
        (``utils.profiling.stage``)."""
        with stage("top_trunk"):
            out = {"rpn": self._trunk(self.top_rpn, top)}
        if "rgb" in self.views:
            with stage("rgb_trunk"):
                out["rgb_features"] = self._trunk(self.rgb_net, rgb)
        if "front" in self.views:
            with stage("front_trunk"):
                out["front_features"] = self._trunk(self.front_net, front)
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
        """Batched NHWC views -> final 3D detections and the proposals;
        the trunks, ``proposals``, ``roi_fusion`` and ``detect`` are the
        stages of ``utils.profiling.stage``."""
        cfg = self.cfg
        outs = self.extract_features(top, rgb, front)
        rpn = outs["rpn"]
        with stage("proposals"):
            inside = self.anchor_mask(top, top_occ)
            props = rpn_proposals(rpn["scores"], rpn["deltas"], self.anchors,
                                  inside, cfg, nms_thresh=nms_thresh)
            boxes = props.rois[..., 1:5]
            rois3d = box3d_ops.top_box_to_box3d(boxes, cfg)
        with stage("roi_fusion"):
            fuse = self.fuse_rois(outs, rois3d, boxes)
        with stage("detect"):
            dets = rcnn_nms(fuse["probs"], fuse["deltas"], rois3d,
                            props.mask, score_threshold=score_threshold,
                            cfg=cfg)
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

    # -- training ----------------------------------------------------------

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Dict[str, torch.Tensor], train: bool = True
                      ) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """Batched training forward: views + gt -> (loss dict, aux).

        ``batch``: top (B, H, W, C), rgb, front (with ``use_front``),
        optional top_occ (B, H, W) from the voxelizer, gt_boxes3d
        (B, G, 8, 3), gt_labels (B, G), gt_mask (B, G) bool. ``noise``: the
        step's uniform draws (:func:`mv3d_tpu_torch.train.targets.draw_noise`).

        With ``train`` every subnet runs in train mode: BatchNorm uses the
        batch statistics and updates its running statistics in place, in
        every subnet that runs, trained or frozen (the JAX step returns the
        same updates from its ``aux["updates"]``). Nothing is detached: the
        fusion losses reach the RPN's deltas through the sampled rois.

        With the model's process ``group`` (every rank holding as many
        frames) the losses are this rank's shares of the group's
        global-batch losses: the per-frame RPN losses summed over the
        rank's frames over the global frame count, the fusion losses'
        masked sums over the global counts.
        """
        cfg = self.cfg
        group = self.group
        self.train(train)
        top, rgb = batch["top"], batch["rgb"]
        gt3d, gt_labels = batch["gt_boxes3d"], batch["gt_labels"]
        gt_mask = batch["gt_mask"]

        outs = self.extract_features(top, rgb, batch.get("front"))
        rpn = outs["rpn"]
        gt_top = box3d_ops.box3d_to_top_box(gt3d, cfg)
        inside = self.anchor_mask(top, batch.get("top_occ"))
        rpn_tg = target_lib.rpn_target(self.anchors, inside, gt_top,
                                       gt_labels, gt_mask, noise["rpn_pos"],
                                       noise["rpn_neg"], cfg)
        props = rpn_proposals(rpn["scores"], rpn["deltas"], self.anchors,
                              inside, cfg)
        fus_tg = target_lib.fusion_target(props.rois, props.mask, gt_top,
                                          gt3d, gt_labels, gt_mask,
                                          noise["fus_fg"], noise["fus_fp"],
                                          cfg)

        feats = {"top": rpn["features"]}
        if "rgb_features" in outs:
            feats["rgb"] = outs["rgb_features"]
        if "front_features" in outs:
            feats["front"] = outs["front_features"]
        pooled = self.pool_rois(feats, fus_tg.rois3d, fus_tg.rois[..., 1:5])
        b, r = fus_tg.rois.shape[:2]
        fuse = self.fusion({k: v.reshape((b * r,) + v.shape[2:])
                            for k, v in pooled.items()})

        top_cls, top_reg = loss_lib.rpn_loss(rpn["scores"], rpn["deltas"],
                                             rpn_tg)
        flat_tg = target_lib.FusionTargets(
            *(x.reshape((b * r,) + x.shape[2:]) for x in fus_tg))
        fuse_cls, fuse_reg = loss_lib.fuse_loss(fuse["scores"],
                                                fuse["deltas"], flat_tg,
                                                group)
        if group is not None:
            frames = b * torch.distributed.get_world_size(group)
            top_cls, top_reg = top_cls.sum() / frames, top_reg.sum() / frames
        loss_dict = {"top_cls_loss": top_cls.mean(),
                     "top_reg_loss": top_reg.mean(),
                     "fuse_cls_loss": fuse_cls, "fuse_reg_loss": fuse_reg}
        aux = {"rpn_targets": rpn_tg, "fusion_targets": fus_tg,
               "proposals_scores": rpn["scores"]}
        return loss_dict, aux


def total_loss(loss_dict: Dict[str, torch.Tensor], train_targets,
               cfg: Config) -> torch.Tensor:
    """Per-stage loss mix: RPN losses for the RPN stage, the weighted sum
    of all four for the full net, the fusion losses otherwise."""
    names = set(train_targets)
    if names == {TOP_VIEW_RPN}:
        return loss_dict["top_cls_loss"] + loss_dict["top_reg_loss"]
    if names == set(SUBNET_NAMES):
        w1, w2, w3, w4, w5 = cfg.train.loss_weights
        return (w1 * (w2 * loss_dict["top_cls_loss"] +
                      w3 * loss_dict["top_reg_loss"]) +
                w4 * loss_dict["fuse_cls_loss"] +
                w5 * loss_dict["fuse_reg_loss"])
    return loss_dict["fuse_cls_loss"] + loss_dict["fuse_reg_loss"]
