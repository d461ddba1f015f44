"""AVODNet: AVOD's detector (Ku et al., "Joint 3D Proposal Generation and
Object Detection from View Aggregation", IROS 2018, arXiv:1712.02294),
inference, at ``model.arch == "avod"`` (``config.avod_cars_config``).

The network, from AVOD's ``avod_cars_example.config`` and the paper's
section III (settings in ``AvodConfig.avod``):

  * two VGG pyramids, one for the BEV (padded at the far edge to a
    multiple of 8 rows, the padding cut off again at the end) and one for
    the image: encoder blocks of 3 x 3 convs (2 x 32, 2 x 64, 3 x 128,
    3 x 256) with 2 x 2 max-pools between them; a decoder of 3 x 3 stride-2
    transposed convs, each concatenated with its encoder block's map and
    fused by a 3 x 3 conv, back to 32 channels at full resolution. Every
    conv and transposed conv is followed by BatchNorm + ReLU
    (``mv3d::bn_relu`` in eval mode), and has no bias;
  * the RPN: a 1 x 1 BatchNorm + ReLU bottleneck to one channel per view;
    3 x 3 crops (TensorFlow's ``crop_and_resize``) of every anchor's BEV
    footprint and image projection, mean-fused; fc6/fc7 of 256 with ReLU
    and fc8 heads for the objectness (2) and the six axis-aligned anchor
    offsets. The heads run as matrix products over all anchors, the empty
    anchors (no point under their footprint) masked to -inf, so the
    program's shapes are fixed;
  * the proposal NMS (``rpn.nms_thresh`` 0.8, ``rpn.nms_post_topn`` 300
    kept, AVOD's number at inference for cars) over the decoded anchors'
    BEV boxes in metres (``ops.nms.nms_topk``, the ``mv3d::nms_topk``
    kernel);
  * the second stage: 7 x 7 crops of both 32-channel maps over each
    proposal, mean-fused, three FC layers of 2,048 with ReLU, then heads
    for the class (2), the ``box_4c`` offsets (10) and the orientation's
    angle vector (2);
  * the detections (``box_4ca``): each proposal's ``box_4c`` plus its
    offsets, fitted to a box and turned to its angle vector
    (``ops.boxes3d``), then the final NMS of their top-view pixel boxes at
    ``rcnn.nms_thresh`` (0.01, "+1" pixels) keeping ``avod.final_topn``,
    then the score threshold.

Departures from AVOD, each forced or chosen here: the lidar frame with a
flat ground plane where AVOD works in the camera frame with a fitted
plane; the BEV's slice boundaries and the empty-anchor filter are the
port's (a point on a slice boundary counts in the lower slice at height
1; the filter is the integral image of ``ops.anchors``, which leaves out
the map's last row and column); the final NMS is the port's "+1" pixel
rule on the boxes' enveloping top-view pixel boxes, before the score
threshold (AVOD's on normalised BEV boxes); the image is not
mean-subtracted; the box fit centres the box across its width (the
middle of the extent); dropout is left out (inference).

Convolutions run in the compute dtype through cuDNN, channels-last (the
NHWC inputs are permuted, not copied); BatchNorm in f32 with the result
rounded once to the compute dtype. ``model.quant = "int8"`` takes int8
products (``ops.quantized``) in every conv, transposed conv and FC layer
but the heads' last layers. Stages (``utils.profiling.stage``):
``bev_pyramid``, ``img_pyramid``, ``rpn`` (bottlenecks, anchor filter,
crops, heads, decode), ``proposal_nms``, ``second_stage`` and ``detect``;
the voxelizer's ``voxelize`` is the caller's. ``forward_inference`` also
returns the counters ``COUNTERS`` a frame, (B, 2) int32: the non-empty
anchors and the sorted boxes the proposal NMS visited before it kept
``rpn.nms_post_topn``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AvodConfig
from ..ops import boxes3d as box3d_ops
from ..ops.anchors import avod_anchors, non_empty_anchor_mask_structured
from ..ops.detect import Detections
from ..ops.nms import nms_topk
from ..ops.proposal import batch_gather
from ..ops.roi_align import crop_and_resize
from ..utils.profiling import stage
from ..ops.quantized import conv_transpose_as_conv, int8_conv_transpose
from .backbone import (COMPUTE_LAYERS, BatchNorm, ConvBnRelu, Linear,
                       _Quantizable, bn_relu)

BEV_PYRAMID, IMG_PYRAMID, RPN, SECOND_STAGE = (
    "bev_pyramid", "img_pyramid", "rpn", "second_stage")
COUNTERS = ("anchors", "nms_visited")


class ConvTranspose2dTF(_Quantizable, nn.ConvTranspose2d):
    """TensorFlow's ``conv2d_transpose(k, stride=s, padding="SAME")``
    (output s times the input) as ``F.conv_transpose2d`` without padding,
    whose output is (n - 1) s + k: TensorFlow's is its first n s rows and
    columns. Computes in ``compute_dtype``; no bias."""
    compute_dtype = torch.float32

    def __init__(self, in_c: int, out_c: int, kernel: int = 3,
                 stride: int = 2, quant: str = "none"):
        super().__init__(in_c, out_c, kernel, stride, bias=False)
        self.quant = quant

    def int8_layout(self, w):
        return conv_transpose_as_conv(w)

    def forward(self, x):
        dt = self.compute_dtype
        if self.int8():
            return int8_conv_transpose(x, self.weight, self.stride[0], dt,
                                       self.group, self.quantized_weight())
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                                  self.stride)


class UpconvBnRelu(nn.Module):
    """A TensorFlow SAME transposed conv, BatchNorm and ReLU, cut to
    ``stride`` times its input."""

    def __init__(self, in_c: int, out_c: int, stride: int = 2,
                 quant: str = "none"):
        super().__init__()
        self.stride = stride
        self.ConvTranspose_0 = ConvTranspose2dTF(in_c, out_c, 3, stride,
                                                 quant)
        self.BatchNorm_0 = BatchNorm(out_c)

    def forward(self, x):
        dtype = self.ConvTranspose_0.compute_dtype
        h, w = x.shape[2] * self.stride, x.shape[3] * self.stride
        # BatchNorm + ReLU act per element: the cut may follow them
        y = bn_relu(self.BatchNorm_0, self.ConvTranspose_0(x), dtype)
        return y[:, :, :h, :w]


class VggPyramid(nn.Module):
    """AVOD's VGG pyramid: NHWC in, (B, C_out, H, W) channels-last out at
    the input's resolution, C_out the first block's channels. H and W must
    divide by 2 ** (blocks - 1)."""

    def __init__(self, in_c: int, vgg_conv, quant: str = "none"):
        super().__init__()
        self.blocks = [int(n) for n, _ in vgg_conv]
        self.widths = [int(c) for _, c in vgg_conv]
        prev = in_c
        for b, (n, c) in enumerate(zip(self.blocks, self.widths), 1):
            for j in range(1, n + 1):
                setattr(self, f"conv{b}_{j}",
                        ConvBnRelu(prev, c, 3, quant=quant))
                prev = c
        for lvl in range(len(self.widths) - 1, 0, -1):
            up = self.widths[lvl - 1]
            setattr(self, f"upconv{lvl}", UpconvBnRelu(prev, up,
                                                       quant=quant))
            out = self.widths[max(lvl - 2, 0)]
            setattr(self, f"fusion{lvl}", ConvBnRelu(2 * up, out, 3,
                                                     quant=quant))
            prev = out

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        skips = []
        for b, n in enumerate(self.blocks, 1):
            if b > 1:
                x = F.max_pool2d(x, 2, 2)
            for j in range(1, n + 1):
                x = getattr(self, f"conv{b}_{j}")(x)
            skips.append(x)
        for lvl in range(len(self.blocks) - 1, 0, -1):
            up = getattr(self, f"upconv{lvl}")(x)
            x = getattr(self, f"fusion{lvl}")(
                torch.cat([skips[lvl - 1], up], dim=1))
        return x


class AvodRpn(nn.Module):
    """The bottlenecks and the RPN's fc heads (fc6/fc7 with ReLU, fc8;
    ``quant`` reaches all but fc8)."""

    def __init__(self, channels: int, crop: int, fc, quant: str = "none"):
        super().__init__()
        self.bev_bottleneck = ConvBnRelu(channels, 1, 1, quant=quant)
        self.img_bottleneck = ConvBnRelu(channels, 1, 1, quant=quant)
        for head, out in (("cls", 2), ("reg", 6)):
            prev = crop * crop
            for i, width in enumerate(fc):
                layer = Linear(prev, width)
                layer.quant = quant
                setattr(self, f"{head}_fc{6 + i}", layer)
                prev = width
            setattr(self, f"{head}_fc{6 + len(fc)}", Linear(prev, out))
        self.depth = len(fc) + 1

    def heads(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        out = []
        for head in ("cls", "reg"):
            h = x
            for i in range(self.depth):
                h = getattr(self, f"{head}_fc{6 + i}")(h)
                if i < self.depth - 1:
                    h = F.relu(h)
            out.append(h)
        return out[0], out[1]


class AvodSecondStage(nn.Module):
    """Three FC layers with ReLU over the fused crops, then the class,
    ``box_4c`` offset and angle-vector heads (``quant`` reaches the FC
    layers, not the heads)."""

    def __init__(self, in_f: int, fc, num_class: int, quant: str = "none"):
        super().__init__()
        prev = in_f
        self.names = []
        for i, width in enumerate(fc):
            name = f"fc{6 + i}"
            layer = Linear(prev, width)
            layer.quant = quant
            setattr(self, name, layer)
            self.names.append(name)
            prev = width
        self.cls_out = Linear(prev, num_class)
        self.off_out = Linear(prev, 10)
        self.ang_out = Linear(prev, 2)

    def forward(self, x):
        for name in self.names:
            x = F.relu(getattr(self, name)(x))
        return self.cls_out(x), self.off_out(x), self.ang_out(x)


class AVODNet(nn.Module):
    """AVOD at ``cfg`` (``model.arch == "avod"``): the two pyramids, the RPN
    and the second stage, with the static anchors and their crop boxes."""

    counter_names = COUNTERS

    def __init__(self, cfg: AvodConfig):
        super().__init__()
        self.cfg = cfg
        m, a, t = cfg.model, cfg.avod, cfg.top
        if m.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {m.compute_dtype!r}")
        if m.quant not in ("none", "int8"):
            raise ValueError(f"quant {m.quant!r}: expected 'none' or 'int8'")
        if cfg.pipeline.view_layout != "hwc":
            raise ValueError("AVOD reads the BEV in the hwc layout")
        unread = cfg.unread_changed()
        if unread:
            raise ValueError(f"AVOD does not read {unread}: leave them at "
                             f"their defaults")
        self.views = ["top", "rgb"]
        scale = 2 ** (len(a.vgg_conv) - 1)
        h, w, _ = cfg.rgb_shape
        if h % scale or w % scale or t.yn % scale:
            raise ValueError(f"the pyramids need the image and the BEV's "
                             f"columns to divide by {scale}")
        self.bev_pad = -t.xn % scale
        channels = int(a.vgg_conv[0][1])
        self.bev_pyramid = VggPyramid(t.zn + 1, a.vgg_conv, m.quant)
        self.img_pyramid = VggPyramid(3, a.vgg_conv, m.quant)
        self.rpn = AvodRpn(channels, a.rpn_crop, a.rpn_fc, m.quant)
        self.second_stage = AvodSecondStage(
            a.rcnn_crop * a.rcnn_crop * channels, a.rcnn_fc, m.num_class,
            m.quant)

        anchors, bases, stride, grid = avod_anchors(cfg)
        self._bases, self._stride, self._grid = bases, stride, grid
        anchors_t = torch.from_numpy(anchors)
        self.register_buffer("anchors", anchors_t, persistent=False)
        self.register_buffer("anchor_bev", box3d_ops.anchor_bev_norm(
            anchors_t, cfg), persistent=False)
        self.register_buffer("anchor_img", box3d_ops.image_box_norm(
            box3d_ops.anchor_corners(anchors_t), cfg), persistent=False)
        self.register_buffer("anchor_boxes", box3d_ops.anchor_bev_boxes(
            anchors_t), persistent=False)

        dtype = getattr(torch, m.compute_dtype)
        for mod in self.modules():
            if isinstance(mod, COMPUTE_LAYERS + (ConvTranspose2dTF,)):
                mod.compute_dtype = dtype
                if getattr(mod, "quant", "none") == "none":
                    mod.to(dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from a CPU ``generator``: LeCun-normal kernels
        (fan-in of each output), zero biases, identity BatchNorm."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = mod.weight
                fan = (w[0].numel() if not isinstance(mod, nn.ConvTranspose2d)
                       else w.shape[0] * w[0, 0].numel())
                w.copy_(torch.randn(w.shape, generator=generator)
                        * fan ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()

    @property
    def subnets(self) -> Dict[str, nn.Module]:
        return {BEV_PYRAMID: self.bev_pyramid, IMG_PYRAMID: self.img_pyramid,
                RPN: self.rpn, SECOND_STAGE: self.second_stage}

    def anchor_mask(self, counts: torch.Tensor) -> torch.Tensor:
        """(B, Xn, Yn) point counts -> (B, A) non-empty anchors."""
        return non_empty_anchor_mask_structured(
            counts, self._bases, self._stride, self._grid,
            self.cfg.pipeline.remove_empty_thresh)

    def features(self, bev: torch.Tensor, rgb: torch.Tensor):
        """The pyramids' (B, H, W, C) maps of the BEV and the image."""
        with stage("bev_pyramid"):
            x = F.pad(bev, (0, 0, 0, 0, self.bev_pad, 0))
            bev_map = self.bev_pyramid(x)[:, :, self.bev_pad:].contiguous(
                memory_format=torch.channels_last)
        with stage("img_pyramid"):
            img_map = self.img_pyramid(rgb)
        return bev_map.permute(0, 2, 3, 1), img_map.permute(0, 2, 3, 1)

    def _fused_crops(self, bev_map, img_map, bev_boxes, img_boxes, crop):
        """Mean of the two views' crops, flattened (B, R, crop*crop*C) in
        the compute dtype."""
        dt = self.second_stage.cls_out.compute_dtype
        bev = crop_and_resize(bev_map, bev_boxes, crop)
        img = crop_and_resize(img_map, img_boxes, crop)
        fused = (bev + img) / 2
        return fused.reshape(*fused.shape[:2], -1).to(dt)

    def rpn_outputs(self, bev_map, img_map, inside):
        """Objectness (B, A) f32, -inf where ``inside`` is False, and the
        decoded proposals (B, A, 6)."""
        bsz = bev_map.shape[0]
        a = self.cfg.avod
        bev_b = self.rpn.bev_bottleneck(bev_map.permute(0, 3, 1, 2))
        img_b = self.rpn.img_bottleneck(img_map.permute(0, 3, 1, 2))
        n = self.anchors.shape[0]
        fused = self._fused_crops(
            bev_b.permute(0, 2, 3, 1), img_b.permute(0, 2, 3, 1),
            self.anchor_bev.expand(bsz, n, 4),
            self.anchor_img.expand(bsz, n, 4), a.rpn_crop)
        cls, reg = self.rpn.heads(fused)
        score = torch.softmax(cls.float(), dim=-1)[..., 1]
        score = torch.where(inside, score, -torch.inf)
        return score, box3d_ops.anchor_decode(self.anchors, reg.float())

    def second_stage_outputs(self, bev_map, img_map, props):
        """Class logits, ``box_4c`` offsets and angle vectors of (B, R, 6)
        proposals."""
        corners = box3d_ops.anchor_corners(props)
        fused = self._fused_crops(
            bev_map, img_map, box3d_ops.anchor_bev_norm(props, self.cfg),
            box3d_ops.image_box_norm(corners, self.cfg),
            self.cfg.avod.rcnn_crop)
        return self.second_stage(fused)

    def decode(self, props, cls, off, ang):
        """Per proposal the class-1 probability and the (8, 3) box."""
        g = self.cfg.avod.ground_z
        probs = torch.softmax(cls.float(), dim=-1)[..., 1]
        box4c = box3d_ops.anchor_to_box4c(props, g) + off.float()
        box3d = box3d_ops.align_orientation(
            box3d_ops.box4c_to_box3d(box4c, g), ang.float())
        return probs, box3d_ops.box3d_corners(box3d)

    def forward_inference(self, top: torch.Tensor, rgb: torch.Tensor,
                          front: Optional[torch.Tensor] = None,
                          score_threshold: Optional[float] = None,
                          nms_thresh: Optional[float] = None,
                          top_occ: Optional[torch.Tensor] = None
                          ) -> Tuple[Detections, Dict[str, torch.Tensor]]:
        """(B, Xn, Yn, Zn+1) BEV, its (B, Xn, Yn) point counts ``top_occ``
        and the (B, H, W, 3) images -> the detections and
        ``{"proposals" (B, R, 6), "proposal_mask" (B, R), "counters" (B, 2)
        int32}``; ``front`` is unused."""
        cfg = self.cfg
        score_threshold = (cfg.rcnn.score_threshold if score_threshold is None
                           else score_threshold)
        nms_thresh = cfg.rcnn.nms_thresh if nms_thresh is None else nms_thresh
        bev_map, img_map = self.features(top, rgb)
        with stage("rpn"):
            inside = self.anchor_mask(top_occ)
            score, proposals = self.rpn_outputs(bev_map, img_map, inside)
            boxes = box3d_ops.anchor_bev_boxes(proposals)
        with stage("proposal_nms"):
            idx, kept, visited = nms_topk(boxes, score, inside,
                                          cfg.rpn.nms_thresh,
                                          cfg.rpn.nms_post_topn, offset=0.0)
            props = batch_gather(proposals, idx)
        with stage("second_stage"):
            cls, off, ang = self.second_stage_outputs(bev_map, img_map,
                                                      props)
        with stage("detect"):
            probs, corners = self.decode(props, cls, off, ang)
            top_boxes = box3d_ops.box3d_to_top_box(corners, cfg)
            keep, keep_mask, _ = nms_topk(top_boxes, probs, kept, nms_thresh,
                                          cfg.avod.final_topn)
            p = batch_gather(probs, keep)
            thr = torch.tensor(score_threshold, dtype=torch.float32,
                               device=p.device)
            mask = keep_mask & (p > thr)
            dets = Detections(boxes3d=batch_gather(corners, keep),
                              probs=torch.where(mask, p, 0.0), mask=mask)
            counters = torch.stack([inside.sum(1).to(torch.int32), visited],
                                   dim=1)
        return dets, {"proposals": props, "proposal_mask": kept,
                      "counters": counters}
