"""The MV3D subnets as ``nn.Module``s.

Port of ``mv3d_tpu/models/nets.py``: ``TopRPN``, ``RgbFeatureNet`` (resnet
trunk), ``FrontFeatureNet``, ``_RoiTower``, ``_PredictHead`` and
``FusionHead`` in its default mode. Public inputs and outputs keep the JAX
layouts: NHWC views and feature maps, (B, A, 2) RPN scores in NHWC order
(grid-major, base-minor, the anchor order). Logits and probabilities are
f32.

Not ported (``NotImplementedError``): ``upsample_features``,
``rgb_basenet="vgg"`` (ROADMAP A3), and the siamese, handcraft and
learnable fusion modes (ROADMAP A4).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config

from .backbone import (Conv2d, ConvBnRelu, DenseBnRelu, Linear, ResnetTiny,
                       avg_pool_same)

TOP_VIEW_RPN = "top_view_rpn"
IMAGE_FEATURE = "image_feature"
FRONT_FEATURE = "front_feature"
FUSION = "fusion"
SUBNET_NAMES = (TOP_VIEW_RPN, IMAGE_FEATURE, FRONT_FEATURE, FUSION)


def _check_upsample(upsample: bool) -> None:
    if upsample:
        raise NotImplementedError(
            "upsample_features: the bilinear deconv is not ported "
            "(ROADMAP A3)")


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class TopRPN(nn.Module):
    """BEV trunk + RPN score/delta heads; the RCNN feature is the stride-8
    reduced map. ``input_prefolded``, ``split_stem`` and ``crop_w`` choose
    the trunk's stem for the folded views (:class:`ResnetTiny`); with
    ``split_stem`` the top view is the (heights, aux) pair."""

    def __init__(self, in_c: int, num_bases: int, s2d_factor: int = 2,
                 repetitions: Sequence[int] = (3, 4),
                 block: str = "bottleneck", upsample: bool = False,
                 input_prefolded: bool = False, split_stem: bool = False,
                 crop_w: int = 0):
        super().__init__()
        _check_upsample(upsample)
        self.trunk = ResnetTiny(in_c, s2d_factor, repetitions, block=block,
                                input_prefolded=input_prefolded,
                                split_stem=split_stem, crop_w=crop_w)
        self.reduce = ConvBnRelu(self.trunk.out_channels, 128, 1)
        self.rpn_conv = ConvBnRelu(128, 128, 3)
        self.rpn_score = Conv2d(128, 2 * num_bases, 1)
        self.rpn_delta = Conv2d(128, 4 * num_bases, 1)

    def forward(self, top_view) -> Dict[str, torch.Tensor]:
        x = self.reduce(self.trunk(top_view))
        up = self.rpn_conv(x)
        scores = _nhwc(self.rpn_score(up)).to(torch.float32)
        deltas = _nhwc(self.rpn_delta(up)).to(torch.float32)
        b = (top_view[0] if isinstance(top_view, (tuple, list))
             else top_view).shape[0]
        return {
            "features": _nhwc(x),                       # (B, H/8, W/8, 128)
            "scores": scores.reshape(b, -1, 2),         # (B, A, 2)
            "deltas": deltas.reshape(b, -1, 4),         # (B, A, 4)
            "score_map": scores,                        # the RPN heatmap
        }


class RgbFeatureNet(nn.Module):
    """RGB trunk (resnet) -> 1x1/128, NHWC out."""

    def __init__(self, in_c: int = 3, s2d_factor: int = 4,
                 repetitions: Sequence[int] = (3, 4),
                 block: str = "bottleneck", basenet: str = "resnet",
                 upsample: bool = False):
        super().__init__()
        _check_upsample(upsample)
        if basenet != "resnet":
            raise NotImplementedError(
                f"rgb_basenet={basenet!r}: only 'resnet' is ported "
                f"(ROADMAP A3)")
        self.trunk = ResnetTiny(in_c, s2d_factor, repetitions, block=block)
        self.reduce = ConvBnRelu(self.trunk.out_channels, 128, 1)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.reduce(self.trunk(rgb)))


class FrontFeatureNet(RgbFeatureNet):
    """Front trunk: resnet_tiny -> 1x1/128, NHWC out."""


class _RoiTower(nn.Module):
    """Per-view ROI tower: 3 residual conv blocks with avg-pool /2,
    6x6 -> 3 -> 2 -> 1."""

    def __init__(self, in_c: int = 128):
        super().__init__()
        c = in_c
        for i, ch in enumerate((128, 256, 512)):
            self.add_module(f"block{i+1}_conv1", ConvBnRelu(c, ch, 3))
            self.add_module(f"block{i+1}_conv2", ConvBnRelu(ch, ch, 3))
            c = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)                  # (R, C, ph, pw)
        for i in range(3):
            h = getattr(self, f"block{i+1}_conv1")(x)
            h = getattr(self, f"block{i+1}_conv2")(h) + h
            x = avg_pool_same(h, 2, 2)
        return x.reshape(x.shape[0], -1)           # (R, 512)


class _PredictHead(nn.Module):
    """Score + 256-256-out corner-delta MLP over a 512-d roi feature."""

    def __init__(self, num_class: int, in_f: int = 512, out_dim: int = 24):
        super().__init__()
        self.num_class = num_class
        self.score = Linear(in_f, num_class)
        self.box_1 = DenseBnRelu(in_f, 256)
        self.box_2 = DenseBnRelu(256, 256)
        self.box_3 = Linear(256, num_class * out_dim)

    def forward(self, feat: torch.Tensor):
        scores = self.score(feat).to(torch.float32)
        h = self.box_2(self.box_1(feat))
        deltas = self.box_3(h).to(torch.float32)
        return scores, deltas.reshape(-1, self.num_class, 8, 3)


class FusionHead(nn.Module):
    """Multi-view ROI fusion, default mode: per-view towers, concat, two
    DenseBnRelu layers and the with-RGB head, whose scores, probs and
    deltas also stand for the ``_with_rgb`` and ``_without_rgb`` twins (as
    the JAX module aliases them in this mode).

    The ``fc_wo_rgb_*`` layers exist so the parameter set matches the JAX
    module. No output of the default mode reads them: in eval mode the
    forward skips them (XLA drops them as dead code); in train mode it runs
    them without gradient, as the JAX module does, for their BatchNorm
    statistics."""

    def __init__(self, cfg: Config, views: Sequence[str]):
        super().__init__()
        m = cfg.model
        for opt in ("use_siamese_fusion", "use_handcraft_fusion",
                    "use_learnable_fusion"):
            if getattr(m, opt):
                raise NotImplementedError(
                    f"model.{opt}: only the default fusion mode is ported "
                    f"(ROADMAP A4)")
        self.views = [v for v in ("top", "front", "rgb") if v in views]
        for v in self.views:
            self.add_module(f"{v}_tower", _RoiTower())
        n_wo = 512 * sum(v != "rgb" for v in self.views)
        self.fc_wo_rgb_1 = DenseBnRelu(n_wo, 512)
        self.fc_wo_rgb_2 = DenseBnRelu(512, 512)
        self.fc_all_1 = DenseBnRelu(512 * len(self.views), 512)
        self.fc_all_2 = DenseBnRelu(512, 512)
        self.head_with_rgb = _PredictHead(m.num_class)

    def forward(self, roi_feats: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        feats = [getattr(self, f"{v}_tower")(roi_feats[v])
                 for v in self.views]
        if self.training:
            with torch.no_grad():
                self.fc_wo_rgb_2(self.fc_wo_rgb_1(torch.cat(
                    [f for v, f in zip(self.views, feats) if v != "rgb"],
                    dim=1)))
        w = self.fc_all_2(self.fc_all_1(torch.cat(feats, dim=1)))
        scores, deltas = self.head_with_rgb(w)
        out = {"scores": scores, "probs": F.softmax(scores, dim=-1),
               "deltas": deltas}
        # one head in the default mode: the twin heads' outputs are its own
        return {k + head: v for head in ("", "_with_rgb", "_without_rgb")
                for k, v in out.items()}
