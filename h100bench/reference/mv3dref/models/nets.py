"""The MV3D subnets as ``nn.Module``s.

Port of ``mv3d_tpu/models/nets.py``: ``TopRPN``, ``VggTrunk``,
``RgbFeatureNet`` (resnet or VGG trunk), ``FrontFeatureNet``, each with
its optional bilinear deconv (``upsample_features``), ``_RoiTower``,
``_PredictHead`` and ``FusionHead`` in every mode: default, siamese
context towers, handcraft and learnable late fusion. Public inputs and
outputs keep the JAX layouts: NHWC views and feature maps, (B, A, 2) RPN
scores in NHWC order (grid-major, base-minor, the anchor order). Logits
and probabilities are f32.

``quant="int8"`` reaches every bias-free conv and dense layer but those
the JAX package keeps float: the stems, the first conv of the VGG trunk,
the transposed convs, the biased heads (``rpn_score``, ``rpn_delta``,
``score``, ``box_3``, ``fuse_scores``) and ``fuse_deltas``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config

from .backbone import (Conv2d, ConvBnRelu, DenseBnRelu, Linear, ResnetTiny,
                       Upsample2D, avg_pool_same, max_pool_same)

TOP_VIEW_RPN = "top_view_rpn"
IMAGE_FEATURE = "image_feature"
FRONT_FEATURE = "front_feature"
FUSION = "fusion"
SUBNET_NAMES = (TOP_VIEW_RPN, IMAGE_FEATURE, FRONT_FEATURE, FUSION)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class TopRPN(nn.Module):
    """BEV trunk + RPN score/delta heads; the RCNN feature is the stride-8
    reduced map, or with ``upsample`` its x4 deconv (``rcnn_upsample``,
    stride 2). ``input_prefolded``, ``split_stem`` and ``crop_w`` choose
    the trunk's stem for the folded views (:class:`ResnetTiny`); with
    ``split_stem`` the top view is the (heights, aux) pair."""

    def __init__(self, in_c: int, num_bases: int, s2d_factor: int = 2,
                 repetitions: Sequence[int] = (3, 4),
                 block: str = "bottleneck", upsample: bool = False,
                 input_prefolded: bool = False, split_stem: bool = False,
                 crop_w: int = 0, quant: str = "none"):
        super().__init__()
        self.trunk = ResnetTiny(in_c, s2d_factor, repetitions, block=block,
                                input_prefolded=input_prefolded,
                                split_stem=split_stem, crop_w=crop_w,
                                quant=quant)
        self.reduce = ConvBnRelu(self.trunk.out_channels, 128, 1,
                                 quant=quant)
        self.rpn_conv = ConvBnRelu(128, 128, 3, quant=quant)
        self.rpn_score = Conv2d(128, 2 * num_bases, 1)
        self.rpn_delta = Conv2d(128, 4 * num_bases, 1)
        self.upsample = upsample
        if upsample:
            self.rcnn_upsample = Upsample2D(128, 4)

    def forward(self, top_view) -> Dict[str, torch.Tensor]:
        x = self.reduce(self.trunk(top_view))
        up = self.rpn_conv(x)
        scores = _nhwc(self.rpn_score(up)).to(torch.float32)
        deltas = _nhwc(self.rpn_delta(up)).to(torch.float32)
        b = (top_view[0] if isinstance(top_view, (tuple, list))
             else top_view).shape[0]
        feature = self.rcnn_upsample(x) if self.upsample else x
        return {
            "features": _nhwc(feature),       # (B, H/8, W/8, 128), or H/2
            "scores": scores.reshape(b, -1, 2),         # (B, A, 2)
            "deltas": deltas.reshape(b, -1, 4),         # (B, A, 4)
            "score_map": scores,                        # the RPN heatmap
        }


class VggTrunk(nn.Module):
    """VGG-style stride-8 trunk: conv blocks (32, 32)/pool, (64, 64)/pool,
    (128, 128, 128)/pool, (128, 128, 128), each conv a 3x3 ConvBnRelu and
    each pool a 2x2/2 SAME max-pool (an odd size rounds up). Input NHWC,
    output NCHW. With ``quant`` every conv but the first (which sees the
    raw pixels) is int8."""
    out_channels = 128

    def __init__(self, in_c: int = 3, quant: str = "none"):
        super().__init__()
        self.layers = []
        c = in_c
        for bi, (reps, ch, pool) in enumerate(
                [(2, 32, True), (2, 64, True), (3, 128, True),
                 (3, 128, False)]):
            for j in range(reps):
                name = f"block{bi + 1}_conv{j + 1}"
                q = "none" if (bi == 0 and j == 0) else quant
                self.add_module(name, ConvBnRelu(c, ch, 3, quant=q))
                self.layers.append(name)
                c = ch
            if pool:
                self.layers.append("pool")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for name in self.layers:
            x = (max_pool_same(x, 2, 2) if name == "pool"
                 else getattr(self, name)(x))
        return x


class RgbFeatureNet(nn.Module):
    """RGB trunk (resnet, or ``basenet="vgg"``) -> 1x1/128 (-> with
    ``upsample`` an x2 deconv, ``upsample``), NHWC out."""
    up_factor = 2

    def __init__(self, in_c: int = 3, s2d_factor: int = 4,
                 repetitions: Sequence[int] = (3, 4),
                 block: str = "bottleneck", basenet: str = "resnet",
                 upsample: bool = False, quant: str = "none"):
        super().__init__()
        if basenet == "vgg":
            self.trunk = VggTrunk(in_c, quant=quant)
        elif basenet == "resnet":
            self.trunk = ResnetTiny(in_c, s2d_factor, repetitions,
                                    block=block, quant=quant)
        else:
            raise ValueError(f"rgb_basenet={basenet!r}: expected 'resnet' "
                             f"or 'vgg'")
        self.reduce = ConvBnRelu(self.trunk.out_channels, 128, 1,
                                 quant=quant)
        if upsample:
            self.upsample = Upsample2D(128, self.up_factor)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        x = self.reduce(self.trunk(rgb))
        if hasattr(self, "upsample"):
            x = self.upsample(x)
        return _nhwc(x)


class FrontFeatureNet(RgbFeatureNet):
    """Front trunk: resnet_tiny -> 1x1/128 (-> an x4 deconv), NHWC out."""
    up_factor = 4


class _RoiTower(nn.Module):
    """Per-view ROI tower: 3 residual conv blocks with avg-pool /2,
    6x6 -> 3 -> 2 -> 1."""

    def __init__(self, in_c: int = 128, quant: str = "none"):
        super().__init__()
        c = in_c
        for i, ch in enumerate((128, 256, 512)):
            self.add_module(f"block{i+1}_conv1",
                            ConvBnRelu(c, ch, 3, quant=quant))
            self.add_module(f"block{i+1}_conv2",
                            ConvBnRelu(ch, ch, 3, quant=quant))
            c = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)                  # (R, C, ph, pw)
        for i in range(3):
            h = getattr(self, f"block{i+1}_conv1")(x)
            h = getattr(self, f"block{i+1}_conv2")(h) + h
            x = avg_pool_same(h, 2, 2)
        return x.reshape(x.shape[0], -1)           # (R, 512)


class _PredictHead(nn.Module):
    """Score + 256-256-out corner-delta MLP over a 512-d roi feature;
    ``score`` and ``box_3`` stay float under ``quant``."""

    def __init__(self, num_class: int, in_f: int = 512, out_dim: int = 24,
                 quant: str = "none"):
        super().__init__()
        self.num_class = num_class
        self.score = Linear(in_f, num_class)
        self.box_1 = DenseBnRelu(in_f, 256, quant=quant)
        self.box_2 = DenseBnRelu(256, 256, quant=quant)
        self.box_3 = Linear(256, num_class * out_dim)

    def forward(self, feat: torch.Tensor):
        scores = self.score(feat).to(torch.float32)
        h = self.box_2(self.box_1(feat))
        deltas = self.box_3(h).to(torch.float32)
        return scores, deltas.reshape(-1, self.num_class, 8, 3)


class FusionHead(nn.Module):
    """Multi-view ROI fusion: per-view towers (with ``use_siamese_fusion``
    each view's tower is concatenated with its ``{view}_ctx_tower`` over
    the enlarged rois, ``{view}_ctx`` in the input), the concatenated
    views through ``fc_all_1/2`` (and ``fc_all_3`` with the siamese
    towers) into ``head_with_rgb``, the views but rgb through
    ``fc_wo_rgb_1/2`` (and ``_3``).

    Modes: by default the with-RGB head's scores, probs and deltas also
    stand for the ``_with_rgb`` and ``_without_rgb`` twins (the JAX
    module aliases them), and the ``fc_wo_rgb_*`` layers exist so the
    parameter set matches: no output reads them, so in eval mode the
    forward skips them (XLA drops them as dead code) and in train mode it
    runs them without gradient, as the JAX module does, for their
    BatchNorm statistics. ``use_handcraft_fusion`` adds
    ``head_without_rgb`` and takes, per roi, the more confident head's
    outputs when either head's fg prob passes ``high_score_threshold``
    (the without-RGB head on a tie), else their mean.
    ``use_learnable_fusion`` adds it too and fuses the two heads' scores
    with ``fuse_scores`` (a dense layer) and their deltas with
    ``fuse_deltas`` (dense + BatchNorm + ReLU)."""

    def __init__(self, cfg: Config, views: Sequence[str]):
        super().__init__()
        m = cfg.model
        q = m.quant
        self.num_class = m.num_class
        self.threshold = m.high_score_threshold
        self.siamese = m.use_siamese_fusion
        self.mode = ("handcraft" if m.use_handcraft_fusion
                     else "learnable" if m.use_learnable_fusion
                     else "default")
        self.views = [v for v in ("top", "front", "rgb") if v in views]
        for v in self.views:
            self.add_module(f"{v}_tower", _RoiTower(quant=q))
            if self.siamese:
                self.add_module(f"{v}_ctx_tower", _RoiTower(quant=q))
        per_view = 1024 if self.siamese else 512
        n_wo = per_view * sum(v != "rgb" for v in self.views)
        self.fc_wo_rgb_1 = DenseBnRelu(n_wo, 512, quant=q)
        self.fc_wo_rgb_2 = DenseBnRelu(512, 512, quant=q)
        self.fc_all_1 = DenseBnRelu(per_view * len(self.views), 512,
                                    quant=q)
        self.fc_all_2 = DenseBnRelu(512, 512, quant=q)
        if self.siamese:
            self.fc_wo_rgb_3 = DenseBnRelu(512, 512, quant=q)
            self.fc_all_3 = DenseBnRelu(512, 512, quant=q)
        self.head_with_rgb = _PredictHead(m.num_class, quant=q)
        if self.mode != "default":
            self.head_without_rgb = _PredictHead(m.num_class, quant=q)
        if self.mode == "learnable":
            dim = m.num_class * 24
            self.fuse_scores = Linear(2 * m.num_class, m.num_class)
            self.fuse_deltas = DenseBnRelu(2 * dim, dim)

    def _without_rgb(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        wo = self.fc_wo_rgb_2(self.fc_wo_rgb_1(torch.cat(
            [feats[v] for v in self.views if v != "rgb"], dim=1)))
        return self.fc_wo_rgb_3(wo) if self.siamese else wo

    def forward(self, roi_feats: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        feats = {}
        for v in self.views:
            f = getattr(self, f"{v}_tower")(roi_feats[v])
            if self.siamese:
                f = torch.cat([f, getattr(self, f"{v}_ctx_tower")(
                    roi_feats[v + "_ctx"])], dim=1)
            feats[v] = f
        if self.mode != "default":
            wo = self._without_rgb(feats)
        elif self.training:
            with torch.no_grad():
                self._without_rgb(feats)
        w = self.fc_all_2(self.fc_all_1(torch.cat(
            [feats[v] for v in self.views], dim=1)))
        if self.siamese:
            w = self.fc_all_3(w)
        scores_w, deltas_w = self.head_with_rgb(w)
        probs_w = F.softmax(scores_w, dim=-1)
        if self.mode == "default":
            out = {"scores": scores_w, "probs": probs_w, "deltas": deltas_w}
            # one head: the twin heads' outputs are its own
            return {k + head: v for head in ("", "_with_rgb", "_without_rgb")
                    for k, v in out.items()}
        scores_wo, deltas_wo = self.head_without_rgb(wo)
        probs_wo = F.softmax(scores_wo, dim=-1)
        if self.mode == "handcraft":
            conf = ((probs_w[:, 1] > self.threshold)
                    | (probs_wo[:, 1] > self.threshold))
            pick_w = probs_w[:, 1] > probs_wo[:, 1]

            def fuse(a, b, sel):
                sel = sel.reshape(sel.shape + (1,) * (a.dim() - 1))
                c = conf.reshape(sel.shape)
                return torch.where(c, torch.where(sel, a, b), (a + b) / 2.0)

            probs = fuse(probs_w, probs_wo, pick_w)
            scores = fuse(scores_w, scores_wo, pick_w)
            deltas = fuse(deltas_w, deltas_wo, conf & pick_w)
        else:
            nc = self.num_class
            scores = self.fuse_scores(torch.cat([scores_w, scores_wo],
                                                dim=1)).to(torch.float32)
            probs = F.softmax(scores, dim=-1)
            d = torch.cat([deltas_w.reshape(-1, nc * 24),
                           deltas_wo.reshape(-1, nc * 24)], dim=1)
            deltas = self.fuse_deltas(d).to(torch.float32).reshape(
                -1, nc, 8, 3)
        return {"scores": scores, "probs": probs, "deltas": deltas,
                "scores_with_rgb": scores_w, "probs_with_rgb": probs_w,
                "deltas_with_rgb": deltas_w,
                "scores_without_rgb": scores_wo,
                "probs_without_rgb": probs_wo,
                "deltas_without_rgb": deltas_wo}
