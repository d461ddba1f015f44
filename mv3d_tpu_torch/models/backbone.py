"""Backbone building blocks as ``nn.Module``s (NCHW inside).

Port of ``mv3d_tpu/models/backbone.py``: ``ConvBnRelu``, ``DenseBnRelu``,
the pre-activation ``Bottleneck``, ``space_to_depth`` and ``ResnetTiny``
with the space-to-depth stems (``s2d_factor`` 2 and 4), the prefolded
stem of the ``s2d2`` view and the split stem of the ``s2d2p`` pair.

Submodule names are flax's auto-names (``Conv_0``, ``BatchNorm_1``,
``Bottleneck_3`` ...), so a flax variable path maps onto a ``state_dict``
key one to one (:mod:`mv3d_tpu_torch.convert`).

Numerics follow the JAX modules: a conv or dense layer computes in its
``compute_dtype`` (bf16 on the card; see ``MV3DNet.__init__``) whatever
the dtype its weights are held in (the compute dtype for inference, f32
master weights for training: flax's ``dtype`` over f32 params), BatchNorm
runs in f32, and the ReLU output is cast back to the compute dtype.
:class:`BatchNorm` has flax's training semantics (see its note). Flax's
``"SAME"`` padding is reproduced exactly: convs here are stride 1 with
odd kernels or 1x1 (symmetric), and the 3x3/2 max-pool pads (lo, hi) =
(total//2, total - total//2) with -inf.

Not ported (``NotImplementedError``): the 7x7/2 stem (``s2d_factor=0``),
``backbone_block="basic"`` and the bilinear ``Upsample2D`` deconv
(``upsample_features``) — ROADMAP A3.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, kernel: int, stride: int):
    """Flax/XLA "SAME" (lo, hi) padding for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor, kernel: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), padding="SAME")`` on NCHW."""
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def avg_pool_same(x: torch.Tensor, kernel: int = 2,
                  stride: int = 2) -> torch.Tensor:
    """``nn.avg_pool(x, (k, k), (s, s), padding="SAME")`` on NCHW: zero pad
    counted in the divisor (flax ``count_include_pad=True``)."""
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.avg_pool2d(x, kernel, stride)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype``: input, weight and
    bias are cast to it at each call (a no-op for weights already held in
    it)."""
    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` (as
    :class:`Conv2d`)."""
    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over dim 1 of an (N, C, ...) input, with flax's
    ``nn.BatchNorm(momentum=0.9)`` semantics.

    Eval mode normalizes with the running statistics. Train mode
    normalizes with the batch mean and the *biased* batch variance and
    updates ``running <- 0.9 * running + 0.1 * batch``, also with the
    biased variance. (``nn.BatchNorm2d`` would update ``running_var`` with
    the unbiased variance, and its ``momentum`` is flax's ``1 - momentum``.)
    ``num_batches_tracked`` stays 0: flax keeps no such count."""

    # False while a rematerialized forward is replayed in the backward
    # pass (``MV3DNet`` with ``train.remat``): the statistics are updated
    # once a step, by the first forward, as JAX's pure recompute does
    update_stats = True

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected (N, C, ...) input, got {x.dim()}-D")

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        if not self.update_stats:
            return y
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            self.running_mean.copy_(self.running_mean * 0.9 + mean * 0.1)
            self.running_var.copy_(self.running_var * 0.9 + var * 0.1)
        return y


def conv(in_c: int, out_c: int, kernel: int = 1, stride: int = 1,
         bias: bool = False) -> Conv2d:
    """A conv whose symmetric padding equals flax "SAME" (stride 1 with an
    odd kernel, or any 1x1)."""
    if stride != 1 and kernel != 1:
        raise NotImplementedError(
            f"{kernel}x{kernel}/{stride} conv: only stride-1 or 1x1 convs "
            f"are ported (ROADMAP A3)")
    return Conv2d(in_c, out_c, kernel, stride, padding=kernel // 2,
                  bias=bias)


def bn_relu(bn: nn.Module, x: torch.Tensor, dtype: torch.dtype):
    """f32 BatchNorm + ReLU, cast back to the compute dtype."""
    return F.relu(bn(x.to(torch.float32))).to(dtype)


class ConvBnRelu(nn.Module):
    def __init__(self, in_c: int, out_c: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.Conv_0 = conv(in_c, out_c, kernel, stride)
        self.BatchNorm_0 = BatchNorm(out_c)

    def forward(self, x):
        dtype = self.Conv_0.compute_dtype
        return bn_relu(self.BatchNorm_0, self.Conv_0(x.to(dtype)), dtype)


class DenseBnRelu(nn.Module):
    def __init__(self, in_f: int, out_f: int):
        super().__init__()
        self.Dense_0 = Linear(in_f, out_f, bias=False)
        self.BatchNorm_0 = BatchNorm(out_f)

    def forward(self, x):
        dtype = self.Dense_0.compute_dtype
        return bn_relu(self.BatchNorm_0, self.Dense_0(x.to(dtype)), dtype)


class Bottleneck(nn.Module):
    """Pre-activation bottleneck block (He et al. 1603.05027)."""

    def __init__(self, in_c: int, filters: int, stride: int = 1,
                 plain_entry: bool = False):
        super().__init__()
        out_c = filters * 4
        self.plain_entry = plain_entry
        bns = [in_c] if not plain_entry else []
        bns += [filters, filters]
        for i, c in enumerate(bns):
            self.add_module(f"BatchNorm_{i}", BatchNorm(c))
        self.Conv_0 = conv(in_c, filters, 1, stride)
        self.Conv_1 = conv(filters, filters, 3)
        self.Conv_2 = conv(filters, out_c, 1)
        self.has_shortcut = in_c != out_c or stride != 1
        if self.has_shortcut:
            self.Conv_3 = conv(in_c, out_c, 1, stride)

    def forward(self, x):
        dtype = self.Conv_0.compute_dtype
        x = x.to(dtype)
        bn = iter([getattr(self, f"BatchNorm_{i}")
                   for i in range(2 if self.plain_entry else 3)])
        h = x if self.plain_entry else bn_relu(next(bn), x, dtype)
        h = bn_relu(next(bn), self.Conv_0(h), dtype)
        h = bn_relu(next(bn), self.Conv_1(h), dtype)
        h = self.Conv_2(h)
        shortcut = self.Conv_3(x) if self.has_shortcut else x
        return h + shortcut


def space_to_depth(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/f, W/f, C*f*f), channel ``(dy*f + dx)*C + c``;
    trailing rows/cols are zero-padded to a multiple of ``factor``."""
    b, h, w, c = x.shape
    ph, pw = (-h) % factor, (-w) % factor
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        h, w = h + ph, w + pw
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // factor, w // factor, factor * factor * c)


class ResnetTiny(nn.Module):
    """Stride-8 tiny bottleneck ResNet with a space-to-depth stem: factor 2
    is s2d/2 + 3x3 conv + 3x3/2 max-pool, factor 4 is s2d/4 + 3x3 conv.
    Input NHWC, output NCHW with ``base_filters * 2**(len(reps)-1) * 4``
    channels.

    ``input_prefolded`` (factor 2): the input is already the folded
    ``s2d2`` view, so the stem skips ``space_to_depth``. ``split_stem``
    (factor 2): the input is the ``s2d2p`` (heights (B, H2, W2P, 128),
    aux (B, H2, W2P, 8)) pair; the stem is a 3x3 conv over each
    (``stem_h``, ``stem_aux``), summed, cropped to ``crop_w`` columns
    before its BatchNorm (``stem_bn``), then ReLU and the max-pool. That
    equals one conv over the concatenated channels of the unpadded view:
    the pad lanes and columns are zeros, as SAME padding is at the true
    edge."""

    def __init__(self, in_c: int, s2d_factor: int,
                 repetitions: Sequence[int] = (3, 4),
                 base_filters: int = 64, block: str = "bottleneck",
                 input_prefolded: bool = False, split_stem: bool = False,
                 crop_w: int = 0):
        super().__init__()
        if s2d_factor not in (2, 4):
            raise NotImplementedError(
                f"s2d_factor={s2d_factor}: only the space-to-depth stems "
                f"(2, 4) are ported; the 7x7/2 stem is ROADMAP A3")
        if block != "bottleneck":
            raise NotImplementedError(
                f"backbone_block={block!r}: only 'bottleneck' is ported "
                f"(ROADMAP A3)")
        if (input_prefolded or split_stem) and s2d_factor != 2:
            raise ValueError("the folded stems need s2d_factor=2")
        self.s2d_factor = s2d_factor
        self.input_prefolded = input_prefolded
        self.split_stem = split_stem
        self.crop_w = crop_w
        if split_stem:
            # lanes: 4 sub-cells x zn heights, zero-padded to 128; aux: 4
            # intensities + 4 densities
            self.stem_h = conv(128, base_filters, 3)
            self.stem_aux = conv(8, base_filters, 3)
            self.stem_bn = BatchNorm(base_filters)
        else:
            self.ConvBnRelu_0 = ConvBnRelu(in_c * s2d_factor ** 2,
                                           base_filters)
        filters, c, k = base_filters, base_filters, 0
        for i, reps in enumerate(repetitions):
            for j in range(reps):
                stride = 2 if (j == 0 and i != 0) else 1
                self.add_module(f"Bottleneck_{k}", Bottleneck(
                    c, filters, stride, plain_entry=(i == 0 and j == 0)))
                c, k = filters * 4, k + 1
            filters *= 2
        self.n_blocks = k
        self.out_channels = c

    def _split_stem(self, x):
        heights, aux = x
        dtype = self.stem_h.compute_dtype
        h = (self.stem_h(heights.permute(0, 3, 1, 2))
             + self.stem_aux(aux.permute(0, 3, 1, 2)))
        if self.crop_w:
            h = h[..., :self.crop_w]
        return max_pool_same(bn_relu(self.stem_bn, h, dtype), 3, 2)

    def forward(self, x):
        if self.split_stem:
            x = self._split_stem(x)
        else:
            if not self.input_prefolded:
                x = space_to_depth(x, self.s2d_factor)
            x = self.ConvBnRelu_0(x.permute(0, 3, 1, 2))
            if self.s2d_factor == 2:
                x = max_pool_same(x, 3, 2)
        for k in range(self.n_blocks):
            x = getattr(self, f"Bottleneck_{k}")(x)
        return x
