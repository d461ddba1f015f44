"""Backbone building blocks as ``nn.Module``s (NCHW inside).

Port of ``mv3d_tpu/models/backbone.py``: ``ConvBnRelu``, ``DenseBnRelu``,
the bilinear ``Upsample2D`` deconv, the pre-activation ``Bottleneck`` and
``BasicBlock``, ``space_to_depth`` and ``ResnetTiny`` with the 7x7/2 stem
(``s2d_factor=0``), the space-to-depth stems (``s2d_factor`` 2 and 4),
the prefolded stem of the ``s2d2`` view and the split stem of the
``s2d2p`` pair.

Submodule names are flax's auto-names (``Conv_0``, ``BatchNorm_1``,
``Bottleneck_3`` ...), so a flax variable path maps onto a ``state_dict``
key one to one (:mod:`mv3d_tpu_torch.convert`).

Numerics follow the JAX modules: a conv or dense layer computes in its
``compute_dtype`` (bf16 on the card; see ``MV3DNet.__init__``) whatever
the dtype its weights are held in (the compute dtype for inference, f32
master weights for training: flax's ``dtype`` over f32 params), BatchNorm
runs in f32, and the ReLU output is cast back to the compute dtype.
:class:`BatchNorm` has flax's training semantics (see its note). Flax's
``"SAME"`` padding is reproduced exactly: a stride-1 conv with an odd
kernel or a 1x1 conv pads symmetrically; a strided conv with a larger
kernel (the 7x7/2 stem, a basic block's 3x3/2) and the max-pools pad
(lo, hi) = (total//2, total - total//2) at run time, which is (2, 3) for
a 7x7/2 conv and (0, 1) for a 3x3/2 conv on an even size (zeros for the
convs, -inf for the pools). The transposed conv of ``Upsample2D`` is
``lax.conv_transpose`` with ``transpose_kernel=False``: a correlation of
the stride-dilated input with the kernel as given, which
``F.conv_transpose2d`` computes with the kernel flipped
(:class:`ConvTranspose2d`).

``quant="int8"`` (``ConvBnRelu``, ``DenseBnRelu``, the blocks and
``ResnetTiny``) gives the bias-free convs and dense layers the int8
forward of :mod:`mv3d_tpu_torch.ops.quantized` in eval mode; train mode
runs the float program. The stems, in every variant, and the transposed
convs stay float, as in the JAX modules. The parameters are the float
layers', so one ``state_dict`` serves both.

A layer's ``group`` (a ``torch.distributed`` process group, set by
:mod:`mv3d_tpu_torch.parallel.mesh` for a sharded step) makes a batch
reduction global over the group's ranks: the int8 activation scale of a
conv or dense layer, and the train-mode statistics of a
:class:`BatchNorm`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quantized import int8_conv, int8_dense, quantize_weight


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


class _Quantizable:
    """``quant="int8"``: the eval-mode forward takes int8 products (set on
    bias-free layers only); ``group``: the process group over which the
    int8 activation scale is global.

    The int8 weight and its scales are quantized once and kept while the
    weight stays the same tensor at the same version: an optimizer step,
    a load or a move to another device quantizes it again, and so does
    the first eval call after train mode (``eval()`` keeps them)."""
    quant = "none"
    group = None
    _qweight = None

    def int8(self) -> bool:
        return self.quant == "int8" and not self.training

    def quantized_weight(self):
        """``quantize_weight(self.weight)``, cached (see the class)."""
        w = self.weight
        if w.is_inference():     # no version counter to watch
            return quantize_weight(w)
        kept = self._qweight
        if (kept is None or kept[0].data_ptr() != w.data_ptr()
                or kept[1] != w._version):
            # the detached view keeps the weight's storage, so its address
            # cannot be reused while the entry stands
            self._qweight = kept = (w.detach(), w._version,
                                    quantize_weight(w))
        return kept[2]

    def train(self, mode: bool = True):
        if mode:
            self._qweight = None
        return super().train(mode)


class Conv2d(_Quantizable, nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype``: input, weight and
    bias are cast to it at each call (a no-op for weights already held in
    it). Its padding is symmetric."""
    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if self.int8():
            return int8_conv(x, self.weight, self.stride[0],
                             (self.padding[1],) * 2 + (self.padding[0],) * 2,
                             dt, self.group, self.quantized_weight())
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Flax's ``nn.ConvTranspose(features, (k, k), strides=(f, f),
    padding="SAME")`` on NCHW, computing in ``compute_dtype``.

    The weight is torch's (in, out, k, k) layout holding flax's
    (k, k, in, out) kernel flipped in both spatial dims
    (:mod:`mv3d_tpu_torch.convert` maps it), since ``F.conv_transpose2d``
    correlates with the flipped kernel. Flax's SAME padding of the
    dilated input, (k + f - 2) split with ``ceil`` to the front (or k - 1
    when f > k - 1), is symmetric for the bilinear sizes k = 2f - f%2, and
    equals ``padding = k - 1 - lo``: outputs are f times the input."""
    compute_dtype = torch.float32

    def __init__(self, in_c: int, out_c: int, kernel: int, stride: int):
        total = kernel + stride - 2
        lo = kernel - 1 if stride > kernel - 1 else -(-total // 2)
        if 2 * lo != total:
            raise ValueError(f"{kernel}x{kernel}/{stride} transposed conv: "
                             f"flax's SAME padding is not symmetric")
        super().__init__(in_c, out_c, kernel, stride,
                         padding=kernel - 1 - lo, bias=True)

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), self.stride,
                                  self.padding)


class Linear(_Quantizable, nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` (as
    :class:`Conv2d`)."""
    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if self.int8():
            return int8_dense(x, self.weight, dt, self.group,
                              self.quantized_weight())
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
    ``num_batches_tracked`` stays 0: flax keeps no such count.

    With a process ``group`` the train-mode statistics are those of the
    batch of every rank of the group, as under JAX's sharded ``jit``: the
    sums and the count, then the squared deviations from the global mean
    are all-reduced by differentiable calls, and the running statistics
    move with the global mean and biased variance. (Two passes, as the
    one-process path computes them: the one-pass E[x^2] - E[x]^2 of flax
    loses digits where a channel's mean is large against its spread,
    enough to move the fusion head's gradients off the one-process
    step's. ``nn.SyncBatchNorm`` keeps torch's momentum and the unbiased
    running variance.)"""

    # False while a rematerialized forward is replayed in the backward
    # pass (``MV3DNet`` with ``train.remat``): the statistics are updated
    # once a step, by the first forward, as JAX's pure recompute does
    update_stats = True
    group = None

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected (N, C, ...) input, got {x.dim()}-D")

    def _global_stats(self, x, dims, shape):
        """(mean, biased var) over ``dims`` of the group's whole batch, in
        two passes (two all-reduces): the mean, then the squared
        deviations from it."""
        from torch.distributed.nn.functional import all_reduce
        c = x.shape[1]
        sums = all_reduce(torch.cat([x.sum(dims),
                                     x.new_full((1,), x.numel() // c)]),
                          group=self.group)
        mean = sums[:c] / sums[c]
        d = x - mean.reshape(shape)
        var = all_reduce((d * d).sum(dims), group=self.group) / sums[c]
        return mean, var

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        if self.group is None:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True,
                             0.0, self.eps)
            if not self.update_stats:
                return y
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=dims, correction=0)
        else:
            shape = (1, -1) + (1,) * (x.dim() - 2)
            mean, var = self._global_stats(x, dims, shape)
            y = ((x - mean.reshape(shape))
                 * torch.rsqrt(var.reshape(shape) + self.eps)
                 * self.weight.reshape(shape) + self.bias.reshape(shape))
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.copy_(self.running_mean * 0.9
                                        + mean.detach() * 0.1)
                self.running_var.copy_(self.running_var * 0.9
                                       + var.detach() * 0.1)
        return y


class StridedConv2d(Conv2d):
    """A strided conv with a kernel above 1x1, padded as flax "SAME" pads
    it: (lo, hi) zeros per spatial dim from the input's size."""

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        ph = same_pads(x.shape[2], k, s)
        pw = same_pads(x.shape[3], k, s)
        pads = (pw[0], pw[1], ph[0], ph[1])
        if self.int8():
            return int8_conv(x, self.weight, s, pads, self.compute_dtype,
                             self.group, self.quantized_weight())
        return super().forward(F.pad(x, pads))


def conv(in_c: int, out_c: int, kernel: int = 1, stride: int = 1,
         bias: bool = False, quant: str = "none") -> Conv2d:
    """A conv with flax's "SAME" padding: symmetric for stride 1 with an
    odd kernel or any 1x1, from the input's size otherwise. ``quant``
    ("none" or "int8") applies to bias-free convs."""
    if quant != "none" and (quant != "int8" or bias):
        raise ValueError(f"quant={quant!r}: expected 'none', or 'int8' on "
                         f"a bias-free conv")
    if stride != 1 and kernel != 1:
        layer = StridedConv2d(in_c, out_c, kernel, stride, bias=bias)
    else:
        layer = Conv2d(in_c, out_c, kernel, stride, padding=kernel // 2,
                       bias=bias)
    layer.quant = quant
    return layer


# the layers that compute in the model's compute dtype
COMPUTE_LAYERS = (Conv2d, ConvTranspose2d, Linear)


def bn_relu(bn: nn.Module, x: torch.Tensor, dtype: torch.dtype):
    """f32 BatchNorm + ReLU, cast back to the compute dtype."""
    return F.relu(bn(x.to(torch.float32))).to(dtype)


class ConvBnRelu(nn.Module):
    def __init__(self, in_c: int, out_c: int, kernel: int = 3,
                 stride: int = 1, quant: str = "none"):
        super().__init__()
        self.Conv_0 = conv(in_c, out_c, kernel, stride, quant=quant)
        self.BatchNorm_0 = BatchNorm(out_c)

    def forward(self, x):
        dtype = self.Conv_0.compute_dtype
        return bn_relu(self.BatchNorm_0, self.Conv_0(x.to(dtype)), dtype)


class DenseBnRelu(nn.Module):
    def __init__(self, in_f: int, out_f: int, quant: str = "none"):
        super().__init__()
        self.Dense_0 = Linear(in_f, out_f, bias=False)
        self.Dense_0.quant = quant
        self.BatchNorm_0 = BatchNorm(out_f)

    def forward(self, x):
        dtype = self.Dense_0.compute_dtype
        return bn_relu(self.BatchNorm_0, self.Dense_0(x.to(dtype)), dtype)


def bilinear_kernel(factor: int) -> torch.Tensor:
    """The bilinear-interpolation (k, k) filter of flax's
    ``bilinear_kernel_init``, k = 2f - f%2."""
    size = 2 * factor - factor % 2
    center = (size - 1) / 2.0 if size % 2 == 1 else factor - 0.5
    og = torch.arange(size, dtype=torch.float64)
    filt = 1 - (og - center).abs() / factor
    return (filt[:, None] * filt[None, :]).to(torch.float32)


class Upsample2D(nn.Module):
    """Trainable x``factor`` deconv upsampling, bilinear at
    initialization (:meth:`init_bilinear`)."""

    def __init__(self, channels: int, factor: int):
        super().__init__()
        self.factor = factor
        self.ConvTranspose_0 = ConvTranspose2d(
            channels, channels, 2 * factor - factor % 2, factor)

    @torch.no_grad()
    def init_bilinear(self) -> None:
        """Flax's init: the bilinear filter on each channel's diagonal
        (symmetric, so its flip is itself), zero bias."""
        w = self.ConvTranspose_0.weight
        w.zero_()
        filt = bilinear_kernel(self.factor)
        for c in range(min(w.shape[0], w.shape[1])):
            w[c, c] = filt
        self.ConvTranspose_0.bias.zero_()

    def forward(self, x):
        return self.ConvTranspose_0(x)


class Bottleneck(nn.Module):
    """Pre-activation bottleneck block (He et al. 1603.05027)."""

    def __init__(self, in_c: int, filters: int, stride: int = 1,
                 plain_entry: bool = False, quant: str = "none"):
        super().__init__()
        out_c = filters * 4
        self.plain_entry = plain_entry
        bns = [in_c] if not plain_entry else []
        bns += [filters, filters]
        for i, c in enumerate(bns):
            self.add_module(f"BatchNorm_{i}", BatchNorm(c))
        self.Conv_0 = conv(in_c, filters, 1, stride, quant=quant)
        self.Conv_1 = conv(filters, filters, 3, quant=quant)
        self.Conv_2 = conv(filters, out_c, 1, quant=quant)
        self.has_shortcut = in_c != out_c or stride != 1
        if self.has_shortcut:
            self.Conv_3 = conv(in_c, out_c, 1, stride, quant=quant)

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


class BasicBlock(nn.Module):
    """Pre-activation basic block (two 3x3 convs, no expansion); the
    projection shortcut is ``Conv_2``."""

    def __init__(self, in_c: int, filters: int, stride: int = 1,
                 plain_entry: bool = False, quant: str = "none"):
        super().__init__()
        self.plain_entry = plain_entry
        bns = [in_c] if not plain_entry else []
        bns += [filters]
        for i, c in enumerate(bns):
            self.add_module(f"BatchNorm_{i}", BatchNorm(c))
        self.Conv_0 = conv(in_c, filters, 3, stride, quant=quant)
        self.Conv_1 = conv(filters, filters, 3, quant=quant)
        self.has_shortcut = in_c != filters or stride != 1
        if self.has_shortcut:
            self.Conv_2 = conv(in_c, filters, 1, stride, quant=quant)

    def forward(self, x):
        dtype = self.Conv_0.compute_dtype
        x = x.to(dtype)
        bn = iter([getattr(self, f"BatchNorm_{i}")
                   for i in range(1 if self.plain_entry else 2)])
        h = x if self.plain_entry else bn_relu(next(bn), x, dtype)
        h = bn_relu(next(bn), self.Conv_0(h), dtype)
        h = self.Conv_1(h)
        shortcut = self.Conv_2(x) if self.has_shortcut else x
        return h + shortcut


BLOCKS = {"bottleneck": (Bottleneck, 4), "basic": (BasicBlock, 1)}


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
    """Stride-8 tiny pre-activation ResNet. The stem: factor 0 is a 7x7/2
    conv + 3x3/2 max-pool, factor 2 s2d/2 + 3x3 conv + 3x3/2 max-pool,
    factor 4 s2d/4 + 3x3 conv. ``block`` is ``"bottleneck"`` or
    ``"basic"``. Input NHWC, output NCHW with ``base_filters *
    2**(len(reps)-1)`` channels, times 4 for bottlenecks.

    ``input_prefolded`` (factor 2): the input is already the folded
    ``s2d2`` view, so the stem skips ``space_to_depth``. ``split_stem``
    (factor 2): the input is the ``s2d2p`` (heights (B, H2, W2P, 128),
    aux (B, H2, W2P, 8)) pair; the stem is a 3x3 conv over each
    (``stem_h``, ``stem_aux``), summed, cropped to ``crop_w`` columns
    before its BatchNorm (``stem_bn``), then ReLU and the max-pool. That
    equals one conv over the concatenated channels of the unpadded view:
    the pad lanes and columns are zeros, as SAME padding is at the true
    edge. ``quant`` applies to the blocks' convs; the stem stays float."""

    def __init__(self, in_c: int, s2d_factor: int,
                 repetitions: Sequence[int] = (3, 4),
                 base_filters: int = 64, block: str = "bottleneck",
                 input_prefolded: bool = False, split_stem: bool = False,
                 crop_w: int = 0, quant: str = "none"):
        super().__init__()
        if s2d_factor not in (0, 2, 4):
            raise ValueError(f"unsupported s2d_factor {s2d_factor}")
        if block not in BLOCKS:
            raise ValueError(f"backbone_block={block!r}: expected one of "
                             f"{tuple(BLOCKS)}")
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
        elif s2d_factor == 0:
            self.ConvBnRelu_0 = ConvBnRelu(in_c, base_filters, 7, 2)
        else:
            self.ConvBnRelu_0 = ConvBnRelu(in_c * s2d_factor ** 2,
                                           base_filters)
        block_cls, expansion = BLOCKS[block]
        self.blocks = []
        filters, c = base_filters, base_filters
        for i, reps in enumerate(repetitions):
            for j in range(reps):
                stride = 2 if (j == 0 and i != 0) else 1
                name = f"{block_cls.__name__}_{len(self.blocks)}"
                self.add_module(name, block_cls(
                    c, filters, stride, plain_entry=(i == 0 and j == 0),
                    quant=quant))
                self.blocks.append(name)
                c = filters * expansion
            filters *= 2
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
            if self.s2d_factor and not self.input_prefolded:
                x = space_to_depth(x, self.s2d_factor)
            x = self.ConvBnRelu_0(x.permute(0, 3, 1, 2))
            if self.s2d_factor != 4:
                x = max_pool_same(x, 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x
