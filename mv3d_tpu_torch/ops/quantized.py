"""int8 products of the serving forward (``model.quant="int8"``).

Port of ``mv3d_tpu/ops/quantized.py``: dynamic symmetric post-training
quantization, no calibration pass.

  * weights: per-output-channel int8, ``s_w[oc] = max(amax|W[oc]|, 1e-12)
    / 127``, ``W_q = round(W / s_w)``, quantized from the float weights,
    so every checkpoint serves float and int8 alike;
  * activations: per-tensor int8, ``s_x = max(amax|x|, 1e-12) / 127`` over
    the whole tensor, batch included. Under a data-parallel mesh the amax
    is all-reduced with MAX over ``group``, so each scale is the global
    batch's, as it is under JAX's sharded ``jit``;
  * products: int8 x int8 -> int32 by ``torch._int_mm`` (the counterpart
    of the JAX package's stock XLA ``dot_general`` / ``conv_general_dilated``
    with ``preferred_element_type=int32``; no Pallas kernel there either),
    dequantized as ``acc.float() * (s_x * s_w)``, then cast to the compute
    dtype. The conv is an im2col of the zero-padded int8 input (a quantized
    zero is a zero) into one int32 product.

Weights are in torch's layout, the output channel first: (out, in) for a
dense layer, (out, in, kh, kw) for a conv, where the JAX functions take
flax's (in, out) and HWIO. Divisions by the constant 127 divide by a
device tensor: CUDA divides by a Python scalar as a reciprocal multiply.

On CUDA ``torch._int_mm`` takes more than 16 rows and K and N multiples
of 8 only; :func:`int_mm` zero-pads to those limits on every device (zero
rows and columns add nothing to the sums) and crops the result.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

QMAX = 127.0


def _qmax(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(QMAX, dtype=torch.float32, device=like.device)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, ...) float weight -> (int8 weight, f32 (out,) scale)."""
    wf = w.detach().to(torch.float32)
    amax = wf.abs().amax(dim=tuple(range(1, wf.dim())))
    s = torch.clamp(amax, min=1e-12) / _qmax(wf)
    q = torch.clamp(torch.round(wf / s.reshape((-1,) + (1,) * (wf.dim() - 1))),
                    -QMAX, QMAX)
    return q.to(torch.int8), s


def quantize_activation(x: torch.Tensor, group=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float activation -> (int8, f32 0-dim scale), per tensor; with a
    process ``group`` the amax is the MAX over its ranks."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax()
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    s = torch.clamp(amax, min=1e-12) / _qmax(xf)
    q = torch.clamp(torch.round(xf / s), -QMAX, QMAX)
    return q.to(torch.int8), s


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K).T int8 -> (M, N) int32 by ``torch._int_mm``,
    zero-padded to M > 16 and K, N multiples of 8 (the CUDA limits)."""
    m, k = a.shape
    n = b_t.shape[0]
    pm, pk, pn = max(17 - m, 0), (-k) % 8, (-n) % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b_t = F.pad(b_t, (0, pk, 0, pn))
    return torch._int_mm(a.contiguous(), b_t.contiguous().t())[:m, :n]


def _dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    return (acc.to(torch.float32) * (sx * sw)).to(out_dtype)


def int8_dense(x: torch.Tensor, w: torch.Tensor,
               out_dtype: torch.dtype = torch.bfloat16, group=None,
               qw=None) -> torch.Tensor:
    """``x @ w.T`` with both operands quantized to int8: x (..., K) float,
    w (N, K) float; ``qw``, if given, is ``quantize_weight(w)``."""
    xq, sx = quantize_activation(x, group)
    wq, sw = quantize_weight(w) if qw is None else qw
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    return _dequantize(acc, sx, sw, out_dtype).reshape(
        x.shape[:-1] + (wq.shape[0],))


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              padding: Tuple[int, int, int, int] = (0, 0, 0, 0),
              out_dtype: torch.dtype = torch.bfloat16, group=None,
              qw=None) -> torch.Tensor:
    """NCHW conv with int8 operands and int32 sums: x (B, Cin, H, W)
    float, w (Cout, Cin, kh, kw) float, ``padding`` (left, right, top,
    bottom) zeros as ``F.pad`` takes them; ``qw``, if given, is
    ``quantize_weight(w)``. Returns (B, Cout, Ho, Wo) in ``out_dtype``."""
    xq, sx = quantize_activation(x, group)
    wq, sw = quantize_weight(w) if qw is None else qw
    cout, cin, kh, kw = wq.shape
    xq = F.pad(xq, padding).permute(0, 2, 3, 1)          # (B, Hp, Wp, Cin)
    b, hp, wp, _ = xq.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    cols = torch.stack(
        [xq[:, i:i + stride * (ho - 1) + 1:stride,
            j:j + stride * (wo - 1) + 1:stride] for i in range(kh)
         for j in range(kw)], dim=3)                      # (B, Ho, Wo, k, C)
    acc = int_mm(cols.reshape(b * ho * wo, kh * kw * cin),
                 wq.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin))
    return _dequantize(acc, sx, sw, out_dtype).reshape(
        b, ho, wo, cout).permute(0, 3, 1, 2)


def conv_transpose_as_conv(w: torch.Tensor) -> torch.Tensor:
    """A transposed conv's (in, out, k, k) weight as the (out, in, k, k)
    weight of the conv over the zero-dilated input that computes it."""
    return w.flip(2, 3).transpose(0, 1)


def int8_conv_transpose(x: torch.Tensor, w: torch.Tensor, stride: int,
                        out_dtype: torch.dtype = torch.bfloat16, group=None,
                        qw=None) -> torch.Tensor:
    """``F.conv_transpose2d(x, w, stride=stride)`` (no padding) with int8
    operands: x (B, Cin, H, W) float, dilated by ``stride`` with zeros
    (which leaves its int8 scale as it was), then :func:`int8_conv` with
    the flipped kernel over k - 1 zeros a side; w (Cin, Cout, k, k) float;
    ``qw``, if given, is ``quantize_weight(conv_transpose_as_conv(w))``.
    Returns (B, Cout, (H - 1) s + k, (W - 1) s + k) in ``out_dtype``."""
    if qw is None:
        qw = quantize_weight(conv_transpose_as_conv(w))
    b, c, h, wd = x.shape
    k = w.shape[-1]
    xd = x.new_zeros(b, c, (h - 1) * stride + 1, (wd - 1) * stride + 1)
    xd[:, :, ::stride, ::stride] = x
    return int8_conv(xd, qw[0], 1, (k - 1,) * 4, out_dtype, group, qw)
