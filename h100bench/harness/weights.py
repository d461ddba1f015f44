"""The model's weights, drawn from the seed on the device.

The layout (each ``state_dict`` entry's name, shape and dtype) is the
reference network's; the program's network holds the same entries, and
both load the same tensors. The rule is the flax default the port
initializes with: conv and dense kernels LeCun-normal (standard
deviation ``fan_in ** -0.5``, ``fan_in`` the kernel's size per output
channel, untruncated), biases zero, BatchNorm the identity (scale 1,
shift 0, running mean 0, running variance 1); but the last layer of each
head starts as Faster R-CNN's do (Ren et al., NIPS 2015;
py-faster-rcnn's model definitions): the scores at standard deviation
0.01, the RPN's deltas at 0.01 and the fusion head's box deltas at 0.001
(the family's ``HEAD_STD``, in ``reference/<family>.py``, names each
head's last layer). So the deltas sit at the scale of a trained
network's, a few per cent of a box, where LeCun-normal gives deltas near
1: boxes deformed by metres, which any change of rounding moves by
metres. The kernels come from one ``torch.randn`` on the device, split,
scaled and cast to the dtype each is served in. A serving cell then
calibrates the running statistics on its drive
(``reference/<family>.py::calibrate``) before either side loads them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Layout = List[Tuple[str, Tuple[int, ...], torch.dtype]]
# name suffix -> standard deviation of a head's last layer
HeadStd = Dict[str, float]


def std_of(name: str, shape: Tuple[int, ...], head_std: HeadStd) -> float:
    for suffix, std in head_std.items():
        if name.endswith(suffix):
            return std
    return (int(torch.Size(shape).numel()) // shape[0]) ** -0.5


def layout(state_dict: Dict[str, torch.Tensor]) -> Layout:
    return [(k, tuple(v.shape), v.dtype) for k, v in state_dict.items()]


def _is_kernel(name: str, shape: Tuple[int, ...]) -> bool:
    return name.endswith("weight") and len(shape) >= 2


def draw(entries: Layout, seed: int, device, head_std: HeadStd
         ) -> Dict[str, torch.Tensor]:
    """The weights for ``entries`` from ``seed`` (any integer up to
    2**64), on ``device``, the heads' last layers at ``head_std``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    kernels = [(k, s, d) for k, s, d in entries if _is_kernel(k, s)]
    total = sum(int(torch.Size(s).numel()) for _, s, _ in kernels)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, dtype in kernels:
        n = int(torch.Size(shape).numel())
        out[name] = (z[at:at + n] * std_of(name, shape, head_std)).reshape(
            shape).to(dtype)
        at += n
    for name, shape, dtype in entries:
        if name in out:
            continue
        fill = 1.0 if (name.endswith("running_var") or (
            name.endswith("weight") and len(shape) == 1)) else 0.0
        out[name] = torch.full(shape, fill, dtype=dtype, device=device)
    return out
