"""Static cost model: parameter and FLOP counting.

Port of ``mv3d_tpu/utils/macs.py``, the counterpart of the reference's
graph-walking MAC counter ``print_macs_to_file`` (src/net/blocks.py:
16-111). Parameters are counted from the modules (or from trees of
arrays); FLOPs come from PyTorch's ``FlopCounterMode`` around one call,
where the JAX package asks XLA's ``cost_analysis``. The two count
different things: ``FlopCounterMode`` counts the matmuls and convolutions
(2 FLOPs a multiply-add) and nothing else, and a kernel launched through
ctypes counts 0; XLA also counts the elementwise work and the
reductions.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


def count_params(tree) -> int:
    """Elements of a module's parameters (buffers such as BatchNorm's
    running statistics excluded, as flax keeps them out of ``params``), or
    of every array leaf of a tree of mappings and sequences."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, Mapping):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    if hasattr(tree, "shape"):
        return int(np.prod(tree.shape))
    return 0


def param_breakdown(variables) -> Dict[str, int]:
    """Per-subnet parameter counts of an ``MV3DNet`` (its ``subnets``), or
    of a ``{subnet: module or variables}`` mapping, plus ``"total"``."""
    subnets = getattr(variables, "subnets", variables)
    out = {}
    for name, v in subnets.items():
        out[name] = count_params(v.get("params", v)
                                 if isinstance(v, Mapping) else v)
    out["total"] = sum(out.values())
    return out


def flops_of(fn: Callable, *example_args) -> Optional[float]:
    """FLOPs of one call ``fn(*example_args)`` as ``FlopCounterMode``
    counts them (a backward run inside ``fn`` counts too); ``None`` if the
    call fails."""
    try:
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter:
            fn(*example_args)
        return float(counter.get_total_flops())
    except Exception:
        return None


def print_macs_to_file(fn: Callable, example_args, variables,
                       path: str = "macs.txt") -> str:
    """Write the cost report (the JAX package's lines; the reference wrote
    a macs file) and return its text."""
    lines = ["MV3D TPU cost report", "=" * 40]
    for name, n in param_breakdown(variables).items():
        lines.append(f"params[{name}]: {n:,}")
    fl = flops_of(fn, *example_args)
    if fl is not None:
        lines.append(f"compiled flops (one step): {fl:,.0f}")
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return text
