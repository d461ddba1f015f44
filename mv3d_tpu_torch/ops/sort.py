"""Stable bitonic sort as a reshape-based network of plain PyTorch ops.

Port of ``mv3d_tpu/ops/sort.py::bitonic_sort_stable``, batched over rows:
Batcher's bitonic network with the ``partner = i XOR j`` exchange written
as a reshape (viewing a row as ``(n/(2j), 2, j)`` puts each pair on axis
1), so every stage is a compare and two selects. A bitonic network is not
stable; the original index rides along as a second key, which makes every
(key, index) pair unique and the result exactly the stable ascending order.

It is the plain version of the hand-written sort kernel
(:mod:`mv3d_tpu_torch.ops.sort_bitonic`, K4) and what that kernel's
wrapper runs on CPU tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def bitonic_sort_stable(key: torch.Tensor, payloads: Sequence[torch.Tensor]
                        ) -> Tuple[torch.Tensor, ...]:
    """Stable ascending sort of each row of ``key`` ((..., n), n a power of
    two), carrying ``payloads`` of the same shape along.

    Returns (sorted_key, *sorted_payloads): ``torch.sort(key, stable=True)``
    with the payloads gathered by its indices. Values are only moved, so
    float payloads keep their bits."""
    n = key.shape[-1]
    if n & (n - 1):
        raise ValueError(f"bitonic sort needs a power-of-two length, got {n}")
    lead = key.shape[:-1]
    idx = torch.arange(n, dtype=torch.int32, device=key.device).expand_as(key)
    arrs = [key, idx, *payloads]

    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            rows = n // (2 * j)
            views = [a.reshape(*lead, rows, 2, j) for a in arrs]
            klo, khi = views[0][..., 0, :], views[0][..., 1, :]
            ilo, ihi = views[1][..., 0, :], views[1][..., 1, :]
            swap = (klo > khi) | ((klo == khi) & (ilo > ihi))
            # descending blocks: (i & k) != 0, constant along a row's pair
            desc = (torch.arange(rows, device=key.device) * (2 * j) & k) != 0
            swap = swap ^ desc[:, None]
            arrs = [torch.stack([torch.where(swap, v[..., 1, :], v[..., 0, :]),
                                 torch.where(swap, v[..., 0, :], v[..., 1, :])],
                                dim=-2).reshape(*lead, n)
                    for v in views]
            j //= 2
        k *= 2
    return (arrs[0], *arrs[2:])
