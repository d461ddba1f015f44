"""Stable key sorts with payloads in plain PyTorch ops.

:func:`bitonic_sort_stable` is the port of
``mv3d_tpu/ops/sort.py::bitonic_sort_stable``, batched over rows: Batcher's
bitonic network with the ``partner = i XOR j`` exchange written as a
reshape (viewing a row as ``(n/(2j), 2, j)`` puts each pair on axis 1), so
every stage is a compare and two selects. A bitonic network is not stable;
the original index rides along as a second key, which makes every (key,
index) pair unique and the result exactly the stable ascending order.

:func:`radix_sort_stable` computes the same function the way the
hand-written sort kernel does (:mod:`mv3d_tpu_torch.ops.sort_bitonic`, K4;
``csrc/sort_radix.cu``): keys flipped to unsigned order, the digit passes
planned from each row's min and max (:func:`radix_pass_plan`), and a
stable reorder by each 8-bit digit, least significant first. It is the
plain version that the K4 wrapper runs on CPU tensors.

:func:`merge_sort_stable` computes it the way the kernels sort rows longer
than one radix cluster holds (``csrc/sort_radix.cu`` on blocks, then
``csrc/sort_merge.cu``): each block of a row sorted alone by
:func:`radix_sort_stable`, then pairs of sorted runs merged stably
(:func:`merge_runs_stable`, the left run first on equal keys) until one
run is left.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

RADIX_BITS = 8


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


def radix_pass_plan(lo: int, hi: int) -> List[int]:
    """Bit shifts of the digit passes a stable LSD radix sort needs for a
    row of sign-flipped keys (``key ^ 0x80000000`` as uint32) whose min is
    ``lo`` and max ``hi``: every key shares the bits above the highest bit
    of ``lo ^ hi``, so only the 8-bit digits at or below it are sorted.
    None when all keys are equal; 3 for keys in [0, 2**24); 4 across 0."""
    vary = lo ^ hi
    if vary == 0:
        return []
    top = vary.bit_length() - 1
    return list(range(0, top // RADIX_BITS * RADIX_BITS + 1, RADIX_BITS))


def radix_sort_stable(key: torch.Tensor, payloads: Sequence[torch.Tensor]
                      ) -> Tuple[torch.Tensor, ...]:
    """Stable ascending sort of each row of int32 ``key`` ((..., n), any
    n >= 1), carrying ``payloads`` of the same shape along, as the K4
    kernel sorts: sign flip, each row's pass plan from its min and max, and
    per planned digit a stable reorder of the row by that digit.

    Returns (sorted_key, *sorted_payloads), equal to
    :func:`bitonic_sort_stable`; values are only moved, so float payloads
    keep their bits."""
    n = key.shape[-1]
    lead = key.shape[:-1]
    arrs = [a.reshape(-1, n) for a in (key, *payloads)]
    flipped = arrs[0].to(torch.int64) + 2 ** 31       # key ^ 0x80000000
    plans = [radix_pass_plan(lo, hi) for lo, hi in zip(
        flipped.min(-1).values.tolist(), flipped.max(-1).values.tolist())]
    pos = torch.arange(n, device=key.device)
    for shift in range(0, 32, RADIX_BITS):
        rows = torch.tensor([shift in plan for plan in plans],
                            device=key.device)
        if not rows.any():
            continue
        digit = (flipped >> shift) & (2 ** RADIX_BITS - 1)
        digit = torch.where(rows[:, None], digit, 0)
        # (digit, position) is unique: ordering by it is the stable order
        order = torch.argsort(digit * n + pos, dim=-1)
        flipped = torch.gather(flipped, -1, order)
        arrs = [torch.gather(a, -1, order) for a in arrs]
    return tuple(a.reshape(*lead, n) for a in arrs)


def merge_runs_stable(arrs: Sequence[torch.Tensor], run: int
                      ) -> List[torch.Tensor]:
    """One merge pass over (R, n) ``arrs`` (the key first, then payloads)
    whose rows are sorted runs of ``run`` elements (n a multiple of
    ``2 * run``): each pair of runs merged stably into one, equal keys
    taking the left run first, as ``csrc/sort_merge.cu`` merges. An
    element's place is its place in its run plus the elements of the
    other run that go before it: smaller keys of the right run for a left
    element, keys at most its own of the left run for a right one."""
    r, n = arrs[0].shape
    if n % (2 * run):
        raise ValueError(f"rows of {n} are no whole pairs of runs of {run}")
    pairs = [a.reshape(r, n // (2 * run), 2, run) for a in arrs]
    left, right = pairs[0][:, :, 0], pairs[0][:, :, 1]
    own = torch.arange(run, device=left.device)
    at_left = own + torch.searchsorted(right.contiguous(), left.contiguous())
    at_right = own + torch.searchsorted(left.contiguous(), right.contiguous(),
                                        right=True)
    out = []
    for a in pairs:
        merged = torch.empty(r, n // (2 * run), 2 * run, dtype=a.dtype,
                             device=a.device)
        merged.scatter_(-1, at_left, a[:, :, 0])
        merged.scatter_(-1, at_right, a[:, :, 1])
        out.append(merged.reshape(r, n))
    return out


def merge_sort_stable(key: torch.Tensor, payloads: Sequence[torch.Tensor],
                      block: int) -> Tuple[torch.Tensor, ...]:
    """Stable ascending sort of each row of int32 ``key`` ((..., n), n a
    power-of-two multiple of ``block``), carrying ``payloads`` along, as
    the kernels sort rows longer than a cluster: every block of ``block``
    elements sorted by :func:`radix_sort_stable`, then merge passes of
    doubling run length. Equal to :func:`radix_sort_stable` of the row."""
    n = key.shape[-1]
    if n % block or (n // block) & (n // block - 1):
        raise ValueError(f"rows of {n} are not a power-of-two number of "
                         f"blocks of {block}")
    lead = key.shape[:-1]
    arrs = radix_sort_stable(key.reshape(-1, block),
                             [p.reshape(-1, block) for p in payloads])
    arrs = [a.reshape(-1, n) for a in arrs]
    run = block
    while run < n:
        arrs = merge_runs_stable(arrs, run)
        run *= 2
    return tuple(a.reshape(*lead, n) for a in arrs)
