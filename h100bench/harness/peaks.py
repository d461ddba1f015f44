"""Published peaks of the cards the benchmark runs on: NVIDIA's H100 data
sheet, SXM part, dense rates without sparsity, at the full 700 W power
limit (a card set below it reads lower; each run prints its limit)."""

from __future__ import annotations

from typing import Dict, Optional

H100_SXM = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


def of(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``kind``
    (``torch.cuda.get_device_name()``), None for a card not in the
    table."""
    if "H100" in kind and ("HBM3" in kind or "SXM" in kind):
        return H100_SXM
    return None
