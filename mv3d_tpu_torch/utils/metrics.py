"""Training metrics: :class:`MetricsWriter` appends one JSON record per
step to ``<log_dir>/metrics_<tag>.jsonl`` (the step, a wall-clock stamp,
the scalars and extra fields such as the phase) and keeps running means.

Port of ``mv3d_tpu/utils/metrics.py``'s writer; its records are the JAX
writer's, line for line, apart from the stamps. Debug-image dumps are not
ported (they need ``utils/viz.py``).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict


class MetricsWriter:
    """Append-only JSONL scalar log with running means."""

    def __init__(self, log_dir: str, tag: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"metrics_{tag}.jsonl")
        self._file = open(self.path, "a")
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def write(self, step: int, scalars: Dict[str, float], **extra):
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}, **extra}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        for k, v in scalars.items():
            self._sums[k] += float(v)
            self._counts[k] += 1

    def means(self) -> Dict[str, float]:
        return {k: self._sums[k] / max(self._counts[k], 1)
                for k in self._sums}

    def close(self):
        self._file.close()
