"""Wall-clock timers. Port of ``mv3d_tpu/utils/timer.py``."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.start = time.time()
        self.last = self.start

    def time_diff_per_n_loops(self) -> float:
        now = time.time()
        diff = now - self.last
        self.last = now
        return diff

    def total_time(self) -> float:
        return time.time() - self.start
