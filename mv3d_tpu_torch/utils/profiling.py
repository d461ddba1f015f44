"""Profiling helpers: device traces and per-step timing.

Port of ``mv3d_tpu/utils/profiling.py``, the counterpart of the
reference's TF ``RunOptions(FULL_TRACE)`` + ``RunMetadata`` timelines
(src/mv3d.py:1211-1213, 1366-1384): ``torch.profiler`` traces, written as
Chrome traces, plus a step-time aggregator that waits for the card where
the JAX package calls ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
from typing import Dict, List, Mapping

import numpy as np
import torch

_trace_ids = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str = "log/profile"):
    """Profile the block (the CPU, and the card where CUDA is available)
    and write a Chrome trace (``chrome://tracing``, Perfetto) to
    ``<log_dir>/trace_<pid>_<n>.json``. Yields the profiler, whose
    ``key_averages()`` and ``trace_path`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_trace_ids)}.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of every tensor in a tree of mappings, sequences
    and dataclasses."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, Mapping):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    return out


def block_until_ready(result):
    """Wait until the card has computed every CUDA tensor of ``result``
    (a tensor or a tree of them); returns ``result``."""
    for dev in _cuda_devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


class StepTimer:
    """Aggregates wall-clock step times; waits for the step output."""

    def __init__(self):
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self, result=None):
        t0 = time.time()
        yield
        if result is not None:
            block_until_ready(result)
        self.times.append(time.time() - t0)

    def record(self, seconds: float):
        self.times.append(seconds)

    def summary(self, skip_warmup: int = 1) -> Dict[str, float]:
        ts = np.asarray(self.times[skip_warmup:] or self.times)
        return {"mean_s": float(ts.mean()), "median_s": float(np.median(ts)),
                "p90_s": float(np.percentile(ts, 90)), "n": len(ts)}
