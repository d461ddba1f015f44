"""Profiling helpers: device traces, named spans and per-step timing.

Port of ``mv3d_tpu/utils/profiling.py``, the counterpart of the
reference's TF ``RunOptions(FULL_TRACE)`` + ``RunMetadata`` timelines
(src/mv3d.py:1211-1213, 1366-1384): ``torch.profiler`` traces, written as
Chrome traces, plus a step-time aggregator that waits for the card where
the JAX package calls ``jax.block_until_ready``.

Spans name the program's stages in a trace, on the profiler's clock, so
each kernel and each idle stretch of the card can be put down to one. A
span is a ``record_function`` range opened only while a profiler runs
(:func:`span`); with none running it costs one flag read. Serving opens:

  ``mv3d.serve.<stage>``     the artifact's host stages, one each a
                             request (``serving/export.py``): ``cut``,
                             ``pad``, ``rgb``, ``quantize`` (quantized
                             artifacts), ``h2d``, ``program``, ``d2h``,
                             ``unpack``, inside ``mv3d.serve.request``;
  ``mv3d.program.<stage>``   the network's stages (:func:`stage`):
                             ``voxelize``, ``top_trunk``, ``rgb_trunk``,
                             ``front_trunk`` (with the front view),
                             ``proposals``, ``roi_fusion``, ``detect``.

A counter (:func:`count`) is a zero-length range named
``mv3d.count.<name>=<value>``, recorded only while a profiler runs:
serving records AVOD's ``anchors`` (non-empty anchors) and
``nms_visited`` (boxes the proposal NMS examined) summed over a request's
frames.

In a trace written by :func:`trace` they are ``user_annotation`` events;
the kernels a range launched are those whose correlation id matches a
runtime call made inside it. ``torch.export`` keeps no range, so
:func:`stage` also annotates the traced nodes (``node.meta["custom"]
["mv3d_stage"]``, kept by ``torch.export.save``), and
:func:`add_stage_ranges` wraps each run of one stage of a loaded program
in its range.
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
import torch.fx.traceback as fx_traceback
from torch.autograd import profiler as autograd_profiler
from torch.autograd.profiler import record_function

_trace_ids = itertools.count()
STAGE_KEY = "mv3d_stage"
PROGRAM_RANGE = "mv3d.program."
COUNT_RANGE = "mv3d.count."
_OFF = contextlib.nullcontext()


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


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs,
    else a context that does nothing."""
    if autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


def count(name: str, value: int) -> None:
    """Record ``value`` of the counter ``name`` in a running profiler's
    trace as the empty range ``mv3d.count.<name>=<value>``; nothing where
    none runs."""
    if autograd_profiler._is_profiler_enabled:
        with record_function(f"{COUNT_RANGE}{name}={int(value)}"):
            pass


def stage(name: str):
    """The network's stage ``name``: in a trace that keeps node metadata
    (``torch.export`` under ``fx.traceback.preserve_node_meta``) each node
    it traces carries ``{STAGE_KEY: name}``; in eager the range
    ``mv3d.program.<name>`` (:func:`span`)."""
    if fx_traceback.has_preserved_node_meta():
        return fx_traceback.annotate({STAGE_KEY: name})
    return span(PROGRAM_RANGE + name)


def range_enter(name: str):
    """Open the range ``name`` while a profiler runs; returns what
    :func:`range_exit` closes (None where nothing was opened). A graph's
    call node, where a ``with`` block cannot be."""
    if not autograd_profiler._is_profiler_enabled:
        return None
    rf = record_function(name)
    rf.__enter__()
    return rf


def range_exit(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


def add_stage_ranges(gm: torch.fx.GraphModule) -> int:
    """Wrap, in place, each maximal run of ``gm``'s call nodes of one stage
    (``node.meta["custom"][STAGE_KEY]``, see :func:`stage`) in
    :func:`range_enter` and :func:`range_exit` nodes of the range
    ``mv3d.program.<stage>``. What the graph computes is unchanged; a
    graph without stage metadata is left as it is. Returns the number of
    ranges added."""
    runs = []    # [stage, first node, last node]
    for n in gm.graph.nodes:
        if n.op != "call_function":
            continue
        name = (n.meta.get("custom") or {}).get(STAGE_KEY)
        if name is None:
            continue
        if runs and runs[-1][0] == name:
            runs[-1][2] = n
        else:
            runs.append([name, n, n])
    for name, first, last in runs:
        with gm.graph.inserting_before(first):
            rf = gm.graph.call_function(range_enter, (PROGRAM_RANGE + name,))
        with gm.graph.inserting_after(last):
            gm.graph.call_function(range_exit, (rf,))
    if runs:
        gm.recompile()
    return len(runs)


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
