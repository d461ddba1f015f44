"""The program's card time by stage (``harness/stages.py``, the readers
``card_ms.<stage>``) on a made-up trace: two requests whose program opens
a range for each stage around its launches."""

from __future__ import annotations

import pytest

from h100bench_tiny import ROOT
from harness import spec, stages, trace

STAGES = ("voxelize", "top_trunk", "rgb_trunk", "proposals", "roi_fusion",
          "detect")
# per request, each stage's kernels as (start, duration) in us after the
# request's start: stages and kernels follow one another on one stream,
# two of them overlap in top_trunk
KERNELS = {"voxelize": [(30, 4), (34, 6)], "top_trunk": [(50, 10), (55, 10)],
           "rgb_trunk": [(65, 20)], "proposals": [(85, 3), (90, 2)],
           "roi_fusion": [(92, 8)], "detect": [(100, 5)]}
# us a request: the union of each stage's kernels; voxelize adds the
# untied K2 sweep (40-50) to its fill and kernel
WANT_US = {"voxelize": 20, "top_trunk": 15, "rgb_trunk": 20,
           "proposals": 5, "roi_fusion": 8, "detect": 5}


def _ev(name, cat, ts, dur, corr=None, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": {"correlation": corr} if corr else {}}


def _events(ranges=True):
    """Two requests of 120 us, one after the other: the host builds the
    image batch (1-23 us, nothing on the card), copies in (25-30), then
    launches each stage's kernels under its range; K2's tile sweep
    (40-50) is tied to no launch; the answers are copied out (105-110)."""
    ev, corr = [], 0
    for t in (0.0, 120.0):
        ev.append(_ev(trace.REQUEST_SPAN, "user_annotation", t, 120.0))
        ev.append(_ev("mv3d.serve.rgb", "user_annotation", t + 1, 22.0))
        ev.append(_ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy",
                      t + 25, 5.0, 999))
        for i, name in enumerate(STAGES):
            t_host = t + 24 + 3 * i
            if ranges:
                ev.append(_ev(stages.RANGE + name, "user_annotation",
                              t_host, 3.0))
            for k, (start, dur) in enumerate(KERNELS[name]):
                corr += 1
                cat = "gpu_memset" if (name, k) == ("voxelize", 0) \
                    else "kernel"
                ev.append(_ev("cudaLaunchKernel", "cuda_runtime",
                              t_host + 1 + k, 0.5, corr))
                ev.append(_ev(f"{name}_kernel_{k}", cat, t + start, dur,
                              corr))
        ev.append(_ev("(anonymous namespace)::tile_sweep(int const*)",
                      "kernel", t + 40, 10.0))
        ev.append(_ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
                      t + 105, 5.0, 998))
    rec = trace.from_events(ev)
    rec.update(frames_per_request=8)
    return rec


def _readers():
    return {name: spec.load_reader("card_ms." + name).read
            for name in STAGES}


def test_stage_readers_are_the_benchmark_metrics():
    bench = spec.load_benchmark(ROOT)
    names = {m["name"]: m for m in bench["per_layer"]}
    for name in STAGES:
        m = names["card_ms." + name]
        assert (m["unit"], m["source"], m["layer"], m["moves"]) == (
            "ms", "device_trace", "model step", "card_ms_per_frame")


def test_stage_card_time_on_a_made_up_trace():
    rec = _events()
    got = {name: read(rec) for name, read in _readers().items()}
    # 2 requests of 8 frames; us to ms
    assert got == {name: pytest.approx(2 * us / 1e3 / 16)
                   for name, us in WANT_US.items()}
    # the stages add up to the card's compute over the traced frames
    busy_ms = trace.busy_s(rec, trace.COMPUTE_CATS) * 1e3
    assert sum(got.values()) * 16 == pytest.approx(busy_ms)
    # the untied sweep is voxelize's, and only voxelize's
    sweeps = [e for name in STAGES for e in stages.events(rec, name)
              if "tile_sweep" in e["name"]]
    assert len(sweeps) == 2
    # the host stage names the gap in which the card waits for it: from
    # the first request's answers to the second's inputs
    assert trace.idle_gaps(rec, top=1) == [["mv3d.serve.rgb",
                                            pytest.approx(35e-6)]]


def test_stage_readers_read_nothing_without_ranges():
    rec = _events(ranges=False)
    assert all(read(rec) is None for read in _readers().values())
