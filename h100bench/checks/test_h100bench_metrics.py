"""The metric arithmetic: rates over the whole window, a tail over every
request, unions of device intervals, the roofline's bytes, MFU, and each
per-layer reader on a made-up trace."""

from __future__ import annotations

import pytest

from h100bench_tiny import ROOT
from harness import compare, guard, peaks, spec, stats, trace

BENCH = spec.load_benchmark(ROOT)


def test_rate_and_tail_take_every_request():
    assert stats.rate(8 * 250, 20.0) == 100.0
    lat = list(range(1, 101))
    assert stats.percentile(lat, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_of_intervals():
    spans = [(0, 2), (1, 3), (5, 6), (6, 7), (10, 10.5)]
    assert stats.union_length(spans) == 5.5
    assert stats.union(spans) == [(0, 3), (5, 7), (10, 10.5)]
    assert stats.union_length([]) == 0.0


def test_peaks_of_the_card():
    assert peaks.of("NVIDIA H100 80GB HBM3")["bf16_flops_per_s"] == 989e12
    assert peaks.of("cpu") is None


def _ev(name, cat, ts, dur, corr=None, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": {"correlation": corr} if corr else {}}


def _record():
    """Two requests of 100 us: the first copies in for 10 us and runs K2
    (a fill and two kernels, 20 us) and one more kernel; the second the
    same; the device is busy 40 us of each."""
    ev = []
    for r, t in enumerate((0.0, 100.0)):
        ev.append(_ev(trace.REQUEST_SPAN, "user_annotation", t, 100.0))
        ev.append(_ev("mv3d::voxelize_padded", "cpu_op", t + 1, 5.0))
        c = 10 * r
        ev.append(_ev("cudaMemsetAsync", "cuda_runtime", t + 2, 1, c + 1))
        ev.append(_ev("cudaLaunchKernel", "cuda_runtime", t + 3, 1, c + 2))
        ev.append(_ev("cuLaunchKernel", "cuda_driver", t + 4, 1, c + 3))
        ev.append(_ev("cudaLaunchKernel", "cuda_runtime", t + 8, 1, c + 4))
        ev.append(_ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy",
                      t + 10, 10.0, c + 5))
        ev.append(_ev("Memset (Device)", "gpu_memset", t + 20, 5.0, c + 1))
        ev.append(_ev("(anonymous namespace)::bin_count(int const*)",
                      "kernel", t + 25, 5.0, c + 2))
        ev.append(_ev("(anonymous namespace)::tile_sweep(int const*)",
                      "kernel", t + 30, 10.0, c + 3))
        ev.append(_ev("void gemm_kernel()", "kernel", t + 60, 10.0, c + 4))
    rec = trace.from_events(ev)
    rec.update(peaks=peaks.H100_SXM, flops_per_frame=1e11,
               frames_per_request=8,
               sizes={"batch": 8, "points": 65536, "xn": 800, "yn": 600,
                      "zn": 25, "top_view_dtype": "bfloat16"})
    return rec


def test_trace_record_reductions():
    rec = _record()
    assert trace.window(rec) == (0.0, 200.0)
    assert trace.busy_s(rec) == pytest.approx(80e-6)
    # the card's SMs: the fills and kernels, not the copies
    assert trace.busy_s(rec, trace.COMPUTE_CATS) == pytest.approx(60e-6)
    assert len(trace.in_window(rec, "kernel")) == 6
    k2 = trace.launched_under(rec, "mv3d::voxelize_padded")
    # per request the fill and the two kernels launched inside the
    # operator, not the kernel launched after it
    assert sorted(e["corr"] for e in k2) == [1, 2, 3, 11, 12, 13]
    gaps = trace.idle_gaps(rec, top=2)
    assert [g[0] for g in gaps] == [trace.REQUEST_SPAN] * 2
    assert gaps[0][1] == pytest.approx(40e-6)


def test_readers_on_a_made_up_trace():
    rec = _record()
    read = {m["name"]: spec.load_reader(m["name"]).read
            for m in BENCH["per_layer"]}
    assert read["launches.serve"](rec) == 3
    # 16 frames of 1e11 FLOP in 60 us of compute
    assert read["mfu.serve"](rec) == pytest.approx(
        100 * 1e11 * 16 / 60e-6 / 989e12)
    roof = spec.load_reader("voxelize_padded_roofline")
    n_sc = 400 * 304
    want = 8 * (65536 * 12 + n_sc * 128 * 2 + n_sc * 32)
    assert roof.bytes_per_call(rec["sizes"]) == want
    # K2's device time: its fill and two kernels, 20 us a call
    assert read["voxelize_padded_roofline"](rec) == pytest.approx(
        100 * want / 3.35e12 / 20e-6)


def test_readers_find_nothing_in_an_empty_trace():
    rec = trace.from_events([])
    rec.update(peaks=None, flops_per_frame=None, frames_per_request=8)
    for m in BENCH["per_layer"]:
        assert spec.load_reader(m["name"]).read(rec) is None, m["name"]


RULE = compare.Rule(0.05, 0.001, {"x_min": 0.0, "y_min": -30.0,
                                   "x_div": 0.1, "y_div": 0.1, "xn": 800,
                                   "yn": 600})


def _box(x, y, length=4.0, width=2.0):
    """An axis-aligned car box with its near corner at (x, y), metres."""
    face = [[x, y], [x + length, y], [x + length, y + width],
            [x, y + width]]
    return [[u, v, z] for z in (-1.5, 0.0) for u, v in face]


def _set(*dets):
    return ([_box(x, y) for x, y, _ in dets], [p for _, _, p in dets])


A, B, C = (10.0, 0.0, 0.8), (11.0, 0.5, 0.795), (30.0, 10.0, 0.6)
EMPTY = ([], [])


@pytest.mark.parametrize("case, got, want, cand, out", [
    ("same", _set(A, C), _set(A, C), _set(A, B, C), (0, 0)),
    # the moved box is no candidate's; it overlaps A at A's probability
    ("moved", _set((10.25, 0.0, 0.8), C), _set(A, C), _set(A, B, C),
     (1, 0)),
    ("the other box of a near-tie", _set(B, C), _set(A, C), _set(A, B, C),
     (0, 0)),
    ("a box under its beaten rival", _set((11.0, 0.5, 0.7), C), _set(A, C),
     _set(A, (11.0, 0.5, 0.7), C), (0, 1)),
    ("both boxes of an overlap", _set(A, B, C), _set(A, C), _set(A, B, C),
     (1, 0)),
    ("nothing answered", EMPTY, _set(A, C), _set(A, B, C), (0, 2)),
    ("at the score threshold", EMPTY, _set((10.0, 0.0, 0.06)),
     _set((10.0, 0.0, 0.06)), (0, 0)),
    ("no candidates", _set(A), EMPTY, EMPTY, (1, 0)),
])
def test_detections_unaccounted_for(case, got, want, cand, out):
    n = compare.counts(got, want, cand, RULE)
    assert (n["got_out"], n["wanted_out"]) == out, (case, n)
    share = compare.worst([(got, want, cand)], RULE)["unaccounted_share"]
    assert share == pytest.approx(sum(out) / max(n["got"] + n["wanted"], 1))


def test_unaccounted_share_over_a_run():
    run = [(_set(A, C), _set(A, C), _set(A, B, C)),
           (_set((10.25, 0.0, 0.8)), _set(A), _set(A, B)),
           (EMPTY, _set(C), _set(C))]
    n = compare.worst(run, RULE)
    # one moved box and one missed of 3 + 4 detections
    assert (n["got"], n["wanted"]) == (3, 4)
    assert n["unaccounted_share"] == pytest.approx(2 / 7)
    checks = compare.judge(n, {"unaccounted_share": 0.3})
    assert compare.passed(checks)
    checks["unaccounted_share"]["limit"] = 0.25
    assert not compare.passed(checks)


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["mv3d_tpu_torch.ops", "jaxtyping",
                                   "flaxen", "numpy"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "mv3d_tpu.config",
                                   "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "mv3d_tpu"]
