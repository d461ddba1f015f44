"""The reader ``bn_relu_ms`` on a made-up trace: two requests of 8 frames
whose program launches the BatchNorm + ReLU kernel under the operator
``mv3d::bn_relu`` between its convolutions."""

from __future__ import annotations

import pytest

from h100bench_tiny import ROOT
from harness import spec, trace

KERNEL = ("void (anonymous namespace)::mv3d_bn_relu_kernel<__nv_bfloat16, "
          "__nv_bfloat16, 1>(__nv_bfloat16 const*, __nv_bfloat16*)")


def _ev(name, cat, ts, dur, corr=None, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": {"correlation": corr} if corr else {}}


def _events(op=True, tied=True):
    """Per request of 100 us: a conv (10 us) then the operator's kernel
    (4 us), twice; with ``op`` False the program runs cuDNN's BatchNorm
    (6 us) and a ReLU (3 us) instead; with ``tied`` False the trace keeps
    no correlation ids for the operator's launches."""
    ev, corr = [], 0
    for t in (0.0, 100.0):
        ev.append(_ev(trace.REQUEST_SPAN, "user_annotation", t, 100.0))
        for k in range(2):
            h, d = t + 2 + 20 * k, t + 30 + 20 * k
            corr += 1
            ev.append(_ev("cudaLaunchKernel", "cuda_runtime", h, 0.5, corr))
            ev.append(_ev("cudnn::conv_kernel", "kernel", d, 10.0, corr))
            if op:
                ev.append(_ev("mv3d::bn_relu", "cpu_op", h + 1, 3.0))
                corr += 1
                ev.append(_ev("cuLaunchKernel", "cuda_driver", h + 2, 0.5,
                              corr if tied else None))
                ev.append(_ev(KERNEL, "kernel", d + 10, 4.0,
                              corr if tied else None))
            else:
                for name, dur in (("cudnn::bn_fw_inf_1C11_kernel_NCHW", 6.0),
                                  ("at::native::clamp_min_kernel", 3.0)):
                    corr += 1
                    ev.append(_ev("cudaLaunchKernel", "cuda_runtime", h + 2,
                                  0.5, corr))
                    ev.append(_ev(name, "kernel", d + 10, dur, corr))
    rec = trace.from_events(ev)
    rec.update(frames_per_request=8)
    return rec


def _read(rec):
    return spec.load_reader("bn_relu_ms").read(rec)


def test_bn_relu_ms_is_a_benchmark_metric():
    bench = spec.load_benchmark(ROOT)
    m = {x["name"]: x for x in bench["per_layer"]}["bn_relu_ms"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
            m["workloads"]) == ("ms", "lower", "device_trace", "model step",
                                "card_ms_per_frame",
                                ["kitti.serve-b8", "didi2.serve-b8"])


@pytest.mark.parametrize("tied", [True, False])
def test_bn_relu_ms_reads_the_kernel_a_frame(tied):
    # two 4 us launches a request, two requests of 8 frames: 16 us / 16
    assert _read(_events(tied=tied)) == pytest.approx(16e-3 / 16)


def test_bn_relu_ms_reads_nothing_without_the_operator():
    assert _read(_events(op=False)) is None
    empty = trace.from_events([])
    empty.update(frames_per_request=8)
    assert _read(empty) is None
