"""Card milliseconds a frame of the eval-mode BatchNorm + ReLU pass
(``mv3d::bn_relu``, ``csrc/bn_relu.cu``): the union of the intervals of
the compute events launched while the operator ran (tied by the runtime
call's correlation id), inside the traced window, over the traced frames.
Where the trace ties no device event to the operator, its kernels are
found by name inside the window. A program without the operator (whose
BatchNorm is cuDNN's, with casts and a ReLU around it) reads None."""

from harness import stats, trace

OP = "mv3d::bn_relu"
KERNEL = "mv3d_bn_relu_kernel"


def read(rec):
    if not rec["requests"]:
        return None
    evs = [e for e in trace.launched_under(rec, OP)
           if e["cat"] in trace.COMPUTE_CATS]
    if not evs:
        evs = [e for e in trace.in_window(rec, "kernel")
               if KERNEL in e["name"]]
    if not evs:
        return None
    lo, hi = trace.window(rec)
    spans = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in evs
             if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    frames = rec["frames_per_request"] * len(rec["requests"])
    return stats.union_length(spans) / 1e3 / frames
