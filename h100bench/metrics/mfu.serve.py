"""Model FLOP utilization of serving, in %: the reference's FLOPs per
frame (``FlopCounterMode`` over the benchmark's reference at the cell's
shapes: convolutions and matrix products, 2 per multiply-add) times the
frames of the traced requests, over the seconds the card's SMs were busy
with them (kernels and fills: ``trace.COMPUTE_CATS``), over the card's
bf16 dense peak (989 TFLOP/s on the H100 SXM). The whole step's share of
the peak while it computes: it moves with ``card_ms_per_frame``, and
bounds any kernel's roofline gain. The reference counts the same work
whatever computes it, so a change that drops work from the program does
not change the count."""

from harness import trace


def read(rec):
    peak = rec.get("peaks")
    if not peak or not rec.get("flops_per_frame") or not rec["requests"]:
        return None
    busy = trace.busy_s(rec, trace.COMPUTE_CATS)
    if not busy:
        return None
    frames = rec["frames_per_request"] * len(rec["requests"])
    achieved = rec["flops_per_frame"] * frames / busy
    return 100.0 * achieved / peak["bf16_flops_per_s"]
