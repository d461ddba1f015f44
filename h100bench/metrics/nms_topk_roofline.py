"""The NMS kernel's (``mv3d::nms_topk``, ``csrc/nms_topk.cu``) share of its
roofline, in %: the least time its bytes need at the card's HBM rate,
over its device time, over every call of the traced requests (AVOD's
proposal NMS and final NMS, ``sizes["nms_calls"]``: candidates and kept
boxes a frame of each).

Bytes: the sorted boxes (16 bytes) and scores (4) of every candidate read
once, the kept positions (4 bytes each) and each frame's count and
visits (8) written once. The kernel stops at the last kept box, so it
reads less than every candidate where that comes early: the count is
what the inputs hand it, as the bound of a kernel that would have to
look at each. Device time: the kernels launched while the operator ran,
found by name where the trace ties none. None where the program calls no
such operator."""

from harness import trace

OP = "mv3d::nms_topk"
KERNEL = "nms_topk_kernel"


def bytes_per_request(sizes):
    return sizes["batch"] * sum(k * 20 + kept * 4 + 8
                                for k, kept in sizes["nms_calls"])


def read(rec):
    peak = rec.get("peaks")
    if not rec["requests"] or not peak or "nms_calls" not in rec["sizes"]:
        return None
    evs = [e for e in trace.launched_under(rec, OP)
           if e["cat"] == "kernel"]
    if not evs:
        evs = [e for e in trace.in_window(rec, "kernel")
               if KERNEL in e["name"]]
    if not evs:
        return None
    seconds = sum(e["dur"] for e in evs) / 1e6
    bound = (bytes_per_request(rec["sizes"]) * len(rec["requests"])
             / peak["hbm_bytes_per_s"])
    return 100.0 * bound / seconds
