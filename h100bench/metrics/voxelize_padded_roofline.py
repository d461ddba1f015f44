"""The lane-padded voxelizer sweep's (K2, ``mv3d::voxelize_padded``)
share of its roofline, in %: the least time its bytes need at the card's
HBM rate, over its device time per call.

Bytes: each input read once, each output written once. Inputs per frame
are the bucket's points as int32 flat id, f32 height value and f32
reflectance (12 bytes a point); outputs are the heights plane
(n_sc x 128 lanes in the view dtype) and per folded cell a f32 count and
intensity (n_sc x 4 cells x 8 bytes), over n_sc = (xn / 2) x w2p
supercells, w2p being yn / 2 rounded up to a multiple of 16. The work is
a few integer operations a byte, far below the card's arithmetic peak, so
bytes bound it. Device time: every kernel, copy and fill launched while
the operator ran (the binning, scan, placement and tile sweep, and the
histogram's fill), over the calls traced. Where the trace ties no
device event to the operator's runtime calls, the kernels are found by
their names inside the traced requests (the serving path runs no other
kernel of these names)."""

from harness import trace

OP = "mv3d::voxelize_padded"
PATTERN = ("bin_count", "bin_scan", "bin_fill", "tile_sweep", "Memset")


def bytes_per_call(sizes):
    xn, yn, zn = sizes["xn"], sizes["yn"], sizes["zn"]
    w2p = -(-(yn // 2) // 16) * 16
    n_sc = (xn // 2) * w2p
    h_bytes = 2 if sizes["top_view_dtype"] == "bfloat16" else 4
    return sizes["batch"] * (sizes["points"] * 12 + n_sc * 128 * h_bytes
                             + n_sc * 4 * 8)


def read(rec):
    peak = rec.get("peaks")
    if not rec["requests"]:
        return None
    calls = sum(e["name"] == OP for e in rec["cpu"])
    evs = [e for e in trace.launched_under(rec, OP)
           if any(p in e["name"] for p in PATTERN)]
    if not evs:
        evs = [e for e in trace.in_window(rec, "kernel")
               if any(p in e["name"] for p in PATTERN[:4])]
    if not peak or not calls or not evs:
        return None
    seconds = sum(e["dur"] for e in evs) / 1e6 / calls
    bound = bytes_per_call(rec["sizes"]) / peak["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
