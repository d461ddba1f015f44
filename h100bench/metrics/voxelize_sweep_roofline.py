"""The fused voxelizer sweep's (K1, ``mv3d::voxelize_sweep``) share of its
roofline, in %: the least time its bytes need at the card's HBM rate,
over its device time per call.

Bytes: each input read once, each output written once. Inputs per frame
are the bucket's points as int32 flat id, f32 height value and f32
reflectance (12 bytes a point); outputs are the heights (xn * yn * zn in
the view dtype), and per cell a f32 count and intensity (8 bytes). The
work is a few integer operations a byte, far below the card's arithmetic
peak, so bytes bound it. Device time: every kernel and fill launched
while the operator ran (the binning histogram's fill, the count, scan,
placement and tile sweep), over the calls traced. Where the trace ties
no device event to the operator's runtime calls, the kernels are found
by their names inside the traced requests (the served path runs no
other kernel of these names). None where the program calls no such
operator."""

from harness import trace

OP = "mv3d::voxelize_sweep"
PATTERN = ("bin_count", "bin_scan", "bin_fill", "tile_sweep", "Memset")


def bytes_per_call(sizes):
    cells = sizes["xn"] * sizes["yn"]
    h_bytes = 2 if sizes["top_view_dtype"] == "bfloat16" else 4
    return sizes["batch"] * (sizes["points"] * 12
                             + cells * sizes["zn"] * h_bytes + cells * 8)


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
