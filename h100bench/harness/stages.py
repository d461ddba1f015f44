"""The program's card time by stage, read from the ranges the port opens
inside its frozen program while a profiler runs: ``mv3d.program.<stage>``
(``voxelize``, ``top_trunk``, ``rgb_trunk``, ``front_trunk``,
``proposals``, ``roi_fusion``, ``detect``), one for each run of a stage's
nodes. A device event belongs to the stage whose range was open when the
host made the runtime call that launched it (tied by correlation id,
``trace.launched_under``). A record of a program without these ranges
reads None.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from . import spec, stats, trace

RANGE = "mv3d.program."
# K2 (``mv3d::voxelize_padded``) runs in ``voxelize`` alone, so its
# kernels are found by name where the trace ties them to no launch
K2_KERNELS = spec.load_reader("voxelize_padded_roofline").PATTERN[:4]


def events(rec, name: str) -> List[Dict[str, Any]]:
    """The compute events (``trace.COMPUTE_CATS``) that stage ``name``
    launched."""
    evs = {id(e): e for e in trace.launched_under(rec, RANGE + name)
           if e["cat"] in trace.COMPUTE_CATS}
    if name == "voxelize":
        evs.update((id(e), e) for e in trace.in_window(rec, "kernel")
                   if any(p in e["name"] for p in K2_KERNELS))
    return list(evs.values())


def card_ms(rec, name: str) -> Optional[float]:
    """Milliseconds a frame that the card's SMs spent on stage ``name``:
    the union of its compute events' intervals inside the traced window,
    over the traced frames; None where the trace holds no such range."""
    if not rec["requests"] or not any(e["name"] == RANGE + name
                                      for e in rec["cpu"]):
        return None
    lo, hi = trace.window(rec)
    spans = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
             for e in events(rec, name)
             if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    frames = rec["frames_per_request"] * len(rec["requests"])
    return stats.union_length(spans) / 1e3 / frames
