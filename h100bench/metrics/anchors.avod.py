"""AVOD's counter ``anchors``: non-empty anchors a frame: the anchors whose
BEV footprint holds a point, on which AVOD's RPN runs. The served
program returns it with its answers and the artifact records each
request's sum over its frames as the range
``mv3d.count.anchors=<value>`` while a profiler runs
(``utils/profiling.count``); the sum over the traced requests, over
their frames. None where the program records no such counter."""

from harness import trace

PREFIX = "mv3d.count.anchors="


def read(rec):
    if not rec["requests"]:
        return None
    lo, hi = trace.window(rec)
    values = [int(e["name"][len(PREFIX):]) for e in rec["cpu"]
              if e["name"].startswith(PREFIX) and lo <= e["ts"] <= hi]
    if not values:
        return None
    return sum(values) / (rec["frames_per_request"] * len(rec["requests"]))
