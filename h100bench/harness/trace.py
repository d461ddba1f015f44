"""A traced run's record: the profiler's events reduced to plain lists
that the per-layer readers (``h100bench/metrics/``) read.

  * ``device``    kernels, copies and fills on the card: name, category
    (``kernel``, ``gpu_memcpy``, ``gpu_memset``), start and duration in
    microseconds, correlation id;
  * ``runtime``   the host's CUDA runtime and driver calls (launches,
    copies), with the correlation id that ties each to its device event;
  * ``cpu``       the host's operators and the benchmark's own spans
    (name, start, duration, thread);
  * ``requests``  each traced request's span (start, end), the
    benchmark's ``h100bench.request`` range around its call into the
    program (the clients' requests may overlap);
  * ``ops``       self device seconds of each aten and ``mv3d::``
    operator (``key_averages``), most first.

Device and host times share one clock in the profiler's trace. Each
request ends when its answers are on the host, so the device work of the
traced requests lies inside the traced window.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

from . import stats

REQUEST_SPAN = "h100bench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# what occupies the card's SMs: copies run on its copy engines, at a
# pace the host's pageable buffers set
COMPUTE_CATS = ("kernel", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def record(prof, work_dir: str) -> Dict[str, Any]:
    path = os.path.join(work_dir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    rec = from_events(events)
    avgs = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total") if len(avgs) else None
    rec["ops"] = sorted(([a.key, getattr(a, key) / 1e6] for a in avgs
                         if key and getattr(a, key) > 0
                         and a.key.startswith(("aten::", "mv3d::"))),
                        key=lambda x: -x[1])
    return rec


def from_events(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    rec: Dict[str, Any] = {"device": [], "runtime": [], "cpu": [],
                           "requests": [], "ops": []}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        ev = {"name": e.get("name", ""), "ts": float(e["ts"]),
              "dur": float(e.get("dur", 0.0)),
              "corr": args.get("correlation"), "tid": e.get("tid")}
        if cat in DEVICE_CATS:
            ev["cat"] = cat
            rec["device"].append(ev)
        elif cat in RUNTIME_CATS:
            rec["runtime"].append(ev)
        elif cat in ("cpu_op", "user_annotation"):
            rec["cpu"].append(ev)
            if cat == "user_annotation" and ev["name"] == REQUEST_SPAN:
                rec["requests"].append((ev["ts"], ev["ts"] + ev["dur"]))
    rec["requests"].sort()
    return rec


def window(rec) -> Tuple[float, float]:
    """(start, end) in microseconds of the traced requests (which may
    overlap, one per client)."""
    return (min(s for s, _ in rec["requests"]),
            max(t for _, t in rec["requests"]))


def in_window(rec, cat: str) -> List[Dict[str, Any]]:
    """The device events of category ``cat`` that start inside the
    traced window."""
    lo, hi = window(rec)
    return [e for e in rec["device"] if e["cat"] == cat
            and lo <= e["ts"] <= hi]


def device_spans(rec, lo: float = float("-inf"), hi: float = float("inf"),
                 cats=DEVICE_CATS) -> List[Tuple[float, float]]:
    return [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
            for e in rec["device"] if e["cat"] in cats
            and e["ts"] < hi and e["ts"] + e["dur"] > lo]


def busy_s(rec, cats=DEVICE_CATS) -> float:
    """Seconds of the traced window in which the device ran something (of
    the categories ``cats``)."""
    lo, hi = window(rec)
    return stats.union_length(device_spans(rec, lo, hi, cats)) / 1e6


def launched_under(rec, op_name: str) -> List[Dict[str, Any]]:
    """The device events launched while a host operator named
    ``op_name`` ran (tied by the runtime call's correlation id)."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in rec["cpu"]
             if e["name"] == op_name]
    corr = {r["corr"] for r in rec["runtime"] if r["corr"] is not None
            and any(s <= r["ts"] <= t and tid == r["tid"]
                    for s, t, tid in spans)}
    return [e for e in rec["device"] if e["corr"] in corr]


def idle_gaps(rec, top: int = 10) -> List[List[Any]]:
    """The longest stretches of the traced window with nothing on the
    device, each named by the innermost host operator or span open at its
    middle: [[name, seconds], ...]."""
    lo, hi = window(rec)
    busy = stats.union(device_spans(rec, lo, hi))
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        open_ = [c for c in rec["cpu"] if c["ts"] <= mid <= c["ts"] + c["dur"]]
        name = min(open_, key=lambda c: c["dur"])["name"] if open_ else "host"
        out.append([name, (e - s) / 1e6])
    return out


def breakdown(rec, top: int = 10) -> Dict[str, List[List[Any]]]:
    return {"device_ops": [list(x) for x in rec["ops"][:top]],
            "idle_gaps": idle_gaps(rec, top)}
