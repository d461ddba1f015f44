"""The ``serve_batch`` traffic: offline batch inference of a drive
through a served artifact, the way a log is run through a deployed
program.

Set-up draws the drive (``pool_frames`` raw sweeps and camera images cut
into batches of ``batch`` consecutive frames) and the weights (BatchNorm
statistics calibrated on the first batch by the reference), and hands
them to the family's program adapter (``programs/<family>.py``), which
freezes the configuration's program at the mix's batch size and loads it
as a serving host does. The window is one client in a closed loop: it
calls the served ``predict_batch`` on the next batch as soon as the last
one's answers (numpy) are in hand, for ``seconds``. An untraced run then
serves ``card_requests`` more under the profiler, whose kernels give the
card's time a frame; a traced run profiles ``trace_requests`` inside the
window instead. Then the program is freed, and every answer of the run
is compared with the reference's for its batch (``compare.py``),
computed at the family's check precision (``CHECK_OVERRIDES`` of
``reference/<family>.py``) from the same frames and weights.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import compare, lidar, peaks, spec, stats, trace, weights

PROFILE_AFTER = 1.0 / 3.0    # share of a traced window before the profile


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _steal_s() -> float:
    """Seconds the hypervisor gave this machine's CPUs to others (the
    ``steal`` column of ``/proc/stat``), 0 where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Inputs(NamedTuple):
    """What a run draws from its seed before the program is built: the
    family's reference module, the configuration tree as run, the
    reference's config, the drive cut into batches, and the weights
    (BatchNorm calibrated on the first batch)."""
    ref: Any
    tree: Dict[str, Any]
    ref_cfg: Any
    batch: int
    score_threshold: float
    drive: List[Any]
    batches: List[Any]
    state: Dict[str, torch.Tensor]


def inputs(config: Dict[str, Any], mix: Dict[str, Any], seed: int, device,
           phases: Optional[list] = None,
           t0: Optional[float] = None) -> Inputs:
    """The run's inputs from ``seed`` (``phases`` gets the seconds at the
    end of each stage, counted from ``t0``)."""
    t0 = time.perf_counter() if t0 is None else t0
    phases = [] if phases is None else phases
    device = torch.device(device)
    ref = spec.reference(config)
    tree = spec.run_config(config, mix)
    ref_cfg = ref.config_from_dict(tree)
    entries = weights.layout(ref.network(ref_cfg).state_dict())
    bsz, thr = int(mix["batch"]), float(mix["score_threshold"])
    area, rgb_shape = ref.drive(ref_cfg)
    drive = lidar.frames(seed, int(mix["pool_frames"]), config["sensor"],
                         area, mix["scene"], rgb_shape)
    batches = [drive[i:i + bsz] for i in range(0, len(drive), bsz)]
    phases.append(("drive", time.perf_counter() - t0))
    net = ref.build(ref_cfg, weights.draw(entries, seed, device,
                                          ref.HEAD_STD), device)
    state = ref.calibrate(net, batches[0], bsz)
    del net
    return Inputs(ref, tree, ref_cfg, bsz, thr, drive, batches, state)


def reference_answers(inp: Inputs, device, overrides=None):
    """The reference's answers for every batch of ``inp`` and its
    candidates (``reference/<family>.py::candidates``), at the
    configuration tree with ``overrides`` laid over it (the check's
    reference precision, the family's ``CHECK_OVERRIDES``, by default),
    TF32 off. Returns (answers, candidates, the comparison's rule), each
    list a batch's per frame."""
    ref = inp.ref
    over = ref.CHECK_OVERRIDES if overrides is None else overrides
    cfg = ref.config_from_dict(spec.merged(inp.tree, over))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = ref.build(cfg, inp.state, device)
    want = [ref.detect(net, b, inp.batch, inp.score_threshold)
            for b in inp.batches]
    cand = [ref.candidates(net, b, inp.batch) for b in inp.batches]
    return want, cand, compare.Rule(**ref.rule(cfg, inp.score_threshold))


def check(answers: List[Any], want, cand, rule: "compare.Rule",
          limits: Dict[str, float]):
    """Every answer of the run (request i answers batch ``i % len(
    want)``) against the reference's, each distinct answer once. Returns
    the compared numbers beside their limits, and the numbers with their
    parts."""
    seen, triples = set(), []
    for i, a in enumerate(answers):
        if a is None:
            continue
        b = i % len(want)
        for f, got in enumerate(a):
            key = (b, f, np.asarray(got[0]).tobytes(),
                   np.asarray(got[1]).tobytes())
            if key not in seen:
                seen.add(key)
                triples.append((got, want[b][f], cand[b][f]))
    numbers = compare.worst(triples, rule)
    return compare.judge(numbers, limits), numbers


def _usage() -> Tuple[float, float, int]:
    """This process's user and system CPU seconds and minor page faults
    so far."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime, r.ru_stime, r.ru_minflt


def run(config: Dict[str, Any], mix: Dict[str, Any],
        limits: Dict[str, float], seed: int, seconds: float, traced: bool,
        device="cuda", t0: Optional[float] = None,
        program_overrides: Optional[Dict[str, Any]] = None,
        wrap: Optional[Callable] = None, keep: bool = False
        ) -> Dict[str, Any]:
    """One run of the cell. ``program_overrides`` lays more configuration
    over the program's alone (the control: the family's
    ``CONTROL_OVERRIDES``); ``wrap(predict_batch)`` replaces the call the
    window drives (the checks' planted faults). Returns the run's
    numbers: ``attempted``, ``failed``, ``correct``, ``checks``, ``e2e``
    (name -> value), ``device``, and for a traced run ``record`` and
    ``breakdown``; with ``keep``, also ``kept``: the inputs, each batch's
    first answers and the reference's."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    program = spec.program(config)

    work = tempfile.mkdtemp(prefix="h100bench_")
    try:
        phases = [("imports", time.perf_counter() - t0)]
        inp = inputs(config, mix, seed, device, phases, t0)
        bsz, thr, batches, state = (inp.batch, inp.score_threshold,
                                    inp.batches, inp.state)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        phases.append(("weights", time.perf_counter() - t0))
        predict = program.served(
            spec.merged(inp.tree, program_overrides or {}), state, bsz, thr,
            device, work,
            lambda name: phases.append((name, time.perf_counter() - t0)))
        call = predict if wrap is None else wrap(predict)
        for i in range(int(mix["warmup_requests"])):
            call(batches[i % len(batches)])
        _sync(device)
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0
        phases.append(("warm-up", setup_s))
        log("setup: " + ", ".join(
            f"{name} {b - a:.3f} s" for (name, b), (_, a)
            in zip(phases, [("start", 0.0)] + phases)))

        answers: List[Any] = []
        lat: List[float] = []
        failed = 0
        rec = None
        use0, steal0 = _usage(), _steal_s()
        start = time.perf_counter()
        if traced:
            # untraced, then a bounded number of requests under the
            # profiler, then untraced to the end of the window
            failed += _closed_loop(call, batches, answers, lat,
                                   until=start + seconds * PROFILE_AFTER)
            prof, n_failed = _profile(call, batches, answers, lat,
                                      int(mix["trace_requests"]), device)
            failed += n_failed
            failed += _closed_loop(call, batches, answers, lat,
                                   until=start + seconds)
        else:
            failed += _closed_loop(call, batches, answers, lat,
                                   until=start + seconds)
        window_s = time.perf_counter() - start
        use = [b - a for a, b in zip(use0, _usage())]
        steal_s = _steal_s() - steal0
        attempted = len(answers)
        if traced:
            rec = trace.record(prof, work)
        else:
            # the card time a frame costs: the compute of a bounded
            # number of requests traced after the window
            prof, n_failed = _profile(call, batches, answers, [],
                                      int(mix["card_requests"]), device)
            failed += n_failed
            card = trace.record(prof, work)
            if not card["requests"]:
                raise RuntimeError("the profile after the window recorded "
                                   "no request")
            card_ms = (trace.busy_s(card, trace.COMPUTE_CATS) * 1e3
                       / (bsz * len(card["requests"])))
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        del predict, call
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the check: every answer of the window against the reference's
        t_check = time.perf_counter()
        want, cand, rule = reference_answers(inp, device)
        checks, numbers = check(answers, want, cand, rule, limits)
        dets = [len(p) for w in want for _, p in w]
        n_req = max(attempted, 1)
        log(f"window: {attempted} requests in {window_s:.3f} s ("
            f"{stats.rate(bsz * attempted, window_s):.2f} frames/s); raw "
            f"points a frame {min(len(p) for p, _ in inp.drive)}-"
            f"{max(len(p) for p, _ in inp.drive)}; reference detections a "
            f"frame {min(dets)}-{max(dets)}; latency ms p10/50/90/95/max "
            + "/".join(f"{stats.percentile(lat, q) * 1e3:.1f}"
                       for q in (10, 50, 90, 95, 100))
            + f"; a request: user {use[0] / n_req * 1e3:.2f} ms, system "
            f"{use[1] / n_req * 1e3:.2f} ms, minor faults "
            f"{use[2] / n_req:.0f}; machine steal {steal_s:.3f} s"
            + f"; the check took {time.perf_counter() - t_check:.3f} s"
            + "; detections " + ", ".join(f"{k} {v:g}"
                                           for k, v in numbers.items()))
        out = {
            "attempted": attempted, "failed": failed,
            "reference_detections": sum(dets),
            "correct": bool(attempted and not failed
                            and compare.passed(checks)),
            "checks": checks,
            "e2e": {"peak_mem_mib": window_peak / 2 ** 20,
                    "setup_s": setup_s},
            "device": {"memory_peak_bytes": int(max(setup_peak,
                                                    window_peak))},
            "window_s": window_s,
        }
        if not traced:
            out["e2e"]["card_ms_per_frame"] = card_ms
        if keep:
            first = {i % len(batches): a for i, a in
                     reversed(list(enumerate(answers))) if a is not None}
            out["kept"] = {"inputs": inp, "want": want, "cand": cand,
                           "answers": [first.get(i) for i in
                                       range(len(batches))]}
        if traced:
            rec.update(_record_extras(inp, device))
            out["record"] = rec
            log(f"reference flops per frame {rec['flops_per_frame']!r}")
            out["breakdown"] = trace.breakdown(rec)
            out["device"].update(busy_s=trace.busy_s(rec),
                                 window_s=(trace.window(rec)[1]
                                           - trace.window(rec)[0]) / 1e6)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _closed_loop(call, batches, answers: List[Any], lat: List[float],
                 until: Optional[float] = None, count: Optional[int] = None,
                 span: Optional[str] = None) -> int:
    """One client: it calls on the next batch as soon as its last
    answers are in hand, until the clock passes ``until`` or ``count``
    more requests were made. Request i takes batch ``i % len(batches)``;
    its answers (None where it failed) and latency land at index i.
    Returns the number that failed."""
    from torch.profiler import record_function
    first, failed = len(answers), 0
    while not ((until is not None and time.perf_counter() >= until)
               or (count is not None and len(answers) >= first + count)):
        i = len(answers)
        t_req = time.perf_counter()
        try:
            with record_function(span) if span else contextlib.nullcontext():
                out = call(batches[i % len(batches)])
        except RuntimeError as err:
            log(f"request {i} failed: {err!r}")
            out = None
            failed += 1
        lat.append(time.perf_counter() - t_req)
        answers.append(out)
    return failed


def _profile(call, batches, answers, lat, n: int, device):
    """``n`` requests under ``torch.profiler``, each in the benchmark's
    request span; their answers join the run's. Returns the profiler (its
    events are read later, out of the window) and the number that
    failed."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        failed = _closed_loop(call, batches, answers, lat, count=n,
                              span=trace.REQUEST_SPAN)
        _sync(device)
    return prof, failed


def _record_extras(inp: Inputs, device):
    """What the readers need beside the trace: the frames a request, the
    reference's FLOPs per frame at the cell's shapes, the card's peaks and
    the family's sizes (``reference/<family>.py::sizes``)."""
    from torch.utils.flop_counter import FlopCounterMode
    ref = inp.ref
    net = ref.build(inp.ref_cfg, inp.state, device)
    counter = FlopCounterMode(display=False)
    with counter:
        ref.detect(net, inp.batches[0], inp.batch, inp.score_threshold)
    del net
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {
        "frames_per_request": inp.batch,
        "flops_per_frame": counter.get_total_flops() / inp.batch,
        "peaks": peaks.of(kind),
        "sizes": ref.sizes(inp.ref_cfg, inp.batch),
    }
