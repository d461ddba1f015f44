"""The number that decides ``correct`` for served detections.

Each answer is a frame's live detections: boxes3d (K, 8, 3) in metres and
probs (K,). The program's answer for a frame is held against the
reference's for the same frame: its live detections (``want``) and its
candidates (``cand``), the fusion head's decoded box and probability for
every proposal the final NMS could be offered under another rounding
(``reference/<family>.py::candidates``). The reference computes in f32 and
the program in bf16, so the two round differently, and a random
network's answers move with rounding: a near-tie of the proposal layer or
of the final NMS (threshold ``nms_thresh``: any overlap) goes the other
way here and there, and a detection near the score threshold falls under
it on one side. A sound program's answers are therefore not the
reference's one for one; the number is the share of detections on
either side that the other side does not account for, which a sound
program keeps to a few per cent and the control does not (PERF.md).

Two detections lie ``d`` metres apart, the largest distance of their
matching corners. A detection *accounts for* another where ``d`` is at
most ``ACCOUNT_M`` and their probabilities lie within ``ACCOUNT_P``; a
pair *overlaps* where the final NMS would suppress one with the other
(their top-view boxes, "+1" pixels, as ``ops/nms.greedy_nms``).

  * a program detection is unaccounted for where no reference candidate
    accounts for it (the program answers only what the network computes
    for some proposal), or where another detection of its answer with a
    probability at least its own overlaps it (the final NMS keeps one of
    the two);
  * a reference detection is unaccounted for where no program detection
    accounts for it, nor overlaps it with a probability at most
    ``ACCOUNT_P`` under its own (the program kept the other box of a
    near-tie); one within ``ACCOUNT_P`` of the score threshold is not
    counted at all (the program's may fall under it).

``unaccounted_share`` is the sum of both over every answer a run
compares, over the program's detections and the reference's counted
ones.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np

NAMES = ("unaccounted_share",)
# a detection accounts for another within these: above the gaps of
# almost every sound pair, below those of most of the control's
ACCOUNT_M = 0.1
ACCOUNT_P = 0.02

Answer = Tuple[np.ndarray, np.ndarray]


class Rule(NamedTuple):
    """What the reference's post-processing decides by: the score
    threshold, the final NMS threshold and the top-view grid (``x_min``,
    ``y_min``, ``x_div``, ``y_div``, ``xn``, ``yn``); the family's
    reference gives them (``reference/<family>.py::rule``)."""
    score_threshold: float
    nms_thresh: float
    grid: Dict[str, float]


def _arrays(a: Answer) -> Tuple[np.ndarray, np.ndarray]:
    b, p = a
    return (np.asarray(b, np.float64).reshape(-1, 8, 3),
            np.asarray(p, np.float64).reshape(-1))


def _dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 8, 3) x (M, 8, 3) -> (N, M) largest corner distance, metres."""
    return np.abs(a[:, None] - b[None]).max(axis=(2, 3))


def _top(b: np.ndarray, g: Dict[str, float]) -> np.ndarray:
    """(N, 8, 3) boxes -> (N, 4) enveloping top-view pixel boxes, as
    ``ops/boxes3d.box3d_to_top_box``."""
    xx = g["yn"] - np.floor((b[:, :4, 1] - g["y_min"]) / g["y_div"])
    yy = g["xn"] - np.floor((b[:, :4, 0] - g["x_min"]) / g["x_div"])
    return np.stack([xx.min(1), yy.min(1), xx.max(1), yy.max(1)], axis=1)


def _overlaps(a: np.ndarray, b: np.ndarray, rule: Rule) -> np.ndarray:
    """(N, M): the final NMS would suppress one of each pair with the
    other."""
    ta, tb = _top(a, rule.grid)[:, None], _top(b, rule.grid)[None]
    iw = np.minimum(ta[..., 2], tb[..., 2]) - np.maximum(
        ta[..., 0], tb[..., 0]) + 1.0
    ih = np.minimum(ta[..., 3], tb[..., 3]) - np.maximum(
        ta[..., 1], tb[..., 1]) + 1.0
    inter = np.clip(iw, 0.0, None) * np.clip(ih, 0.0, None)
    area = lambda t: (t[..., 2] - t[..., 0] + 1.0) * (t[..., 3] - t[..., 1]
                                                      + 1.0)
    t = rule.nms_thresh
    return inter * (1.0 + t) > t * (area(ta) + area(tb))


def counts(got: Answer, want: Answer, cand: Answer, rule: Rule
           ) -> Dict[str, float]:
    """One frame's detections (``got``: the program's, ``wanted``: the
    reference's counted ones) and those unaccounted for on each side
    (``got_out``, ``wanted_out``); see the module's docstring."""
    (gb, gp), (wb, wp), (cb, cp) = _arrays(got), _arrays(want), _arrays(cand)
    counted = wp > rule.score_threshold + ACCOUNT_P
    out = {"got": float(len(gb)), "wanted": float(counted.sum()),
           "got_out": 0.0, "wanted_out": float(counted.sum())}
    if not len(gb):
        return out
    explained = np.zeros(len(gb), bool)
    if len(cb):
        explained = ((_dist(gb, cb) <= ACCOUNT_M)
                     & (np.abs(gp[:, None] - cp[None]) <= ACCOUNT_P)).any(1)
    over = _overlaps(gb, gb, rule) & ~np.eye(len(gb), dtype=bool)
    beaten = (over & (gp[None, :] >= gp[:, None])).any(1)
    out["got_out"] = float((~explained | beaten).sum())
    if len(wb):
        accounts = ((_dist(gb, wb) <= ACCOUNT_M)
                    & (np.abs(gp[:, None] - wp[None]) <= ACCOUNT_P))
        rival = _overlaps(gb, wb, rule) & (gp[:, None]
                                           >= wp[None] - ACCOUNT_P)
        out["wanted_out"] = float(
            (~(accounts | rival).any(0) & counted).sum())
    return out


def worst(triples: Sequence[Tuple[Answer, Answer, Answer]], rule: Rule
          ) -> Dict[str, float]:
    """The run's number over ``(got, want, cand)`` answer triples, with
    its parts (the sums of :func:`counts`)."""
    out = {"got": 0.0, "wanted": 0.0, "got_out": 0.0, "wanted_out": 0.0}
    for got, want, cand in triples:
        for k, v in counts(got, want, cand, rule).items():
            out[k] += v
    out["unaccounted_share"] = ((out["got_out"] + out["wanted_out"])
                                / max(out["got"] + out["wanted"], 1.0))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit (the check passes where
    every number is at or under its limit)."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in NAMES}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
