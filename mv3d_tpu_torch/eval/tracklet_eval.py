"""Tracklet-vs-tracklet 3D detection scoring.

Port of ``mv3d_tpu/eval/tracklet_eval.py`` (host numpy; its CSVs equal the
JAX package's byte for byte):

  * per-frame greedy matching of gt <-> predicted obstacles by descending
    yaw-aware 3D IoU (same object type only);
  * per-class volume IoU aggregated over all frames -> ``iou_per_obj.csv``;
  * precision/recall at IoU thresholds 0.1..0.8 -> ``pr_per_iou.csv``;
  * ``"box"`` (oriented box) and ``"sphere"`` volume methods.

The polygon intersection is the Sutherland-Hodgman clip of
:mod:`mv3d_tpu_torch.ops.boxes3d`.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.tracklets import Tracklet, parse_tracklets
from ..ops.boxes3d import _polygon_area, _polygon_clip

IOU_THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8)


def _lwh_to_box(l, w, h):
    return np.array([
        [-l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2],
        [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2],
        [-h / 2, -h / 2, -h / 2, -h / 2, h / 2, h / 2, h / 2, h / 2]])


class _Obs:
    """One obstacle of one frame: type, size, position and yaw."""

    def __init__(self, tracklet_idx, object_type, size, position, yaw):
        self.tracklet_idx = tracklet_idx
        self.object_type = object_type
        self.h, self.w, self.l = size
        self.position = np.asarray(position, np.float64)
        self.yaw = yaw
        self._bbox = None

    def bbox(self):
        if self._bbox is None:
            b = _lwh_to_box(self.l, self.w, self.h)
            c, s = np.cos(self.yaw), np.sin(self.yaw)
            rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            self._bbox = rot @ b + self.position[:, None]
        return self._bbox

    def vol_box(self):
        return self.h * self.w * self.l

    def vol_sphere(self):
        r = max(self.h, self.w, self.l) / 2
        return 4 / 3.0 * np.pi * r ** 3

    def vol(self, method):
        return self.vol_sphere() if method == "sphere" else self.vol_box()

    def iou(self, other, method="box"):
        if method == "sphere":
            return self._iou_sphere(other)
        return self._iou_box(other)

    def _iou_box(self, other):
        a, b = self.bbox(), other.bbox()
        z_int = max(0.0, min(a[2].max(), b[2].max()) -
                    max(a[2].min(), b[2].min()))
        if z_int == 0:
            return 0.0, 0.0
        xy_int = _polygon_area(_polygon_clip(a[0:2, 0:4].T, b[0:2, 0:4].T))
        if xy_int == 0:
            return 0.0, 0.0
        inter = z_int * xy_int
        union = self.vol_box() + other.vol_box() - inter
        return inter / union, inter

    def _iou_sphere(self, other):
        ra = max(self.h, self.w, self.l) / 2
        rb = max(other.h, other.w, other.l) / 2
        dist = float(np.linalg.norm(self.position - other.position))
        if dist >= ra + rb:
            return 0.0, 0.0
        if dist <= abs(ra - rb):
            inter = 4 / 3.0 * np.pi * min(ra, rb) ** 3
        else:
            inter = (ra + rb - dist) ** 2
            inter *= (dist ** 2 + 2 * dist * (ra + rb) - 3 * (ra - rb) ** 2)
            inter *= np.pi / (12 * dist)
        union = self.vol_sphere() + other.vol_sphere() - inter
        return inter / union, inter


def _generate_obstacles(tracklets: Sequence[Tracklet], override_size=None):
    for ti, t in enumerate(tracklets):
        for i, p in enumerate(t.poses):
            size = (override_size if override_size is not None
                    else (t.h, t.w, t.l))
            yield t.first_frame + i, _Obs(
                ti, t.object_type, size,
                (p["tx"], p["ty"], p["tz"]), p["rz"])


def _score_frame(gt_obs, pred_obs, inter_count, union_count, pr_at_ious,
                 method):
    """Greedy matching of one frame's obstacles by descending IoU; adds the
    matched intersections and every union to the per-class counters and
    the TP/FP/FN counts at each threshold."""
    intersections = []
    fn = set(range(len(gt_obs)))
    fp = set(range(len(pred_obs)))
    for p_idx, p in enumerate(pred_obs):
        for g_idx, g in enumerate(gt_obs):
            if p.object_type == g.object_type:
                iou_val, inter_vol = g.iou(p, method)
                if iou_val > 0:
                    intersections.append((iou_val, inter_vol, p_idx, g_idx))
    intersections.sort(key=lambda x: x[0], reverse=True)
    for iou_val, inter_vol, p_idx, g_idx in intersections:
        if g_idx in fn and p_idx in fp:
            fn.remove(g_idx)
            fp.remove(p_idx)
            obs = gt_obs[g_idx]
            inter_count[obs.object_type] += inter_vol
            union_count[obs.object_type] += (
                obs.vol(method) + pred_obs[p_idx].vol(method) - inter_vol)
            for thr in pr_at_ious:
                if iou_val > thr:
                    pr_at_ious[thr]["TP"] += 1
                else:
                    pr_at_ious[thr]["FP"] += 1
                    pr_at_ious[thr]["FN"] += 1
    for g_idx in fn:
        union_count[gt_obs[g_idx].object_type] += gt_obs[g_idx].vol(method)
        for thr in pr_at_ious:
            pr_at_ious[thr]["FN"] += 1
    for p_idx in fp:
        union_count[pred_obs[p_idx].object_type] += pred_obs[p_idx].vol(
            method)
        for thr in pr_at_ious:
            pr_at_ious[thr]["FP"] += 1


def tracklet_score(pred_file: str, gt_file: str,
                   output_dir: Optional[str] = None,
                   volume_method: str = "sphere",
                   filter_indices: Optional[Sequence[int]] = None,
                   override_lwh_with_gt: bool = False) -> Dict:
    """Score predicted vs ground-truth tracklet XMLs.

    Returns {'iou_per_obj': {class: iou, 'All': mean}, 'pr_per_iou':
    {thr: {'precision': p, 'recall': r}}} and, with ``output_dir``, writes
    ``iou_per_obj.csv`` and ``pr_per_iou.csv`` there.
    """
    assert volume_method in ("box", "sphere")
    pred = parse_tracklets(pred_file)
    gt = parse_tracklets(gt_file)
    if not gt:
        raise ValueError("no ground-truth tracklets")

    num_frames = 0
    for t in list(gt) + list(pred):
        num_frames = max(num_frames, t.first_frame + t.n_frames)
    eval_indices = (list(filter_indices) if filter_indices is not None
                    else list(range(num_frames)))
    eval_set = set(eval_indices)

    frames: Dict[int, Dict[str, List[_Obs]]] = {
        i: {"gt": [], "pred": []} for i in eval_indices}
    for fi, obs in _generate_obstacles(gt):
        if fi in eval_set:
            frames[fi]["gt"].append(obs)
    gt_size = (gt[0].h, gt[0].w, gt[0].l) if override_lwh_with_gt else None
    for fi, obs in _generate_obstacles(pred, override_size=gt_size):
        if fi in eval_set:
            frames[fi]["pred"].append(obs)

    pr_at_ious = {k: Counter() for k in IOU_THRESHOLDS}
    inter_count: Counter = Counter()
    union_count: Counter = Counter()
    for i in eval_indices:
        _score_frame(frames[i]["gt"], frames[i]["pred"], inter_count,
                     union_count, pr_at_ious, volume_method)

    results = {"iou_per_obj": {}, "pr_per_iou": {}}
    iou_sum = 0.0
    for k in inter_count:
        iou = inter_count[k] / union_count[k] if union_count[k] else 0.0
        results["iou_per_obj"][k] = float(iou)
        iou_sum += iou
    results["iou_per_obj"]["All"] = (
        float(iou_sum / len(inter_count)) if inter_count else 0.0)
    for k, v in pr_at_ious.items():
        p = v["TP"] / (v["TP"] + v["FP"]) if v["TP"] else 0.0
        r = v["TP"] / (v["TP"] + v["FN"]) if v["TP"] else 0.0
        results["pr_per_iou"][k] = {"precision": p, "recall": r}

    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "iou_per_obj.csv"), "w") as f:
            f.write("object_type,iou\n")
            for k, v in sorted(results["iou_per_obj"].items()):
                f.write(f"{k},{v}\n")
        with open(os.path.join(output_dir, "pr_per_iou.csv"), "w") as f:
            f.write("iou_threshold,p,r\n")
            for k, v in sorted(results["pr_per_iou"].items()):
                f.write(f"{k},{v['precision']},{v['recall']}\n")
    return results
