"""The port's evaluation modules against the JAX package's: the tracklet
3D-IoU scorer (``eval/tracklet_eval.py``) and the KITTI txt export
(``eval/kitti_export.py``).

Tolerances: the scorer's results are equal and its CSVs equal byte for
byte (both are host float64 numpy on the same parsed XML); the KITTI lines
are equal as strings (the camera transform and the rgb projection are f32
on both sides; a field whose last printed digit moved by f32 rounding
would be a recorded deviation, and none does on these boxes).
"""

import os

import numpy as np
import pytest
import torch

from mv3d_tpu.config import kitti_config
from mv3d_tpu.data import tracklets as jtracklets
from mv3d_tpu.eval import kitti_export as jexport
from mv3d_tpu.eval import tracklet_eval as jeval
from mv3d_tpu_torch.data import kitti as tkitti
from mv3d_tpu_torch.data import tracklets as ttracklets
from mv3d_tpu_torch.eval import kitti_export, tracklet_eval
from mv3d_tpu_torch.ops import boxes3d as tb3

from test_torch_config import to_port_config

CFG = kitti_config()
PCFG = to_port_config(CFG)


def _tracks(offsets=(0.0, 0.0), yaw=0.3, frames=5):
    ts = []
    for dy in (0.0, 6.0):
        t = jtracklets.Tracklet("Car", h=1.5, w=1.6, l=4.0, first_frame=0)
        for i in range(frames):
            t.poses.append({"tx": 10.0 + i + offsets[0],
                            "ty": dy + offsets[1], "tz": -0.9,
                            "rx": 0.0, "ry": 0.0, "rz": yaw})
        ts.append(t)
    return ts


def _spurious():
    t = jtracklets.Tracklet("Car", 1.5, 1.6, 4.0, first_frame=0)
    t.poses.append({"tx": 100.0, "ty": 50.0, "tz": 0.0,
                    "rx": 0, "ry": 0, "rz": 0})
    return [t]


def _partial():
    """Shifted and rotated predictions on some frames only, one extra
    class, a prediction past the gt's last frame."""
    ts = _tracks((0.7, 0.3), yaw=0.5, frames=3)
    van = jtracklets.Tracklet("Van", 2.0, 1.9, 5.0, first_frame=2)
    van.poses.append({"tx": 12.0, "ty": 0.5, "tz": -0.9,
                      "rx": 0, "ry": 0, "rz": 0.2})
    late = jtracklets.Tracklet("Car", 1.5, 1.6, 4.0, first_frame=7)
    late.poses.append({"tx": 9.0, "ty": 1.0, "tz": -0.9,
                       "rx": 0, "ry": 0, "rz": 0.0})
    return ts + [van, late]


CASES = {
    "perfect": (_tracks, "box", None),
    "shifted": (lambda: _tracks((1.0, 0.5)), "box", None),
    "sphere": (_tracks, "sphere", None),
    "sphere_shifted": (lambda: _tracks((0.8, 0.2)), "sphere", None),
    "missed_and_spurious": (_spurious, "box", None),
    "partial_filtered": (_partial, "box", [0, 1, 2, 3, 7]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracklet_score_matches_jax_csvs_byte_for_byte(tmp_path, case):
    """The perfect, shifted, sphere and missed/spurious cases of
    tests/test_eval.py, plus a shifted sphere case and a partial one with
    a second class, a late frame and ``filter_indices``: the port's
    results equal JAX's, and both CSVs equal byte for byte."""
    make_pred, method, filt = CASES[case]
    gt = str(tmp_path / "gt.xml")
    pred = str(tmp_path / "pred.xml")
    jtracklets.write_tracklets(gt, _tracks())
    jtracklets.write_tracklets(pred, make_pred())
    want = jeval.tracklet_score(pred, gt, output_dir=str(tmp_path / "jax"),
                                volume_method=method, filter_indices=filt)
    got = tracklet_eval.tracklet_score(pred, gt,
                                       output_dir=str(tmp_path / "port"),
                                       volume_method=method,
                                       filter_indices=filt)
    assert got == want
    for name in ("iou_per_obj.csv", "pr_per_iou.csv"):
        with open(tmp_path / "jax" / name, "rb") as a, \
                open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read(), name
    if case == "perfect":
        assert got["iou_per_obj"]["Car"] == pytest.approx(1.0)
    if case == "missed_and_spurious":
        assert got["iou_per_obj"]["All"] == 0.0


def test_tracklet_score_reads_the_ports_xml(tmp_path):
    """Tracklets written by the port's writer score as JAX's do, and an
    empty gt file raises as in JAX."""
    gt, pred = str(tmp_path / "gt.xml"), str(tmp_path / "pred.xml")
    ttracklets.write_tracklets(gt, [ttracklets.Tracklet(**vars(t))
                                    for t in _tracks()])
    jtracklets.write_tracklets(pred, _tracks((0.5, 0.1)))
    assert tracklet_eval.tracklet_score(pred, gt, volume_method="box") == \
        jeval.tracklet_score(pred, gt, volume_method="box")
    ttracklets.write_tracklets(gt, [])
    with pytest.raises(ValueError):
        tracklet_eval.tracklet_score(pred, gt)


def _boxes(rng, k):
    """k composed lidar boxes in front of the camera, some partly out of
    the image."""
    t = np.stack([rng.uniform(5, 60, k), rng.uniform(-20, 20, k),
                  rng.uniform(-2.0, -0.5, k)], 1)
    s = np.stack([rng.uniform(1.3, 1.8, k), rng.uniform(1.4, 1.9, k),
                  rng.uniform(3.2, 4.8, k)], 1)
    r = np.stack([np.zeros(k), np.zeros(k), rng.uniform(-np.pi, np.pi, k)],
                 1)
    return tb3.box3d_compose(t, s, r, PCFG).numpy(), \
        rng.rand(k).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kitti_lines_match_jax(seed):
    """``detection_to_kitti_lines`` on 12 boxes (sorted by score, with and
    without ``top_k``): the port's strings equal JAX's."""
    boxes, probs = _boxes(np.random.RandomState(seed), 12)
    for top_k in (None, 5):
        want = jexport.detection_to_kitti_lines(boxes, probs, CFG,
                                                top_k=top_k)
        got = kitti_export.detection_to_kitti_lines(boxes, probs, PCFG,
                                                    top_k=top_k)
        assert len(got) == (top_k or 12)
        assert got == want


def test_kitti_export_files_match_jax_and_round_trip(tmp_path):
    """``export_kitti_detections`` writes JAX's files (an empty frame as
    an empty file), and a line parses back to its box."""
    boxes, probs = _boxes(np.random.RandomState(3), 4)
    dets = {"000001": (boxes, probs),
            "000002": (np.zeros((0, 8, 3), np.float32),
                       np.zeros(0, np.float32))}
    jexport.export_kitti_detections(dets, str(tmp_path / "jax"), CFG)
    kitti_export.export_kitti_detections(dets, str(tmp_path / "port"), PCFG)
    for tag in dets:
        with open(tmp_path / "jax" / f"{tag}.txt", "rb") as a, \
                open(tmp_path / "port" / f"{tag}.txt", "rb") as b:
            assert a.read() == b.read(), tag
    box = tb3.box3d_compose([20.0, 3.0, -1.2], [1.5, 1.6, 4.1],
                            [0.0, 0.0, 0.4], PCFG).numpy()[None]
    lines = kitti_export.detection_to_kitti_lines(
        box, np.array([0.9], np.float32), PCFG)
    back, _ = tkitti.kitti_label_to_lidar_box3d(lines, "Car",
                                                positive_only=False,
                                                cfg=PCFG)
    t0, s0, r0 = tb3.boxes3d_decompose(torch.from_numpy(box), PCFG)
    t1, s1, r1 = tb3.boxes3d_decompose(torch.from_numpy(back), PCFG)
    np.testing.assert_allclose(t1.numpy(), t0.numpy(), atol=0.02)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), atol=0.01)
    dyaw = abs(((r1[0, 2] - r0[0, 2]).item() + np.pi / 2) % np.pi
               - np.pi / 2)
    assert dyaw < 0.01
