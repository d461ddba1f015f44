"""The port's testers, debugging and debug drawing against the JAX
package's: ``PredictorForTest``, ``TesterRPNTarget``, ``TesterRPN`` and
``Tester3DOP`` on the same views and converted weights; ``debug_dump``
and ``debug_mode``; ``dump_debug_images`` and ``utils/viz`` against JAX's
PIL drawing.

Tolerances (f32 compute on both sides, as tests/test_torch_slice.py):
masks and counts exact, boxes3d and rois within atol 1e-3, probs, scores
and the heatmap within atol 1e-4; target masks exact (the same uniform
draws); ``debug_dump`` minima and maxima as JAX prints them, means within
rtol 1e-4 (summation order); pixels equal.
"""

import ast
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from __graft_entry__ import _tiny_config
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.train import trainer as jtrainer
from mv3d_tpu.utils import metrics as jmetrics
from mv3d_tpu.utils import viz as jviz
from mv3d_tpu_torch import serving_config
from mv3d_tpu_torch.data import loader as tloader
from mv3d_tpu_torch.ops import boxes3d as tb3
from mv3d_tpu_torch.ops import voxelize as tvox
from mv3d_tpu_torch.train import trainer as ttrainer
from mv3d_tpu_torch.utils import metrics, viz

from test_torch_config import to_port_config
from test_torch_models import randomize_bn

torch.set_num_threads(2)

CFG = dataclasses.replace(_tiny_config(), model=dataclasses.replace(
    _tiny_config().model, compute_dtype="float32"))
PCFG = to_port_config(CFG)
THRESH = 0.05


@pytest.fixture(scope="module")
def variables():
    return randomize_bn(jax.jit(JaxMV3DNet(CFG).init_variables)(
        jax.random.PRNGKey(0)), seed=5)


@pytest.fixture(scope="module")
def frame():
    """One synthetic frame's hwc views (the port's plain voxelizer, equal
    to the numpy oracle), rgb and gt."""
    drive = chip_smoke.SynthDrive(np.random.RandomState(3), PCFG, 1, 3000,
                                  cars=(2, 3))
    b = tloader.frames_to_batch(drive.frames, PCFG)
    pts, num = torch.from_numpy(b["points"]), torch.from_numpy(
        b["num_points"])
    top = tvox.lidar_to_top_batch(pts, PCFG, num)[0].numpy()
    front = tvox.lidar_to_front_batch(pts, PCFG, num)[0].numpy()
    return {"top": top, "front": front, "rgb": b["rgb"][0],
            "gt": drive.frames[0].gt_boxes3d,
            "labels": drive.frames[0].gt_labels}


def _jax(cls, variables, tmp_path, **kw):
    obj = cls(CFG, log_tag="j", checkpoint_dir=str(tmp_path / "jck"),
              log_dir=str(tmp_path / "jlog"), **kw)
    obj.variables = variables
    return obj


def _port(cls, variables, tmp_path, **kw):
    return cls(PCFG, log_tag="p", checkpoint_dir=str(tmp_path / "pck"),
               log_dir=str(tmp_path / "plog"), device="cpu",
               variables=variables, **kw)


def _pixels(path):
    return np.asarray(Image.open(path))


def test_predictor_for_test_matches_jax(tmp_path, variables, frame):
    """Main and twin-head detections and the proposals drawn equal JAX's;
    ``dump_log`` writes JAX's pixels for the same arrays."""
    j = _jax(jtrainer.PredictorForTest, variables, tmp_path, load=False)
    p = _port(ttrainer.PredictorForTest, variables, tmp_path, load=False)
    args = (frame["top"], frame["front"], frame["rgb"])
    jb, _, jp = j(*args, nms_threshold=THRESH, gt_boxes3d=frame["gt"])
    pb, labels, pp = p(*args, nms_threshold=THRESH, gt_boxes3d=frame["gt"])
    assert labels == [] and len(jb) >= 1 and len(pb) == len(jb)
    np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-4)
    for head in ("_with_rgb", "_without_rgb"):
        np.testing.assert_allclose(getattr(p, "boxes3d" + head),
                                   getattr(j, "boxes3d" + head), atol=1e-3)
        np.testing.assert_allclose(getattr(p, "probs" + head),
                                   getattr(j, "probs" + head), atol=1e-4)
        np.testing.assert_array_equal(getattr(p, "boxes3d" + head), pb)
    assert p._last["proposals"].shape == j._last["proposals"].shape
    np.testing.assert_allclose(p._last["proposals"], j._last["proposals"],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(p._last["top"], frame["top"])
    d = p.dump_log("probe", 4)
    want = jmetrics.dump_debug_images(
        str(tmp_path / "want"), 4, p._last["top"], rgb=p._last["rgb"],
        gt_boxes3d=p._last["gt_boxes3d"], det_boxes3d=p._last["boxes3d"],
        proposals=p._last["proposals"], cfg=CFG)
    for name in ("top.png", "camera.png"):
        np.testing.assert_array_equal(_pixels(os.path.join(d, name)),
                                      _pixels(os.path.join(want, name)))


@pytest.mark.parametrize("seed", [0, 1])
def test_rpn_target_tester_matches_jax(tmp_path, variables, frame, seed):
    """On JAX's own draws (PRNGKey(seed) split into the positive and
    negative picks) the port's tester samples the same anchors, reports
    the same counts and draws the same PNG; on its own seeded draws it
    samples the same counts."""
    j = _jax(jtrainer.TesterRPNTarget, variables, tmp_path)
    p = _port(ttrainer.TesterRPNTarget, variables, tmp_path)
    k_pos, k_neg = jax.random.split(jax.random.PRNGKey(seed))
    a = CFG.num_anchors
    noise = {"rpn_pos": np.array(jax.random.uniform(k_pos, (a,))),
             "rpn_neg": np.array(jax.random.uniform(k_neg, (a,)))}
    want = j(frame["top"], frame["gt"], frame["labels"], seed=seed)
    got = p(frame["top"], frame["gt"], frame["labels"], noise=noise)
    assert got == want and want[1] > 0
    for k in ("cls_mask", "labels", "pos_mask"):
        np.testing.assert_array_equal(p._last[k], j._last[k])
    assert p.anchors_details() == j.anchors_details()
    np.testing.assert_array_equal(
        _pixels(p.dump_log("rt", seed)), _pixels(j.dump_log("rt", seed)))
    n_sampled, n_pos = p(frame["top"], frame["gt"], frame["labels"],
                         seed=seed)
    assert (n_sampled, n_pos) == want


def test_rpn_tester_matches_jax(tmp_path, variables, frame):
    j = _jax(jtrainer.TesterRPN, variables, tmp_path, load=False)
    p = _port(ttrainer.TesterRPN, variables, tmp_path, load=False)
    jr, js, jh = j(frame["top"])
    pr, ps, ph = p(frame["top"])
    assert pr.shape == jr.shape and pr.shape[1] == 5 and len(jr) > 1
    np.testing.assert_allclose(pr, jr, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ps, js, rtol=0, atol=1e-4)
    assert ph.shape == jh.shape == CFG.top_feature_shape()[:2] + (
        2 * len(CFG.model.bases),)
    np.testing.assert_allclose(ph, jh, rtol=0, atol=1e-4)


def test_3dop_tester_matches_jax(tmp_path, variables, frame):
    j = _jax(jtrainer.Tester3DOP, variables, tmp_path, load=False)
    p = _port(ttrainer.Tester3DOP, variables, tmp_path, load=False)
    rois3d = np.concatenate([frame["gt"], tb3.box3d_compose(
        [[6.0 + 2 * i, 0.5 * i, -1.5] for i in range(4)],
        [[1.5, 1.6, 4.0]] * 4, [[0, 0, 0.1 * i] for i in range(4)],
        PCFG).numpy()]).astype(np.float32)
    args = (frame["top"], frame["front"], frame["rgb"], rois3d)
    jp, jb = j(*args, score_threshold=0.0)
    pp, pb = p(*args, score_threshold=0.0)
    assert pb.shape[1:] == (8, 3) and len(pb) == len(jb) >= 1
    np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-3)


def test_testers_take_the_s2d2p_pair(tmp_path):
    """In the served ``s2d2p`` layout the testers take the (heights, aux)
    pair: ``PredictorForTest`` detects what ``MV3D.predict`` does and
    draws the heights plane, ``TesterRPN`` proposes what the inference
    forward proposes, ``TesterRPNTarget`` draws the heights plane."""
    cfg = serving_config(PCFG)
    drive = chip_smoke.SynthDrive(np.random.RandomState(4), cfg, 1, 3000)
    b = tloader.frames_to_batch(drive.frames, cfg)
    pts, num = torch.from_numpy(b["points"]), torch.from_numpy(
        b["num_points"])
    top = tvox.lidar_to_top_batch(pts, cfg, num)
    kw = dict(log_tag="s", checkpoint_dir=str(tmp_path / "c"),
              log_dir=str(tmp_path / "l"), device="cpu", seed=2)
    pft = ttrainer.PredictorForTest(cfg, load=False, **kw)
    boxes, _, probs = pft(top, None, b["rgb"], nms_threshold=THRESH)
    want = ttrainer.first_frame(ttrainer.MV3D(cfg, **kw).predict(
        top, None, b["rgb"], score_threshold=THRESH))
    np.testing.assert_array_equal(boxes, want[0])
    np.testing.assert_array_equal(probs, want[1])
    assert pft._last["top"].shape == top[0].shape[1:]
    assert os.path.exists(os.path.join(pft.dump_log("pair", 0), "top.png"))
    rpn = ttrainer.TesterRPN(cfg, load=False, **kw)
    rois, _, _ = rpn(top)
    with torch.no_grad():
        _, props = rpn.model.forward_inference(top, torch.from_numpy(
            b["rgb"]), None, score_threshold=THRESH)
    np.testing.assert_array_equal(
        rois, props.rois[0].numpy()[props.mask[0].numpy()])
    rt = ttrainer.TesterRPNTarget(cfg, **kw)
    assert rt(top, drive.frames[0].gt_boxes3d, drive.frames[0].gt_labels
              )[1] > 0
    assert os.path.exists(rt.dump_log("pair"))


def _stats(path):
    """(numel, min, max) -> (mean, nan, inf) per line of a dump."""
    out = []
    for line in open(path):
        shape = line[line.index("("):line.index(")") + 1]
        f = dict(kv.split("=") for kv in line.split() if "=" in kv)
        numel = int(np.prod(ast.literal_eval(shape)))
        out.append(((numel, f["min"], f["max"]), float(f["mean"]),
                    int(f["nan"]), int(f["inf"])))
    return sorted(out)


def test_debug_dump_matches_jax(tmp_path, variables):
    """Per-array statistics of the same weights: one line per JAX array
    (no ``num_batches_tracked``), the same minima and maxima as printed,
    means within rtol 1e-4, no NaN or infinity."""
    j = jtrainer.MV3D(CFG, log_tag="j", checkpoint_dir=str(tmp_path / "c"),
                      log_dir=str(tmp_path / "jl"))
    j.variables = variables
    p = _port(ttrainer.MV3D, variables, tmp_path)
    want, got = _stats(j.debug_dump()), _stats(p.debug_dump())
    assert p.debug_dump() == str(tmp_path / "plog" / "debug" /
                                 "p_weights.txt")
    assert len(got) == len(want) > 50
    for (gk, gm, gn, gi), (wk, wm, wn, wi) in zip(got, want):
        assert gk == wk and (gn, gi) == (wn, wi) == (0, 0)
        assert gm == pytest.approx(wm, rel=1e-4, abs=1e-6)
    line = open(p.debug_dump()).readline()
    assert line.startswith("front_feature.") and "float32 min=" in line


def _poisoned(variables):
    """The variables with one NaN in the top RPN's ``reduce`` conv."""
    v = jax.tree.map(np.array, variables)
    node = v["top_view_rpn"]["params"]["reduce"]
    while "kernel" not in node:
        node = node[next(k for k in sorted(node) if "Conv" in k)]
    node["kernel"].reshape(-1)[0] = np.nan
    return v


def test_debug_mode_raises_at_the_first_nan_module(tmp_path, variables,
                                                   frame):
    """``debug_mode`` raises ``FloatingPointError`` naming the module whose
    output went non-finite; an instance without it (the same weights)
    predicts NaN quietly: the hooks belong to the instance."""
    bad = _poisoned(variables)
    dbg = _port(ttrainer.MV3D, bad, tmp_path, debug_mode=True)
    with pytest.raises(FloatingPointError, match="top_rpn.reduce"):
        dbg.predict(frame["top"], None, frame["rgb"])
    quiet = _port(ttrainer.MV3D, bad, tmp_path)
    quiet.predict(frame["top"], None, frame["rgb"])
    ok = _port(ttrainer.MV3D, variables, tmp_path, debug_mode=True)
    ok.predict(frame["top"], None, frame["rgb"], score_threshold=THRESH)
    assert "nan=1 " in open(dbg.debug_dump()).read()


@pytest.fixture
def batch():
    drive = chip_smoke.SynthDrive(np.random.RandomState(2), PCFG, 1, 3000,
                                  cars=(2, 2))
    b = tloader.frames_to_batch(drive.frames, PCFG)
    return {k: v for k, v in b.items() if k != "tags"}


class _Fixed:
    def __init__(self, batch):
        self.batch = batch

    def load(self):
        return self.batch


def test_debug_mode_checks_the_backward_in_the_step(tmp_path, monkeypatch,
                                                    batch, variables):
    """A step whose loss is finite but whose gradient is NaN (sqrt at 0)
    raises under ``debug_mode`` (anomaly detection around the step) and
    passes quietly without it; anomaly mode is off after either."""
    real = ttrainer.total_loss
    monkeypatch.setattr(ttrainer, "total_loss",
                        lambda *a: torch.sqrt(real(*a) * 0.0))
    kw = dict(cfg=PCFG, device="cpu", variables=variables,
              checkpoint_dir=str(tmp_path / "c"), log_dir=str(tmp_path / "l"))
    dbg = ttrainer.Trainer(_Fixed(batch), debug_mode=True, **kw)
    with pytest.raises(RuntimeError, match="nan"):
        dbg.fit_iteration(batch)
    assert not torch.is_anomaly_enabled()
    quiet = ttrainer.Trainer(_Fixed(batch), **kw)
    assert np.isfinite(list(quiet.fit_iteration(batch).values())).all()
    assert not torch.is_anomaly_enabled()


def test_nan_loss_crash_save_writes_the_debug_dump(tmp_path, batch,
                                                   variables):
    tr = ttrainer.Trainer(_Fixed(batch), cfg=PCFG, device="cpu",
                          variables=_poisoned(variables), log_tag="nan",
                          checkpoint_dir=str(tmp_path / "c"),
                          log_dir=str(tmp_path / "l"))
    with pytest.raises(FloatingPointError, match="NaN loss"):
        tr(max_iter=2)
    tr.close()
    dump = tmp_path / "l" / "debug" / "nan_weights.txt"
    assert "nan=1 " in dump.read_text()
    assert f"stats at {dump}" in (tmp_path / "l" / "log.txt").read_text()
    assert os.listdir(tmp_path / "c" / "nan" / "top_view_rpn")


def test_trainer_dumps_debug_images_on_its_cadence(tmp_path, batch,
                                                   variables):
    """``debug_image_every``: the first frame's hwc top view (voxelized on
    the model's device, equal to the plain view) with gt and detections,
    every that many iterations after the first."""
    tr = ttrainer.Trainer(_Fixed(batch), cfg=PCFG, device="cpu",
                          variables=variables, log_tag="img",
                          checkpoint_dir=str(tmp_path / "c"),
                          log_dir=str(tmp_path / "l"))
    tr.debug_image_every = 2
    tr(max_iter=5)
    tr.close()
    d = tmp_path / "l" / "debug_images" / "img"
    assert sorted(os.listdir(d)) == ["000002", "000004"]
    top = tvox.lidar_to_top_batch(torch.from_numpy(batch["points"][:1]),
                                  PCFG, torch.from_numpy(
                                      batch["num_points"][:1]))[0].numpy()
    gm = batch["gt_mask"][0]
    img = viz.draw_box3d_on_top(viz.draw_top_image(top),
                                batch["gt_boxes3d"][0][gm], cfg=PCFG)
    got = _pixels(d / "000002" / "top.png")
    white = (img == 255).all(-1)
    assert white.any() and (got[white] == 255).all()
    assert _pixels(d / "000002" / "camera.png").shape == \
        batch["rgb"].shape[1:]


def _draw_inputs(seed):
    rng = np.random.RandomState(seed)
    top = rng.rand(*CFG.top_shape).astype(np.float32)
    rgb = (rng.rand(*CFG.rgb_shape) * 300 - 20).astype(np.float32)
    k = 5
    boxes = tb3.box3d_compose(
        np.stack([rng.uniform(2, 18, k), rng.uniform(-7, 7, k),
                  rng.uniform(-2, -1, k)], 1),
        np.stack([rng.uniform(1.3, 1.8, k), rng.uniform(1.4, 1.9, k),
                  rng.uniform(3, 5, k)], 1),
        np.stack([np.zeros(k), np.zeros(k), rng.uniform(-3, 3, k)], 1),
        PCFG).numpy()
    props = np.sort(rng.uniform(-15, 95, (12, 2, 2)), axis=1).reshape(
        12, 4)[:, [0, 2, 1, 3]]
    props[:4] = np.round(props[:4] * 2) / 2
    return top, rgb, boxes[:2], boxes[2:], props.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_debug_images_and_viz_match_jax_pixels(tmp_path, seed):
    """``dump_debug_images`` (PNGs through the port's encoder) and each
    ``viz`` function against JAX's PIL drawing on the same arrays: float
    proposal corners, half-integers, boxes off the image, an rgb beyond
    0-255."""
    top, rgb, gt, det, props = _draw_inputs(seed)
    want = jmetrics.dump_debug_images(str(tmp_path / "j"), seed, top,
                                      rgb=rgb, gt_boxes3d=gt,
                                      det_boxes3d=det, proposals=props,
                                      cfg=CFG)
    got = metrics.dump_debug_images(str(tmp_path / "p"), seed, top, rgb=rgb,
                                    gt_boxes3d=gt, det_boxes3d=det,
                                    proposals=props, cfg=PCFG)
    assert os.path.basename(got) == f"{seed:06d}"
    for name in ("top.png", "camera.png"):
        np.testing.assert_array_equal(_pixels(os.path.join(got, name)),
                                      _pixels(os.path.join(want, name)))
    img = (np.random.RandomState(seed).rand(*CFG.rgb_shape) * 255).astype(
        np.uint8)
    np.testing.assert_array_equal(viz.draw_top_image(top),
                                  jviz.draw_top_image(top))
    np.testing.assert_array_equal(viz.draw_boxes2d(img, props),
                                  jviz.draw_boxes2d(img, props))
    top_img = viz.draw_top_image(top)
    np.testing.assert_array_equal(
        viz.draw_box3d_on_top(top_img, det, cfg=PCFG),
        jviz.draw_box3d_on_top(top_img, det, cfg=CFG))
    np.testing.assert_array_equal(
        viz.draw_rgb_projections(img, np.concatenate([gt, det]), cfg=PCFG),
        jviz.draw_rgb_projections(img, np.concatenate([gt, det]), cfg=CFG))
    assert viz.draw_box3d_on_top(top_img, det[:0], cfg=PCFG) is top_img
