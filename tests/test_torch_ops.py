"""Port parity of the post-trunk ops: the empty-anchor filter, greedy NMS,
RPN proposals, ROI-align, rcnn_nms and the box geometry they use.

Inputs are made with numpy from a seed and go through both packages; the
training targets get the JAX function's own uniform draws.
Tolerances: anchor masks and NMS/proposal indices and masks are exact;
target masks and labels are exact and their regression targets within
atol 1e-5; box encodings and IoUs within atol 1e-6;
boxes within atol 1e-4 (exp/log differ in the last ulp between XLA and
torch); ROI-align within atol 1e-5; image-pixel projections are int32
truncations, compared exactly with the count of moved pixels stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mv3d_tpu.config import kitti_config
from mv3d_tpu.models import mv3d_net as jnet
from mv3d_tpu.ops import anchors as janchors
from mv3d_tpu.ops import boxes as jboxes
from mv3d_tpu.ops import boxes3d as jbox3d
from mv3d_tpu.ops import detect as jdetect
from mv3d_tpu.ops import nms as jnms
from mv3d_tpu.ops import proposal as jproposal
from mv3d_tpu.ops import roi_align as jroi
from mv3d_tpu.train import targets as jtargets
from mv3d_tpu_torch.models import mv3d_net as tnet
from mv3d_tpu_torch.ops import anchors as tanchors
from mv3d_tpu_torch.ops import boxes as tboxes
from mv3d_tpu_torch.ops import boxes3d as tbox3d
from mv3d_tpu_torch.ops import detect as tdetect
from mv3d_tpu_torch.ops import nms as tnms
from mv3d_tpu_torch.ops import proposal as tproposal
from mv3d_tpu_torch.ops import roi_align as troi
from mv3d_tpu_torch.train import targets as ttargets

from test_torch_config import to_port_config

torch.set_num_threads(2)

CFG = _tiny_config()
PCFG = to_port_config(CFG)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_anchor_setup_matches_jax():
    a_j, in_j = janchors.anchor_setup(CFG)
    a_t, in_t = tanchors.anchor_setup(PCFG)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(in_t, in_j)
    kitti = to_port_config(kitti_config())
    assert tanchors.anchor_setup(kitti)[0].shape == (30000, 4)


@pytest.mark.parametrize("threshold", [0.0, 2.0, 5.0])
def test_anchor_mask_matches_jax(rng, threshold):
    """Counts-like occupancy: exact window sums on both sides."""
    h, w = CFG.top.xn, CFG.top.yn
    occ = (rng.poisson(0.05, (2, h, w))
           * (rng.rand(2, h, w) < 0.3)).astype(np.float32)
    bases = janchors.mv3d_car_bases()
    feat = CFG.top_feature_shape()
    want = np.stack([np.asarray(janchors.non_empty_anchor_mask_structured(
        np.zeros((h, w, 1), np.float32), bases, 8, feat, threshold,
        occ=jnp.asarray(o))) for o in occ])
    got = tanchors.non_empty_anchor_mask_structured(
        _t(occ), bases, 8, feat, threshold).numpy()
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)


def _random_boxes(rng, b, k, span=60.0):
    xy = rng.uniform(0, span, (b, k, 2))
    wh = rng.uniform(2, 20, (b, k, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.001, 0.5])
def test_greedy_nms_same_indices(rng, thresh):
    b, k, max_out = 3, 120, 40
    boxes = _random_boxes(rng, b, k)
    # quantized scores: plenty of ties, broken by lowest index on both sides
    scores = np.round(rng.rand(b, k), 1).astype(np.float32)
    valid = rng.rand(b, k) < 0.8
    idx, mask = tnms.greedy_nms(_t(boxes), _t(scores), _t(valid), thresh,
                                max_out)
    for i in range(b):
        ji, jm = jnms.greedy_nms(boxes[i], scores[i], valid[i], thresh,
                                 max_out)
        jm = np.asarray(jm)
        np.testing.assert_array_equal(mask[i].numpy(), jm)
        np.testing.assert_array_equal(idx[i].numpy()[jm], np.asarray(ji)[jm])


@pytest.fixture(scope="module")
def rpn_inputs():
    rng = np.random.RandomState(5)
    anchors, _ = janchors.anchor_setup(CFG)
    a = len(anchors)
    logits = rng.randn(2, a, 2).astype(np.float32)
    logits[:, ::7] = 0.3         # repeated scores, as flat BEV regions give
    scores = np.asarray(jax.nn.softmax(logits, -1))
    deltas = (rng.randn(2, a, 4) * 0.2).astype(np.float32)
    inside = rng.rand(2, a) < 0.9
    return anchors, scores, deltas, inside


def test_rpn_proposals_match_jax(rpn_inputs):
    anchors, scores, deltas, inside = rpn_inputs
    got = tproposal.rpn_proposals(_t(scores), _t(deltas), _t(anchors),
                                  _t(inside), PCFG)
    for i in range(2):
        want = jproposal.rpn_proposals(scores[i], deltas[i], anchors,
                                       inside[i], CFG)
        m = np.asarray(want.mask)
        assert m.sum() > 4
        np.testing.assert_array_equal(got.mask[i].numpy(), m)
        np.testing.assert_allclose(got.rois[i].numpy(), np.asarray(want.rois),
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got.scores[i].numpy(),
                                      np.asarray(want.scores))


def test_roi_align_matches_jax(rng):
    feats = rng.randn(2, 12, 10, 8).astype(np.float32)
    rois = _random_boxes(rng, 2, 9, span=70.0) - 8.0   # some stick out
    rois[0, 0] = [10, 10, 10, 10]                      # malformed -> 1x1
    got = troi.roi_align(_t(feats), _t(rois), 1.0 / 8, (6, 6)).numpy()
    for i in range(2):
        want = np.asarray(jroi.roi_align(feats[i], rois[i], 1.0 / 8, (6, 6)))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5)


def test_rcnn_nms_matches_jax(rng):
    b, r = 2, 16
    centers = rng.uniform([4, -4, -1.5], [14, 4, -1.0], (b, r, 3))
    rois3d = np.stack([np.asarray(jbox3d.box3d_compose(
        centers[i], np.tile([1.5, 1.6, 4.0], (r, 1)),
        np.zeros((r, 3)))) for i in range(b)]).astype(np.float32)
    logits = rng.randn(b, r, 2).astype(np.float32) * 2
    probs = np.asarray(jax.nn.softmax(logits, -1))
    deltas = (rng.randn(b, r, 2, 8, 3) * 0.05).astype(np.float32)
    roi_mask = rng.rand(b, r) < 0.9
    got = tdetect.rcnn_nms(_t(probs), _t(deltas), _t(rois3d), _t(roi_mask),
                           score_threshold=0.3, cfg=PCFG)
    for i in range(b):
        want = jdetect.rcnn_nms(probs[i], deltas[i], rois3d[i], roi_mask[i],
                                score_threshold=0.3, cfg=CFG)
        m = np.asarray(want.mask)
        assert m.sum() > 0
        np.testing.assert_array_equal(got.mask[i].numpy(), m)
        np.testing.assert_allclose(got.boxes3d[i].numpy()[m],
                                   np.asarray(want.boxes3d)[m], atol=1e-5)
        np.testing.assert_allclose(got.probs[i].numpy(),
                                   np.asarray(want.probs), atol=1e-7)


def test_box_lift_and_projections_match_jax(rng):
    boxes = _random_boxes(rng, 1, 64, span=50.0)[0]
    b3 = tbox3d.top_box_to_box3d(_t(boxes), PCFG)
    j3 = np.asarray(jbox3d.top_box_to_box3d(boxes, CFG))
    np.testing.assert_allclose(b3.numpy(), j3, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tbox3d.box3d_to_top_box(_t(j3), PCFG).numpy(),
        np.asarray(jbox3d.box3d_to_top_box(j3, CFG)))
    # image projection truncates to int pixels, where a last-bit
    # difference can move a corner by one: none of these 512 moves
    got = tbox3d.box3d_to_rgb_box(_t(j3), PCFG).numpy()
    want = np.asarray(jbox3d.box3d_to_rgb_box(j3, CFG))
    assert (got != want).sum() == 0
    np.testing.assert_allclose(
        tbox3d.regularise_box3d(_t(j3)).numpy(),
        np.asarray(jbox3d.regularise_box3d(j3)), atol=1e-6)


def test_roi_projections_match_jax(rng):
    """rgb and front ROI envelopes of lifted proposals: int-pixel
    truncations (rgb corners, front atan2), so compared exactly; none of
    these 48 ROIs moves."""
    boxes = _random_boxes(rng, 1, 48, span=50.0)[0]
    j3 = np.asarray(jbox3d.top_box_to_box3d(boxes, CFG))
    for name in ("project_to_rgb_roi", "project_to_front_roi"):
        got = getattr(tnet, name)(_t(j3), PCFG).numpy()
        want = np.asarray(getattr(jnet, name)(j3, CFG))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_box_encodings_and_overlaps_match_jax(rng):
    et = _random_boxes(rng, 1, 50, span=60.0)[0]
    gt = _random_boxes(rng, 1, 50, span=60.0)[0]
    np.testing.assert_allclose(
        tboxes.box_transform(_t(et), _t(gt)).numpy(),
        np.asarray(jboxes.box_transform(et, gt)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tboxes.bbox_overlaps(_t(et), _t(gt[:7])).numpy(),
        np.asarray(jboxes.bbox_overlaps(et, gt[:7])), rtol=0, atol=1e-6)
    e3 = np.asarray(jbox3d.top_box_to_box3d(et, CFG))
    g3 = e3 + rng.normal(0, 0.3, e3.shape).astype(np.float32)
    np.testing.assert_allclose(
        tbox3d.box3d_transform(_t(e3), _t(g3)).numpy(),
        np.asarray(jbox3d.box3d_transform(e3, g3)), rtol=0, atol=1e-6)


def _gt_rows(rng, n, g=8, span=70.0):
    boxes = np.zeros((g, 4), np.float32)
    boxes[:n] = _random_boxes(rng, 1, n, span)[0] + [0, 0, 10, 6]
    labels = np.zeros(g, np.int32)
    labels[:n] = 1
    labels[n - 1] = 2 if n > 2 else 1     # a non-car gt the RPN ignores
    return boxes, labels, np.arange(g) < n


@pytest.mark.parametrize("n_gt", [1, 4])
def test_rpn_target_matches_jax(n_gt):
    rng = np.random.RandomState(n_gt)
    anchors, _ = janchors.anchor_setup(CFG)
    a = len(anchors)
    rows = [_gt_rows(rng, n_gt) for _ in range(2)]
    inside = rng.rand(2, a) < 0.8
    keys = jax.random.split(jax.random.PRNGKey(n_gt), 2)
    draws = [[np.asarray(jax.random.uniform(k, (a,)))
              for k in jax.random.split(key)] for key in keys]
    got = ttargets.rpn_target(
        _t(anchors), _t(inside), *(_t(np.stack(x)) for x in zip(*rows)),
        *(_t(np.stack(x)) for x in zip(*draws)), PCFG)
    for i in range(2):
        want = jtargets.rpn_target(anchors, inside[i], *rows[i], keys[i], CFG)
        assert np.asarray(want.pos_mask).sum() > 0
        for k in ("cls_mask", "labels", "pos_mask"):
            np.testing.assert_array_equal(getattr(got, k)[i].numpy(),
                                          np.asarray(getattr(want, k)),
                                          err_msg=k)
        np.testing.assert_allclose(got.targets[i].numpy(),
                                   np.asarray(want.targets), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("rcnn_batch", [32, 16])
def test_fusion_target_matches_jax(rcnn_batch):
    """32 slots > the 24 candidates (dead padding slots), 16 < 24 (the
    top-k cut)."""
    import dataclasses
    cfg = dataclasses.replace(CFG, rcnn=dataclasses.replace(
        CFG.rcnn, batch_size=rcnn_batch))
    rng = np.random.RandomState(rcnn_batch)
    p = cfg.rpn.nms_post_topn
    frames, jaxed = [], []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(3), 2)):
        gt, gl, gm = _gt_rows(rng, 3)
        gt3d = np.asarray(jbox3d.top_box_to_box3d(gt, cfg)) + rng.normal(
            0, 0.2, (8, 8, 3)).astype(np.float32)
        rois = np.zeros((p, 5), np.float32)
        rois[:, 1:] = _random_boxes(rng, 1, p, span=70.0)[0]
        rois[:4, 1:] = gt[[0, 0, 1, 2]] + rng.normal(0, 1.0, (4, 4))
        mask = np.arange(p) < p - 3 * i
        frames.append((rois, mask, gt, gt3d, gl, gm))
        jaxed.append(jtargets.fusion_target(rois, mask, gt, gt3d, gl, gm,
                                            key, cfg))
    draws = [[np.asarray(jax.random.uniform(k, (p + 8,)))
              for k in jax.random.split(key)]
             for key in jax.random.split(jax.random.PRNGKey(3), 2)]
    got = ttargets.fusion_target(*(_t(np.stack(x)) for x in zip(*frames)),
                                 *(_t(np.stack(x)) for x in zip(*draws)),
                                 to_port_config(cfg))
    for i, want in enumerate(jaxed):
        assert np.asarray(want.pos_mask).sum() > 0
        for k in ("mask", "labels", "pos_mask"):
            np.testing.assert_array_equal(getattr(got, k)[i].numpy(),
                                          np.asarray(getattr(want, k)),
                                          err_msg=k)
        for k in ("rois", "rois3d", "targets"):
            np.testing.assert_allclose(getattr(got, k)[i].numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=0, atol=1e-5, err_msg=k)
