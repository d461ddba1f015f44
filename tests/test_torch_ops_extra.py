"""The JAX package's small host and tensor functions with a port of their
own, against each JAX function on the CPU: ``nms_select``, ``box_vote``,
``greedy_nms_np`` and ``non_max_suppress`` (``ops/nms.py``),
``roi_pool_max`` (``ops/roi_align.py``), ``make_bases`` and
``non_empty_anchor_mask`` (``ops/anchors.py``).

Tolerances: the host numpy functions and the NMS keep sets bit-equal (the
same f32 arithmetic); ``roi_pool_max`` within 1e-6 (a max of the same
taps, each a 4-term f32 sum); the anchor masks equal (integer-valued
views, whose sums are exact in JAX's f32 integral image and in the
port's f64 one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mv3d_tpu.ops import anchors as janchors
from mv3d_tpu.ops import nms as jnms
from mv3d_tpu.ops import roi_align as jroi
from mv3d_tpu_torch.config import kitti_config
from mv3d_tpu_torch.ops import anchors as tanchors
from mv3d_tpu_torch.ops import nms as tnms
from mv3d_tpu_torch.ops import roi_align as troi


def _boxes(rng, k, scale=20.0):
    xy = rng.uniform(0, scale, (k, 2))
    wh = rng.uniform(2, 12, (k, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_select_matches_jax(seed):
    """Batched ``nms_select`` (B=3) against JAX's per frame: kept boxes,
    scores (zero on empty slots) and mask, with ties and dead
    candidates."""
    rng = np.random.RandomState(seed)
    b, k, max_out = 3, 40, 24
    boxes = np.stack([_boxes(rng, k) for _ in range(b)])
    scores = rng.rand(b, k).astype(np.float32)
    scores[:, 5] = scores[:, 6]              # a tie: the lower index wins
    valid = rng.rand(b, k) < 0.8
    got = tnms.nms_select(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(valid), 0.3, max_out)
    for i in range(b):
        want = jnms.nms_select(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                               jnp.asarray(valid[i]), 0.3, max_out)
        m = np.asarray(want[2])
        assert 0 < m.sum() < max_out
        np.testing.assert_array_equal(got[2][i].numpy(), m)
        np.testing.assert_array_equal(got[0][i].numpy()[m],
                                      np.asarray(want[0])[m])
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))


def test_greedy_nms_np_and_box_vote_match_jax():
    rng = np.random.RandomState(2)
    boxes, scores = _boxes(rng, 60), rng.rand(60).astype(np.float32)
    scores[10] = scores[11]
    for t in (0.1, 0.3, 0.7):
        keep = tnms.greedy_nms_np(boxes, scores, t)
        assert keep.dtype == np.int64 and 0 < len(keep) < 60
        np.testing.assert_array_equal(keep, jnms.greedy_nms_np(boxes,
                                                               scores, t))
    dets = np.hstack([boxes, scores[:, None]])
    kept = dets[tnms.greedy_nms_np(boxes, scores, 0.3)]
    got = tnms.box_vote(kept, dets)
    np.testing.assert_array_equal(got, jnms.box_vote(kept, dets))
    assert not np.array_equal(got, kept)
    np.testing.assert_array_equal(tnms.box_vote(kept, np.zeros((0, 5))),
                                  kept)


@pytest.mark.parametrize("vote,cap", [(False, 100), (True, 100),
                                      (False, 7)])
def test_non_max_suppress_matches_jax(vote, cap):
    """3 classes (0 the background), the score gate, greedy NMS per class,
    with and without box voting, and the per-image cap."""
    rng = np.random.RandomState(3)
    n, nc = 50, 3
    boxes = np.concatenate([_boxes(rng, n) for _ in range(nc)], 1)
    scores = rng.rand(n, nc).astype(np.float32)
    got = tnms.non_max_suppress(boxes, scores, nc, 0.3, 0.05, vote, cap)
    want = jnms.non_max_suppress(boxes, scores, nc, 0.3, 0.05, vote, cap)
    assert len(got) == nc and got[0].shape == (0, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    total = sum(len(g) for g in got[1:])
    assert total == 7 if cap == 7 else total > 7


@pytest.mark.parametrize("samples", [2, 4])
def test_roi_pool_max_matches_jax(samples):
    """(B, H, W, C) x (B, R, 4), rois inside, across and outside the map's
    edge, against JAX's per frame."""
    rng = np.random.RandomState(4)
    feats = rng.randn(2, 11, 13, 5).astype(np.float32)
    rois = np.stack([_boxes(rng, 7, scale=100.0) - 10 for _ in range(2)])
    got = troi.roi_pool_max(torch.from_numpy(feats), torch.from_numpy(rois),
                            1 / 8, (3, 4), samples)
    for i in range(2):
        want = jroi.roi_pool_max(jnp.asarray(feats[i]), jnp.asarray(rois[i]),
                                 1 / 8, (3, 4), samples)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)
    mean = troi.roi_align(torch.from_numpy(feats), torch.from_numpy(rois),
                          1 / 8, (3, 4), samples)
    assert (got >= mean - 1e-6).all() and (got > mean).any()


@pytest.mark.parametrize("kw", [{}, dict(base_size=8, ratios=(1, 3),
                                         scales=(2, 5))])
def test_make_bases_matches_jax(kw):
    got = tanchors.make_bases(**kw)
    assert got.shape == (len(kw.get("ratios", (0.5, 1, 2)))
                         * len(kw.get("scales", (8, 16, 32))), 4)
    np.testing.assert_array_equal(got, janchors.make_bases(**kw))


def test_non_empty_anchor_mask_matches_jax_and_the_model_filter():
    """On count-valued views (a KITTI-shaped grid, 3 channels): anchors
    from ``make_bases`` at stride 8 (some sticking out of the map) and
    the model's anchors against JAX's mask, batched. The structured filter
    the model calls equals this mask over the anchors of the truncated
    bases: it adds each base's int-truncated corner to the stride grid,
    where ``make_anchors`` truncates the sum, which moves a corner of a
    base at -0.5 by a cell. So on the model's own anchors the two differ,
    in the JAX package as in the port (counted, equal counts)."""
    rng = np.random.RandomState(5)
    cfg = kitti_config()
    h, w = cfg.top.xn, cfg.top.yn
    view = (rng.rand(2, h, w, 3) < 0.002).astype(np.float32) * \
        rng.randint(1, 5, (2, h, w, 3))
    tv = torch.from_numpy(view)
    feat = cfg.top_feature_shape()
    bases = np.asarray(cfg.model.bases)
    model_anchors, _ = tanchors.anchor_setup(cfg)
    made, _ = tanchors.make_anchors(tanchors.make_bases(8, scales=(1, 2, 4)),
                                    8, (h, w), feat)
    for anchors in (made, model_anchors):
        got = tanchors.non_empty_anchor_mask(tv, anchors)
        for i in range(2):
            want = np.asarray(janchors.non_empty_anchor_mask(
                jnp.asarray(view[i]), jnp.asarray(anchors)))
            np.testing.assert_array_equal(got[i].numpy(), want)
            assert 0 < want.sum() < len(want)
    structured = tanchors.non_empty_anchor_mask_structured(
        tv.sum(-1), bases, cfg.model.rpn_stride, feat)
    trunc, _ = tanchors.make_anchors(np.trunc(bases), cfg.model.rpn_stride,
                                     (h, w), feat)
    assert torch.equal(tanchors.non_empty_anchor_mask(tv, trunc), structured)
    moved = int((tanchors.non_empty_anchor_mask(tv, model_anchors)[0]
                 != structured[0]).sum())
    jax_moved = int((np.asarray(janchors.non_empty_anchor_mask(
        jnp.asarray(view[0]), jnp.asarray(model_anchors)))
        != np.asarray(janchors.non_empty_anchor_mask_structured(
            jnp.asarray(view[0]), bases, cfg.model.rpn_stride,
            feat))).sum())
    assert moved == jax_moved > 0
