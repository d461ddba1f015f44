"""The didi presets in the port against the JAX package, at a tiny didi
grid (``tests/test_e2e_didi.py::tiny_didi_config``: top 120 x 60 x 14 over
x +-12 m, y +-6 m and didi's z range, so the top slice's height value
reaches 1.33; a 96 x 100 camera cropped by 30 + 20 rows), f32 compute:

  * the crop with the center-car hole (top view) and without it (front
    view), against JAX's ``_crop_mask``, on clouds with points on the
    hole's edges;
  * ``lidar_to_top_batch`` in hwc, s2d2 and s2d2p, bit-exact against
    JAX's (its Pallas sweeps in interpret mode), built eagerly;
  * the host's ``crop_pad`` and ``lidar_to_top_aux`` against
    ``mv3d_tpu.native`` (or its numpy fallback), bit-exact;
  * ``CameraModel.project`` and ``distortion_correct`` within 1e-4 px;
  * ``box3d_to_rgb_box``'s didi branch bit-exact: boxes in view, behind
    the camera, with one corner in the image and with a corner on the
    camera plane; the saturating float-to-int32 cast against XLA's;
  * ``MV3D.predict_from_points`` against JAX's ``forward_inference``
    (probs within 1e-4, boxes3d within 1e-3 on live slots, the mask
    exact, as tests/test_torch_slice.py);
  * an exported didi artifact served from disk;
  * port only: a tiny didi drive in the bag converter's layout through
    ``Trainer`` (2 steps, the loader's center-car crop and host aux
    plane), ``cli.tracking --dataset didi --eval``, the XML and the 3D-IoU
    CSVs.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mv3d_tpu import native
from mv3d_tpu.config import didi_config, make_config
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.ops import boxes3d as jbox3d
from mv3d_tpu.ops import projection as jproj
from mv3d_tpu.ops import voxelize as jvox
from mv3d_tpu_torch.cli import tracking
from mv3d_tpu_torch.data import host_aux, tracklets
from mv3d_tpu_torch.data.kitti import KittiRawDataset
from mv3d_tpu_torch.data.loader import BatchLoader
from mv3d_tpu_torch.ops import boxes3d as tbox3d
from mv3d_tpu_torch.ops import projection as tproj
from mv3d_tpu_torch.ops import voxelize as tvox
from mv3d_tpu_torch.serving import export_serving, load_serving
from mv3d_tpu_torch.train.trainer import MV3D, Trainer

from test_torch_config import to_port_config
from test_torch_models import randomize_bn

torch.set_num_threads(2)


def tiny_didi_config():
    cfg = didi_config()
    top = dataclasses.replace(cfg.top, x_min=-12.0, x_max=12.0,
                              y_min=-6.0, y_max=6.0)       # (120, 60, 14)
    front = dataclasses.replace(cfg.front, width=64, height=32)
    rpn = dataclasses.replace(cfg.rpn, nms_pre_topn=200, nms_post_topn=16)
    rcnn = dataclasses.replace(cfg.rcnn, batch_size=32)
    pipe = dataclasses.replace(cfg.pipeline, max_points=4096, max_gt=8)
    model = dataclasses.replace(cfg.model, compute_dtype="float32")
    return dataclasses.replace(cfg, top=top, front=front, rpn=rpn, rcnn=rcnn,
                               pipeline=pipe, model=model, image_width=96,
                               image_height=100, image_crop_top=30,
                               image_crop_bottom=20)


CFG = tiny_didi_config()
PCFG = to_port_config(CFG)
THRESH = 0.05
F32 = np.float32


def with_pipeline(cfg, **kw):
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **kw))


def didi_cloud(rng, n, cfg=CFG):
    """A tricky cloud (crop edges, slice boundaries, duplicates, the top
    slice filled up to z_max) with the capture car's own returns and
    points on the center-car box's edges (|x| = 2.35, |y| = 1.05 in f32)."""
    pts = chip_smoke.make_cloud(rng, 1, n, cfg, tricky=True)[0]
    k = n // 20
    pts[-k:] = np.stack([rng.uniform(-2.6, 2.6, k), rng.uniform(-1.3, 1.3, k),
                         rng.uniform(-1.5, 0.6, k), rng.uniform(0, 1, k)], 1)
    edge = pts[-2 * k:-k]
    q = k // 4
    edge[:q, 0] = F32(4.7 / 2) * rng.choice([-1, 1], q)
    edge[q:2 * q, 1] = F32(2.1 / 2) * rng.choice([-1, 1], q)
    edge[:2 * q, 2] = rng.uniform(-1.5, 0.0, 2 * q)
    edge[2 * q:, 2] = rng.uniform(0.3, 0.7, k - 2 * q)    # the top slice
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.RandomState(3)
    padded = [jvox.pad_points(didi_cloud(rng, n), 4096) for n in (3000, 2400)]
    return (np.stack([p for p, _ in padded]),
            np.array([n for _, n in padded], np.int32))


@pytest.mark.parametrize("view", ["top", "front"])
def test_crop_mask_matches_jax(clouds, view):
    """The top view drops the capture car's box; the front view keeps
    it."""
    batch, num = clouds
    fc = view == "top"
    want = np.stack([np.asarray(jvox._crop_mask(jnp.asarray(p), CFG, n,
                                                filter_center_car=fc))
                     for p, n in zip(batch, num)])
    got = tvox._crop_mask(torch.from_numpy(batch), PCFG,
                          torch.from_numpy(num), filter_center_car=fc).numpy()
    np.testing.assert_array_equal(got, want)
    x, y = batch[..., 0], batch[..., 1]
    hole = (np.abs(x) <= F32(2.35)) & (np.abs(y) <= F32(1.05)) \
        & (np.arange(batch.shape[1]) < num[:, None])
    assert hole.sum() > 100
    assert not got[hole].any() if fc else got[hole].sum() > 50


@pytest.mark.parametrize("layout", ["hwc", "s2d2", "s2d2p"])
def test_top_view_matches_jax(clouds, layout):
    """Every layout bit-exact (JAX's K1/K2 in interpret mode), and the top
    slice holds height values above 1 (didi's 12.33 slices in 12)."""
    batch, num = clouds
    cfg = with_pipeline(CFG, view_layout=layout, use_pallas_fused=True)
    jtop, jocc = jvox.lidar_to_top_batch(batch, cfg, num, return_occ=True)
    top, occ = tvox.lidar_to_top_batch(torch.from_numpy(batch),
                                       to_port_config(cfg),
                                       torch.from_numpy(num), return_occ=True)
    if layout == "s2d2p":
        for g, w in zip(top, jtop):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        heights = top[0].numpy()
    else:
        np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
        heights = top.numpy()
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    if layout == "hwc":
        assert heights[..., CFG.top.zn - 1].max() > 1.3
        assert heights[..., :CFG.top.zn - 1].max() <= 1.0
    else:
        assert heights.max() > 1.3


def test_host_aux_matches_native(clouds):
    """The loader's crop/pad and aux plane with the center-car filter
    against the JAX package's native library (numpy where it is not
    built)."""
    batch, num = clouds
    for p, n in zip(batch, num):
        raw = p[:n]
        want_pts, want_n = native.crop_pad(raw, 4096, CFG)
        got_pts, got_n = host_aux.crop_pad(raw, 4096, PCFG)
        assert got_n == want_n and 0 < got_n < n
        np.testing.assert_array_equal(got_pts, want_pts)
        np.testing.assert_array_equal(host_aux.lidar_to_top_aux(raw, PCFG),
                                      native.lidar_to_top_aux(raw, CFG))


@pytest.mark.parametrize("preset", ["didi", "didi2"])
def test_quantized_transfer_matches_jax_at_didi_bounds(clouds, preset):
    """The uint16/uint8 point transfer over the didi grids (x from -45 or
    -50 m, where KITTI's starts at 0): host codes and device points
    bit-equal to JAX's."""
    from mv3d_tpu.ops import quantize as jquant
    from mv3d_tpu_torch.ops import quantize as tquant
    cfg = make_config(preset)
    batch, _ = clouds
    pts = batch * np.float32([3.5, 2.0, 1.0, 1.0])      # spread over the grid
    q, r = jquant.quantize_points(pts, cfg)
    tq, tr = tquant.quantize_points(pts, to_port_config(cfg))
    np.testing.assert_array_equal(tq, q)
    np.testing.assert_array_equal(tr, r)
    assert q.min() == 0 and q.max() == 65535 and (q[..., 0] < 1000).any()
    want = np.asarray(jquant.dequantize_points(jnp.asarray(q),
                                               jnp.asarray(r), cfg))
    got = tquant.dequantize_points(torch.from_numpy(q), torch.from_numpy(r),
                                   to_port_config(cfg)).numpy()
    np.testing.assert_array_equal(got, want)


def test_camera_model_matches_jax():
    rng = np.random.RandomState(4)
    pts = np.stack([rng.uniform(-8, 8, 500), rng.uniform(-4, 4, 500),
                    rng.uniform(2, 40, 500)], 1).astype(np.float32)
    ext = np.eye(4)
    ext[:3, 3] = [0.1, -0.2, 0.3]
    for cam in ({}, {"extrinsic": ext}):
        jm, tm = jproj.CameraModel(**cam), tproj.CameraModel(**cam)
        want = np.asarray(jm.project(jnp.asarray(pts)))
        got = tm.project(torch.from_numpy(pts)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(
            tm.distortion_correct(torch.from_numpy(got)).numpy(),
            np.asarray(jm.distortion_correct(jnp.asarray(want))),
            rtol=0, atol=1e-4)
    for name in ("DIDI_CAMERA_MATRIX", "DIDI_DIST_COEFFS", "DIDI_PROJ_MAT"):
        np.testing.assert_array_equal(getattr(tproj, name),
                                      getattr(jproj, name))


def _plane_x(depth_of_x, x0):
    """The f32 x near ``x0`` whose corner's f32 depth is closest to 0:
    exactly 0 or one ulp of the sum away, so the pixel is infinite or far
    outside int32."""
    lo, hi = F32(x0 - 0.1), F32(x0 + 0.1)      # depth rises with x
    assert depth_of_x(lo) < 0 < depth_of_x(hi)
    while np.nextafter(lo, hi) < hi:
        mid = F32((float(lo) + float(hi)) / 2)
        mid = mid if lo < mid < hi else np.nextafter(lo, hi)
        lo, hi = (mid, hi) if depth_of_x(mid) < 0 else (lo, mid)
    x = min((lo, hi), key=lambda v: abs(depth_of_x(v)))
    assert abs(depth_of_x(x)) < 1e-7, depth_of_x(x)
    return x


def _didi_depth(x):
    p = torch.tensor(jproj.DIDI_PROJ_MAT.T, dtype=torch.float32)
    pt = torch.tensor([[x, 0.0, 0.0, 1.0]], dtype=torch.float32)
    return tbox3d._affine(pt, p)[0, 2].item()


def _kitti_depth(x):
    mt = torch.tensor(to_port_config(didi_config()).matrix_mt,
                      dtype=torch.float32)
    pt = torch.tensor([[x, 0.0, 0.0, 1.0]], dtype=torch.float32)
    return tbox3d._affine(pt, mt)[0, 2].item()


def _box_with_corner(x, ahead):
    """A car ``ahead`` m in front whose first corner is (x, 0, 0)."""
    box = chip_smoke.car_corners(np.array([ahead, 0.0, -1.6]),
                                 (1.5, 1.6, 4.0), 0.0).astype(np.float32)
    box[0] = [x, 0.0, 0.0]
    return box


def test_int32_cast_saturates_as_xla():
    vals = np.array([1e12, -1e12, np.inf, -np.inf, np.nan, 3e9, -3e9,
                     2.5, -2.5, 2147483520.0, -2147483648.0], np.float32)
    want = np.asarray(jnp.asarray(vals).astype(jnp.int32))
    got = tbox3d.trunc_to_int32(torch.from_numpy(vals)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want[:5], [2 ** 31 - 1, -2 ** 31,
                                             2 ** 31 - 1, -2 ** 31, 0])


@pytest.mark.parametrize("preset", ["kitti", "didi"])
def test_rgb_box_with_a_corner_on_the_camera_plane(preset):
    """A corner at depth exactly 0 divides by zero: XLA saturates the
    pixel (or takes NaN to 0), and so does the port."""
    depth, x0 = ((_kitti_depth, 0.272) if preset == "kitti"
                 else (_didi_depth, 1.349))
    x = _plane_x(depth, x0)
    boxes = np.stack([_box_with_corner(x, a) for a in (6.0, 10.0, 20.0)])
    cfgs = ([dataclasses.replace(CFG, dataset_type="kitti")]
            if preset == "kitti" else [CFG, didi_config()])
    for cfg in cfgs:
        want = np.asarray(jbox3d.box3d_to_rgb_box(jnp.asarray(boxes), cfg))
        got = tbox3d.box3d_to_rgb_box(torch.from_numpy(boxes),
                                      to_port_config(cfg)).numpy()
        np.testing.assert_array_equal(got, want)
    if preset == "kitti":
        assert np.isin(got[:, 0], [2 ** 31 - 1, -2 ** 31]).any()
    else:
        # kept boxes, the corner on the plane clamped to an image edge
        h, w, _ = cfg.rgb_shape
        assert got.any(axis=(1, 2)).all()
        assert np.isin(got[:, 0, 0], [0, w - 1]).all()


def test_rgb_box_didi_branch_is_bit_exact():
    """Boxes in view, behind the camera (zeroed), with one corner in the
    cropped image (zeroed) and partly out of it (clamped), at the tiny
    camera and at didi's own."""
    rng = np.random.RandomState(6)
    n = 600
    centers = np.stack([rng.uniform(-20, 40, n), rng.uniform(-15, 15, n),
                        rng.uniform(-2.0, -1.0, n)], 1)
    boxes = np.stack([chip_smoke.car_corners(
        c, (1.5, 1.7, rng.uniform(3, 12)), rng.uniform(-np.pi, np.pi))
        for c in centers]).astype(np.float32)
    seen = np.zeros(4, int)
    for cfg in (CFG, didi_config()):
        want = np.asarray(jbox3d.box3d_to_rgb_box(jnp.asarray(boxes), cfg))
        got = tbox3d.box3d_to_rgb_box(torch.from_numpy(boxes),
                                      to_port_config(cfg)).numpy()
        np.testing.assert_array_equal(got, want)
        # each branch of the mask is taken
        p = jproj.DIDI_PROJ_MAT
        hom = np.concatenate([boxes, np.ones((n, 8, 1), F32)], -1)
        q = hom @ p.T
        u = np.trunc(q[..., 0] / q[..., 2]) - cfg.image_crop_left
        v = np.trunc(q[..., 1] / q[..., 2]) - cfg.image_crop_top
        h, w, _ = cfg.rgb_shape
        inside = ((u >= 0) & (u < w) & (v >= 0) & (v < h)).sum(-1)
        ahead = (boxes[..., 0] > 0).any(-1)
        kept = got.any(axis=(1, 2))
        assert not kept[~ahead].any()
        assert not kept[ahead & (inside < 2)].any()
        seen += [(~ahead).sum(), (ahead & (inside == 1)).sum(),
                 kept[ahead & (inside >= 2) & (inside < 8)].sum(),
                 kept[ahead & (inside == 8)].sum()]
    # behind, one corner in view, partly in view (clamped), fully in view
    assert (seen > 0).all(), seen


@pytest.mark.parametrize("preset,anchors", [("didi", 2964),
                                            ("didi2", 9576)])
def test_full_size_presets_construct(preset, anchors):
    """The full didi grids build (anchors and camera crop as JAX's); they
    run on the card (chip_smoke.py phase options)."""
    cfg = make_config(preset)
    port = MV3D(to_port_config(cfg), device="cpu", seed=0)
    assert cfg.num_anchors == anchors
    assert tuple(port.model.anchors.shape) == (anchors, 4)
    np.testing.assert_array_equal(port.model.anchors.numpy(),
                                  np.asarray(JaxMV3DNet(cfg).anchors))
    assert port.cfg.rgb_shape == (596, 1368, 3)


def _requests(seed, b=2):
    rng = np.random.RandomState(seed)
    pts = np.stack([jvox.pad_points(didi_cloud(rng, 3500), 4096)[0]
                    for _ in range(b)])
    num = np.array([3500, 3200], np.int32)[:b]
    return pts, num, rng.rand(b, *CFG.rgb_shape).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jm = JaxMV3DNet(CFG)
    variables = randomize_bn(jm.init_variables(jax.random.PRNGKey(0)),
                             seed=5)
    return jm, variables, MV3D(PCFG, device="cpu", variables=variables)


def test_predict_from_points_matches_jax(models):
    jm, variables, port = models
    pts, num, rgb = _requests(1)
    # eagerly: under jit XLA folds the quantization's division
    top, occ = jvox.lidar_to_top_batch(jnp.asarray(pts), CFG,
                                       jnp.asarray(num), return_occ=True)
    jdets, _ = jax.jit(lambda v, t, r, o: jm.forward_inference(
        v, t, r, None, score_threshold=THRESH, top_occ=o))(
        variables, top, rgb, occ)
    dets = port.predict_from_points(pts, num, rgb, score_threshold=THRESH)
    m = np.asarray(jdets.mask)
    assert m.sum() >= 2, "too few live detections to compare"
    np.testing.assert_array_equal(dets.mask.numpy(), m)
    np.testing.assert_allclose(dets.boxes3d.numpy()[m],
                               np.asarray(jdets.boxes3d)[m], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(dets.probs.numpy()[m],
                               np.asarray(jdets.probs)[m], rtol=0, atol=1e-4)


def test_didi_artifact_round_trip(models, tmp_path):
    """The artifact keeps the preset (grid, crop, camera crop) and serves
    the in-process detections."""
    _, _, port = models
    art = export_serving(port.get_variables(), PCFG, str(tmp_path / "art"),
                         batch_size=2, score_threshold=THRESH)
    served = load_serving(art, device="cpu")
    assert served.cfg == PCFG and served.meta["rgb_shape"] == [50, 96, 3]
    pts, num, rgb = _requests(2)
    want = port.predict_from_points(pts, num, rgb, score_threshold=THRESH)
    got = served.predict_batch([(p[:k], r) for p, k, r in
                                zip(pts, num, rgb)])
    for i, (boxes, probs) in enumerate(got):
        m = want.mask[i].numpy()
        np.testing.assert_array_equal(boxes, want.boxes3d[i].numpy()[m])
        np.testing.assert_array_equal(probs, want.probs[i].numpy()[m])


TINY_JSON = {
    "top": {"x_min": -12, "x_max": 12, "y_min": -6, "y_max": 6},
    "front": {"width": 64, "height": 32},
    "rpn": {"nms_pre_topn": 200, "nms_post_topn": 16},
    "rcnn": {"batch_size": 32},
    "pipeline": {"max_points": 4096, "max_gt": 8},
    "model": {"compute_dtype": "float32"},
    "image_width": 96, "image_height": 100,
    "image_crop_top": 30, "image_crop_bottom": 20}


def test_didi_drive_train_track_and_score(tmp_path):
    """A 4-frame drive in the bag converter's layout (the capture car's
    returns in every cloud) -> ``Trainer`` (2 steps of every subnet) ->
    ``cli.tracking --dataset didi --eval`` -> XML -> CSVs."""
    rng = np.random.RandomState(7)
    drive = chip_smoke.SynthDrive(rng, PCFG, 4, 3000, cars=(1, 2), ego=400)
    root = str(tmp_path / "raw")
    base = chip_smoke.write_raw_drive(root, drive, PCFG, date="1",
                                      drive_id="15", didi=True)
    assert base == os.path.join(root, "1", "15")
    ds = KittiRawDataset(root, "1", "15", PCFG)
    assert len(ds) == 4 and ds.base == base
    ckpt, log = str(tmp_path / "ckpt"), str(tmp_path / "log")
    with BatchLoader(ds, PCFG, batch_size=2) as data:
        batch = data.load()
        assert batch["top_aux"].shape == (2, 120, 60, 2)
        # the capture car's returns were cropped on the host
        pts = batch["points"]
        live = np.arange(pts.shape[1]) < batch["num_points"][:, None]
        assert not ((np.abs(pts[..., 0]) <= 2.35) & (np.abs(pts[..., 1])
                                                     <= 1.05) & live).any()
        tr = Trainer(data, cfg=PCFG, device="cpu", log_tag="didi",
                     checkpoint_dir=ckpt, log_dir=log)
        for _ in range(2):
            losses = tr.fit_iteration(data.load())
        assert np.isfinite(list(losses.values())).all()
        tr.save_weights(step=2)
        tr.close()
    cfg_path = str(tmp_path / "tiny_didi.json")
    with open(cfg_path, "w") as f:
        json.dump(TINY_JSON, f)
    out = str(tmp_path / "pred")
    path = tracking.main(["-n", "didi", "--kitti-raw", root, "--date", "1",
                          "--drive", "15", "--dataset", "didi", "--config",
                          cfg_path, "--checkpoint-dir", ckpt, "--out-dir",
                          out, "--score-threshold", "0.0", "--eval",
                          "--device", "cpu"])
    assert path == os.path.join(out, "1_15", "tracklet_labels_pred.xml")
    pred = tracklets.read_objects(path, range(4), PCFG)
    assert len(pred) == 4 and sum(len(o) for o in pred) > 0
    d = os.path.dirname(path)
    for name in ("iou_per_obj.csv", "pr_per_iou.csv"):
        with open(os.path.join(d, name)) as f:
            rows = [line.split(",") for line in f.read().splitlines()]
        assert len(rows) >= 2 and all(len(r) == len(rows[0]) for r in rows)
