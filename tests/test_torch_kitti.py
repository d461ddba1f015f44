"""The port's KITTI data path against the JAX package's: PNG decoding and
encoding against PIL, the rgb resize against PIL's ``BILINEAR``, the
object, raw and odometry readers, ``frames_to_batch`` (also with
``stream_quantized``), the ordered multi-worker stream, the loader's
failures, tracklet XML, and the box helpers the readers and the
validation IoU use.

Tolerances: images, points, rgb, batches and streams are bit-equal (the
batches' density channel within atol 2e-5, as tests/test_torch_data.py
holds it); gt boxes within atol 1e-5 (the camera-to-lidar transform and
the box's cos/sin in f32: torch and XLA round them differently); IoU
within 1e-6.
"""

import dataclasses
import io
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from mv3d_tpu.config import didi_config, kitti_config
from mv3d_tpu.data import kitti as jkitti
from mv3d_tpu.data import loader as jloader
from mv3d_tpu.data import tracklets as jtracklets
from mv3d_tpu.ops import boxes3d as jb3
from mv3d_tpu_torch.data import kitti as tkitti
from mv3d_tpu_torch.data import loader as tloader
from mv3d_tpu_torch.data import tracklets as ttracklets
from mv3d_tpu_torch.ops import boxes3d as tb3
from mv3d_tpu_torch.utils import png

from test_torch_config import to_port_config
from test_torch_data import _assert_batches_equal as _assert_same_batches

CFG = kitti_config()
SMALL = dataclasses.replace(
    CFG, top=dataclasses.replace(CFG.top, x_max=8.0, y_min=-3.0, y_max=3.0),
    pipeline=dataclasses.replace(CFG.pipeline, max_points=4096, max_gt=4),
    image_width=96, image_height=40)
PSMALL = to_port_config(SMALL)


def _image(rng, h, w, c=3):
    """A smooth image with noise, so every PNG filter type gets picked."""
    yy, xx = np.mgrid[:h, :w]
    base = (np.sin(xx / 9.0) * 60 + np.cos(yy / 7.0) * 50 + 120)[..., None]
    img = base + rng.randint(0, 24, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


# -- PNG ---------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "cycle", "adaptive"])
def test_png_encoder_and_decoder_match_pil(channels, filters):
    """Our bytes decode in PIL to the array written, and our decoder reads
    them (and PIL's own encoding) bit for bit."""
    img = _image(np.random.RandomState(channels), 21, 34, channels)
    if channels == 1:
        img = img[..., 0]
    f = {"cycle": np.arange(21) % 5, "adaptive": None}.get(filters, filters)
    data = png.encode_png(img, f)
    used = png.row_filters(data)
    if isinstance(filters, int):
        assert (used == filters).all()
    elif filters == "cycle":
        assert set(used) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(png.decode_png(data), img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    np.testing.assert_array_equal(png.decode_png(buf.getvalue()), img)


@pytest.mark.parametrize("ftype", [3, 4])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_png_helper_matches_numpy_twin(ftype, bpp):
    rng = np.random.RandomState(bpp)
    rows = _image(rng, 6, 40, bpp).reshape(6, -1)
    cand = png.filter_rows(rows, bpp)[ftype]
    for y in range(1, 6):
        a, b = cand[y].copy(), cand[y].copy()
        png.unfilter_row_kernel(ftype, a, rows[y - 1], bpp)
        png.unfilter_row_plain(ftype, b, rows[y - 1], bpp)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, rows[y])
    data = png.encode_png(_image(rng, 9, 13, bpp), np.arange(9) % 5)
    np.testing.assert_array_equal(
        png.decode_png(data),
        png.decode_png(data, row_fn=png.unfilter_row_plain))


def test_png_decoder_refuses_what_it_cannot_read():
    img = _image(np.random.RandomState(0), 8, 8)
    data = png.encode_png(img)
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(data[:40] + bytes([data[40] ^ 1]) + data[41:])
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png(data[:-20])
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + data[6:])
    buf = io.BytesIO()
    Image.fromarray(img).convert("P").save(buf, format="PNG")
    with pytest.raises(ValueError, match="colour type 3"):
        png.decode_png(buf.getvalue())


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_read_image_matches_jax(tmp_path, mode):
    img = Image.fromarray(_image(np.random.RandomState(1), 30, 50, 4),
                          "RGBA").convert(mode)
    path = str(tmp_path / "im.png")
    img.save(path)
    got = tkitti.read_image(path)
    assert got.dtype == np.uint8 and got.shape == (30, 50, 3)
    np.testing.assert_array_equal(got, jkitti.read_image(path))


# -- rgb resize --------------------------------------------------------------

@pytest.mark.parametrize("size", chip_smoke.KITTI_IMAGE_SIZES)
def test_prepare_rgb_matches_pil_at_kitti_sizes(size):
    img = _image(np.random.RandomState(size[0]), *size)
    got = tloader.prepare_rgb(img, to_port_config(CFG))
    want = jloader.prepare_rgb(img, CFG)
    assert got.shape == (375, 1242, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,out", [((1096, 1368), None),
                                      ((61, 77), (20, 31)),
                                      ((20, 31), (61, 77)),
                                      ((9, 500), (30, 7))])
def test_prepare_rgb_matches_pil_on_crops_and_scales(size, out):
    """The didi crop (sky and hood rows, then a downscale), and down- and
    upscales along each axis."""
    cfg = didi_config() if out is None else dataclasses.replace(
        CFG, image_height=out[0], image_width=out[1])
    img = _image(np.random.RandomState(3), *size)
    np.testing.assert_array_equal(
        tloader.prepare_rgb(img, to_port_config(cfg)),
        jloader.prepare_rgb(img, cfg))


# -- readers -----------------------------------------------------------------

@pytest.fixture(scope="module")
def object_dir(tmp_path_factory):
    """A KITTI object directory in the layout of tests/test_data.py: 4
    frames with a Car and a DontCare label, PNGs written by PIL at the
    KITTI sizes (one all zeros, as there)."""
    root = tmp_path_factory.mktemp("kitti")
    for sub in ("velodyne", "label_2", "image_2"):
        os.makedirs(root / "training" / sub)
    rng = np.random.RandomState(0)
    for i, size in enumerate(chip_smoke.KITTI_IMAGE_SIZES):
        tag = f"{i:06d}"
        pts = np.stack([rng.uniform(0, 70, 5000), rng.uniform(-20, 20, 5000),
                        rng.uniform(-2, 1, 5000), rng.uniform(0, 1, 5000)],
                       1).astype(np.float32)
        pts[:300] = [4.0 + 0.5 * i, 0.5, -1.0, 0.3]    # a dense gt cell
        pts.tofile(root / "training" / "velodyne" / f"{tag}.bin")
        with open(root / "training" / "label_2" / f"{tag}.txt", "w") as f:
            f.write(f"Car 0 0 0 0 0 50 50 1.5 1.6 4.0 {0.3 * i:.2f} 1.5 "
                    f"{4.0 + 2 * i:.2f} {-1.57 + 0.4 * i:.2f}\n")
            f.write("DontCare -1 -1 -10 0 0 10 10 -1 -1 -1 -1000 -1000 "
                    "-1000 -10\n")
        img = (np.zeros(size + (3,), np.uint8) if i == 0
               else _image(rng, *size))
        Image.fromarray(img).save(root / "training" / "image_2" / f"{tag}.png")
    return str(root)


def _assert_frames_equal(got, want):
    assert got.tag == want.tag
    np.testing.assert_array_equal(got.points, want.points)
    if want.rgb is None:
        assert got.rgb is None
    else:
        np.testing.assert_array_equal(got.rgb, want.rgb)
    np.testing.assert_allclose(got.gt_boxes3d, want.gt_boxes3d, rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got.gt_labels, want.gt_labels)


def test_object_frames_match_jax(object_dir):
    got = tkitti.KittiObjectDataset(object_dir, cfg=to_port_config(CFG))
    want = jkitti.KittiObjectDataset(object_dir, cfg=CFG)
    assert got.tags == want.tags and len(got) == 4
    for i in range(4):
        _assert_frames_equal(got.load_frame(i), want.load_frame(i))
    assert got.load_frame(1).gt_boxes3d.shape == (1, 8, 3)


def test_label_parse_matches_jax():
    lines = ["Car 0 0 0 0 0 50 50 1.5 1.6 4.0 2.0 1.5 20.0 -1.5",
             "Van 0 0 0 0 0 50 50 2.1 1.9 5.0 -3.0 1.7 11.0 0.7",
             "Pedestrian 0 0 0 0 0 5 5 1.7 0.6 0.8 1.0 1.6 8.0 2.9",
             "DontCare -1 -1 -10 0 0 10 10 -1 -1 -1 -1000 -1000 -1000 -10"]
    for obj in ("Car", "Pedestrian", "Truck"):
        for positive_only in (True, False):
            got = tkitti.kitti_label_to_lidar_box3d(
                lines, obj, positive_only, to_port_config(CFG))
            want = jkitti.kitti_label_to_lidar_box3d(lines, obj,
                                                     positive_only, CFG)
            np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(got[1], want[1])


def _tracklet(first, ty, trunc, obj="Car"):
    t = jtracklets.Tracklet(obj, h=1.5, w=1.6, l=4.0, first_frame=first)
    for i in range(3):
        t.poses.append({"tx": 10.0 + i, "ty": ty, "tz": -0.9, "rx": 0.0,
                        "ry": 0.0, "rz": 0.3 + 0.1 * i, "truncation": trunc})
    return t


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """A raw drive (velodyne, image_02 PNGs, a tracklet XML written by the
    JAX package) and an odometry sequence."""
    root = tmp_path_factory.mktemp("raw")
    base = root / "2011_09_26" / "2011_09_26_drive_0001_sync"
    os.makedirs(base / "velodyne_points" / "data")
    os.makedirs(base / "image_02" / "data")
    rng = np.random.RandomState(4)
    for i in range(4):
        rng.rand(200, 4).astype(np.float32).tofile(
            base / "velodyne_points" / "data" / f"{i:010d}.bin")
        if i < 3:
            Image.fromarray(_image(rng, 20, 30)).save(
                base / "image_02" / "data" / f"{i:010d}.png")
    jtracklets.write_tracklets(str(base / "tracklet_labels.xml"), [
        _tracklet(1, 4.0, 0), _tracklet(0, 2.0, 0, "Truck"),
        _tracklet(2, 1.0, 0, "Pedestrian")])
    seq = root / "sequences" / "04"
    os.makedirs(seq / "velodyne")
    os.makedirs(seq / "image_2")
    for i in range(2):
        rng.rand(50, 4).astype(np.float32).tofile(
            seq / "velodyne" / f"{i:06d}.bin")
        Image.fromarray(_image(rng, 10, 12)).save(seq / "image_2"
                                                  / f"{i:06d}.png")
    return str(root)


@pytest.mark.parametrize("dataset", ["kitti", "didi2"])
def test_raw_and_odometry_frames_match_jax(raw_dir, dataset):
    cfg = kitti_config() if dataset == "kitti" else \
        dataclasses.replace(CFG, dataset_type="didi2")
    # the XML writer stamps truncation -1, which the KITTI filter drops
    got = tkitti.KittiRawDataset(raw_dir, "2011_09_26", "0001",
                                 to_port_config(cfg))
    want = jkitti.KittiRawDataset(raw_dir, "2011_09_26", "0001", cfg)
    assert len(got) == len(want) == 4
    n_boxes = 0
    for i in range(4):
        g, w = got.load_frame(i), want.load_frame(i)
        _assert_frames_equal(g, w)
        n_boxes += len(g.gt_boxes3d)
    assert n_boxes == (0 if dataset == "kitti" else 6)
    got = tkitti.KittiOdometryDataset(raw_dir, "04", to_port_config(CFG))
    want = jkitti.KittiOdometryDataset(raw_dir, "04", CFG)
    for i in range(2):
        _assert_frames_equal(got.load_frame(i), want.load_frame(i))


# -- tracklets ---------------------------------------------------------------

def test_tracklets_round_trip_and_read_jax_xml(tmp_path):
    port = ttracklets.Tracklet("Car", h=1.5, w=1.6, l=4.0, first_frame=2)
    port.poses = [dict(p) for p in _tracklet(2, 3.0, 0).poses]
    ours, theirs = str(tmp_path / "ours.xml"), str(tmp_path / "theirs.xml")
    ttracklets.write_tracklets(ours, [port])
    jtracklets.write_tracklets(theirs, [_tracklet(2, 3.0, 0)])
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()
    back = ttracklets.parse_tracklets(theirs)
    want = jtracklets.parse_tracklets(theirs)
    assert [vars(t) for t in back] == [vars(t) for t in want]
    didi = to_port_config(dataclasses.replace(CFG, dataset_type="didi2"))
    got = ttracklets.read_objects(theirs, range(6), didi)
    ref = jtracklets.read_objects(theirs, range(6),
                                  dataclasses.replace(CFG,
                                                      dataset_type="didi2"))
    assert [len(o) for o in got] == [len(o) for o in ref] == [0, 0, 1, 1,
                                                              1, 0]
    for g, w in zip(got, ref):
        gb, gl = ttracklets.objects_to_gt_boxes3d(g)
        wb, wl = jtracklets.objects_to_gt_boxes3d(w)
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gl, wl)
    saver = ttracklets.TrackletSaver(str(tmp_path / "pred"))
    saver.add_tracklet(0, [1.5, 1.6, 4.0], [5.0, 4.0, -1.0], [0, 0, 0.2])
    saver.add_tracklet(1, [1.5, 1.6, 4.0], [5.0, 9.0, -1.0], [0, 0, 0.2])
    saver.write_tracklet()
    assert len(jtracklets.parse_tracklets(saver.path)) == 1


# -- boxes -------------------------------------------------------------------

def _boxes(rng, n):
    centers = np.stack([rng.uniform(5, 30, n), rng.uniform(-8, 8, n),
                        np.full(n, -1.7)], 1)
    sizes = np.stack([rng.uniform(1.4, 1.7, n), rng.uniform(1.5, 1.8, n),
                      rng.uniform(3.5, 4.5, n)], 1)
    yaws = rng.uniform(-np.pi, np.pi, n)
    return centers.astype(np.float32), sizes.astype(np.float32), \
        np.stack([np.zeros(n), np.zeros(n), yaws], 1).astype(np.float32)


def test_box_helpers_match_jax():
    rng = np.random.RandomState(5)
    t, s, r = _boxes(rng, 12)
    got = tb3.box3d_compose(t, s, r).numpy()
    want = np.array(jb3.box3d_compose(t, s, r, CFG))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for g, w in zip(tb3.boxes3d_decompose(torch.from_numpy(want)),
                    jb3.boxes3d_decompose(want, CFG)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    pcfg = to_port_config(CFG)
    pts = rng.uniform(-30, 30, (7, 3)).astype(np.float32)
    for fn in ("lidar_to_camera_points", "camera_to_lidar_points"):
        np.testing.assert_allclose(
            getattr(tb3, fn)(torch.from_numpy(pts), pcfg).numpy(),
            np.asarray(getattr(jb3, fn)(pts, CFG)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tb3.box3d_to_camera_box3d(torch.from_numpy(want), pcfg).numpy(),
        np.asarray(jb3.box3d_to_camera_box3d(want, CFG)), rtol=0, atol=1e-5)


def test_boxes3d_score_iou_matches_jax():
    rng = np.random.RandomState(6)
    gt = np.asarray(jb3.box3d_compose(*_boxes(rng, 4), CFG))
    t, s, r = _boxes(rng, 9)
    t[:4] = gt[:, :4].mean(1) + rng.uniform(-1, 1, (4, 3)) * [1, 1, 0]
    pred = np.asarray(jb3.box3d_compose(t, s, r, CFG))
    for p in (pred, pred[:0], gt):
        got = tb3.boxes3d_score_iou(gt, p, to_port_config(CFG))
        want = jb3.boxes3d_score_iou(gt, p, CFG)
        assert abs(got - want) <= 1e-6
    assert tb3.boxes3d_score_iou(gt, pred, to_port_config(CFG)) > 0
    assert abs(tb3.boxes3d_score_iou(gt, gt, to_port_config(CFG)) - 1) < 1e-5
    a, b = gt[0].T.astype(np.float64), pred[0].T.astype(np.float64)
    assert tb3.box3d_intersection(a, b) == jb3.box3d_intersection(a, b)


# -- batches and streams -----------------------------------------------------

def _assert_batches_equal(got, want):
    """tests/test_torch_data.py's comparison, with the gt boxes of frames
    read from disk within atol 1e-5."""
    np.testing.assert_allclose(got["gt_boxes3d"], want["gt_boxes3d"],
                               rtol=0, atol=1e-5)
    _assert_same_batches(dict(got, gt_boxes3d=0), dict(want, gt_boxes3d=0))


@pytest.fixture(scope="module")
def datasets(object_dir):
    return (tkitti.KittiObjectDataset(object_dir, cfg=PSMALL),
            jkitti.KittiObjectDataset(object_dir, cfg=SMALL))


@pytest.mark.parametrize("quantized", [False, True])
def test_frames_to_batch_matches_jax(datasets, quantized):
    cfg = dataclasses.replace(SMALL, pipeline=dataclasses.replace(
        SMALL.pipeline, stream_quantized=quantized))
    tds, jds = datasets
    got = tloader.frames_to_batch([tds.load_frame(i) for i in range(4)],
                                  to_port_config(cfg))
    want = jloader.frames_to_batch([jds.load_frame(i) for i in range(4)],
                                   cfg)
    assert ("points_q" in got) == quantized and got["gt_mask"].sum() == 4
    _assert_batches_equal(got, want)


def _stream(loader, n):
    return [loader.load(timeout=60) for _ in range(n)]


def test_multi_worker_stream_matches_single_worker_and_jax(datasets):
    tds, jds = datasets
    with tloader.BatchLoader(tds, PSMALL, batch_size=2, seed=5,
                             workers=3) as a, \
            tloader.BatchLoader(tds, PSMALL, batch_size=2, seed=5) as b, \
            jloader.BatchLoader(jds, SMALL, batch_size=2, seed=5,
                                workers=2) as c:
        for x, y, z in zip(_stream(a, 5), _stream(b, 5), _stream(c, 5)):
            _assert_batches_equal(x, y)
            _assert_batches_equal(x, z)


@pytest.mark.parametrize("workers", [1, 3])
def test_damaged_frames_are_skipped_as_jax_skips_them(datasets, workers):
    tds, jds = datasets

    def flaky(base):
        class Flaky:
            def __len__(self):
                return 7

            def load_frame(self, i):
                if i in (1, 4):
                    raise IOError("corrupt frame")
                return base.load_frame(i % 4)
        return Flaky()

    def drain(loader):
        out = []
        while (b := loader.load(timeout=60)) is not None:
            out.append(b)
        return out

    with tloader.BatchLoader(flaky(tds), PSMALL, batch_size=2, loop=False,
                             shuffle=False, workers=workers) as a, \
            jloader.BatchLoader(flaky(jds), SMALL, batch_size=2, loop=False,
                                shuffle=False, workers=workers) as b:
        got, want = drain(a), drain(b)
    # 7 indices, 2 damaged: 5 good frames, 2 full batches, the partial
    # drops; with several workers which replacement a batch draws depends
    # on timing (in both loaders), with one it is the stream's next index
    assert len(got) == len(want) == 2
    assert all(len(x["tags"]) == 2 for x in got)
    if workers == 1:
        for x, y in zip(got, want):
            _assert_batches_equal(x, y)


def test_loader_stalls_and_deaths_are_loud():
    class Stalls:
        def __len__(self):
            return 8

        def load_frame(self, i):
            time.sleep(3)

    class Poison:
        def __len__(self):
            return 8

        def load_frame(self, i):
            return None          # frames_to_batch dies on it

    with tloader.BatchLoader(Stalls(), PSMALL, batch_size=2,
                             workers=2) as bl:
        with pytest.raises(RuntimeError, match="stalled"):
            bl.load(timeout=0.2)
    for workers in (1, 3):
        with tloader.BatchLoader(Poison(), PSMALL, batch_size=2,
                                 workers=workers) as bl:
            with pytest.raises(RuntimeError, match="died"):
                for _ in range(4):
                    bl.load(timeout=10.0)


def test_close_joins_the_workers(datasets):
    bl = tloader.BatchLoader(datasets[0], PSMALL, batch_size=2, workers=3,
                             prefetch=1)
    bl.load(timeout=60)
    bl.close()
    assert not any(t.is_alive() for t in bl._threads)


def test_multi_worker_stream_under_thread_stress():
    """More workers than cores and a very short switch interval: the
    ordered stream is still the single-worker stream."""
    import sys
    drive = chip_smoke.SynthDrive(np.random.RandomState(1), PSMALL, 9, 500,
                                  cars=(1, 1))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tloader.BatchLoader(drive, PSMALL, batch_size=2, seed=7,
                                 workers=(os.cpu_count() or 4) + 4) as a, \
                tloader.BatchLoader(drive, PSMALL, batch_size=2,
                                    seed=7) as b:
            for x, y in zip(_stream(a, 12), _stream(b, 12)):
                _assert_same_batches(x, y)
    finally:
        sys.setswitchinterval(interval)
