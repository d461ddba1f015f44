"""The port's host data path against the JAX package's: crop + pad and the
BEV aux plane (``mv3d_tpu.native``, its C++ library or numpy fallback),
``frames_to_batch`` and the single-worker loader's batch stream.

Tolerances: crop + pad, intensity and every batch array are exact;
density within atol 2e-5 (the JAX package's own test tolerance: the C++
``logf`` and numpy's ``log`` may differ in the last bits).
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from mv3d_tpu import native
from mv3d_tpu.config import kitti_config
from mv3d_tpu.data import loader as jloader
from mv3d_tpu.data.kitti import Frame as JaxFrame
from mv3d_tpu_torch.data import host_aux, loader as tloader

from test_torch_config import to_port_config

CFG = kitti_config()
SMALL = dataclasses.replace(
    CFG, top=dataclasses.replace(CFG.top, x_max=8.0, y_min=-3.0, y_max=3.0),
    pipeline=dataclasses.replace(CFG.pipeline, max_points=4096, max_gt=4),
    image_width=32, image_height=24)
PSMALL = to_port_config(SMALL)


@pytest.fixture(scope="module")
def drive():
    return chip_smoke.SynthDrive(np.random.RandomState(2), PSMALL, 5, 6000,
                                 cars=(1, 2))


@pytest.mark.parametrize("max_points", [8192, 300])
def test_crop_pad_matches_native(max_points):
    pts = chip_smoke.make_cloud(np.random.RandomState(0), 1, 6000, SMALL,
                                tricky=True)[0]
    got, n = host_aux.crop_pad(pts, max_points, PSMALL)
    want, wn = native.crop_pad(pts, max_points, SMALL)
    assert n == wn and 0 < n
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", [SMALL, CFG], ids=["small", "kitti"])
def test_host_aux_plane_matches_native(cfg):
    pts = chip_smoke.make_cloud(np.random.RandomState(1), 1, 20000, cfg,
                                tricky=True)[0]
    got = host_aux.lidar_to_top_aux(pts, to_port_config(cfg))
    want = native.lidar_to_top_aux(pts, cfg)
    assert got.shape == want.shape == (cfg.top.xn, cfg.top.yn, 2)
    assert (want[..., 1] > 0).sum() > 1000
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0, atol=2e-5)


def _jax_frames(frames):
    return [JaxFrame(tag=f.tag, points=f.points, rgb=f.rgb,
                     gt_boxes3d=f.gt_boxes3d, gt_labels=f.gt_labels)
            for f in frames]


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    assert got["tags"] == want["tags"]
    for k in set(want) - {"tags", "top_aux"}:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["top_aux"][..., 0],
                                  want["top_aux"][..., 0])
    np.testing.assert_allclose(got["top_aux"][..., 1],
                               want["top_aux"][..., 1], rtol=0, atol=2e-5)


def test_frames_to_batch_matches_jax(drive):
    frames = drive.frames[:3]
    got = tloader.frames_to_batch(frames, PSMALL)
    want = jloader.frames_to_batch(_jax_frames(frames), SMALL)
    assert "top_aux" in got and got["gt_mask"].sum() >= 3
    _assert_batches_equal(got, want)


def test_loader_stream_matches_jax(drive):
    """Same seed, same shuffled batch stream; a non-looping loader drops
    the trailing partial batch and then returns None."""
    jds = chip_smoke.SynthDrive(np.random.RandomState(2), PSMALL, 5, 6000,
                                cars=(1, 2))
    jds.frames = _jax_frames(jds.frames)
    with tloader.BatchLoader(drive, PSMALL, batch_size=2, seed=3,
                             loop=False) as tl, \
            jloader.BatchLoader(jds, SMALL, batch_size=2, seed=3,
                                loop=False) as jl:
        for _ in range(2):
            _assert_batches_equal(tl.load(), jl.load())
        assert tl.load() is None and jl.load() is None
        assert tl.load() is None
