"""The port's single-frame voxelizers against the JAX package's:
``ops/voxelize.py::lidar_to_top`` (with ``num_points``, ``aux`` and
``return_occ``) and ``lidar_to_front``, ``ops/boxes3d.py::
lidar_to_front_coords``, and the host numpy ``lidar_to_top`` /
``lidar_to_front`` of ``data/host_aux.py`` against ``mv3d_tpu.native``;
the counterparts of ``tests/test_voxelize.py:80-125`` and
``tests/test_native.py:24-37``, at the ``SMALL`` grid and on the empty
cloud.

The JAX single-frame function runs eagerly here (a jitted JAX view folds
its divisions into reciprocal multiplies, see tests/test_torch_train.py):
through XLA scatters by default, through the Pallas sweep ``scatter_top_fused``
(K1, interpret mode) with ``use_pallas_fused`` and through
``scatter_max_sorted`` (K3, interpret mode) with ``aux`` and
``use_pallas_heights``. The port's runs K1 at B=1, or K3 with ``aux``
(their plain versions on the CPU).

Tolerances. The top view's heights, intensity and occupancy are
bit-equal to JAX's single-frame output, the density within 1 ulp (the two
``log``s); the port's single frame is bit-equal to its batched form at
B=1 (JAX's own batched-vs-single test allows atol 1e-5). The front view
within atol 5e-5 of JAX's (sums and ``sqrt`` reassociate), as the batched
test; ``lidar_to_front_coords`` bit-equal. The host top view is bit-equal
to the native library's and to the numpy oracle; the host front view's
height and reflectance channels are bit-equal to the native library's,
its distance channel within rtol 1e-6 (the library is built with
``-march=native``, where the compiler may fuse its sum of squares into
FMAs).

Wall time about 17 s on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from mv3d_tpu import native
from mv3d_tpu.config import kitti_config
from mv3d_tpu.ops import boxes3d as jb3
from mv3d_tpu.ops import voxelize as jvox
from mv3d_tpu.ops import voxelize_ref
from mv3d_tpu_torch.data import host_aux
from mv3d_tpu_torch.ops import boxes3d as tb3
from mv3d_tpu_torch.ops import voxelize as tvox
from mv3d_tpu_torch.ops import voxelize_heights, voxelize_sweep

from test_torch_config import to_port_config

torch.set_num_threads(2)

CFG = kitti_config()
SMALL = dataclasses.replace(
    CFG, top=dataclasses.replace(CFG.top, x_max=8.0, y_min=-3.0, y_max=3.0))
ZN = SMALL.top.zn


def with_pipeline(cfg, **kw):
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **kw))


# JAX's three single-frame formulations, and the port's layouts that the
# single frame ignores (it is always the f32 hwc view)
FORMS = {"xla": SMALL,
         "fused": with_pipeline(SMALL, use_pallas_fused=True),
         "fused_s2d2p_bf16": with_pipeline(
             SMALL, use_pallas_fused=True, view_layout="s2d2p",
             top_view_dtype="bfloat16")}


@pytest.fixture(scope="module")
def cloud():
    """One padded cloud (test_voxelize.make_cloud's kind, with exact
    slice boundaries and duplicated positions) and its point count."""
    raw = chip_smoke.make_cloud(np.random.RandomState(4), 1, 3000, SMALL,
                                tricky=True)[0]
    padded, n = jvox.pad_points(raw, 4096)
    return raw, np.asarray(padded), n


def _assert_top_equal(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[..., :ZN + 1], want[..., :ZN + 1])
    np.testing.assert_array_max_ulp(got[..., ZN + 1], want[..., ZN + 1],
                                    maxulp=1)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_top_matches_jax_single_frame(cloud, form):
    _, padded, n = cloud
    cfg = FORMS[form]
    jcfg = SMALL if form == "fused_s2d2p_bf16" else cfg
    want, wocc = jvox.lidar_to_top(padded, jcfg, num_points=np.int32(n),
                                   return_occ=True)
    got, occ = tvox.lidar_to_top(torch.from_numpy(padded),
                                 to_port_config(cfg), num_points=n,
                                 return_occ=True)
    _assert_top_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(wocc))
    # the single frame is the batched form's frame at B=1, bit for bit
    batched = tvox.lidar_to_top_batch(
        torch.from_numpy(padded[None]), to_port_config(jcfg),
        torch.tensor([n]))
    assert torch.equal(got, batched[0])


def test_top_with_aux_matches_jax_scatter_max_sorted(cloud):
    """``aux``: the heights through K3 (JAX's ``scatter_max_sorted`` in
    interpret mode), the host plane concatenated, the occupancy the f32
    sum of every channel."""
    raw, padded, n = cloud
    cfg = with_pipeline(SMALL, use_pallas_heights=True)
    aux = native.lidar_to_top_aux(raw, SMALL)
    want, wocc = jvox.lidar_to_top(padded, cfg, num_points=np.int32(n),
                                   aux=aux, return_occ=True)
    before = voxelize_heights.scatter_max_batched.launches
    got, occ = tvox.lidar_to_top(torch.from_numpy(padded),
                                 to_port_config(cfg), num_points=n,
                                 aux=torch.from_numpy(aux), return_occ=True)
    assert voxelize_heights.scatter_max_batched.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(wocc))


def test_top_matches_numpy_oracle(cloud):
    raw, padded, n = cloud
    want = voxelize_ref.lidar_to_top_np(raw, SMALL)
    got = tvox.lidar_to_top(torch.from_numpy(padded), to_port_config(SMALL))
    _assert_top_equal(got.numpy(), want)


def test_num_points_masking(cloud):
    """In-bounds junk past ``num_points`` is dropped (test_voxelize.py
    :110-119)."""
    raw, padded, n = cloud
    junk = padded.copy()
    junk[n:] = chip_smoke.make_cloud(np.random.RandomState(5), 1,
                                     len(junk) - n, SMALL, tricky=True)[0]
    got = tvox.lidar_to_top(torch.from_numpy(junk), to_port_config(SMALL),
                            num_points=torch.tensor(n, dtype=torch.int32))
    _assert_top_equal(got.numpy(), voxelize_ref.lidar_to_top_np(raw, SMALL))
    want = jvox.lidar_to_top(junk, SMALL, num_points=np.int32(n))
    _assert_top_equal(got.numpy(), np.asarray(want))
    front = tvox.lidar_to_front(torch.from_numpy(junk),
                                to_port_config(SMALL), num_points=n)
    np.testing.assert_allclose(
        front.numpy(), np.asarray(jvox.lidar_to_front(
            junk, SMALL, num_points=np.int32(n))), rtol=0, atol=5e-5)


def test_front_matches_jax_and_oracle(cloud):
    raw, padded, _ = cloud
    got = tvox.lidar_to_front(torch.from_numpy(padded),
                              to_port_config(SMALL)).numpy()
    assert got.shape == SMALL.front.shape
    np.testing.assert_allclose(got, np.asarray(jvox.lidar_to_front(
        padded, SMALL)), rtol=0, atol=5e-5)
    np.testing.assert_allclose(got, voxelize_ref.lidar_to_front_np(
        raw, SMALL), rtol=1e-5, atol=5e-5)


def test_empty_cloud():
    padded, _ = jvox.pad_points(np.zeros((0, 4), np.float32), 1024)
    pts = torch.from_numpy(np.asarray(padded))
    top = tvox.lidar_to_top(pts, to_port_config(SMALL)).numpy()
    front = tvox.lidar_to_front(pts, to_port_config(SMALL)).numpy()
    assert top.shape == SMALL.top.shape and front.shape == SMALL.front.shape
    assert np.all(top == 0) and np.all(front == 0)
    host = np.zeros((0, 4), np.float32)
    assert np.all(host_aux.lidar_to_top(host, to_port_config(SMALL)) == 0)
    assert np.all(host_aux.lidar_to_front(host, to_port_config(SMALL)) == 0)


def test_cpu_single_frame_takes_the_plain_versions(cloud):
    _, padded, _ = cloud
    counts = (voxelize_sweep.scatter_top_fused_batched.launches,
              voxelize_heights.scatter_max_batched.launches)
    tvox.lidar_to_top(torch.from_numpy(padded), to_port_config(SMALL))
    assert counts == (voxelize_sweep.scatter_top_fused_batched.launches,
                      voxelize_heights.scatter_max_batched.launches)


def test_lidar_to_front_coords_matches_jax():
    rng = np.random.RandomState(6)
    pts = np.stack([rng.uniform(-10, 80, (50, 8)),
                    rng.uniform(-40, 40, (50, 8)),
                    rng.uniform(-3, 2, (50, 8))], -1).astype(np.float32)
    wc, wr = jb3.lidar_to_front_coords(pts, CFG)
    gc, gr = tb3.lidar_to_front_coords(torch.from_numpy(pts),
                                       to_port_config(CFG))
    assert gc.dtype == gr.dtype == torch.float32 and gc.shape == (50, 8)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))


def _host_cloud(rng, cfg, n=20000):
    """test_native.py's cloud (5 m around the KITTI grid) around ``cfg``'s
    grid, with exact slice boundaries."""
    t = cfg.top
    pts = np.stack([rng.uniform(t.x_min - 5, t.x_max + 5, n),
                    rng.uniform(t.y_min - 5, t.y_max + 5, n),
                    rng.uniform(-5, 1.5, n), rng.uniform(0, 1, n)],
                   1).astype(np.float32)
    pts[:n // 50, 2] = (t.z_min + rng.randint(0, t.zn, n // 50) * t.z_div
                        ).astype(np.float32)
    return pts


@pytest.mark.parametrize("cfg", [SMALL, CFG], ids=["small", "kitti"])
def test_host_top_matches_native_and_oracle(cfg):
    pts = _host_cloud(np.random.RandomState(8), cfg)
    got = host_aux.lidar_to_top(pts, to_port_config(cfg))
    assert got.dtype == np.float32 and got.shape == cfg.top.shape
    assert (got[..., ZN + 1] > 0).sum() > 100
    np.testing.assert_array_equal(got, voxelize_ref.lidar_to_top_np(pts,
                                                                     cfg))
    if native.available():
        np.testing.assert_array_equal(got, native.lidar_to_top(pts, cfg))
    # the host plane is this view's last two channels
    np.testing.assert_array_equal(
        host_aux.lidar_to_top_aux(pts, to_port_config(cfg)),
        got[..., ZN:])


@pytest.mark.parametrize("cfg", [SMALL, CFG], ids=["small", "kitti"])
def test_host_front_matches_native_and_oracle(cfg):
    pts = _host_cloud(np.random.RandomState(9), cfg)
    got = host_aux.lidar_to_front(pts, to_port_config(cfg))
    assert got.dtype == np.float32 and got.shape == cfg.front.shape
    assert (got[..., 1] > 0).sum() > 1000
    want = native.lidar_to_front(pts, cfg)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, voxelize_ref.lidar_to_front_np(pts, cfg),
                               rtol=1e-5, atol=2e-5)
