"""Port parity: the PyTorch voxelizer (its sweep's plain version on the CPU)
against the JAX package, whose fused path runs the Pallas sweep in
interpret mode, and against the numpy oracle.

Tolerances: heights, intensity, count and occupancy are bit-exact; density
within 1 ulp (the two ``log`` implementations may differ in the last
bit); the front view within atol 5e-5 (sums and ``sqrt`` reassociate).
The CUDA kernel against its plain version is in tests/test_torch_cuda.py;
the folded layouts are in tests/test_torch_folded.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from mv3d_tpu.config import kitti_config
from mv3d_tpu.ops import voxelize as jvox
from mv3d_tpu.ops import voxelize_pallas, voxelize_ref
from mv3d_tpu_torch.ops import voxelize as tvox
from mv3d_tpu_torch.ops import voxelize_heights, voxelize_sweep

from test_torch_config import to_port_config

torch.set_num_threads(2)

CFG = kitti_config()
KITTI_ZN = CFG.top.zn


def jnp_dtype(dtype):
    """The JAX dtype of a torch heights dtype."""
    import jax.numpy as jnp
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

SMALL = dataclasses.replace(
    CFG, top=dataclasses.replace(CFG.top, x_max=8.0, y_min=-3.0, y_max=3.0),
    pipeline=dataclasses.replace(CFG.pipeline, use_pallas_fused=True))


def make_cloud(rng, n, cfg):
    """One cloud around the crop box, with exact slice-boundary z values
    and duplicated positions carrying different reflectance."""
    return chip_smoke.make_cloud(rng, 1, n, cfg, tricky=True)[0]


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.RandomState(7)
    raw = [make_cloud(rng, 3000, SMALL), make_cloud(rng, 2500, SMALL)]
    padded = [jvox.pad_points(p, 4096) for p in raw]
    batch = np.stack([p for p, _ in padded])
    num = np.array([n for _, n in padded], np.int32)
    return raw, batch, num


@pytest.fixture(scope="module")
def jax_views(clouds):
    _, batch, num = clouds
    top, occ = jvox.lidar_to_top_batch(batch, SMALL, num, return_occ=True)
    front = jvox.lidar_to_front_batch(batch, SMALL, num)
    return np.asarray(top), np.asarray(occ), np.asarray(front)


def _torch_views(batch, num, cfg=SMALL):
    pts = torch.from_numpy(batch)
    n = torch.from_numpy(num)
    cfg = to_port_config(cfg)
    top, occ = tvox.lidar_to_top_batch(pts, cfg, n, return_occ=True)
    return top.numpy(), occ.numpy(), tvox.lidar_to_front_batch(
        pts, cfg, n).numpy()


def test_top_view_matches_jax_fused_sweep(clouds, jax_views):
    _, batch, num = clouds
    jtop, jocc, _ = jax_views
    top, occ, _ = _torch_views(batch, num)
    zn = SMALL.top.zn
    assert top.shape == jtop.shape == (2, *SMALL.top.shape)
    np.testing.assert_array_equal(top[..., :zn + 1], jtop[..., :zn + 1])
    np.testing.assert_array_max_ulp(top[..., zn + 1], jtop[..., zn + 1],
                                    maxulp=1)
    np.testing.assert_array_equal(occ, jocc)


def test_top_view_matches_numpy_oracle(clouds):
    raw, batch, num = clouds
    top, _, _ = _torch_views(batch, num)
    zn = SMALL.top.zn
    for i, p in enumerate(raw):
        want = voxelize_ref.lidar_to_top_np(p, SMALL)
        np.testing.assert_array_equal(top[i, ..., :zn + 1], want[..., :zn + 1])
        np.testing.assert_array_max_ulp(top[i, ..., zn + 1], want[..., zn + 1],
                                        maxulp=1)


def test_front_view_matches_jax(clouds, jax_views):
    raw, batch, num = clouds
    _, _, jfront = jax_views
    _, _, front = _torch_views(batch, num)
    np.testing.assert_allclose(front, jfront, rtol=0, atol=5e-5)
    np.testing.assert_allclose(
        front[0], voxelize_ref.lidar_to_front_np(raw[0], SMALL),
        rtol=0, atol=5e-5)


def test_bf16_view_is_the_f32_view_rounded_once(clouds):
    _, batch, num = clouds
    bf16 = dataclasses.replace(SMALL, pipeline=dataclasses.replace(
        SMALL.pipeline, top_view_dtype="bfloat16"))
    pts, n = torch.from_numpy(batch), torch.from_numpy(num)
    top32, occ32 = tvox.lidar_to_top_batch(pts, to_port_config(SMALL), n,
                                           return_occ=True)
    top16, occ16 = tvox.lidar_to_top_batch(pts, to_port_config(bf16), n,
                                           return_occ=True)
    assert top16.dtype == torch.bfloat16
    assert torch.equal(top16, top32.to(torch.bfloat16))
    assert torch.equal(occ16, occ32)


def test_nonzero_threshold_occupancy_matches_jax(clouds):
    """remove_empty_thresh != 0 needs the true channel sum, not the count."""
    _, batch, num = clouds
    cfg = dataclasses.replace(SMALL, pipeline=dataclasses.replace(
        SMALL.pipeline, remove_empty_thresh=0.5))
    _, want = jvox.lidar_to_top_batch(batch, cfg, num, return_occ=True)
    _, got = tvox.lidar_to_top_batch(torch.from_numpy(batch),
                                     to_port_config(cfg),
                                     torch.from_numpy(num), return_occ=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_num_points_masks_in_bounds_junk(clouds):
    """Points past ``num_points`` are dropped even inside the crop box."""
    raw, batch, num = clouds
    junk = batch.copy()
    junk[0, num[0]:] = make_cloud(np.random.RandomState(3),
                                  junk.shape[1] - num[0], SMALL)
    top, _, _ = _torch_views(junk, num)
    clean, _, _ = _torch_views(batch, num)
    np.testing.assert_array_equal(top, clean)


def test_full_kitti_grid_shape_and_oracle(rng):
    pts = make_cloud(rng, 5000, CFG)
    padded, n = tvox.pad_points(pts, 8192)
    top, occ = tvox.lidar_to_top_batch(torch.from_numpy(padded[None]),
                                       to_port_config(CFG),
                                       return_occ=True)
    assert top.shape == (1, 800, 600, 27) and occ.shape == (1, 800, 600)
    want = voxelize_ref.lidar_to_top_np(pts, CFG)
    np.testing.assert_array_equal(top[0, ..., :26].numpy(), want[..., :26])


def test_sweep_plain_matches_bruteforce(rng):
    """The plain sweep against a per-point Python loop of its definition,
    including lowest-index tie-breaking on equal qz."""
    n_cells, zn, n = 7, 3, 200
    flat = rng.randint(0, n_cells * zn + 4, (2, n)).astype(np.int32)
    hval = rng.choice([0.25, 0.5, 1.0], (2, n)).astype(np.float32)
    refl = rng.uniform(0, 1, (2, n)).astype(np.float32)
    h, c, r = voxelize_sweep.scatter_top_fused_plain(
        torch.from_numpy(flat), torch.from_numpy(hval),
        torch.from_numpy(refl), n_cells, zn)
    for b in range(2):
        heights = np.zeros(n_cells * zn, np.float32)
        count = np.zeros(n_cells, np.float32)
        inten = np.zeros(n_cells, np.float32)
        best = np.full(n_cells, -1.0)
        for i in range(n):
            f = flat[b, i]
            if f >= n_cells * zn:
                continue
            heights[f] = max(heights[f], hval[b, i])
            cell = f // zn
            count[cell] += 1
            qz = np.float32(f % zn) + hval[b, i]
            if qz > best[cell]:
                best[cell], inten[cell] = qz, refl[b, i]
        np.testing.assert_array_equal(h[b].numpy(), heights)
        np.testing.assert_array_equal(c[b].numpy(), count)
        np.testing.assert_array_equal(r[b].numpy(), inten)


def test_cpu_tensors_take_the_plain_version(rng):
    before = voxelize_sweep.scatter_top_fused_batched.launches
    flat = torch.zeros(1, 8, dtype=torch.int32)
    out = voxelize_sweep.scatter_top_fused_batched(
        flat, torch.ones(1, 8), torch.ones(1, 8), 4, 2)
    assert voxelize_sweep.scatter_top_fused_batched.launches == before
    assert out[1][0, 0] == 8 and out[0][0, 0] == 1.0
    with pytest.raises(ValueError):
        voxelize_sweep.scatter_top_fused_kernel(
            flat, torch.ones(1, 8), torch.ones(1, 8), 4, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("total_cells", [481401, 2 * 481401, 8 * 481401,
                                         2000, 100])
def test_sweep_tile_plan_covers_every_cell(total_cells, dtype):
    """K1's tiles over the batch's cells taken as one array: consecutive
    runs of ``tile`` cells that cover [0, total_cells) once, in order, the
    last one possibly partial (every KITTI batch's is: 481,401 cells a
    frame); every tile starts on a 16-byte boundary of the heights (f32
    or bf16, zn = 25), count and intensity planes, as bulk copies need; a
    sweep block's two tile buffers fit in one H100 block."""
    zn = 25
    tile, n_tiles, smem = voxelize_sweep.tile_plan(total_cells, zn)
    assert tile >= 8 and tile & (tile - 1) == 0
    assert tile <= voxelize_sweep.TILE_CELLS
    bounds = [(t * tile, min((t + 1) * tile, total_cells))
              for t in range(n_tiles)]
    assert bounds[0][0] == 0 and bounds[-1][1] == total_cells
    assert all(lo < hi and hi - lo <= tile for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(hi - lo == tile for lo, hi in bounds[:-1])
    esize = 2 if dtype == torch.bfloat16 else 4
    for lo, _ in bounds:
        assert lo * zn * esize % 16 == 0 and lo * 4 % 16 == 0
    # f32 heights, 64-bit winner, count, intensity; bf16 rounds in place
    assert smem == 2 * tile * (zn * 4 + 16) <= 232448
    if total_cells == 481401:     # one KITTI frame: 1,881 tiles of 256
        assert (tile, n_tiles) == (256, 1881)
        assert bounds[-1][1] - bounds[-1][0] == 121
        assert smem == 59392      # three blocks to an H100 SM


def test_sweep_tile_plan_shrinks_for_tall_columns():
    """A tall column of slices halves the tile until two buffers fit;
    heights come in f32 or bf16 only."""
    tile, _, smem = voxelize_sweep.tile_plan(10000, 300)
    assert tile == 64 and smem == 2 * 64 * (300 * 4 + 16) <= 232448
    flat = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        voxelize_sweep.scatter_top_fused_batched(
            flat, torch.ones(1, 8), torch.ones(1, 8), 4, 2,
            heights_dtype=torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["one tile", "one cell", "last tile",
                                  "padding"])
def test_sweep_plain_matches_jax_on_skewed_clouds(kind, dtype):
    """K1's plain version against JAX's ``scatter_top_fused_batched``
    (interpret mode) with the same ``heights_dtype``, on
    ``chip_smoke.sweep_cases`` (B=2 frames of 1,000 cells, so the kernel's
    last tile holds 208 of 256 cells): every frame's points in one tile's
    span, all in one cell (qz ties decided by the lowest index), in the
    last cells with padding beyond n_cells*zn, all padding. Bit-exact in
    f32 and bf16 (the f32 max rounded once)."""
    n_cells, zn = 1000, KITTI_ZN
    flat, hval, refl = chip_smoke.sweep_cases(
        np.random.RandomState(13), 2, 1024, n_cells, zn)[kind]
    got = voxelize_sweep.scatter_top_fused_batched(
        *(torch.from_numpy(x) for x in (flat, hval, refl)), n_cells, zn,
        heights_dtype=dtype)
    want = voxelize_pallas.scatter_top_fused_batched(
        flat, hval, refl, n_cells, zn, interpret=True,
        heights_dtype=jnp_dtype(dtype))
    assert got[0].dtype == dtype
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))
    occupied = int((got[1] > 0).sum())
    assert occupied == {"one cell": 2, "padding": 0}.get(kind, occupied)
    assert occupied > 0 or kind == "padding"


@pytest.mark.parametrize("thresh", [0.0, 0.5])
@pytest.mark.parametrize("layout", ["hwc", "s2d2"])
def test_bf16_view_matches_jax(clouds, layout, thresh):
    """The hwc and s2d2 views at top_view_dtype="bfloat16" (K1 writes bf16
    heights, as the JAX caller asks its kernel to) against JAX's eager
    ``lidar_to_top_batch``: heights and intensity bit-equal, density
    within 1 bf16 ulp; the occupancy equal at threshold 0 (the count) and
    within 1e-6 at 0.5, where both sum the bf16 heights."""
    _, batch, num = clouds
    cfg = dataclasses.replace(SMALL, pipeline=dataclasses.replace(
        SMALL.pipeline, top_view_dtype="bfloat16", view_layout=layout,
        remove_empty_thresh=thresh))
    jtop, jocc = (np.asarray(x).astype(np.float32) for x in
                  jvox.lidar_to_top_batch(batch, cfg, num, return_occ=True))
    top, occ = tvox.lidar_to_top_batch(
        torch.from_numpy(batch), to_port_config(cfg), torch.from_numpy(num),
        return_occ=True)
    assert top.dtype == torch.bfloat16 and top.shape == jtop.shape
    top = top.float().numpy()
    zn = SMALL.top.zn
    if layout == "hwc":
        exact, dens = np.s_[..., :zn + 1], np.s_[..., zn + 1]
    else:
        exact, dens = np.s_[..., :-4], np.s_[..., -4:]
    np.testing.assert_array_equal(top[exact], jtop[exact])
    np.testing.assert_allclose(top[dens], jtop[dens], rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(occ.numpy(), jocc, rtol=1e-6, atol=1e-6)
    if thresh == 0.0:
        np.testing.assert_array_equal(occ.numpy(), jocc)


@pytest.fixture(scope="module")
def host_aux_planes(clouds):
    """The JAX package's native (or numpy) host aux planes of the clouds."""
    from mv3d_tpu import native
    _, batch, num = clouds
    return np.stack([native.lidar_to_top_aux(p[:n], SMALL)
                     for p, n in zip(batch, num)])


def test_heights_plain_matches_jax_scatter_max_sorted(clouds):
    """The heights kernel's plain version against the JAX Pallas kernel it
    replaces (``scatter_max_sorted`` in interpret mode) and the numpy
    oracle's height channels: bit-exact."""
    from mv3d_tpu.ops import voxelize_pallas
    raw, batch, num = clouds
    t = SMALL.top
    n_flat = t.xn * t.yn * t.zn
    _, _, flat, val, _ = tvox._top_prep(torch.from_numpy(batch),
                                        to_port_config(SMALL),
                                        torch.from_numpy(num))
    got = voxelize_heights.scatter_max_plain(flat, val, n_flat).numpy()
    for i in range(2):
        want = np.asarray(voxelize_pallas.scatter_max_sorted(
            flat[i].numpy(), val[i].numpy(), n_flat, interpret=True))
        np.testing.assert_array_equal(got[i], want)
        oracle = voxelize_ref.lidar_to_top_np(raw[i], SMALL)[..., :t.zn]
        np.testing.assert_array_equal(got[i].reshape(oracle.shape), oracle)


def test_aux_branch_matches_jax(clouds, host_aux_planes):
    """``lidar_to_top_batch(aux=...)``: heights through the heights kernel
    (the JAX side through ``scatter_max_sorted``, interpret mode), the
    host plane concatenated; view and occupancy (the full channel sum)
    bit-exact."""
    _, batch, num = clouds
    cfg = dataclasses.replace(SMALL, pipeline=dataclasses.replace(
        SMALL.pipeline, use_pallas_fused=False, use_pallas_heights=True))
    jtop, jocc = jvox.lidar_to_top_batch(batch, cfg, num,
                                         aux=host_aux_planes,
                                         return_occ=True)
    top, occ = tvox.lidar_to_top_batch(
        torch.from_numpy(batch), to_port_config(cfg), torch.from_numpy(num),
        aux=torch.from_numpy(host_aux_planes), return_occ=True)
    assert top.dtype == torch.float32 and top.shape == jtop.shape
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_heights_cpu_tensors_take_the_plain_version():
    before = voxelize_heights.scatter_max_batched.launches
    flat = torch.tensor([[0, 3, 3, 8, -1]], dtype=torch.int32)
    val = torch.tensor([[0.5, 0.25, 0.75, 1.0, 1.0]])
    out = voxelize_heights.scatter_max_batched(flat, val, 8)
    assert voxelize_heights.scatter_max_batched.launches == before
    np.testing.assert_array_equal(out.numpy(),
                                  [[0.5, 0, 0, 0.75, 0, 0, 0, 0]])
    with pytest.raises(ValueError):
        voxelize_heights.scatter_max_kernel(flat, val, 8)
