"""Port parity of the folded view layouts (``view_layout`` ``"s2d2"`` and
``"s2d2p"``) and of the JAX package's serving configuration (``s2d2p``,
bf16 top view, ``roi_align_impl="matmul"``), against the JAX package on
the CPU: its Pallas sweeps run in interpret mode and its views are built
eagerly (under ``jit`` on the CPU, XLA divides by a constant as a
reciprocal multiply; see tests/test_torch_train.py).

Tolerances: views, folded occupancy and the lane-padded sweep bit-exact
(density within 1 f32 ulp, or 1 bf16 ulp in a bf16 view); the anchor
masks exact; the trunks with converted weights in f32 within rtol/atol
1e-4 (cuDNN-free CPU convs sum in another order than XLA's); the split
stem built from an s2d2 stem within atol 2e-4, as the JAX package's own
test; ``roi_align_matmul`` within atol 1e-5 (the einsums sum in another
order); the whole slice: masks exact, boxes3d within atol 1e-3 and probs
within atol 1e-4 on live slots, as tests/test_torch_slice.py. The CUDA
kernel against its plain version is in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _tiny_config
from mv3d_tpu.config import kitti_config
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.models.mv3d_net import (
    project_to_rgb_roi as jax_project_to_rgb_roi)
from mv3d_tpu.models.mv3d_net import total_loss as jax_total_loss
from mv3d_tpu.ops import roi_align as jroi
from mv3d_tpu.ops import voxelize as jvox
from mv3d_tpu.ops import voxelize_pallas
from mv3d_tpu.train.trainer import _prepare_views as jax_prepare_views
from mv3d_tpu_torch import convert, serving_config
from mv3d_tpu_torch.models.mv3d_net import MV3DNet
from mv3d_tpu_torch.ops import roi_align as troi
from mv3d_tpu_torch.ops import voxelize as tvox
from mv3d_tpu_torch.ops import voxelize_padded
from mv3d_tpu_torch.data import loader as tloader
from mv3d_tpu_torch.models.mv3d_net import project_to_rgb_roi, total_loss
from mv3d_tpu_torch.models.nets import SUBNET_NAMES, TOP_VIEW_RPN
from mv3d_tpu_torch.train.trainer import MV3D, Trainer, _prepare_views

from test_torch_config import to_port_config
from test_torch_models import randomize_bn
from test_torch_train import _flax_grads, _leaves, noise_from_key

torch.set_num_threads(2)

KITTI = kitti_config()
SMALL = dataclasses.replace(       # 80 x 60 x 25: w2p = 32, n_sc = 1,280
    KITTI, top=dataclasses.replace(KITTI.top, x_max=8.0, y_min=-3.0,
                                   y_max=3.0),
    pipeline=dataclasses.replace(KITTI.pipeline, use_pallas_fused=True))
TINY = dataclasses.replace(
    _tiny_config(),
    model=dataclasses.replace(_tiny_config().model, compute_dtype="float32"),
    pipeline=dataclasses.replace(_tiny_config().pipeline,
                                 use_pallas_fused=True))
TOL = dict(rtol=1e-4, atol=1e-4)
THRESH = 0.05
LAYOUTS = ["s2d2", "s2d2p"]


def with_pipeline(cfg, **kw):
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **kw))


def serving(cfg):
    """``bench.py``'s accelerator configuration on a JAX ``cfg``."""
    cfg = with_pipeline(cfg, use_pallas_fused=True, use_pallas_heights=True,
                        view_layout="s2d2p", top_view_dtype="bfloat16")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, roi_align_impl="matmul"))


def test_port_serving_config_is_bench_configuration():
    assert serving_config(to_port_config(KITTI)) \
        == to_port_config(serving(KITTI))


def _as_np(x):
    if isinstance(x, (tuple, list)):
        return [_as_np(v) for v in x]
    if torch.is_tensor(x):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.RandomState(7)
    padded = [jvox.pad_points(chip_smoke.make_cloud(rng, 1, n, SMALL,
                                                    tricky=True)[0], 4096)
              for n in (3000, 2500)]
    return (np.stack([p for p, _ in padded]),
            np.array([n for _, n in padded], np.int32))


def _check_view(got, want, layout, dtype):
    got, want = _as_np(got), _as_np(want)
    if layout == "s2d2p":
        np.testing.assert_array_equal(got[0], want[0])
        got, want = got[1], want[1]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., :-4], want[..., :-4])
    if dtype == "float32":
        np.testing.assert_array_max_ulp(got[..., -4:], want[..., -4:],
                                        maxulp=1)
    else:
        np.testing.assert_allclose(got[..., -4:], want[..., -4:],
                                   rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_folded_view_matches_jax(clouds, layout, dtype):
    """``lidar_to_top_batch`` in the folded layouts against the JAX package
    (its K1/K2 in interpret mode): view and folded occupancy."""
    batch, num = clouds
    cfg = with_pipeline(SMALL, view_layout=layout, top_view_dtype=dtype)
    jtop, jocc = jvox.lidar_to_top_batch(batch, cfg, num, return_occ=True)
    top, occ = tvox.lidar_to_top_batch(torch.from_numpy(batch),
                                       to_port_config(cfg),
                                       torch.from_numpy(num), return_occ=True)
    want_dtype = getattr(torch, dtype)
    t = SMALL.top
    if layout == "s2d2p":
        w2p = tvox.folded_pad_width(t.yn)
        assert [x.dtype for x in top] == [want_dtype] * 2
        assert top[0].shape == (2, t.xn // 2, w2p, 128)
        assert top[1].shape == (2, t.xn // 2, w2p, 8)
        assert occ.shape == (2, t.xn // 2, w2p, 4)
    else:
        assert top.dtype == want_dtype
        assert top.shape == (2, t.xn // 2, t.yn // 2, 4 * (t.zn + 2))
        assert occ.shape == (2, t.xn // 2, t.yn // 2, 4)
    _check_view(top, jtop, layout, dtype)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_folded_nonzero_threshold_occupancy_matches_jax(clouds, layout):
    """``remove_empty_thresh != 0``: the folded occupancy is the true
    per-cell channel sum (s2d2p: from the sweep's f32 heights, whatever
    the view dtype), not the count; sums within rtol/atol 1e-6, as the hwc
    test."""
    batch, num = clouds
    cfg = with_pipeline(SMALL, view_layout=layout, remove_empty_thresh=0.5,
                        top_view_dtype="bfloat16")
    _, want = jvox.lidar_to_top_batch(batch, cfg, num, return_occ=True)
    _, got = tvox.lidar_to_top_batch(torch.from_numpy(batch),
                                     to_port_config(cfg),
                                     torch.from_numpy(num), return_occ=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_folded_view_is_the_folded_hwc_view(clouds, layout):
    """The folded views equal the fold of the port's own hwc view, and the
    unfolded occupancy equals the hwc occupancy (what chip_smoke checks on
    the card, here on the plain versions)."""
    batch, num = clouds
    pts, n = torch.from_numpy(batch), torch.from_numpy(num)
    top, occ = tvox.lidar_to_top_batch(pts, to_port_config(SMALL), n,
                                       return_occ=True)
    cfg = to_port_config(with_pipeline(SMALL, view_layout=layout))
    ftop, focc = tvox.lidar_to_top_batch(pts, cfg, n, return_occ=True)
    fold = tvox.fold_view_s2d2p if layout == "s2d2p" else tvox.fold_view_s2d2
    want = fold(top)
    if layout == "s2d2p":
        assert all(torch.equal(a, b) for a, b in zip(ftop, want))
    else:
        assert torch.equal(ftop, want)
    assert torch.equal(tvox.unfold_occ4(focc, SMALL.top.xn, SMALL.top.yn),
                       occ)


def test_fold_helpers_match_jax():
    rng = np.random.RandomState(3)
    view = rng.rand(2, 80, 60, 27).astype(np.float32)
    occ4 = rng.rand(2, 40, 32, 4).astype(np.float32)
    np.testing.assert_array_equal(
        tvox.fold_view_s2d2(torch.from_numpy(view)).numpy(),
        np.asarray(jvox.fold_view_s2d2(view)))
    for g, w in zip(tvox.fold_view_s2d2p(torch.from_numpy(view)),
                    jvox.fold_view_s2d2p(view)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tvox.unfold_occ4(torch.from_numpy(occ4), 80, 60).numpy(),
        np.asarray(jvox.unfold_occ4(occ4, 80, 60)))
    for yn in (60, 64, 66, 600):
        assert tvox.folded_pad_width(yn) == jvox.folded_pad_width(yn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_plain_matches_jax_kernel(clouds, dtype):
    """The lane-padded sweep's plain version against the JAX Pallas kernel
    it replaces (``scatter_top_padded_batched``, interpret mode) on the
    s2d2p quantization of the clouds: bit-exact in f32 and bf16."""
    batch, num = clouds
    t = SMALL.top
    n_sc = (t.xn // 2) * tvox.folded_pad_width(t.yn)
    _, _, flat, val, refl = tvox._top_prep(
        torch.from_numpy(batch), to_port_config(SMALL), torch.from_numpy(num),
        s2d="pad")
    refl = torch.where(flat < n_sc * 128, refl, 0.0)
    got = voxelize_padded.scatter_top_padded_plain(flat, val, refl, n_sc,
                                                   t.zn, dtype)
    want = voxelize_pallas.scatter_top_padded_batched(
        flat.numpy(), val.numpy(), refl.numpy(), n_sc, t.zn, interpret=True,
        heights_dtype=jnp.bfloat16 if dtype == torch.bfloat16
        else jnp.float32)
    assert got[0].dtype == dtype
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_as_np(g), _as_np(w).reshape(g.shape))


def test_padded_plain_matches_bruteforce(rng):
    """The plain lane-padded sweep against a per-point loop of its
    definition: lane decode, pad lanes and out-of-range ids dropped,
    lowest-index tie-breaking, bf16 as the f32 max rounded once."""
    n_sc, zn, n = 5, 3, 300
    lanes = rng.randint(0, 4 * zn + 3, (2, n))          # some pad lanes
    flat = (rng.randint(0, n_sc + 1, (2, n)) * 128 + lanes).astype(np.int32)
    hval = rng.choice([0.25, 0.5, 1.0, 1e-3], (2, n)).astype(np.float32)
    refl = rng.uniform(0, 1, (2, n)).astype(np.float32)
    args = (torch.from_numpy(flat), torch.from_numpy(hval),
            torch.from_numpy(refl), n_sc, zn)
    h, c, r = voxelize_padded.scatter_top_padded_plain(*args)
    h16, c16, r16 = voxelize_padded.scatter_top_padded_plain(
        *args, heights_dtype=torch.bfloat16)
    for b in range(2):
        heights = np.zeros(n_sc * 128, np.float32)
        count = np.zeros(n_sc * 4, np.float32)
        inten = np.zeros(n_sc * 4, np.float32)
        best = np.full(n_sc * 4, -1.0)
        for i in range(n):
            f = flat[b, i]
            lane, sub = f % 128, (f % 128) // zn
            if f >= n_sc * 128 or sub >= 4:
                continue
            heights[f] = max(heights[f], hval[b, i])
            cell = (f // 128) * 4 + sub
            count[cell] += 1
            qz = np.float32(lane - sub * zn) + hval[b, i]
            if qz > best[cell]:
                best[cell], inten[cell] = qz, refl[b, i]
        np.testing.assert_array_equal(h[b].numpy(), heights)
        np.testing.assert_array_equal(c[b].numpy(), count)
        np.testing.assert_array_equal(r[b].numpy(), inten)
        assert torch.equal(h16[b], torch.from_numpy(heights).bfloat16())
    assert torch.equal(c16, c) and torch.equal(r16, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_sc", [1, 5, 64, 200, 1280, 121600])
def test_padded_tile_plan_covers_every_supercell(n_sc, dtype):
    """The K2 kernel's tiles: consecutive runs of at most TILE_SC
    supercells that cover [0, n_sc) once, the last one possibly partial;
    every supercell's tile (``sc // tile_sc``, as the kernel bins) is one of
    them; a tile's shared memory (f32 heights, 64-bit winners, int32
    counts, whatever the output dtype) fits in one H100 block."""
    tile_sc, n_tiles, smem = voxelize_padded.tile_plan(n_sc, dtype)
    assert 1 <= tile_sc <= voxelize_padded.TILE_SC
    bounds = [(t * tile_sc, min((t + 1) * tile_sc, n_sc))
              for t in range(n_tiles)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n_sc
    assert all(lo < hi and hi - lo <= tile_sc for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sc = np.arange(n_sc)
    tiles = sc // tile_sc
    assert tiles.max() == n_tiles - 1
    lo = np.array([b[0] for b in bounds])[tiles]
    hi = np.array([b[1] for b in bounds])[tiles]
    assert ((lo <= sc) & (sc < hi)).all()
    assert smem == tile_sc * (128 * 4 + 4 * 8 + 4 * 4)
    assert smem <= 232448         # what one H100 block may use (227 KB)
    if n_sc == 121600:            # the KITTI width: 1,900 full tiles
        assert (tile_sc, n_tiles, smem) == (64, 1900, 35840)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["one tile", "one cell", "last tile",
                                  "pad lanes"])
def test_padded_plain_matches_jax_on_skewed_clouds(kind, dtype):
    """The K2 plain version against JAX's ``scatter_top_padded_batched``
    (interpret mode) on ``chip_smoke.padded_cases`` (n_sc = 200, so the
    kernel's last tile holds 8 supercells): all points in one tile, all in
    one cell (qz ties decided by the lowest index), in the last partial
    tile with padding beyond n_sc*128, and lanes over all 128. The port
    treats lanes >= 4*zn as padding, where JAX, whose quantizer never
    emits them, would spill into the next cell: JAX gets those points as
    padding. Bit-exact in f32 and bf16."""
    n_sc, zn = 200, KITTI.top.zn
    flat, hval, refl = chip_smoke.padded_cases(
        np.random.RandomState(9), 2, 1024, n_sc, zn)[kind]
    got = voxelize_padded.scatter_top_padded_plain(
        *(torch.from_numpy(x) for x in (flat, hval, refl)), n_sc, zn, dtype)
    pad_lane = ((flat % 128) >= 4 * zn) & (flat < n_sc * 128)
    assert pad_lane.any() == (kind == "pad lanes")
    want = voxelize_pallas.scatter_top_padded_batched(
        np.where(pad_lane, n_sc * 128, flat).astype(np.int32), hval, refl,
        n_sc, zn, interpret=True,
        heights_dtype=jnp.bfloat16 if dtype == torch.bfloat16
        else jnp.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_as_np(g), _as_np(w).reshape(g.shape))
    if kind == "one cell":
        assert int((got[1] > 0).sum()) == 2       # one cell per frame
    assert (got[1] > 0).sum() > 0


def test_padded_cpu_tensors_take_the_plain_version():
    before = voxelize_padded.scatter_top_padded_batched.launches
    flat = torch.tensor([[0, 130, 130, 131, 256]], dtype=torch.int32)
    out = voxelize_padded.scatter_top_padded_batched(
        flat, torch.tensor([[0.5, 0.25, 0.75, 1.0, 1.0]]),
        torch.tensor([[0.1, 0.2, 0.3, 0.4, 0.5]]), 2, 2)
    assert voxelize_padded.scatter_top_padded_batched.launches == before
    assert out[0][0, 130] == 0.75 and out[0][0, 131] == 1.0
    assert out[1][0, 5] == 3 and out[2][0, 5] == 0.4    # cell 1*4 + 1
    with pytest.raises(ValueError):
        voxelize_padded.scatter_top_padded_kernel(
            flat, torch.ones(1, 5), torch.ones(1, 5), 2, 2)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_folded_layouts_refuse_host_aux(layout):
    cfg = to_port_config(with_pipeline(SMALL, view_layout=layout))
    with pytest.raises(ValueError, match="aux"):
        tvox.lidar_to_top_batch(torch.zeros(1, 16, 4), cfg,
                                aux=torch.zeros(1, 80, 60, 2))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_trainer_refuses_folded_layouts(layout, tmp_path, train_batch):
    """The trainer refuses the folded layouts only with the host aux plane
    (as the JAX voxelizer does: they compute every channel on the card),
    and trains in them without it."""
    cfg = to_port_config(with_pipeline(TINY, view_layout=layout))
    tr = Trainer(None, cfg=cfg, device="cpu", checkpoint_dir=str(tmp_path),
                 log_dir=str(tmp_path))
    aux = np.zeros((2, TINY.top.xn, TINY.top.yn, 2), np.float32)
    with pytest.raises(ValueError, match="aux"):
        tr.fit_iteration(dict(train_batch, top_aux=aux))
    losses = tr.fit_iteration(train_batch)
    assert np.isfinite(list(losses.values())).all()


@pytest.mark.parametrize("change", [
    dict(model=dict(stem_space_to_depth=False)),
    dict(top=dict(x_max=17.0)),                       # xn = 85
    dict(top=dict(z_min=-9.0, z_div=0.25))])          # 4 * zn > 128
def test_folded_model_checks_raise(change):
    """The JAX constructor's checks: folded layouts need the
    space-to-depth stem and an even grid; s2d2p needs 4*zn <= 128."""
    cfg = with_pipeline(TINY, view_layout="s2d2p")
    cfg = dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v)
        for k, v in change.items()})
    with pytest.raises(ValueError):
        MV3DNet(to_port_config(cfg))


@pytest.fixture(scope="module")
def folded_models():
    """layout -> (JAX model, randomized variables, port model with the
    converted variables), f32 compute."""
    out = {}
    for i, layout in enumerate(LAYOUTS):
        cfg = with_pipeline(TINY, view_layout=layout)
        jm = JaxMV3DNet(cfg)
        variables = randomize_bn(jax.jit(jm.init_variables)(
            jax.random.PRNGKey(i)), seed=10 + i)
        model = MV3DNet(to_port_config(cfg))
        convert.load_variables(model, variables)
        out[layout] = (jm, variables, model.eval())
    return out


def _sparse_top(seed, b=2, keep=0.2):
    rng = np.random.RandomState(seed)
    shape = (b, *TINY.top_shape)
    return (rng.rand(*shape) * (rng.rand(*shape) < keep)).astype(np.float32)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_folded_top_rpn_matches_flax(folded_models, layout):
    """TopRPN with the prefolded (s2d2) or split (s2d2p) stem and converted
    weights, BatchNorm statistics random, against flax."""
    jm, variables, model = folded_models[layout]
    top = torch.from_numpy(_sparse_top(1))
    fold = tvox.fold_view_s2d2p if layout == "s2d2p" else tvox.fold_view_s2d2
    view = fold(top)
    jview = (tuple(x.numpy() for x in view) if layout == "s2d2p"
             else view.numpy())
    want = jax.jit(lambda v, a: jm.top_rpn.apply(v, a, False))(
        variables["top_view_rpn"], jview)
    with torch.no_grad():
        got = model.top_rpn(view)
    for k in ("features", "scores", "deltas"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_split_stem_from_s2d2_stem_gives_s2d2_outputs(folded_models):
    """The port's split-stem TopRPN, its stem built from the s2d2 model's
    (heights lanes = the first 4*zn folded channels, zero above; aux conv
    = the last 8; the same BatchNorm), gives the s2d2 model's outputs on
    the same view (tests/test_model.py's split-stem equivalence)."""
    fold_net = folded_models["s2d2"][2].top_rpn
    pad_net = MV3DNet(to_port_config(with_pipeline(
        TINY, view_layout="s2d2p"))).eval().top_rpn
    sd = {k: v.clone() for k, v in fold_net.state_dict().items()
          if not k.startswith("trunk.ConvBnRelu_0.")}
    zn = TINY.top.zn
    k = fold_net.trunk.ConvBnRelu_0.Conv_0.weight            # (64, 4c, 3, 3)
    sd["trunk.stem_h.weight"] = torch.cat(
        [k[:, :4 * zn], k.new_zeros(k.shape[0], 128 - 4 * zn, 3, 3)], 1)
    sd["trunk.stem_aux.weight"] = k[:, 4 * zn:].clone()
    for name, t in fold_net.trunk.ConvBnRelu_0.BatchNorm_0.state_dict(
            ).items():
        sd[f"trunk.stem_bn.{name}"] = t.clone()
    pad_net.load_state_dict(sd)
    top = torch.from_numpy(_sparse_top(2, b=1) * 0.5)
    with torch.no_grad():
        want = fold_net(tvox.fold_view_s2d2(top))
        got = pad_net(tvox.fold_view_s2d2p(top))
    for key in ("scores", "features"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=0, atol=2e-4, err_msg=key)


@pytest.mark.parametrize("source", ["view", "voxelizer"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_folded_anchor_mask_matches_jax(folded_models, layout, source):
    """``anchor_mask`` on the folded occupancy against the JAX model's
    (its parity-decomposed window sums): from the view's channel sums
    (tests/test_model.py's layout equivalence, a sparse random view) and
    from the voxelizer's count occupancy. Exact, and equal to the hwc
    mask of the same scene."""
    jm, _, model = folded_models[layout]
    fold = tvox.fold_view_s2d2p if layout == "s2d2p" else tvox.fold_view_s2d2
    if source == "view":
        top = _sparse_top(3, keep=0.3)
        view, occ = fold(torch.from_numpy(top)), None
        jview = ([x.numpy() for x in view] if layout == "s2d2p"
                 else view.numpy())
        hwc = MV3DNet(to_port_config(TINY)).anchor_mask(
            torch.from_numpy(top))
        want = [np.asarray(jm.anchor_mask(
            tuple(x[i] for x in jview) if layout == "s2d2p" else jview[i]))
            for i in range(2)]
    else:
        pts, num, _ = _requests(6)
        cfg = with_pipeline(TINY, view_layout=layout)
        view, occ = tvox.lidar_to_top_batch(
            torch.from_numpy(pts), to_port_config(cfg),
            torch.from_numpy(num), return_occ=True)
        htop, hocc = tvox.lidar_to_top_batch(
            torch.from_numpy(pts), to_port_config(TINY),
            torch.from_numpy(num), return_occ=True)
        hwc = MV3DNet(to_port_config(TINY)).anchor_mask(htop, hocc)
        jview, jocc = jvox.lidar_to_top_batch(pts, cfg, num, return_occ=True)
        want = [np.asarray(jm.anchor_mask(
            tuple(x[i] for x in jview) if layout == "s2d2p" else jview[i],
            occ=jocc[i])) for i in range(2)]
    got = model.anchor_mask(view, occ).numpy()
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got, np.stack(want))
    np.testing.assert_array_equal(got, hwc.numpy())


def test_roi_align_matmul_matches_jax():
    """``roi_align_matmul`` batched over frames against the JAX einsums
    per frame, in f32, with in-range and edge-touching ROIs (the JAX test's
    (-8, -8, 40, 40)): the same variant, so the clamped edge taps agree
    too. The gather variant differs from both at the edge."""
    rng = np.random.RandomState(7)
    h, w, c = 40, 30, 16
    feat = rng.rand(2, h, w, c).astype(np.float32)
    rois = []
    for _ in range(2 * 12):
        x1, y1 = rng.uniform(0, 8 * (w - 10)), rng.uniform(0, 8 * (h - 10))
        rois.append([x1, y1, x1 + rng.uniform(16, 60),
                     y1 + rng.uniform(16, 60)])
    rois = np.array(rois, np.float32).reshape(2, 12, 4)
    rois[:, 0] = [-8.0, -8.0, 40.0, 40.0]
    rois[1, 1] = [8 * w - 30.0, 8 * h - 20.0, 8 * w + 24.0, 8 * h + 40.0]
    got = troi.roi_align_matmul(torch.from_numpy(feat),
                                torch.from_numpy(rois), 1 / 8.0, (6, 6), 2)
    assert got.shape == (2, 12, 6, 6, c) and got.dtype == torch.float32
    for b in range(2):
        want = np.asarray(jroi.roi_align_matmul(feat[b], rois[b], 1 / 8.0,
                                                (6, 6), 2))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=1e-5)
        inside = np.asarray(jroi.roi_align(feat[b], rois[b, 2:], 1 / 8.0,
                                           (6, 6), 2))
        np.testing.assert_allclose(got[b, 2:].numpy(), inside, rtol=0,
                                   atol=1e-5)
    gather = troi.roi_align(torch.from_numpy(feat), torch.from_numpy(rois),
                            1 / 8.0, (6, 6), 2)
    assert (gather[:, 0] - got[:, 0]).abs().max() > 1e-3


def _requests(seed, b=2):
    """Clouds drawn as bench.py draws them (scaled to the tiny grid), with
    a short second frame, and random rgb."""
    rng = np.random.RandomState(seed)
    n = TINY.pipeline.max_points
    t = TINY.top
    pts = np.stack([rng.uniform(t.x_min, t.x_max, (b, n)),
                    rng.uniform(t.y_min, t.y_max, (b, n)),
                    rng.uniform(t.z_min, t.z_max, (b, n)),
                    rng.uniform(0, 1, (b, n))], axis=-1).astype(np.float32)
    num = np.array([n, n - 300], np.int32)[:b]
    rgb = rng.rand(b, *TINY.rgb_shape).astype(np.float32)
    return pts, num, rgb


@pytest.fixture(scope="module")
def serving_pair():
    """The JAX package's serving configuration on the tiny grid with f32
    compute: the JAX model (views built eagerly, the rest jitted) and the
    port's ``MV3D`` on the CPU with the converted weights."""
    cfg = serving(TINY)
    jm = JaxMV3DNet(cfg)
    variables = randomize_bn(jax.jit(jm.init_variables)(
        jax.random.PRNGKey(0)), seed=5)
    infer = jax.jit(lambda v, top, occ, rgb: jm.forward_inference(
        v, top, rgb, None, score_threshold=THRESH, top_occ=occ))

    def jax_serve(points, num, rgb):
        top, occ = jvox.lidar_to_top_batch(points, cfg, num, return_occ=True)
        return infer(variables, top, occ, rgb)

    port = MV3D(to_port_config(cfg), device="cpu", variables=variables)
    return jax_serve, port


@pytest.mark.parametrize("seed", [0, 1])
def test_serving_configuration_matches_jax(serving_pair, seed):
    """The whole s2d2p + bf16 view + matmul ROI-align slice,
    ``predict_from_points`` against the JAX package's forward_inference
    with the same weights: the voxelizer's plain K2 here against its
    Pallas K2 in interpret mode there."""
    jax_serve, port = serving_pair
    pts, num, rgb = _requests(seed)
    jdets, jprops = jax_serve(pts, num, rgb)
    dets = port.predict_from_points(pts, num, rgb, score_threshold=THRESH)
    m = np.asarray(jdets.mask)
    assert m.sum() >= 1, "no live detection: the comparison would be empty"
    assert dets.boxes3d.shape == (2, TINY.rpn.nms_post_topn, 8, 3)
    np.testing.assert_array_equal(dets.mask.numpy(), m)
    np.testing.assert_allclose(dets.boxes3d.numpy()[m],
                               np.asarray(jdets.boxes3d)[m], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(dets.probs.numpy()[m],
                               np.asarray(jdets.probs)[m], rtol=0, atol=1e-4)


def test_serving_predict_from_pair_matches_points(serving_pair):
    """``predict`` on the port's own (heights, aux) pair gives
    ``predict_from_points``' detections (the anchor filter then sums the
    pair's lane groups instead of reading the count occupancy: the same
    zero-set); single frames are batched element by element."""
    _, port = serving_pair
    pts, num, rgb = _requests(4, b=1)
    want = port.predict_from_points(pts[0], num[0], rgb[0],
                                    score_threshold=THRESH)
    heights, aux = tvox.lidar_to_top_batch(torch.from_numpy(pts), port.cfg,
                                           torch.from_numpy(num))
    got = port.predict((heights[0], aux[0]), None, rgb[0],
                       score_threshold=THRESH)
    assert want.mask.any()
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.boxes3d, want.boxes3d)


def test_split_stem_weights_round_trip(serving_pair, tmp_path):
    """``stem_bn`` maps both ways: the converter round-trips the split
    stem's variables (BatchNorm statistics random), and an npz checkpoint
    in the JAX layout loads into a fresh model bit-equal."""
    _, port = serving_pair
    sd = port.model.top_rpn.state_dict()
    assert "trunk.stem_bn.running_var" in sd
    back = convert.subnet_variables(sd)
    stem_bn = back["params"]["trunk"]["stem_bn"]
    assert set(stem_bn) == {"scale", "bias"}
    assert set(back["batch_stats"]["trunk"]["stem_bn"]) == {"mean", "var"}
    grads_like = convert.subnet_variables(
        dict(port.model.top_rpn.named_parameters()))      # no running stats
    assert set(grads_like["params"]["trunk"]["stem_bn"]) == {"scale", "bias"}
    again = convert.subnet_state_dict(back)
    assert set(again) == set(sd)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k

    saver = MV3D(port.cfg, device="cpu", seed=3,
                 checkpoint_dir=str(tmp_path), log_dir=str(tmp_path))
    saver.save_weights(step=1)
    fresh = MV3D(port.cfg, device="cpu", seed=4,
                 checkpoint_dir=str(tmp_path), log_dir=str(tmp_path))
    fresh.load_weights()
    for name, module in saver.model.subnets.items():
        for (ka, va), (kb, vb) in zip(module.state_dict().items(),
                                      fresh.model.subnets[name]
                                      .state_dict().items()):
            assert ka == kb and torch.equal(va, vb), (name, ka)


# -- training in the folded layouts ------------------------------------------

@pytest.fixture(scope="module")
def train_batch():
    """Two synthetic frames with planted cars, without the host aux plane
    (the folded layouts compute every channel on the card)."""
    cfg = to_port_config(with_pipeline(TINY, host_aux_channels=False))
    drive = chip_smoke.SynthDrive(np.random.RandomState(2), cfg, 2, 3000,
                                  cars=(2, 3))
    batch = tloader.frames_to_batch(drive.frames, cfg)
    return {k: v for k, v in batch.items() if k != "tags"}


@pytest.fixture(scope="module", params=LAYOUTS)
def folded_training(request, train_batch):
    """The RPN stage's training forward and gradients in a folded layout:
    the JAX step (views made eagerly, one jitted value_and_grad, its own
    draws) and the port's on the converted weights and the same draws."""
    layout = request.param
    cfg = with_pipeline(TINY, view_layout=layout, host_aux_channels=False)
    pcfg = to_port_config(cfg)
    jm = JaxMV3DNet(cfg)
    variables = randomize_bn(jax.jit(jm.init_variables)(
        jax.random.PRNGKey(0)), seed=3)
    key = jax.random.PRNGKey(11)

    @jax.jit
    def ref(variables, batch, key):
        def f(p_rpn):
            var = {n: dict(variables[n]) for n in SUBNET_NAMES}
            var[TOP_VIEW_RPN]["params"] = p_rpn
            ld, aux = jm.forward_train(var, batch, key, train=True)
            return jax_total_loss(ld, (TOP_VIEW_RPN,), cfg), (ld, aux)

        (_, (ld, aux)), g = jax.value_and_grad(f, has_aux=True)(
            variables[TOP_VIEW_RPN]["params"])
        return ld, aux["rpn_targets"], aux["fusion_targets"], g

    views = jax_prepare_views({k: jnp.asarray(v)
                               for k, v in train_batch.items()}, cfg)
    ld, rpn_tg, fus_tg, grads = jax.tree.map(np.asarray,
                                             ref(variables, views, key))
    model = MV3DNet(pcfg)
    convert.load_variables(model, variables)
    batch = _prepare_views({k: torch.from_numpy(v)
                            for k, v in train_batch.items()}, pcfg, False)
    noise = {k: torch.from_numpy(v)
             for k, v in noise_from_key(key, 2, cfg).items()}
    pld, aux = model.forward_train(batch, noise)
    total_loss(pld, (TOP_VIEW_RPN,), pcfg).backward(
        inputs=list(model.top_rpn.parameters()))
    return dict(layout=layout, want=(ld, rpn_tg, fus_tg, grads),
                got=(pld, aux["rpn_targets"], aux["fusion_targets"],
                     _flax_grads(model.top_rpn)))


def test_folded_training_losses_and_targets_match_jax(folded_training):
    """Target masks and labels exact; the RPN losses within rtol 1e-4
    (tests/test_torch_train.py's hwc case); the fusion losses within rtol
    1e-4 where no rgb ROI corner moved and within 1e-2 where one did (a
    last-bit difference in a proposal moves an int-truncated corner by a
    pixel and with it that ROI's pooled rgb features; ``chip_smoke``'s
    card-against-CPU step holds them the same way). On this batch corners
    move in both layouts."""
    (ld, rpn_tg, fus_tg, _), (pld, prpn, pfus, _) = (
        folded_training["want"], folded_training["got"])
    assert rpn_tg.pos_mask.sum() > 0 and fus_tg.pos_mask.sum() > 0
    got = project_to_rgb_roi(pfus.rois3d.detach(), to_port_config(TINY))
    want = np.stack([np.asarray(jax_project_to_rgb_roi(r, TINY))
                     for r in fus_tg.rois3d])
    moved = int((got.numpy() != want).sum())
    for k in ("cls_mask", "labels", "pos_mask"):
        np.testing.assert_array_equal(getattr(prpn, k).numpy(),
                                      getattr(rpn_tg, k), k)
    for k in ("mask", "labels", "pos_mask"):
        np.testing.assert_array_equal(getattr(pfus, k).numpy(),
                                      getattr(fus_tg, k), k)
    for k, want in ld.items():
        tol = 1e-4 if k.startswith("top") or not moved else 1e-2
        np.testing.assert_allclose(pld[k].item(), want, rtol=tol,
                                   err_msg=k)


def test_folded_rpn_gradients_match_jax(folded_training):
    """Every top_view_rpn gradient within 1e-3 of its tensor's max |g|
    (tests/test_torch_train.py's RPN stage), the stem's included: the
    split stem's backward (heights lanes, aux plane, shared BatchNorm) in
    s2d2p, the prefolded stem's in s2d2."""
    want = dict(_leaves(folded_training["want"][3]))
    got = dict(_leaves(folded_training["got"][3]))
    assert set(got) == set(want)
    stem = [k for k in want if "stem" in k or k.startswith("trunk/ConvBnRelu_0")]
    assert len(stem) >= (4 if folded_training["layout"] == "s2d2p" else 3)
    for name, w in want.items():
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)
