"""Tests of the port that need an NVIDIA card (marked ``cuda``; they skip
where CUDA is absent). The machine with the card has no JAX, so this file
imports only torch, numpy, the port and ``chip_smoke``'s helpers. Run it
there, from the repository root, without the repo's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (BN_RELU_MODES, BN_RELU_SITES,
                        bn_relu_program_launches, check_bn_relu,
                        check_operators, check_padded_cases, check_sort,
                        check_sort_then_sweep, check_sweep,
                        check_sweep_cases, eager_model, eager_serving,
                        kernel_counters, make_cloud, serve_http,
                        small_reference, small_train_reference, sort_cases)
from mv3d_tpu_torch import kitti_config
from mv3d_tpu_torch.ops import voxelize as tvox
from mv3d_tpu_torch.ops import (sort_bitonic, voxelize_heights,
                                voxelize_padded, voxelize_sweep)

torch.set_num_threads(2)

CFG = dataclasses.replace(kitti_config(), pipeline=dataclasses.replace(
    kitti_config().pipeline, use_pallas_fused=True))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 8])
def test_sweep_kernel_bit_equals_plain_on_card(b):
    """The sweep kernel (K1) against its plain version at KITTI shapes
    (65,536 points per frame), heights in f32 and in bf16: bit-equal on
    the card and to the CPU, one launch each (``chip_smoke.check_sweep``).
    """
    dev = _cuda()
    pts = torch.from_numpy(make_cloud(np.random.RandomState(b), b, 65536,
                                     CFG, tricky=True))
    _, _, flat, val, refl = tvox._top_prep(pts, CFG, None)
    t = CFG.top
    n_cells = t.xn * t.yn
    refl = torch.where(flat < n_cells * t.zn, refl, 0.0)
    occupied, err = check_sweep((flat, val, refl), dev, n_cells, t.zn,
                                f"B={b}")
    assert err == 0 and occupied > 1000 * b


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,n_cells", [(2, 65536, 481401),
                                         (8, 65536, 481401),
                                         (2, 2048, 1000)])
def test_sweep_kernel_on_skewed_clouds_on_card(b, n, n_cells):
    """K1 on ``chip_smoke.sweep_cases`` (every frame's points in one tile,
    all in one cell, in the last cells with padding, all padding),
    heights in f32 and bf16: bit-equal to its plain version on the card
    and on the CPU, at the KITTI grid (481,401 cells a frame, tiles that
    cross frames, a partial last tile) and at 1,000 cells a frame."""
    dev = _cuda()
    occupied, err = check_sweep_cases(np.random.RandomState(n_cells), dev,
                                      b, n, n_cells, CFG.top.zn)
    assert err == 0 and occupied["one cell"] == b
    assert occupied["padding"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_kernel_bit_equals_plain_on_card(dtype):
    """The lane-padded sweep kernel (K2) against its plain version at the
    s2d2p serving shapes (B=2, 65,536 points per frame, n_sc = 400 x 304):
    bit-equal on the card and to the CPU, heights in f32 and in bf16."""
    dev = _cuda()
    pts = torch.from_numpy(make_cloud(np.random.RandomState(0), 2, 65536,
                                     CFG, tricky=True))
    _, _, flat, val, refl = tvox._top_prep(pts, CFG, None, s2d="pad")
    t = CFG.top
    n_sc = (t.xn // 2) * tvox.folded_pad_width(t.yn)
    refl = torch.where(flat < n_sc * 128, refl, 0.0)
    want = voxelize_padded.scatter_top_padded_plain(flat, val, refl, n_sc,
                                                    t.zn, dtype)
    args = (flat.to(dev), val.to(dev), refl.to(dev), n_sc, t.zn, dtype)
    before = voxelize_padded.scatter_top_padded_batched.launches
    got = voxelize_padded.scatter_top_padded_batched(*args)
    plain = voxelize_padded.scatter_top_padded_plain(*args)
    torch.cuda.synchronize()
    assert voxelize_padded.scatter_top_padded_batched.launches == before + 1
    assert got[0].dtype == dtype
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p) and torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,n_sc", [(2, 65536, 121600), (8, 65536, 121600),
                                      (2, 2048, 200)])
def test_padded_kernel_on_skewed_clouds_on_card(b, n, n_sc):
    """K2 on ``chip_smoke.padded_cases`` (all points in one tile, all in
    one cell, in the last partial tile, in pad lanes), heights in f32 and
    bf16: bit-equal to its plain version on the card and on the CPU, at the
    KITTI width (n_sc = 400 x 304, 1,900 tiles) and at n_sc = 200 (a
    partial last tile)."""
    dev = _cuda()
    occupied, err = check_padded_cases(np.random.RandomState(n_sc), dev, b,
                                       n, n_sc, CFG.top.zn)
    assert err == 0 and occupied["one cell"] == b


@pytest.mark.cuda
def test_predict_from_points_card_matches_cpu():
    """A small f32 model from one seed, on the card and on the CPU, through
    the steps of ``predict_from_points``: the same proposals and live
    detections, RPN outputs, probs and boxes3d
    within the tolerances ``chip_smoke.small_reference`` states."""
    small_reference(np.random.RandomState(1), _cuda())


@pytest.mark.cuda
def test_heights_kernel_bit_equals_plain_on_card():
    """The heights scatter-max kernel against its plain version at the
    training path's shapes (B=2, 65,536 points per frame, n_flat =
    12,000,000): bit-equal on the card and to the CPU."""
    dev = _cuda()
    pts = torch.from_numpy(make_cloud(np.random.RandomState(0), 2, 65536,
                                     CFG, tricky=True))
    _, _, flat, val, _ = tvox._top_prep(pts, CFG, None)
    t = CFG.top
    n_flat = t.xn * t.yn * t.zn
    want = voxelize_heights.scatter_max_plain(flat, val, n_flat)
    before = voxelize_heights.scatter_max_batched.launches
    got = voxelize_heights.scatter_max_batched(flat.to(dev), val.to(dev),
                                               n_flat)
    plain = voxelize_heights.scatter_max_plain(flat.to(dev), val.to(dev),
                                               n_flat)
    torch.cuda.synchronize()
    assert voxelize_heights.scatter_max_batched.launches == before + 1
    assert torch.equal(got, plain) and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_training_step_card_matches_cpu(tmp_path):
    """One small f32 RPN-stage training step on the card and on the CPU,
    within the tolerances ``chip_smoke.small_train_reference`` states."""
    small_train_reference(np.random.RandomState(2), _cuda(), str(tmp_path))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 2048, 8192, 65536, 131072, 262144])
def test_sort_kernel_bit_equals_plain_and_torch_sort_on_card(n):
    """The sort kernels (K4: the cluster radix sort up to 65,536 elements,
    radix blocks then stable merge passes above) on keys that need 0 to 4
    digit passes and on ties across runs (B=2): keys and payloads
    bit-equal to the plain twin on the card and on the CPU and to
    ``torch.sort(stable=True)`` + gathers, one radix launch and one merge
    launch per doubling above 65,536 (``chip_smoke.check_sort``)."""
    dev = _cuda()
    for kind, case in sort_cases(np.random.RandomState(n), 2, n).items():
        assert check_sort(*case, dev, f"{kind} n={n}") == 0


@pytest.mark.cuda
def test_sort_kernel_on_the_serving_path_inputs():
    """K4 at the pallas-sort serving path's inputs (B=2, 65,536 tricky
    points per frame): bit-equal as above, one launch per call; K1 on its
    output equals K1 on the unsorted points, bit for bit."""
    dev = _cuda()
    pts = torch.from_numpy(make_cloud(np.random.RandomState(3), 2, 65536,
                                     CFG, tricky=True))
    _, _, flat, val, refl = tvox._top_prep(pts, CFG, None)
    t = CFG.top
    n_cells = t.xn * t.yn
    refl = torch.where(flat < n_cells * t.zn, refl, 0.0)
    before = sort_bitonic.bitonic_sort_batched.launches
    assert check_sort(flat, val, refl, dev, "serving path") == 0
    assert sort_bitonic.bitonic_sort_batched.launches == before + 1
    assert check_sort_then_sweep(flat.to(dev), val.to(dev), refl.to(dev),
                                 n_cells, t.zn) > 0


@pytest.mark.cuda
def test_http_serving_at_pallas_sort_on_card(tmp_path):
    """The CLI-exported pallas-sort artifact over HTTP at full KITTI width
    (``chip_smoke.serve_http``): K4 (the radix kernel) and K1 once per
    request, the merge kernel never, answers
    bit-equal to in-process calls and to ``voxel_order="sort"``."""
    dev = _cuda()
    counters = {"voxelize_sweep": voxelize_sweep.scatter_top_fused_batched,
                "voxelize_padded": voxelize_padded.scatter_top_padded_batched,
                "voxelize_heights": voxelize_heights.scatter_max_batched,
                "sort_radix": sort_bitonic.bitonic_sort_batched,
                "sort_merge": sort_bitonic.merge_pass_kernel}
    counts, _ = serve_http(np.random.RandomState(4), CFG, dev,
                           str(tmp_path), counters)
    assert counts["sort_radix"] == counts["voxelize_sweep"] == 3


@pytest.mark.cuda
def test_operators_bit_equal_plain_on_card():
    """Each ``mv3d::`` operator on CUDA tensors at the serving path's
    shapes (B=2, 65,536 points a frame; K4 also at 131,072): one launch
    of its kernel(s), bit-equal to its plain version on the card and to
    the operator on CPU tensors (``chip_smoke.check_operators``)."""
    dev = _cuda()
    t = CFG.top
    n_cells, n_flat = t.xn * t.yn, t.xn * t.yn * t.zn
    n_sc = (t.xn // 2) * tvox.folded_pad_width(t.yn)

    def prep(s2d):
        pts = torch.from_numpy(make_cloud(np.random.RandomState(5), 2, 65536,
                                         CFG, tricky=True)).to(dev)
        _, _, flat, val, refl = tvox._top_prep(pts, CFG, None, s2d=s2d)
        dump = n_sc * 128 if s2d else n_flat
        return flat, val, torch.where(flat < dump, refl, 0.0)

    flat, val, refl = prep(False)
    check_operators((flat, val, refl, n_cells, t.zn), (flat, val, n_flat),
                    prep("pad"), n_sc)


@pytest.mark.cuda
def test_cpu_traced_program_launches_the_kernels_on_card(tmp_path):
    """A serving program traced on the CPU (tiny grid, "pallas-sort",
    ``platforms=("cuda", "cpu")``) and loaded on the card launches K4 and
    K1 once per request there, and answers as the eager serving function
    of the same weights on the card."""
    from mv3d_tpu_torch.serving import export_serving, load_serving
    from mv3d_tpu_torch.train.trainer import MV3D
    dev = _cuda()
    cfg = dataclasses.replace(
        CFG, top=dataclasses.replace(CFG.top, x_max=16.0, y_min=-6.0,
                                     y_max=6.0, x_div=0.2, y_div=0.2),
        pipeline=dataclasses.replace(CFG.pipeline, max_points=2048,
                                     voxel_order="pallas-sort"),
        image_width=96, image_height=64)
    art = export_serving(MV3D(cfg, device="cpu", seed=0),
                         str(tmp_path / "art"), batch_size=2,
                         platforms=("cuda", "cpu"))
    served = load_serving(art, device=dev)
    pts = make_cloud(np.random.RandomState(6), 2, 2048, cfg, tricky=False)
    num = np.full(2, 2048, np.int32)
    rgb = np.random.RandomState(7).rand(2, 64, 96, 3).astype(np.float32)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    got = served(pts, num, rgb)
    assert {k: c.launches for k, c in counters.items()} == {
        "voxelize_sweep": 1, "voxelize_padded": 0, "voxelize_heights": 0,
        "sort_radix": 1, "sort_merge": 0}
    want = eager_serving(eager_model(art, dev), served.meta)(pts, num, rgb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(BN_RELU_SITES))
def test_bn_relu_kernel_at_the_served_sites(site):
    """``mv3d::bn_relu`` at a BatchNorm site of the served cells (kitti
    and didi2, B=8: the top and rgb stems, the split stem's cropped view,
    stages 1 and 2, the ROI towers, the dense layers) in bf16 against
    cast + cuDNN BatchNorm + ReLU + cast on the card: one launch, the same
    strides, under 1e-3 of the elements apart, each by at most one bf16
    ulp plus 8 f32 ulps of the affine's terms, which is many bf16 ulps
    only where the terms cancel near 0 (``chip_smoke.check_bn_relu``)."""
    check_bn_relu(_cuda(), sites={site: BN_RELU_SITES[site]}, modes={})


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(BN_RELU_MODES))
def test_bn_relu_kernel_in_its_other_modes(mode):
    """The kernel's element-at-a-time mode (NCHW, a cropped NCHW view,
    channels-last with 5 channels), bf16 and f32, held as at the served
    sites."""
    check_bn_relu(_cuda(), sites={}, modes={mode: BN_RELU_MODES[mode]})


@pytest.mark.cuda
def test_bn_relu_launches_once_per_site_per_request(tmp_path):
    """A small s2d2p serving program (bf16) exported and loaded on the
    card launches the kernel once per BatchNorm site its model runs, in
    each request (``chip_smoke.bn_relu_program_launches``)."""
    sites, launches = bn_relu_program_launches(_cuda(), str(tmp_path))
    assert sites > 40 and launches == 2 * sites
