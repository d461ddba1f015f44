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

from chip_smoke import make_cloud, small_reference
from mv3d_tpu_torch import kitti_config
from mv3d_tpu_torch.ops import voxelize as tvox
from mv3d_tpu_torch.ops import voxelize_sweep

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
def test_sweep_kernel_bit_equals_plain_on_card():
    """The CUDA kernel against its plain version at KITTI shapes (B=2,
    65,536 points per frame): bit-equal on the card and to the CPU."""
    dev = _cuda()
    pts = torch.from_numpy(make_cloud(np.random.RandomState(0), 2, 65536,
                                     CFG, tricky=True))
    _, _, flat, val, refl = tvox._top_prep(pts, CFG, None)
    t = CFG.top
    n_cells = t.xn * t.yn
    refl = torch.where(flat < n_cells * t.zn, refl, 0.0)
    want = voxelize_sweep.scatter_top_fused_plain(flat, val, refl, n_cells,
                                                  t.zn)
    args = (flat.to(dev), val.to(dev), refl.to(dev), n_cells, t.zn)
    before = voxelize_sweep.scatter_top_fused_batched.launches
    got = voxelize_sweep.scatter_top_fused_batched(*args)
    plain = voxelize_sweep.scatter_top_fused_plain(*args)
    torch.cuda.synchronize()
    assert voxelize_sweep.scatter_top_fused_batched.launches == before + 1
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p) and torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_predict_from_points_card_matches_cpu():
    """A small f32 model from one seed, on the card and on the CPU, through
    the steps of ``predict_from_points``: the same proposals and live
    detections, RPN outputs, probs and boxes3d
    within the tolerances ``chip_smoke.small_reference`` states."""
    small_reference(np.random.RandomState(1), _cuda())
