"""The reference against the program at the tiny sizes on the CPU, and
what each side may import."""

from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from h100bench_tiny import HERE, ROOT, tiny_cell
from harness import guard, lidar, spec, weights
from reference import mv3d as ref


@pytest.mark.parametrize("layout", ["serving", "hwc"])
def test_reference_equals_the_program_on_the_cpu(layout):
    """The frozen copy's detections equal the port's eager model's on the
    same frames and weights: in the cell's serving configuration (s2d2p,
    K2's plain version, matmul ROI-align, bf16) and in hwc with f32
    compute (K1's plain version, gather ROI-align)."""
    from mv3d_tpu_torch.serving.export import config_from_dict
    from mv3d_tpu_torch.train.trainer import MV3D
    config, mix, _ = tiny_cell()
    tree = spec.run_config(config, mix)
    if layout == "hwc":
        tree = spec.merged(config["config"],
                           {"model": {"compute_dtype": "float32"}})
    ref_cfg = ref.config_from_dict(tree)
    entries = weights.layout(ref.network(ref_cfg).state_dict())
    w = weights.draw(entries, 2 ** 40 + 3, "cpu", ref.HEAD_STD)
    net = ref.build(ref_cfg, w, "cpu")
    model = MV3D(config_from_dict(tree), device="cpu")
    model.model.load_state_dict(w)
    frames = lidar.frames(17, 2, config["sensor"], tree["top"],
                          mix["scene"], ref_cfg.rgb_shape)
    want = ref.detect(net, frames, 2, 0.05)
    n = ref_cfg.pipeline.max_points
    pts = np.full((2, n, 4), -1e9, np.float32)
    num = np.zeros(2, np.int32)
    for i, (p, _) in enumerate(frames):
        p = ref.within_budget(p, n)
        pts[i, :len(p)], num[i] = p, len(p)
    rgb = np.stack([r for _, r in frames])
    dets = model.predict_from_points(pts, num, rgb, 0.05)
    assert sum(len(p) for _, p in want) > 0
    for i, (boxes, probs) in enumerate(want):
        m = dets.mask[i].numpy()
        np.testing.assert_array_equal(dets.boxes3d[i].float().numpy()[m],
                                      boxes)
        np.testing.assert_array_equal(dets.probs[i].float().numpy()[m],
                                      probs)


def test_reference_cuts_a_cloud_over_the_bucket_as_the_artifact_does():
    from mv3d_tpu_torch.data.host_aux import within_budget
    pts = np.arange(40, dtype=np.float32).reshape(10, 4)
    for n in (3, 7, 10, 12):
        np.testing.assert_array_equal(ref.within_budget(pts, n),
                                      within_budget(pts, n))


def test_weights_are_drawn_from_the_seed():
    cfg = ref.config_from_dict(tiny_cell()[0]["config"])
    entries = weights.layout(ref.network(cfg).state_dict())
    a = weights.draw(entries, 2 ** 63 + 1, "cpu", ref.HEAD_STD)
    b = weights.draw(entries, 2 ** 63 + 1, "cpu", ref.HEAD_STD)
    c = weights.draw(entries, 5, "cpu", ref.HEAD_STD)
    kernels = [k for k, s, _ in entries if len(s) >= 2]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[kernels[0]], c[kernels[0]])
    w = a[kernels[0]].float()
    assert abs(w.std().item() * w[0].numel() ** 0.5 - 1.0) < 0.2
    assert all(a[k].dtype == d and tuple(a[k].shape) == s
               for k, s, d in entries)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_and_the_reference_no_program():
    for root, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            names = set(_imports(path))
            assert not names & set(guard.FORBIDDEN), path
            if os.sep + "reference" + os.sep in path:
                assert "mv3d_tpu_torch" not in names, path


def _fresh(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([HERE, ROOT]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_a_fresh_process_holds_no_jax():
    """The reference loads nothing of the program; the harness with the
    family's program adapter loads neither JAX nor the JAX package."""
    got = _fresh(
        "import sys\n"
        "from reference import mv3d\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'mv3d_tpu_torch', 'mv3d_tpu', 'jax', 'jaxlib', 'flax'}))\n"
        "from harness import guard, serve_batch, spec\n"
        "spec.program({'family': 'mv3d'})\n"
        "print(guard.forbidden_loaded())\n")
    assert got.split("\n")[:2] == ["[]", "[]"]


def test_run_refuses_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is for hosts "
                    "without one")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "kitti.serve-b8", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_reference_config_tree_is_the_copy_of_the_programs():
    from mv3d_tpu_torch.config import Config
    assert dataclasses.asdict(ref.config_from_dict({})) == \
        dataclasses.asdict(Config())
