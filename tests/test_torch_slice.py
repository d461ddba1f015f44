"""The whole port slice, points -> 3D detections, against the JAX package
with the same (converted) weights: the tiny config of ``__graft_entry__``
with the fused voxelizer (``pipeline.use_pallas_fused=True``, the Pallas
sweep in interpret mode on the JAX side) and f32 compute.

Tolerances: the live-detection mask is exact; boxes3d within atol 1e-3
and probs within atol 1e-4 on live slots (slots outside the mask hold
garbage on both sides); proposals' mask exact and rois within atol 1e-3.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.ops import voxelize as jvox
from mv3d_tpu_torch.ops import voxelize as tvox
from mv3d_tpu_torch.train.trainer import MV3D

from test_torch_config import to_port_config
from test_torch_models import randomize_bn

torch.set_num_threads(2)

CFG = dataclasses.replace(
    _tiny_config(),
    model=dataclasses.replace(_tiny_config().model, compute_dtype="float32"),
    pipeline=dataclasses.replace(_tiny_config().pipeline,
                                 use_pallas_fused=True))
PCFG = to_port_config(CFG)
THRESH = 0.05
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _requests(seed, b=2):
    """Clouds drawn as bench.py draws them (scaled to the tiny grid), with
    a short second frame, and random rgb."""
    rng = np.random.RandomState(seed)
    n = CFG.pipeline.max_points
    t = CFG.top
    pts = np.stack([rng.uniform(t.x_min, t.x_max, (b, n)),
                    rng.uniform(t.y_min, t.y_max, (b, n)),
                    rng.uniform(t.z_min, t.z_max, (b, n)),
                    rng.uniform(0, 1, (b, n))], axis=-1).astype(np.float32)
    num = np.array([n, n - 300], np.int32)[:b]
    rgb = rng.rand(b, *CFG.rgb_shape).astype(np.float32)
    return pts, num, rgb


@pytest.fixture(scope="module")
def both():
    jm = JaxMV3DNet(CFG)
    variables = randomize_bn(jax.jit(jm.init_variables)(
        jax.random.PRNGKey(0)), seed=5)

    @jax.jit
    def infer(v, points, num, rgb):
        top, occ = jvox.lidar_to_top_batch(points, CFG, num, return_occ=True)
        front = jvox.lidar_to_front_batch(points, CFG, num)
        return jm.forward_inference(v, top, rgb, front,
                                    score_threshold=THRESH, top_occ=occ)

    return infer, variables, MV3D(PCFG, device="cpu", variables=variables)


@pytest.mark.parametrize("seed", [0, 1])
def test_points_to_detections_match_jax(both, seed):
    infer, variables, port = both
    pts, num, rgb = _requests(seed)
    jdets, jprops = infer(variables, pts, num, rgb)
    dets = port.predict_from_points(pts, num, rgb, score_threshold=THRESH)
    m = np.asarray(jdets.mask)
    assert m.sum() >= 1, "no live detection: the comparison would be empty"
    assert dets.boxes3d.shape == (2, CFG.rpn.nms_post_topn, 8, 3)
    np.testing.assert_array_equal(dets.mask.numpy(), m)
    np.testing.assert_allclose(dets.boxes3d.numpy()[m],
                               np.asarray(jdets.boxes3d)[m], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(dets.probs.numpy()[m],
                               np.asarray(jdets.probs)[m], rtol=0, atol=1e-4)


def test_proposals_match_jax(both):
    infer, variables, port = both
    pts, num, rgb = _requests(3)
    _, jprops = infer(variables, pts, num, rgb)
    p, n = torch.from_numpy(pts), torch.from_numpy(num)
    top, occ = tvox.lidar_to_top_batch(p, PCFG, n, return_occ=True)
    with torch.no_grad():
        _, props = port.model.forward_inference(
            top, torch.from_numpy(rgb), None, score_threshold=THRESH,
            top_occ=occ)
    m = np.asarray(jprops.mask)
    np.testing.assert_array_equal(props.mask.numpy(), m)
    np.testing.assert_allclose(props.rois.numpy(), np.asarray(jprops.rois),
                               rtol=0, atol=1e-3)


def test_predict_from_views_matches_points(both):
    """``predict`` on the port's own views gives ``predict_from_points``'
    detections (the anchor filter then sums the view's channels instead of
    reading the count occupancy: the same zero-set)."""
    _, _, port = both
    pts, num, rgb = _requests(4)
    want = port.predict_from_points(pts, num, rgb, score_threshold=THRESH)
    top = tvox.lidar_to_top_batch(torch.from_numpy(pts), PCFG,
                                  torch.from_numpy(num))
    got = port.predict(top, None, rgb, score_threshold=THRESH)
    assert want.mask.any()
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.boxes3d, want.boxes3d)


def test_predict_from_points_with_host_aux(both):
    """``predict_from_points(top_aux=...)``: the loader's host plane joins
    the device heights (heights kernel's plain version on the CPU), and
    the detections equal ``predict`` on the same assembled view."""
    from mv3d_tpu_torch.data.host_aux import lidar_to_top_aux
    _, _, port = both
    pts, num, rgb = _requests(5)
    aux = np.stack([lidar_to_top_aux(p[:n], PCFG) for p, n in zip(pts, num)])
    got = port.predict_from_points(pts, num, rgb, score_threshold=THRESH,
                                   top_aux=aux)
    top = tvox.lidar_to_top_batch(torch.from_numpy(pts), PCFG,
                                  torch.from_numpy(num),
                                  aux=torch.from_numpy(aux))
    want = port.predict(top, None, rgb, score_threshold=THRESH)
    assert want.mask.any()
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.boxes3d, want.boxes3d)


_NO_JAX = r"""
import dataclasses, io, json, os, sys, threading, urllib.request
import numpy as np
import torch
import chip_smoke
import mv3d_tpu_torch
from mv3d_tpu_torch import config, convert, serving
from mv3d_tpu_torch.cli import common, export as cli_export
from mv3d_tpu_torch.cli import serve as cli_serve
from mv3d_tpu_torch.cli import train as cli_train
from mv3d_tpu_torch.cli import (dashboard as cli_dashboard,
                                preprocess as cli_preprocess,
                                rehearsal as cli_rehearsal,
                                render as cli_render, test as cli_test,
                                tracking as cli_tracking,
                                viewer as cli_viewer)
from mv3d_tpu_torch import eval as evaluation, experiments
from mv3d_tpu_torch.data import (host_aux, kitti, loader, precomputed,
                                 preprocess, tracklets)
from mv3d_tpu_torch.eval import kitti_export, tracklet_eval
from mv3d_tpu_torch.experiments import manager, task
from mv3d_tpu_torch.utils import (dashboard, datacheck, logger, macs,
                                  metrics, png, profiling, timer, video, viz,
                                  viz3d)
from mv3d_tpu_torch import tracking
from mv3d_tpu_torch.tracking import seq_model, tracker, ukf
from mv3d_tpu_torch.ops import (anchors, boxes, boxes3d, cuda_build, detect,
                                library, nms, nms_topk, projection, proposal,
                                quantize, quantized, roi_align, sort,
                                sort_bitonic, voxelize,
                                voxelize_heights, voxelize_padded,
                                voxelize_sweep)
from mv3d_tpu_torch.models import avod_net, backbone, mv3d_net, nets
from mv3d_tpu_torch.parallel import mesh
from mv3d_tpu_torch.train import (augment, checkpoint, losses, targets,
                                  trainer)
torch.set_num_threads(2)        # as the test processes: they share cores
cfg = mv3d_tpu_torch.kitti_config()
cfg = dataclasses.replace(
    cfg, top=dataclasses.replace(cfg.top, x_max=16.0, y_min=-6.0, y_max=6.0,
                                 x_div=0.2, y_div=0.2),
    pipeline=dataclasses.replace(cfg.pipeline, max_points=2048),
    image_width=96, image_height=64)
rng = np.random.RandomState(0)
pts = np.stack([rng.uniform(0, 16, 512), rng.uniform(-6, 6, 512),
                rng.uniform(-4, 0.8, 512), rng.uniform(0, 1, 512)], -1)
dets = trainer.MV3D(cfg, device="cpu", seed=0).predict_from_points(
    pts.astype(np.float32), 512, rng.rand(64, 96, 3).astype(np.float32))
assert dets.boxes3d.shape == (1, cfg.rpn.nms_post_topn, 8, 3)
padded, n = voxelize.pad_points(pts.astype(np.float32), 2048)
assert voxelize.lidar_to_top(torch.from_numpy(padded), cfg, n).shape == \
    cfg.top.shape
assert host_aux.lidar_to_front(pts, cfg).shape == cfg.front.shape
assert macs.count_params(trainer.MV3D(cfg, device="cpu").model) > 0
seq = seq_model.SeqMotionTracker(hidden=4, device="cpu")
assert np.isfinite(seq.fit(np.cumsum(rng.rand(2, 5, 3), 1), steps=2))
serve = mv3d_tpu_torch.serving_config(cfg)
dets = trainer.MV3D(serve, device="cpu", seed=0).predict_from_points(
    pts.astype(np.float32), 512, rng.rand(64, 96, 3).astype(np.float32))
assert dets.boxes3d.shape == (1, cfg.rpn.nms_post_topn, 8, 3)
int8 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                          quant="int8"))
dets = trainer.MV3D(int8, device="cpu", seed=0).predict_from_points(
    pts.astype(np.float32), 512, rng.rand(64, 96, 3).astype(np.float32))
assert dets.boxes3d.shape == (1, cfg.rpn.nms_post_topn, 8, 3)
didi = config.make_config("didi")
didi = dataclasses.replace(
    didi, top=dataclasses.replace(didi.top, x_min=-12, x_max=12, y_min=-6,
                                  y_max=6),
    pipeline=dataclasses.replace(didi.pipeline, max_points=2048),
    image_width=96, image_height=100, image_crop_top=30,
    image_crop_bottom=20)
dpts = np.stack([rng.uniform(-12, 12, 512), rng.uniform(-6, 6, 512),
                 rng.uniform(-3, 0.7, 512), rng.uniform(0, 1, 512)], -1)
dets = trainer.MV3D(didi, device="cpu", seed=0).predict_from_points(
    dpts.astype(np.float32), 512, rng.rand(50, 96, 3).astype(np.float32))
assert dets.boxes3d.shape == (1, didi.rpn.nms_post_topn, 8, 3)
options = dataclasses.replace(cfg, model=dataclasses.replace(
    cfg.model, upsample_features=True, stem_space_to_depth=False,
    rgb_basenet="vgg", backbone_block="basic", use_siamese_fusion=True,
    use_learnable_fusion=True))
dets = trainer.MV3D(options, device="cpu", seed=0).predict_from_points(
    pts.astype(np.float32), 512, rng.rand(64, 96, 3).astype(np.float32))
assert dets.boxes3d.shape == (1, cfg.rpn.nms_post_topn, 8, 3)
drive = chip_smoke.SynthDrive(rng, cfg, 2, 3000, cars=(2, 2))
d = sys.argv[1]          # the test's tmp_path
with loader.BatchLoader(drive, cfg, batch_size=2) as data:
    tr = trainer.Trainer(data, cfg=cfg, device="cpu",
                         checkpoint_dir=d + "/ckpt", log_dir=d + "/log")
    assert np.isfinite(list(tr.fit_iteration(data.load()).values())).all()
served = dataclasses.replace(cfg, pipeline=dataclasses.replace(
    cfg.pipeline, use_pallas_fused=True, voxel_order="pallas-sort"))
art = serving.export_serving(trainer.MV3D(served, device="cpu", seed=0),
                             d + "/art", batch_size=2)
srv = cli_serve.make_server(art, port=0, device="cpu")
threading.Thread(target=srv.serve_forever, daemon=True).start()
buf = io.BytesIO()
np.savez(buf, points=pts.astype(np.float32),
         rgb=rng.rand(64, 96, 3).astype(np.float32))
req = urllib.request.Request(
    f"http://127.0.0.1:{srv.server_address[1]}/predict",
    data=buf.getvalue(), method="POST")
with urllib.request.urlopen(req, timeout=120) as r:
    with np.load(io.BytesIO(r.read())) as z:
        assert z["boxes3d"].shape[1:] == (8, 3)
srv.shutdown()
srv.server_close()
frozen = serving.load_serving(art, device="cpu")
assert frozen.meta["program"] == "serving_fn.pt2"
assert frozen.predict(pts.astype(np.float32),
                      rng.rand(64, 96, 3).astype(np.float32))[0].shape[1:] \
    == (8, 3)
acfg = mv3d_tpu_torch.avod_cars_config()
acfg = dataclasses.replace(
    acfg, top=dataclasses.replace(acfg.top, x_max=16.0, y_min=-6.0,
                                  y_max=6.0),
    rpn=dataclasses.replace(acfg.rpn, nms_post_topn=32),
    pipeline=dataclasses.replace(acfg.pipeline, max_points=2048),
    image_width=96, image_height=64)
aart = serving.export_serving(trainer.MV3D(acfg, device="cpu", seed=0),
                              d + "/avod", batch_size=1)
assert serving.load_serving(aart, device="cpu").predict(
    pts.astype(np.float32), rng.rand(64, 96, 3).astype(np.float32)
)[0].shape[1:] == (8, 3)
assert set(library.OPS) <= set(dir(torch.ops.mv3d))
root = d + "/kitti"
chip_smoke.write_kitti_dir(root, chip_smoke.SynthDrive(rng, cfg, 4, 3000),
                           cfg, 2, image_sizes=((60, 90), (64, 96)))
assert datacheck.check_kitti_object_dir(root)["ok"]
with open(d + "/tiny.json", "w") as f:
    json.dump({"top": {"x_max": 16.0, "y_min": -6.0, "y_max": 6.0,
                       "x_div": 0.2, "y_div": 0.2},
               "pipeline": {"max_points": 2048},
               "image_width": 96, "image_height": 64}, f)
cli_train.main(["--kitti-object", root, "--device", "cpu", "-b", "2",
                "--train-split", root + "/ImageSets/train.txt",
                "--val-split", root + "/ImageSets/val.txt",
                "--loader-workers", "2", "-i", "3", "--config",
                d + "/tiny.json", "--set", "train.validation_every", "2",
                "--set", "train.ckpt_every", "2", "--checkpoint-dir",
                d + "/ck", "--log-dir", d + "/lg", "-n", "t"])
assert os.path.exists(d + "/lg/dashboard.html")
ev = ["--kitti-object", root, "--device", "cpu", "--config", d + "/tiny.json",
      "-n", "t", "--checkpoint-dir", d + "/ck", "--limit", "1"]
for cmd in ("test_mv3d", "export_kitti", "probe_rpn"):
    cli_test.main([cmd, "--out-dir", d + "/" + cmd] + ev)
assert os.listdir(d + "/export_kitti") == ["000000.txt"]
assert cli_preprocess.main(["--kitti-object", root, "-o", d + "/pre",
                            "--device", "cpu", "--config",
                            d + "/tiny.json"]) == 4
cli_rehearsal.main(["--synthetic-fixture", "--fixture-frames", "2", "-o",
                    d + "/rh", "-i", "1", "--config", d + "/tiny.json",
                    "--device", "cpu"])
assert os.path.exists(d + "/rh/eval/iou_per_obj.csv")
cli_dashboard.main([d + "/rh/log"])
velo = root + "/training/velodyne"
cli_viewer.main([velo, "-o", d + "/view", "--limit", "1", "--config",
                 d + "/tiny.json"])
assert len(os.listdir(d + "/view")) == 2
top = host_aux.lidar_to_top(pts.astype(np.float32), cfg)
box = np.array([[[x, y, z] for z in (-1.7, -0.2) for x, y in
                 ((5, -1), (9, -1), (9, 1), (5, 1))]], np.float32)
frame = cli_render.render_frame(top, None, box, None, cfg)
assert frame.shape == (top.shape[0], 2 * top.shape[1], 3)
viz3d.render_cloud_3d(pts, box, d + "/c3d.png")
viz3d.render_top_feature_maps(top, box, d + "/sheet.png", cfg=cfg)
assert os.path.exists(d + "/sheet_bev.png")
assert manager.Manager(d + "/no_experiments").discover() == []
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "flax", "mv3d_tpu", "PIL", "matplotlib"))
assert not bad, bad
print("ok")
"""


def test_port_never_imports_jax(tmp_path):
    """Every port module, its CLI and ``chip_smoke`` import, predict (the
    hwc and the s2d2p serving configuration, an int8 model, a tiny didi
    preset, a tiny AVOD served from its artifact and a
    model with every option: the reference graph's upsampling and 7x7
    stem, basic blocks, the VGG rgb trunk, siamese and learnable fusion),
    train, export an artifact
    that answers one HTTP /predict request, run the train command on a
    tiny KITTI directory written to disk, then the test command
    (test_mv3d, export_kitti, probe_rpn), the preprocess command, a
    rehearsal and the dashboard command, voxelize one frame, count a
    model's parameters and fit the motion GRU, load the frozen artifact
    (its ``mv3d::`` operators registered) and answer from it, run the
    viewer on a scan, draw a render frame, a 3D cloud and a feature sheet
    and discover experiments, on the CPU, without loading jax, flax, the
    JAX package, PIL or matplotlib."""
    out = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
