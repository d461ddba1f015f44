"""The port's evaluation commands and their data modules against the JAX
package's, on the CPU at the tiny config (f32 compute, the fused
voxelizer as tests/test_torch_slice.py runs it): the preprocessor and its
precomputed-view dataset, ``cli.preprocess``, ``cli.test`` (all eight
subcommands), ``cli.tracking.pred_and_save`` with the tracklet scorer,
``cli.dashboard``, ``experiments.task.run_task``, the rehearsal's fixture
and the rehearsal end to end.

Tolerances: preprocessed top views bit-equal to JAX's numpy oracle
(``device=False``), front views within atol 5e-5 (as
tests/test_torch_voxelize.py), PNG pixels and gt arrays equal; detections
(``test_mv3d``, ``pred_and_save``) with equal counts, boxes3d within atol
1e-3 and probs within atol 1e-4 (tests/test_torch_slice.py); KITTI lines
with equal fields apart from numbers within the boxes' 1e-3 plus one unit
of the last printed digit, and image coordinates (truncated pixels)
within one pixel; tracklet XML poses within 1e-3 and the scores within
1e-3; the fixture's velodyne bytes and label lines equal.
"""

import argparse
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from mv3d_tpu.cli import dashboard as jdashboard_cli
from mv3d_tpu.cli import preprocess as jpreprocess_cli
from mv3d_tpu.cli import rehearsal as jrehearsal
from mv3d_tpu.cli import test as jtest_cli
from mv3d_tpu.cli import tracking as jtracking
from mv3d_tpu.cli import common as jcommon
from mv3d_tpu.data import kitti as jkitti
from mv3d_tpu.data import precomputed as jprecomputed
from mv3d_tpu.data import preprocess as jpreprocess
from mv3d_tpu.data import tracklets as jtracklets
from mv3d_tpu.eval import kitti_export as jexport
from mv3d_tpu.eval import tracklet_eval as jeval
from mv3d_tpu.experiments import task as jtask
from mv3d_tpu.models.mv3d_net import MV3DNet as JaxMV3DNet
from mv3d_tpu.train import trainer as jtrainer
from mv3d_tpu.train.checkpoint import SubnetCheckpointer
from mv3d_tpu.utils import datacheck as jdatacheck
from mv3d_tpu_torch.cli import common
from mv3d_tpu_torch.cli import dashboard as dashboard_cli
from mv3d_tpu_torch.cli import preprocess as preprocess_cli
from mv3d_tpu_torch.cli import rehearsal
from mv3d_tpu_torch.cli import test as test_cli
from mv3d_tpu_torch.cli import tracking
from mv3d_tpu_torch.data import kitti, precomputed, preprocess
from mv3d_tpu_torch.eval import tracklet_eval
from mv3d_tpu_torch.experiments import task
from mv3d_tpu_torch.ops import boxes3d as tb3
from mv3d_tpu_torch.train import trainer as ttrainer
from mv3d_tpu_torch.utils import datacheck

from test_torch_models import randomize_bn

torch.set_num_threads(2)

TINY = {"top": {"x_max": 16.0, "y_min": -6.0, "y_max": 6.0,
                "x_div": 0.2, "y_div": 0.2},
        "front": {"width": 64, "height": 32},
        "rpn": {"nms_pre_topn": 200, "nms_post_topn": 16},
        "rcnn": {"batch_size": 32},
        "pipeline": {"max_points": 2048, "max_gt": 8,
                     "use_pallas_fused": True},
        "model": {"compute_dtype": "float32"},
        "image_width": 96, "image_height": 64}
THRESH = "0.05"


def _configs(path):
    args = argparse.Namespace(dataset="kitti", config=path, set_kv=[])
    return jcommon.resolve_config(args), common.resolve_config(args)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A tiny KITTI object directory (4 frames, 1-3 cars each, PNGs at the
    model's size and a smaller one, so two are resized), its config JSON
    and checkpoints of random JAX weights (random BatchNorm too, box deltas
    scaled down) in the npz layout both packages read."""
    d = tmp_path_factory.mktemp("cli_eval")
    cfg_path = str(d / "tiny.json")
    with open(cfg_path, "w") as f:
        json.dump(TINY, f)
    jcfg, pcfg = _configs(cfg_path)
    root = str(d / "kitti")
    drive = chip_smoke.SynthDrive(np.random.RandomState(6), pcfg, 4, 3000,
                                  cars=(1, 3))
    chip_smoke.write_kitti_dir(root, drive, pcfg, 3,
                               image_sizes=((64, 96), (60, 90)))
    variables = randomize_bn(jax.jit(JaxMV3DNet(jcfg).init_variables)(
        jax.random.PRNGKey(0)), seed=5)
    # small box deltas: detections stay near the proposals, on the points
    head = variables["fusion"]["params"]["head_with_rgb"]["box_3"]
    head["kernel"], head["bias"] = head["kernel"] * 0.05, head["bias"] * 0.05
    ckpt = str(d / "ckpt")
    for name, tree in variables.items():
        SubnetCheckpointer(name, os.path.join(ckpt, "tag")).save(tree, 1)
    return {"dir": d, "cfg_path": cfg_path, "jcfg": jcfg, "pcfg": pcfg,
            "root": root, "ckpt": ckpt, "variables": variables}


def _pixels(path):
    return np.asarray(Image.open(path))


def test_preprocessor_and_precomputed_match_jax(data, tmp_path):
    """The port's ``Preprocessor`` on the CPU against JAX's with
    ``device=False`` (its numpy oracle): top views bit-equal, front views
    within 5e-5, gt arrays, rgb and top-image pixels equal; the port's
    ``PrecomputedViewDataset`` over its dump gives JAX's over JAX's."""
    jds = jkitti.KittiObjectDataset(data["root"], cfg=data["jcfg"])
    pds = kitti.KittiObjectDataset(data["root"], cfg=data["pcfg"])
    jout, pout = str(tmp_path / "j"), str(tmp_path / "p")
    assert jpreprocess.Preprocessor(jout, data["jcfg"], batch_size=3,
                                    device=False).run(jds) == 4
    assert preprocess.Preprocessor(pout, data["pcfg"], batch_size=3,
                                   device="cpu").run(pds) == 4
    for tag in pds.tags:
        for sub, key in (("top", "top_view"), ("front", "front_view")):
            with np.load(os.path.join(jout, sub, tag + ".npy.npz")) as a, \
                    np.load(os.path.join(pout, sub, tag + ".npy.npz")) as b:
                assert a.files == b.files
                if sub == "top":
                    np.testing.assert_array_equal(b[key], a[key])
                else:
                    np.testing.assert_allclose(b[key], a[key], rtol=0,
                                               atol=5e-5)
        # the label parse's camera transform: within 1e-5, as
        # tests/test_torch_kitti.py holds it
        np.testing.assert_allclose(
            np.load(os.path.join(pout, "gt_boxes3d", tag + ".npy")),
            np.load(os.path.join(jout, "gt_boxes3d", tag + ".npy")),
            rtol=0, atol=1e-5)
        np.testing.assert_array_equal(
            np.load(os.path.join(pout, "gt_labels", tag + ".npy")),
            np.load(os.path.join(jout, "gt_labels", tag + ".npy")))
        for sub in ("rgb", "top_image"):
            np.testing.assert_array_equal(
                _pixels(os.path.join(pout, sub, tag + ".png")),
                _pixels(os.path.join(jout, sub, tag + ".png")))
    jpv = jprecomputed.PrecomputedViewDataset(jout, data["jcfg"])
    ppv = precomputed.PrecomputedViewDataset(pout, data["pcfg"])
    assert ppv.tags == jpv.tags and len(ppv) == 4
    want, got = jpv.load_batch([0, 2, 3]), ppv.load_batch([0, 2, 3])
    assert sorted(got) == sorted(want) and got["tags"] == want["tags"]
    for k in ("top", "rgb", "gt_labels", "gt_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["gt_boxes3d"], want["gt_boxes3d"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["front"], want["front"], atol=5e-5)
    assert datacheck.check_preprocessed_dir(pout) == \
        jdatacheck.check_preprocessed_dir(pout)
    os.remove(os.path.join(pout, "gt_labels", pds.tags[1] + ".npy"))
    rep = datacheck.check_preprocessed_dir(pout)
    assert rep == jdatacheck.check_preprocessed_dir(pout)
    assert not rep["ok"] and rep["missing"]["gt_labels"] == [pds.tags[1]]


def test_preprocessed_s2d2p_pair_round_trips(data, tmp_path):
    """In the served ``s2d2p`` layout the dump holds the (heights, aux)
    pair (keys ``top_view``, ``top_view_aux``): the pair voxelized from
    the frames' first ``max_points`` points, as the preprocessor pads
    them; the dataset gives it back and the model detects on it."""
    from mv3d_tpu_torch import serving_config
    from mv3d_tpu_torch.ops.voxelize import lidar_to_top_batch, pad_points
    cfg = serving_config(data["pcfg"])
    ds = kitti.KittiObjectDataset(data["root"], cfg=cfg)
    out = str(tmp_path / "pair")
    preprocess.Preprocessor(out, cfg, batch_size=2, device="cpu").run(
        ds, indices=[0, 1])
    batch = precomputed.PrecomputedViewDataset(out, cfg).load_batch([0, 1])
    padded = [pad_points(ds.load_frame(i).points, cfg.pipeline.max_points)
              for i in (0, 1)]
    want = lidar_to_top_batch(
        torch.from_numpy(np.stack([p for p, _ in padded])), cfg,
        torch.tensor([n for _, n in padded], dtype=torch.int32))
    assert want[0].dtype == torch.bfloat16 and len(batch["top"]) == 2
    for got, w in zip(batch["top"], want):
        np.testing.assert_array_equal(got, w.float().numpy())
    assert batch["top"][0].shape[-1] == 128 and batch["top"][1].shape[
        -1] == 8
    m = ttrainer.MV3D(cfg, device="cpu", seed=1)
    got = m.predict(batch["top"], None, batch["rgb"], score_threshold=0.05)
    ref = m.predict(want, None, batch["rgb"], score_threshold=0.05)
    assert torch.equal(got.mask, ref.mask) and ref.mask.any()
    assert torch.equal(got.boxes3d[got.mask], ref.boxes3d[ref.mask])


def test_preprocess_main(data, tmp_path, capsys):
    out = str(tmp_path / "pre")
    assert preprocess_cli.main(["--kitti-object", data["root"], "-o", out,
                                "-b", "2", "--device", "cpu", "--config",
                                data["cfg_path"]]) == 4
    assert "preprocessed 4 frames" in capsys.readouterr().out
    tops = sorted(os.listdir(os.path.join(out, "top")))
    assert len(tops) == 4
    with np.load(os.path.join(out, "top", tops[0])) as z:
        assert z["top_view"].shape == data["pcfg"].top_shape
    assert len(os.listdir(os.path.join(out, "gt_boxes3d"))) == 4
    assert len(os.listdir(os.path.join(out, "top_image"))) == 4


ARGVS = {
    "test": ["test_mv3d", "-n", "t", "--kitti-object", "k", "--limit", "2",
             "--score-threshold", "0.1", "--set", "rpn.nms_thresh", "0.5"],
    "tracking": ["-n", "t", "--kitti-raw", "r", "--date", "d", "--drive",
                 "0001", "--eval", "-w", "all"],
    "preprocess": ["--kitti-raw", "r", "-o", "o", "-b", "3", "--no-images"],
    "rehearsal": ["--synthetic-fixture", "-o", "o", "-i", "3", "-b", "2",
                  "--split-fraction", "0.5", "--score-threshold", "0.01"],
    "dashboard": ["log", "-o", "x.html", "--watch", "2"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_commands_parse_the_jax_flags(name):
    """Each command parses the JAX command's argv to the same values and
    adds ``--device`` (default the card); the preprocessor's ``--cpu`` is
    ``--device cpu``."""
    mods = {"test": (jtest_cli, test_cli),
            "tracking": (jtracking, tracking),
            "preprocess": (jpreprocess_cli, preprocess_cli),
            "rehearsal": (jrehearsal, rehearsal),
            "dashboard": (jdashboard_cli, dashboard_cli)}
    jmod, pmod = mods[name]
    want = vars(jmod.parse_args(ARGVS[name]))
    got = vars(pmod.parse_args(ARGVS[name]))
    if name != "dashboard":
        assert got.pop("device") == "cuda"
    if name == "preprocess":
        assert want.pop("cpu") is False
        assert vars(pmod.parse_args(ARGVS[name] + ["--device", "cpu"]))[
            "device"] == "cpu"
    assert got == want


def _cli(data, *argv):
    return ["--kitti-object", data["root"], "-n", "tag", "--checkpoint-dir",
            data["ckpt"], "--config", data["cfg_path"], *argv]


def _close(a, b, digits):
    """Two printed numbers equal within the boxes' 1e-3 plus one unit of
    the last printed digit."""
    return abs(float(a) - float(b)) <= 1e-3 + 10.0 ** -digits + 1e-9


def test_test_mv3d_and_export_kitti_match_jax(data, tmp_path, capsys):
    """``test_mv3d`` on the CPU against the JAX command on the same
    checkpoints: per frame the same number of detections, boxes3d within
    1e-3, probs within 1e-4; the port's ``export_kitti`` files line for
    line against JAX's export of JAX's detections, which is what JAX's
    ``export_kitti`` command writes (numbers as the module docstring
    says)."""
    out = {}
    for name, mod, cmds, extra in (
            ("jax", jtest_cli, ("test_mv3d",), []),
            ("port", test_cli, ("test_mv3d", "export_kitti"),
             ["--device", "cpu"])):
        for cmd in cmds:
            out[name, cmd] = str(tmp_path / f"{name}_{cmd}")
            mod.main([cmd, *_cli(data, "--out-dir", out[name, cmd],
                                 "--score-threshold", THRESH), *extra])
    tags = kitti.KittiObjectDataset(data["root"]).tags
    out["jax", "export_kitti"] = str(tmp_path / "jax_export_kitti")
    jexport.export_kitti_detections(
        {tag: tuple(np.load(os.path.join(out["jax", "test_mv3d"],
                                         f"{tag}_{k}.npy"))
                    for k in ("boxes3d", "probs")) for tag in tags},
        out["jax", "export_kitti"], data["jcfg"])
    live = 0
    for tag in tags:
        jb = np.load(os.path.join(out["jax", "test_mv3d"],
                                  f"{tag}_boxes3d.npy"))
        pb = np.load(os.path.join(out["port", "test_mv3d"],
                                  f"{tag}_boxes3d.npy"))
        jp = np.load(os.path.join(out["jax", "test_mv3d"],
                                  f"{tag}_probs.npy"))
        pp = np.load(os.path.join(out["port", "test_mv3d"],
                                  f"{tag}_probs.npy"))
        assert pb.shape == jb.shape and pb.dtype == np.float32
        np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-3)
        np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-4)
        live += len(pb)
        with open(os.path.join(out["jax", "export_kitti"], tag + ".txt")) as f:
            want = f.read().splitlines()
        with open(os.path.join(out["port", "export_kitti"],
                               tag + ".txt")) as f:
            got = f.read().splitlines()
        assert len(got) == len(want) == len(pb)
        for g, w in zip(got, want):
            g, w = g.split(), w.split()
            assert g[:4] == w[:4] and len(g) == len(w) == 16
            assert all(abs(float(a) - float(b)) <= 1
                       for a, b in zip(g[4:8], w[4:8])), (g, w)
            assert all(_close(a, b, 3) for a, b in zip(g[8:15], w[8:15]))
            assert _close(g[15], w[15], 4)
    assert live >= 2, "no live detection: the comparison would be empty"
    assert "dumped detections" in capsys.readouterr().out


def test_remaining_subcommands_run_and_write_their_files(data, tmp_path,
                                                         capsys):
    """test_rpn, test_single_mv3d, test_3dop, test_rpn_target, test_front
    and probe_rpn (object and raw drives) on the CPU write what the JAX
    command writes; test_rpn's proposals are the ``TesterRPN``'s."""
    cpu = ["--limit", "2", "--device", "cpu"]
    out = {c: str(tmp_path / c) for c in test_cli.COMMANDS}
    test_cli.main(["test_rpn", *_cli(data, "--out-dir", out["test_rpn"]),
                   *cpu])
    test_cli.main(["test_single_mv3d", *_cli(
        data, "--out-dir", out["test_single_mv3d"], "--score-threshold",
        THRESH), *cpu])
    assert "000000: " in capsys.readouterr().out
    prop = tmp_path / "props"
    prop.mkdir()
    roi = tb3.box3d_compose([8.0, 0.0, -1.5], [1.5, 1.6, 4.0], [0, 0, 0.1],
                            data["pcfg"]).numpy()[None]
    np.save(prop / "000000_rois3d.npy", roi)
    test_cli.main(["test_3dop", *_cli(data, "--out-dir", out["test_3dop"],
                                      "--proposal-dir", str(prop),
                                      "--score-threshold", "0.0"), *cpu])
    assert "000001: no proposals, skipped" in capsys.readouterr().out
    for cmd in ("test_rpn_target", "test_front", "probe_rpn"):
        test_cli.main([cmd, *_cli(data, "--out-dir", out[cmd]), *cpu])
    files = {c: sorted(os.listdir(out[c])) for c in out
             if os.path.isdir(out[c])}
    assert files["test_rpn"] == ["000000_proposal_scores.npy",
                                 "000000_proposals.npy",
                                 "000001_proposal_scores.npy",
                                 "000001_proposals.npy"]
    assert files["test_single_mv3d"] == ["000000_boxes3d.npy",
                                         "000000_probs.npy"]
    assert files["test_3dop"] == ["000000_boxes3d.npy", "000000_probs.npy"]
    assert sorted(os.listdir(os.path.join(out["test_rpn_target"],
                                          "rpn_target"))) == [
        "rpn_target_000000.png", "rpn_target_000001.png"]
    assert files["test_front"] == ["000000_front.npy", "000000_front.png",
                                   "000001_front.npy", "000001_front.png"]
    front = np.load(os.path.join(out["test_front"], "000000_front.npy"))
    assert _pixels(os.path.join(out["test_front"], "000000_front.png")
                   ).shape == (front.shape[1], front.shape[0], 3)
    assert files["probe_rpn"] == ["000000", "000001"]
    assert sorted(os.listdir(os.path.join(out["probe_rpn"], "000000"))) == [
        "camera.png", "top.png"]
    rpn = ttrainer.TesterRPN(data["pcfg"], log_tag="tag",
                             checkpoint_dir=data["ckpt"], device="cpu",
                             log_dir=str(tmp_path / "l"))
    from mv3d_tpu_torch.data.loader import frames_to_batch
    from mv3d_tpu_torch.ops.voxelize import lidar_to_top_batch
    b = frames_to_batch([kitti.KittiObjectDataset(
        data["root"], cfg=data["pcfg"]).load_frame(1)], data["pcfg"])
    top = lidar_to_top_batch(torch.from_numpy(b["points"]), data["pcfg"],
                             torch.from_numpy(b["num_points"]))
    np.testing.assert_array_equal(
        np.load(os.path.join(out["test_rpn"], "000001_proposals.npy")),
        rpn(top)[0])
    raw = _raw_drive(tmp_path / "raw", 1)
    out_r = str(tmp_path / "probe_raw")
    test_cli.main(["probe_rpn", "--out-dir", out_r, "--kitti-raw", raw,
                   "--date", "2011_09_26", "--drive", "0005",
                   "--checkpoint-dir", data["ckpt"], "--config",
                   data["cfg_path"], *cpu])
    assert os.path.exists(os.path.join(out_r, "000000", "top.png"))
    with pytest.raises(SystemExit):
        test_cli.main(["test_mv3d", "--device", "cpu", "--config",
                       data["cfg_path"]])


def _raw_drive(base, n):
    """A KITTI raw drive of n frames (2011_09_26, drive 0005) with one car
    tracklet, as tests/test_cli.py writes it."""
    d = base / "2011_09_26" / "2011_09_26_drive_0005_sync"
    os.makedirs(d / "velodyne_points" / "data")
    os.makedirs(d / "image_02" / "data")
    rng = np.random.RandomState(0)
    for i in range(n):
        pts = np.stack([rng.uniform(0, 16, 3000), rng.uniform(-6, 6, 3000),
                        rng.uniform(-4, 0.8, 3000), rng.uniform(0, 1, 3000)],
                       1).astype(np.float32)
        pts[:400] = np.stack([rng.uniform(6, 10, 400),
                              rng.uniform(-0.5, 2.5, 400),
                              rng.uniform(-1.5, 0.0, 400),
                              rng.uniform(0, 1, 400)], 1)
        pts.tofile(d / "velodyne_points" / "data" / f"{i:010d}.bin")
        Image.fromarray((rng.rand(64, 96, 3) * 255).astype(np.uint8)).save(
            d / "image_02" / "data" / f"{i:010d}.png")
    t = jtracklets.Tracklet("Car", 1.5, 1.6, 4.0, first_frame=0)
    for i in range(n):
        t.poses.append({"tx": 8.0, "ty": 1.0, "tz": -1.5,
                        "rx": 0.0, "ry": 0.0, "rz": 0.2})
    jtracklets.write_tracklets(str(d / "tracklet_labels.xml"), [t])
    return str(base)


def test_pred_and_save_and_tracking_main_match_jax(data, tmp_path, capsys):
    """``pred_and_save`` over a raw drive with the same weights: the port's
    tracklet XML holds JAX's detections (poses and sizes within 1e-3), and
    the scores of both against the drive's gt agree within 1e-3; the
    tracking command writes the XML and the CSVs.

    Both run at a ``max_points`` above a frame's 3,000 points, so neither
    loader drops a point (over the budget the port keeps an evenly spaced
    subset and the JAX package the first ``max_points``)."""
    jcfg, pcfg = (dataclasses.replace(c, pipeline=dataclasses.replace(
        c.pipeline, max_points=4096)) for c in (data["jcfg"], data["pcfg"]))
    raw = _raw_drive(tmp_path / "raw", 3)
    jds = jkitti.KittiRawDataset(raw, "2011_09_26", "0005", jcfg)
    pds = kitti.KittiRawDataset(raw, "2011_09_26", "0005", pcfg)
    jm = jtrainer.MV3D(jcfg, log_tag="j",
                       checkpoint_dir=str(tmp_path / "c"),
                       log_dir=str(tmp_path / "l"))
    jm.variables = data["variables"]
    pm = ttrainer.MV3D(pcfg, device="cpu", variables=data["variables"])
    jpath = jtracking.pred_and_save(jds, jm, str(tmp_path / "jp"),
                                    score_threshold=0.05, log=print)
    ppath = tracking.pred_and_save(pds, pm, str(tmp_path / "pp"),
                                   score_threshold=0.05, log=print)
    want, got = (jtracklets.parse_tracklets(p) for p in (jpath, ppath))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert (g.object_type, g.first_frame, g.n_frames) == (
            w.object_type, w.first_frame, 1)
        np.testing.assert_allclose([g.h, g.w, g.l], [w.h, w.w, w.l],
                                   atol=1e-3)
        for k in ("tx", "ty", "tz", "rz"):
            assert g.poses[0][k] == pytest.approx(w.poses[0][k], abs=1e-3)
    gt = pds.tracklet_file
    for method in ("box", "sphere"):
        a = jeval.tracklet_score(jpath, gt, volume_method=method)
        b = tracklet_eval.tracklet_score(ppath, gt, volume_method=method)
        assert b["iou_per_obj"].keys() == a["iou_per_obj"].keys()
        for k, v in a["iou_per_obj"].items():
            assert b["iou_per_obj"][k] == pytest.approx(v, abs=1e-3)
        assert b["pr_per_iou"] == a["pr_per_iou"]
    path = tracking.main(["-n", "tag", "--kitti-raw", raw, "--date",
                          "2011_09_26", "--drive", "0005", "--out-dir",
                          str(tmp_path / "pred"), "--checkpoint-dir",
                          data["ckpt"], "--score-threshold", THRESH,
                          "--eval", "--config", data["cfg_path"],
                          "--device", "cpu"])
    d = os.path.dirname(path)
    assert path == os.path.join(str(tmp_path / "pred"), "2011_09_26_0005",
                                "tracklet_labels_pred.xml")
    assert os.path.exists(os.path.join(d, "iou_per_obj.csv"))
    assert "wrote" in capsys.readouterr().out


def test_dashboard_main(data, tmp_path, capsys):
    log = tmp_path / "log"
    log.mkdir()
    with open(log / "metrics_t.jsonl", "w") as f:
        for step in range(3):
            f.write(json.dumps({"step": step, "time": 0.0, "loss": 1.0 / (
                step + 1), "phase": "training"}) + "\n")
    path = dashboard_cli.main([str(log)])
    assert path == str(log / "dashboard.html") and os.path.exists(path)
    assert dashboard_cli.main([str(log), "-o", str(tmp_path / "x.html")]) \
        == str(tmp_path / "x.html")
    assert "wrote" in capsys.readouterr().out


def _attempts(mod, outcomes, min_seconds=0.0):
    """run_task over a function that raises or returns per ``outcomes``;
    returns (result or the exception's type and text, the log lines)."""
    lines, it = [], iter(outcomes)

    def fn():
        o = next(it)
        if isinstance(o, Exception):
            raise o
        return o

    try:
        res = mod.run_task(fn, retries=3, min_seconds=min_seconds,
                           log=lines.append)
    except RuntimeError as e:
        res = ("RuntimeError", str(e))
    return res, lines


@pytest.mark.parametrize("outcomes,min_seconds", [
    ([ValueError("a"), ValueError("b"), 7], 0.0),
    ([ValueError("a"), ValueError("b"), ValueError("c")], 0.0),
    ([1, 2, 3], 60.0),
    ([ValueError("a"), 5, 6], 60.0),
    ([4], 0.0),
])
def test_run_task_retries_as_jax(outcomes, min_seconds):
    """``run_task`` retries a failing or suspiciously fast stage as JAX's
    does, with the same log lines, and raises after the last failure."""
    assert _attempts(task, outcomes, min_seconds) == \
        _attempts(jtask, outcomes, min_seconds)


def test_rehearsal_fixture_matches_jax(tmp_path):
    """``make_fixture`` draws JAX's ``RandomState`` sequence: the velodyne
    bytes and label lines are equal and the PNGs decode to the same
    pixels; the layout check passes and labels parse to in-grid boxes."""
    jcfg, pcfg = _configs("")
    jrehearsal.make_fixture(str(tmp_path / "j"), jcfg, n_frames=3, seed=4)
    rehearsal.make_fixture(str(tmp_path / "p"), pcfg, n_frames=3, seed=4)
    for i in range(3):
        tag = f"{i:06d}"
        for sub, ext in (("velodyne", ".bin"), ("label_2", ".txt")):
            with open(tmp_path / "j" / "training" / sub / (tag + ext),
                      "rb") as a, open(tmp_path / "p" / "training" / sub /
                                       (tag + ext), "rb") as b:
                assert a.read() == b.read(), (sub, tag)
        np.testing.assert_array_equal(
            kitti.read_image(str(tmp_path / "p" / "training" / "image_2" /
                                 (tag + ".png"))),
            _pixels(tmp_path / "j" / "training" / "image_2" /
                    (tag + ".png")))
    rep = datacheck.check_kitti_object_dir(str(tmp_path / "p"))
    assert rep["ok"] and rep["counts"] == {"velodyne": 3, "image_2": 3,
                                           "label_2": 3}
    f = kitti.KittiObjectDataset(str(tmp_path / "p"), cfg=pcfg).load_frame(1)
    c = f.gt_boxes3d[0].mean(0)
    assert f.gt_labels.tolist() == [1]
    assert (np.abs(f.points[:, :2] - c[:2]).max(1) < 2.5).sum() > 1000


def test_rehearsal_end_to_end(data, tmp_path, capsys):
    """The dress rehearsal on the CPU at ``-i 2``: fixture -> layout check
    -> the two stages (each re-run while it finishes in under 10 s, as
    JAX's ``run_task`` does) -> predictions -> tracklet XML -> CSVs; with
    a held-out split too."""
    out = str(tmp_path / "rh")
    res = rehearsal.main(["--synthetic-fixture", "--fixture-frames", "3",
                          "-o", out, "-i", "2", "-b", "2",
                          "--score-threshold", "0.01", "--config",
                          data["cfg_path"], "--device", "cpu"])
    for name in ("iou_per_obj.csv", "pr_per_iou.csv"):
        assert os.path.exists(os.path.join(out, "eval", name))
    assert "All" in res["iou_per_obj"]
    assert os.path.exists(os.path.join(out, "gt_tracklets.xml"))
    assert len(jtracklets.parse_tracklets(os.path.join(
        out, "gt_tracklets.xml"))) == 3
    stdout = capsys.readouterr().out
    assert "layout check: ok=True" in stdout and "stage 2/2" in stdout
    assert stdout.count("finished suspiciously fast; retrying") == 4
    with open(os.path.join(out, "eval", "pr_per_iou.csv")) as f:
        assert len(f.readlines()) == 9
    res = rehearsal.main(["--synthetic-fixture", "--fixture-frames", "4",
                          "-o", str(tmp_path / "rh2"), "-i", "1",
                          "--split-fraction", "0.5", "--config",
                          data["cfg_path"], "--device", "cpu"])
    assert "All" in res["iou_per_obj"]
    with open(tmp_path / "rh2" / "splits" / "val.txt") as f:
        assert len(f.read().split()) == 2
