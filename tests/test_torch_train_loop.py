"""The port's training loop around the step, against the JAX package's:
the validation interleave and ``validation_iou`` (with converted
weights), the metrics JSONL, the dashboard, ``train.remat`` and the train
command (argv and a few iterations on a tiny KITTI directory, on the
CPU).

Tolerances: ``validation_iou`` within 1e-4 of JAX's (its detections come
from f32 forwards that differ in the last bits); metrics lines equal
apart from the wall-clock stamp; remat bit-equal to the step without it
(losses, gradients, BatchNorm statistics, the updated weights).
"""

import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from __graft_entry__ import _tiny_config
from mv3d_tpu.cli import train as jax_train_cli
from mv3d_tpu.ops import voxelize as jvox
from mv3d_tpu.train.trainer import Trainer as JaxTrainer
from mv3d_tpu.utils import dashboard as jdashboard
from mv3d_tpu.utils import metrics as jmetrics
from mv3d_tpu_torch.cli import train as train_cli
from mv3d_tpu_torch.data import loader as tloader
from mv3d_tpu_torch.models.mv3d_net import MV3DNet, total_loss
from mv3d_tpu_torch.models.nets import SUBNET_NAMES
from mv3d_tpu_torch.train.targets import draw_noise
from mv3d_tpu_torch.train.trainer import Trainer, _prepare_views
from mv3d_tpu_torch.utils import dashboard, metrics

from test_torch_config import to_port_config

torch.set_num_threads(2)

CFG = dataclasses.replace(_tiny_config(), model=dataclasses.replace(
    _tiny_config().model, compute_dtype="float32"))
PCFG = to_port_config(CFG)
THRESH = 0.05
TINY_JSON = {"top": {"x_max": 16.0, "y_min": -6.0, "y_max": 6.0,
                     "x_div": 0.2, "y_div": 0.2},
             "front": {"width": 64, "height": 32},
             "rpn": {"nms_pre_topn": 200, "nms_post_topn": 16},
             "rcnn": {"batch_size": 32},
             "pipeline": {"max_points": 2048, "max_gt": 8},
             "image_width": 96, "image_height": 64}


@pytest.fixture(scope="module")
def batch_np():
    drive = chip_smoke.SynthDrive(np.random.RandomState(2), PCFG, 2, 3000,
                                  cars=(2, 3))
    batch = tloader.frames_to_batch(drive.frames, PCFG)
    return {k: v for k, v in batch.items() if k != "tags"}


class FixedSet:
    def __init__(self, batch):
        self.batch = batch

    def load(self):
        return self.batch


def test_validation_iou_matches_jax(tmp_path, batch_np):
    """The JAX ``validation_iou``, its views made eagerly (under jit XLA
    folds the quantization's division into a reciprocal multiply, which
    moves points by a cell against the numpy oracle and the port; see
    tests/test_torch_train.py), against the port's on the same weights.
    The box deltas are scaled down so that detections stay near the
    proposals and overlap the planted cars."""
    jm = JaxTrainer(FixedSet(batch_np), cfg=CFG, seed=4,
                    log_dir=str(tmp_path / "jlog"),
                    checkpoint_dir=str(tmp_path / "jck"))
    head = jm.variables["fusion"]["params"]["head_with_rgb"]["box_3"]
    head["kernel"] = head["kernel"] * 0.05
    head["bias"] = head["bias"] * 0.05
    infer = jax.jit(lambda v, top, occ, rgb, front, thresh:
                    jm.model.forward_inference(v, top, rgb, front,
                                               score_threshold=thresh,
                                               top_occ=occ))

    def eager_views(variables, points, num, rgb, thresh):
        top, occ = jvox.lidar_to_top_batch(points, CFG, num, return_occ=True)
        front = jvox.lidar_to_front_batch(points, CFG, num)
        return infer(variables, top, occ, rgb, front, thresh)

    jm._infer_points = eager_views
    port = Trainer(FixedSet(batch_np), cfg=PCFG, device="cpu",
                   variables=jax.tree.map(np.asarray, jm.variables),
                   log_dir=str(tmp_path / "log"),
                   checkpoint_dir=str(tmp_path / "ck"))
    ious = []
    for thresh in (THRESH, 0.5):
        want = jm.validation_iou(batch_np, score_threshold=thresh)
        got = port.validation_iou(batch_np, score_threshold=thresh)
        assert abs(got - want) <= 1e-4, (thresh, got, want)
        ious.append(got)
    assert ious[0] > 0, ious
    no_gt = dict(batch_np, gt_mask=np.zeros_like(batch_np["gt_mask"]))
    assert port.validation_iou(no_gt) == jm.validation_iou(no_gt) == 0.0


def test_metrics_writer_lines_match_jax(tmp_path):
    rows = [(0, {"top_cls_loss": 0.5, "fuse_reg_loss": np.float32(2.25)},
             "training"),
            (4, {"top_cls_loss": 0.25, "iou": 0.125}, "validation")]
    writers = [metrics.MetricsWriter(str(tmp_path / "port"), tag="t"),
               jmetrics.MetricsWriter(str(tmp_path / "jax"), tag="t")]
    for w in writers:
        for step, scalars, phase in rows:
            w.write(step, scalars, phase=phase)
        w.close()
    lines = []
    for d in ("port", "jax"):
        with open(tmp_path / d / "metrics_t.jsonl") as f:
            lines.append(f.read().splitlines())
    assert len(lines[0]) == len(lines[1]) == 2
    for a, b in zip(*lines):
        a, b = json.loads(a), json.loads(b)
        assert list(a) == list(b) and a.pop("time") > 0 and b.pop("time")
        assert a == b
    assert writers[0].means() == writers[1].means()


def test_training_loop_writes_validation_rows_metrics_and_dashboard(
        tmp_path, batch_np):
    """The loop of the JAX Trainer: a validation step every
    ``validation_every`` iterations (not the first) with its IoU in
    log.txt and the metrics JSONL, a row per iteration with its phase,
    the timer line and the dashboard at the checkpoint cadence, and the
    same dashboard the JAX renderer makes of these logs."""
    cfg = dataclasses.replace(PCFG, train=dataclasses.replace(
        PCFG.train, validation_every=2, ckpt_every=3),
        rcnn=dataclasses.replace(PCFG.rcnn, score_threshold=THRESH))
    log_dir = str(tmp_path / "log")
    tr = Trainer(FixedSet(batch_np), validation_set=FixedSet(batch_np),
                 cfg=cfg, device="cpu", log_dir=log_dir, log_tag="loop",
                 checkpoint_dir=str(tmp_path / "ckpt"))
    last = tr(5)
    tr.close()
    assert "iou" in last and tr.n_global_step == 5
    rows = chip_smoke._metric_rows(log_dir, "loop")
    assert [(r["step"], r["phase"]) for r in rows] == [
        (0, "training"), (1, "training"), (2, "validation"),
        (3, "training"), (4, "validation")]
    losses = ["top_cls_loss", "top_reg_loss", "fuse_cls_loss",
              "fuse_reg_loss"]
    for r in rows:
        want = ["step", "time", *losses] + (
            ["iou"] if r["phase"] == "validation" else []) + ["phase"]
        assert list(r) == want
    val = chip_smoke.check_command_outputs(log_dir, str(tmp_path / "ckpt"),
                                           "loop", rows)
    assert any(r["iou"] > 0 for r in val)
    with open(os.path.join(log_dir, "log.txt")) as f:
        text = f.read()
    assert re.search(r"validation:     2 .* \|  iou \d\.\d{5}\n", text)
    assert "It takes" in text and "secs to train 3 iterations" in text

    def normalized(path):
        with open(path) as f:
            html = f.read()
        html = re.sub(r"generated [0-9: -]+", "generated", html)
        return re.sub(r"<title>.*</title>", "", html)

    ours = dashboard.render_dashboard(log_dir, str(tmp_path / "ours.html"))
    theirs = jdashboard.render_dashboard(log_dir, str(tmp_path / "j.html"))
    assert "top_cls_loss" in normalized(ours) and "iou" in normalized(ours)
    assert normalized(ours) == normalized(theirs)


def test_a_failing_dashboard_never_stops_training(tmp_path, batch_np,
                                                   monkeypatch):
    from mv3d_tpu_torch.train import trainer as trainer_mod

    def broken(log_dir):
        raise OSError("disk full")

    monkeypatch.setattr(trainer_mod, "render_dashboard", broken)
    cfg = dataclasses.replace(PCFG, train=dataclasses.replace(
        PCFG.train, ckpt_every=1))
    tr = Trainer(FixedSet(batch_np), cfg=cfg, device="cpu",
                 train_targets=("top_view_rpn",),
                 log_dir=str(tmp_path / "log"),
                 checkpoint_dir=str(tmp_path / "ckpt"))
    tr(2)
    tr.close()
    assert tr.n_global_step == 2
    with open(tmp_path / "log" / "log.txt") as f:
        assert "dashboard render failed: disk full" in f.read()


def _step(model, batch, noise, cfg):
    ld, _ = model.forward_train(batch, noise)
    loss = total_loss(ld, SUBNET_NAMES, cfg)
    model.zero_grad(set_to_none=True)
    loss.backward()
    return ld


@pytest.mark.parametrize("layout", ["hwc", "s2d2p"])
def test_remat_matches_the_step_without_it(batch_np, layout):
    """``train.remat`` changes what the backward pass keeps, not the math:
    the same losses, gradients and BatchNorm statistics (updated once a
    step, not again by the recompute) as without it."""
    cfg = PCFG
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    if layout == "s2d2p":
        cfg = to_port_config(dataclasses.replace(
            CFG, pipeline=dataclasses.replace(
                CFG.pipeline, view_layout="s2d2p", use_pallas_fused=True,
                host_aux_channels=False)))
        batch.pop("top_aux")
    batch = _prepare_views(batch, cfg, False)
    runs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, remat=remat))
        model = MV3DNet(c)
        model.init_weights(torch.Generator().manual_seed(3))
        noise = draw_noise(c, 2, torch.Generator().manual_seed(5),
                           torch.device("cpu"))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        ld = _step(model, batch, noise, c)
        runs.append((ld, model, before))
    (l0, m0, b0), (l1, m1, b1) = runs
    for k in l0:
        assert l0[k].item() == l1[k].item(), k
    g0 = {n: p.grad for n, p in m0.named_parameters() if p.grad is not None}
    g1 = {n: p.grad for n, p in m1.named_parameters() if p.grad is not None}
    assert set(g0) == set(g1) and len(g0) > 50
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    stats = [k for k in b0 if k.endswith(("running_mean", "running_var"))]
    moved = 0
    for k in stats:
        assert torch.equal(m0.state_dict()[k], m1.state_dict()[k]), k
        moved += not torch.equal(m1.state_dict()[k], b1[k])
    assert moved > 50


def test_remat_trainer_step_matches(tmp_path, batch_np):
    def run(remat):
        cfg = dataclasses.replace(PCFG, train=dataclasses.replace(
            PCFG.train, remat=remat))
        tr = Trainer(FixedSet(batch_np), cfg=cfg, device="cpu", seed=3,
                     log_dir=str(tmp_path / f"l{remat}"),
                     checkpoint_dir=str(tmp_path / f"c{remat}"))
        losses = tr.fit_iteration(batch_np)
        return losses, tr.get_variables()

    (l0, v0), (l1, v1) = run(False), run(True)
    assert l0 == l1
    for name in SUBNET_NAMES:
        jax.tree.map(np.testing.assert_array_equal, v0[name], v1[name])


def test_quantized_batches_train_as_their_dequantized_points(tmp_path,
                                                             batch_np):
    """A ``stream_quantized`` batch (``points_q``/``refl_q``) is
    dequantized on the step's device: the same losses and validation IoU
    as the batch of the dequantized points."""
    from mv3d_tpu_torch.ops.quantize import (dequantize_points,
                                             quantize_points)
    q, r = quantize_points(batch_np["points"], PCFG)
    quantized = dict(batch_np, points_q=q, refl_q=r)
    del quantized["points"]
    plain = dict(batch_np, points=dequantize_points(
        torch.from_numpy(q), torch.from_numpy(r), PCFG).numpy())
    out = []
    for i, batch in enumerate((quantized, plain)):
        tr = Trainer(FixedSet(batch), cfg=PCFG, device="cpu", seed=3,
                     log_dir=str(tmp_path / f"l{i}"),
                     checkpoint_dir=str(tmp_path / f"c{i}"))
        out.append((tr.validation_iou(batch, score_threshold=THRESH),
                    tr.fit_iteration(batch)))
    assert out[0] == out[1]


@pytest.mark.parametrize("argv", [
    ["--kitti-object", "d"],
    ["--kitti-object", "d", "-n", "tag", "-i", "7", "-t",
     "top_view_rpn,fusion", "-w", "all", "-c", "-b", "2", "-l", "0.01",
     "--loader-workers", "4", "--train-split", "a.txt", "--val-split",
     "b.txt", "--checkpoint-dir", "ck", "--log-dir", "lg", "--dataset",
     "didi", "--config", "x.json", "--set", "rpn.nms_thresh", "0.4",
     "--set", "train.remat", "True"]])
def test_train_cli_parses_argv_as_jax(argv):
    got = vars(train_cli.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jax_train_cli.parse_args(argv))
    assert train_cli.parse_args(argv + ["--device", "cpu"]).device == "cpu"


def test_train_command_runs_on_the_cpu(tmp_path):
    """``main`` trains a few iterations from a tiny KITTI directory (PNGs
    at three sizes, resized by the loader; two loader workers), writes the
    validation rows, metrics, dashboard and checkpoints, and resumes with
    ``-c``; the served s2d2p configuration trains too, and refuses the
    host aux plane."""
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(TINY_JSON))
    cfg = to_port_config(_tiny_config())
    drive = chip_smoke.SynthDrive(np.random.RandomState(0), cfg, 6, 3000,
                                  cars=(2, 3))
    data = str(tmp_path / "kitti")
    chip_smoke.write_kitti_dir(data, drive, cfg, 4,
                               image_sizes=((60, 90), (64, 96), (66, 100)))
    argv = ["--kitti-object", data, "--device", "cpu",
            "--train-split", os.path.join(data, "ImageSets", "train.txt"),
            "--val-split", os.path.join(data, "ImageSets", "val.txt"),
            "-b", "2", "--loader-workers", "2", "--config", str(cfg_path),
            "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--set", "train.validation_every", "2",
            "--set", "train.ckpt_every", "3"]
    log_dir = str(tmp_path / "log")
    last = train_cli.main(argv + ["-n", "t", "--log-dir", log_dir,
                                  "-i", "3"])
    assert np.isfinite(list(last.values())).all()
    train_cli.main(argv + ["-n", "t", "--log-dir", log_dir, "-i", "2",
                           "-c"])
    rows = chip_smoke._metric_rows(log_dir, "t")
    assert [r["step"] for r in rows] == [0, 1, 2, 3, 4]
    assert [r["phase"] for r in rows].count("validation") == 2
    chip_smoke.check_command_outputs(log_dir, str(tmp_path / "ckpt"), "t",
                                     rows)
    served = list(chip_smoke.SERVED_FLAGS)
    train_cli.main(argv + served + ["-n", "s", "--log-dir",
                                    str(tmp_path / "ls"), "-i", "3"])
    assert len(chip_smoke._metric_rows(str(tmp_path / "ls"), "s")) == 3
    with pytest.raises(ValueError, match="aux"):
        train_cli.main(argv + served[:-3] + ["-n", "a", "--log-dir",
                                             str(tmp_path / "la"), "-i", "1"])
