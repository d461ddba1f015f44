"""Dress rehearsal: one command from raw KITTI object files to
``iou_per_obj.csv`` / ``pr_per_iou.csv``.

Port of ``mv3d_tpu/cli/rehearsal.py``, with the same flags and
``--device`` (the card by default):

    python -m mv3d_tpu_torch.cli.rehearsal --kitti-object <root> \\
        --config <overrides.json> -i 10000

runs: layout validation (``utils/datacheck.check_kitti_object_dir``) ->
the two-stage schedule (``experiments/task.Task``: the RPN alone, then
image + front + fusion) -> per-frame prediction
(``cli/tracking.pred_and_save``) -> tracklet XML -> 3D-IoU CSVs.

Unlike the JAX command, the prediction XML keeps every detection: the
JAX command writes it through the tracking saver's ``0 < ty < 8`` gate
(the reference's ``Tracklet_saver``), which drops the cars right of the
sensor (ty < 0), so the scorer counted every such gt car as missed.

``--synthetic-fixture`` first writes a small learnable drive in the KITTI
object layout (a car-sized point cluster per frame with its
camera-coordinate label), drawn as the JAX command draws it, and
rehearses on it.
"""

from __future__ import annotations

import argparse
import math
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="MV3D dress rehearsal: raw KITTI object root -> "
                    "trained model -> iou_per_obj.csv")
    ap.add_argument("--kitti-object", default="",
                    help="KITTI object dataset root (training/{velodyne,"
                         "image_2,label_2}); omit with --synthetic-fixture")
    ap.add_argument("--synthetic-fixture", action="store_true",
                    help="generate a tiny learnable fixture drive in KITTI "
                         "layout under <out>/fixture and rehearse on it")
    ap.add_argument("--fixture-frames", type=int, default=6)
    ap.add_argument("-o", "--out", default="rehearsal",
                    help="output dir (checkpoints, logs, predictions, CSVs)")
    ap.add_argument("-i", "--iters", type=int, default=10000,
                    help="iterations per training stage")
    ap.add_argument("-b", "--batch-size", type=int, default=1)
    ap.add_argument("-l", "--lr", type=float, default=None)
    ap.add_argument("-n", "--tag", default="rehearsal")
    ap.add_argument("--score-threshold", type=float, default=0.05)
    ap.add_argument("--split-fraction", type=float, default=1.0,
                    help="train fraction; <1 evaluates on the held-out rest "
                         "(the fixture default trains and scores the same "
                         "drive, an overfit-style end-to-end smoke)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains and predicts (cuda, or "
                         "cpu)")
    from .common import add_config_args
    add_config_args(ap)
    return ap.parse_args(argv)


def make_fixture(root: str, cfg, n_frames: int = 6, seed: int = 0):
    """Write a synthetic KITTI object dir: a dense car-sized cluster per
    frame on a sparse ground plane, with a camera-coordinate label that
    parses back (``kitti_label_to_lidar_box3d``) to the cluster's lidar
    box. Poses and sizes are drawn independently per frame, so a
    train/held-out split of fixture frames probes generalization. The
    draws are the JAX command's, from ``RandomState(seed)``."""
    import numpy as np
    import torch

    from ..ops import boxes3d as b3
    from ..utils.png import write_png

    base = os.path.join(root, "training")
    for sub in ("velodyne", "image_2", "label_2"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    x_lo, x_hi = cfg.top.x_min, min(cfg.top.x_max, 24.0)
    y_lo, y_hi = max(cfg.top.y_min, -8.0), min(cfg.top.y_max, 8.0)
    span_x, span_y = x_hi - x_lo, y_hi - y_lo
    h, w = cfg.rgb_shape[:2]
    for i in range(n_frames):
        tag = f"{i:06d}"
        # independent pose + size draws (the margin keeps the box in-grid)
        cx = x_lo + span_x * rng.uniform(0.25, 0.75)
        cy = y_lo + span_y * rng.uniform(0.25, 0.75)
        length = rng.uniform(3.8, 4.2)
        width = rng.uniform(1.5, 1.7)
        height = rng.uniform(1.4, 1.6)
        ground = np.stack([rng.uniform(x_lo, x_hi, 4000),
                           rng.uniform(y_lo, y_hi, 4000),
                           rng.uniform(-2.0, -1.8, 4000),
                           rng.uniform(0, 0.2, 4000)], 1)
        car = np.stack([rng.uniform(cx - length / 2, cx + length / 2, 3000),
                        rng.uniform(cy - width / 2, cy + width / 2, 3000),
                        rng.uniform(-1.6, -1.6 + height, 3000),
                        rng.uniform(0.6, 1.0, 3000)], 1)
        pts = np.concatenate([ground, car]).astype(np.float32)
        pts.tofile(os.path.join(base, "velodyne", tag + ".bin"))
        write_png(os.path.join(base, "image_2", tag + ".png"),
                  (rng.rand(h, w, 3) * 255).astype(np.uint8))
        # label in camera coords, built to invert to lidar (cx, cy, -1.6)
        rz = 0.0
        ry = -rz - math.pi / 2
        cam = b3.lidar_to_camera_points(
            torch.tensor([[cx, cy, -1.6]], dtype=torch.float32),
            cfg).numpy()[0]
        line = ("Car 0.0 0 0.0 0 0 50 50 "
                f"{height:.2f} {width:.2f} {length:.2f} "
                f"{cam[0]:.4f} {cam[1]:.4f} {cam[2]:.4f} {ry:.4f}")
        with open(os.path.join(base, "label_2", tag + ".txt"), "w") as f:
            f.write(line + "\n")
    return root


def _gt_tracklets_for(dataset, cfg):
    """Per-frame gt boxes -> one-frame Tracklet objects (the object split
    has no cross-frame identity; one pose per tracklet scores identically
    under the per-frame evaluator)."""
    import numpy as np
    import torch

    from ..data import tracklets
    from ..ops import boxes3d as b3

    out = []
    for i in range(len(dataset)):
        f = dataset.load_frame(i)
        keep = np.asarray(f.gt_labels) > 0
        if not keep.any():
            continue
        trans, size, rot = (v.numpy() for v in b3.boxes3d_decompose(
            torch.as_tensor(np.asarray(f.gt_boxes3d, np.float32)[keep]),
            cfg))
        for t, s, r in zip(trans, size, rot):
            tk = tracklets.Tracklet("Car", float(s[0]), float(s[1]),
                                    float(s[2]), first_frame=i)
            tk.poses.append({"tx": float(t[0]), "ty": float(t[1]),
                             "tz": float(t[2]), "rx": float(r[0]),
                             "ry": float(r[1]), "rz": float(r[2])})
            out.append(tk)
    return out


def main(argv=None):
    """Rehearse as the flags say; returns the scorer's results."""
    args = parse_args(argv)

    from .common import resolve_config
    cfg = resolve_config(args)

    from ..data import tracklets
    from ..data.kitti import KittiObjectDataset
    from ..data.loader import BatchLoader
    from ..eval import tracklet_score
    from ..experiments.task import Task
    from ..train.trainer import Trainer, resolve_device
    from ..utils.datacheck import (check_kitti_object_dir, split_train_val,
                                   write_split_files)
    from .tracking import pred_and_save

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    root = args.kitti_object
    if args.synthetic_fixture:
        root = make_fixture(os.path.join(args.out, "fixture"), cfg,
                            n_frames=args.fixture_frames)
        print(f"fixture drive written to {root}")
    if not root:
        raise SystemExit("--kitti-object or --synthetic-fixture required")

    # 1. layout validation
    report = check_kitti_object_dir(root)
    print(f"layout check: ok={report['ok']} counts={report['counts']}")
    if not report["ok"]:
        raise SystemExit(f"layout check FAILED: missing={report['missing']}")

    # 2. train/eval split (the whole drive by default for the fixture)
    if args.split_fraction < 1.0:
        train_tags, val_tags = split_train_val(
            report["tags"], train_fraction=args.split_fraction,
            by_drive=False)
        write_split_files(train_tags, val_tags,
                          os.path.join(args.out, "splits"))
        train_split = os.path.join(args.out, "splits", "train.txt")
        eval_split = os.path.join(args.out, "splits", "val.txt")
    else:
        train_split = eval_split = ""

    train_ds = KittiObjectDataset(root, split_file=train_split, cfg=cfg)
    eval_ds = KittiObjectDataset(root, split_file=eval_split, cfg=cfg)
    print(f"dataset: {len(train_ds)} train / {len(eval_ds)} eval frames")

    # 3. the two-stage schedule over the Trainer API
    ckpt_dir = os.path.join(args.out, "checkpoint")
    log_dir = os.path.join(args.out, "log")
    trainers = []
    with BatchLoader(train_ds, cfg, batch_size=args.batch_size) as bl:

        def factory(targets, continue_train, pretrained):
            trainers.append(Trainer(
                bl, pre_trained_weights=pretrained, train_targets=targets,
                cfg=cfg, log_tag=args.tag, continue_train=continue_train,
                lr=args.lr, checkpoint_dir=ckpt_dir, log_dir=log_dir,
                device=device))
            return trainers[-1]

        try:
            task = Task(factory)
            task.iters = args.iters
            print(f"stage 1/2: RPN alone, {args.iters} iters")
            task.train_rpn()
            print(f"stage 2/2: image+front+fusion, {args.iters} iters")
            trainer = task.train_img_and_fusion()
        finally:
            for t in trainers:
                t.close()

    # 4. predictions over the eval frames -> tracklet XML, every detection
    # kept (see the module note)
    pred_dir = os.path.join(args.out, "pred")
    pred_path = pred_and_save(eval_ds, trainer, pred_dir,
                              score_threshold=args.score_threshold, cfg=cfg,
                              gate_ty=False)

    # 5. gt tracklet XML + 3D-IoU scoring CSVs
    gt_path = os.path.join(args.out, "gt_tracklets.xml")
    tracklets.write_tracklets(gt_path, _gt_tracklets_for(eval_ds, cfg))
    eval_dir = os.path.join(args.out, "eval")
    res = tracklet_score(pred_path, gt_path, output_dir=eval_dir,
                         volume_method="box")
    print(f"iou_per_obj: {res['iou_per_obj']}")
    print(f"wrote {os.path.join(eval_dir, 'iou_per_obj.csv')} and "
          f"pr_per_iou.csv")
    return res


if __name__ == "__main__":
    main()
