"""Per-drive inference -> ``tracklet_labels_pred.xml`` -> optional
scoring.

Port of ``mv3d_tpu/cli/tracking.py``, with the same flags and
``--device`` (the card by default):

    python -m mv3d_tpu_torch.cli.tracking -n TAG --kitti-raw ROOT \\
        --date 2011_09_26 --drive 0005 --eval

Each frame is voxelized and detected on the model's device; frame 0's
live detections are decomposed into (translation, size, rotation) and
written as single-pose tracklets.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="MV3D tracking/prediction")
    ap.add_argument("-n", "--tag", default="unknown_tag")
    ap.add_argument("-w", "--weights", default="all",
                    help="comma list of subnets to load, or 'all'")
    ap.add_argument("--kitti-raw", required=True, help="KITTI raw root")
    ap.add_argument("--date", required=True)
    ap.add_argument("--drive", required=True)
    ap.add_argument("--out-dir", default="predicted")
    ap.add_argument("--checkpoint-dir", default="checkpoint")
    ap.add_argument("--score-threshold", type=float, default=None)
    ap.add_argument("--eval", action="store_true",
                    help="score vs gt tracklets after prediction")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda, or cpu)")
    from .common import add_config_args
    add_config_args(ap)
    return ap.parse_args(argv)


def pred_and_save(dataset, predictor, out_dir, score_threshold=None,
                  cfg=None, log=print):
    """Run ``predictor`` (any ``MV3D``, a ``Trainer`` too) over a drive and
    write ``<out_dir>/tracklet_labels_pred.xml``; returns its path."""
    from ..data.loader import frames_to_batch
    from ..data.tracklets import TrackletSaver
    from ..ops import boxes3d as box3d_ops
    from ..train.trainer import first_frame
    from ..utils.timer import Timer

    cfg = cfg or predictor.cfg
    if cfg.pipeline.stream_quantized:
        # predict_from_points takes f32 points; the quantized transfer
        # applies to the training and serving loaders
        cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, stream_quantized=False))
    saver = TrackletSaver(out_dir)
    timer = Timer()
    for i in range(len(dataset)):
        frame = dataset.load_frame(i)
        batch = frames_to_batch([frame], cfg)
        boxes3d, _ = first_frame(predictor.predict_from_points(
            batch["points"], batch["num_points"], batch["rgb"],
            score_threshold=score_threshold))
        if len(boxes3d):
            trans, size, rot = (v.numpy() for v in
                                box3d_ops.boxes3d_decompose(
                                    torch.from_numpy(boxes3d), cfg))
            for j in range(len(boxes3d)):
                saver.add_tracklet(i, size[j], trans[j], rot[j])
        if (i + 1) % 100 == 0:
            log(f"{i+1} frames, {timer.time_diff_per_n_loops():.1f}s/100")
    saver.write_tracklet()
    return saver.path


def main(argv=None):
    """Predict a drive as the flags say; returns the XML's path (and,
    with ``--eval``, prints the per-class IoU)."""
    args = parse_args(argv)

    from .common import resolve_config
    cfg = resolve_config(args)
    from ..data.kitti import KittiRawDataset
    from ..train.trainer import Predictor

    predictor = Predictor(cfg, log_tag=args.tag,
                          checkpoint_dir=args.checkpoint_dir,
                          device=args.device)
    ds = KittiRawDataset(args.kitti_raw, args.date, args.drive, cfg)
    out_dir = os.path.join(args.out_dir, f"{args.date}_{args.drive}")
    pred_path = pred_and_save(ds, predictor, out_dir,
                              score_threshold=args.score_threshold, cfg=cfg)
    print(f"wrote {pred_path}")

    if args.eval and os.path.exists(ds.tracklet_file):
        from ..eval import tracklet_score
        res = tracklet_score(pred_path, ds.tracklet_file, output_dir=out_dir)
        print(res["iou_per_obj"])
    return pred_path


if __name__ == "__main__":
    main()
