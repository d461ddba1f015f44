"""Test and inspection command.

Port of ``mv3d_tpu/cli/test.py``, with the same subcommands and flags and
``--device`` (the card by default):

  test_rpn         dump per-frame proposals (+scores) as npy
  test_mv3d        full-net inference, dump <tag>_boxes3d.npy/<tag>_probs.npy
  test_single_mv3d one-frame inference, print detections
  export_kitti     full-net inference over a split, KITTI txt output
  test_3dop        fusion head on external 3D proposals (<tag>_rois3d.npy in
                   --proposal-dir)
  test_rpn_target  RPN target-assignment probe: anchor counts + annotated
                   label png
  test_front       dump front-view arrays + pngs
  probe_rpn        annotated proposal/gt images per frame (with
                   --kitti-raw/--date/--drive it walks a raw drive)

    python -m mv3d_tpu_torch.cli.test test_mv3d -n TAG --kitti-object DIR

Every frame is voxelized and detected on the model's device; the outputs
are frame 0's live detections as host arrays. In the ``s2d2p`` layout the
drawn top view is the pair's heights plane.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

COMMANDS = ("test_rpn", "test_mv3d", "test_single_mv3d", "export_kitti",
            "test_3dop", "test_rpn_target", "test_front", "probe_rpn")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="MV3D test utilities")
    ap.add_argument("command", choices=list(COMMANDS))
    ap.add_argument("--proposal-dir", default="",
                    help="test_3dop: dir of <tag>_rois3d.npy proposals")
    ap.add_argument("-n", "--tag", default="unknown_tag")
    ap.add_argument("--kitti-object", default="",
                    help="KITTI object dataset root (default source)")
    ap.add_argument("--kitti-raw", default="",
                    help="KITTI raw root: probe a raw drive instead of the "
                         "object dataset (with --date/--drive)")
    ap.add_argument("--date", default="2011_09_26")
    ap.add_argument("--drive", default="0005")
    ap.add_argument("--split", default="")
    ap.add_argument("--out-dir", default="test_output")
    ap.add_argument("--checkpoint-dir", default="checkpoint")
    ap.add_argument("--score-threshold", type=float, default=None)
    ap.add_argument("--limit", type=int, default=0, help="max frames (0=all)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda, or cpu)")
    from .common import add_config_args
    add_config_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Run one subcommand as the flags say."""
    args = parse_args(argv)

    from .common import resolve_config
    cfg = resolve_config(args)
    from ..data.kitti import KittiObjectDataset, KittiRawDataset
    from ..data.loader import frames_to_batch
    from ..ops.voxelize import lidar_to_front_batch, lidar_to_top_batch
    from ..train import trainer as tr

    device = tr.resolve_device(args.device)
    if args.kitti_raw:
        ds = KittiRawDataset(args.kitti_raw, args.date, args.drive, cfg)
    else:
        if not args.kitti_object:
            raise SystemExit("one of --kitti-object / --kitti-raw is required")
        ds = KittiObjectDataset(args.kitti_object, split_file=args.split,
                                cfg=cfg)
    weights = dict(log_tag=args.tag, checkpoint_dir=args.checkpoint_dir,
                   device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    n = len(ds) if not args.limit else min(args.limit, len(ds))

    def frame(i):
        """Frame i and its batch of one, points on the model's device."""
        f = ds.load_frame(i)
        b = frames_to_batch([f], cfg)
        return f, b, (torch.from_numpy(b["points"]).to(device),
                      torch.from_numpy(b["num_points"]).to(device))

    def save(name, arr):
        np.save(os.path.join(args.out_dir, name), arr)

    if args.command in ("test_rpn", "probe_rpn"):
        # the RPN alone; the anchor filter reads the view (every layout,
        # the s2d2p pair included)
        tester = tr.TesterRPN(cfg, **weights)
        for i in range(n):
            f, b, (pts, num) = frame(i)
            with torch.inference_mode():
                top = lidar_to_top_batch(pts, cfg, num)
            props, _ = tester.proposals(top)
            mask = props.mask[0].cpu().numpy()
            rois = props.rois[0].cpu().numpy()[mask]
            if args.command == "test_rpn":
                save(f"{f.tag}_proposals.npy", rois)
                save(f"{f.tag}_proposal_scores.npy",
                     props.scores[0].cpu().numpy()[mask])
            else:
                from ..utils.metrics import dump_debug_images
                dump_debug_images(
                    args.out_dir, i, tr.top_plane(top), rgb=f.rgb,
                    gt_boxes3d=f.gt_boxes3d if len(f.gt_boxes3d) else None,
                    proposals=rois[:, 1:5], cfg=cfg)
        print(f"dumped proposals for {n} frames to {args.out_dir}"
              if args.command == "test_rpn"
              else f"probe images -> {args.out_dir}")

    elif args.command in ("test_mv3d", "test_single_mv3d", "export_kitti"):
        predictor = tr.Predictor(cfg, **weights)
        frames = range(1) if args.command == "test_single_mv3d" else range(n)
        dets = {}
        for i in frames:
            f, b, _ = frame(i)
            boxes3d, probs = tr.first_frame(predictor.predict_from_points(
                b["points"], b["num_points"], b["rgb"],
                score_threshold=args.score_threshold))
            dets[f.tag] = (boxes3d, probs)
            if args.command == "export_kitti":
                continue
            save(f"{f.tag}_boxes3d.npy", boxes3d)
            save(f"{f.tag}_probs.npy", probs)
            if args.command == "test_single_mv3d":
                print(f"{f.tag}: {len(boxes3d)} detections, probs={probs}")
        if args.command == "export_kitti":
            from ..eval.kitti_export import export_kitti_detections
            export_kitti_detections(dets, args.out_dir, cfg)
            print(f"wrote KITTI txt for {len(dets)} frames to "
                  f"{args.out_dir}")
        else:
            print(f"dumped detections to {args.out_dir}")

    elif args.command == "test_3dop":
        # external 3D proposals (e.g. 3DOP dumps): <tag>_rois3d.npy (K, 8, 3)
        tester = tr.Tester3DOP(cfg, **weights)
        for i in range(n):
            f, b, (pts, num) = frame(i)
            rois_path = os.path.join(args.proposal_dir, f"{f.tag}_rois3d.npy")
            if not os.path.exists(rois_path):
                print(f"{f.tag}: no proposals, skipped")
                continue
            rois3d = np.load(rois_path).astype(np.float32)
            with torch.inference_mode():
                top = lidar_to_top_batch(pts, cfg, num)
                front = lidar_to_front_batch(pts, cfg, num)
            probs, boxes3d = tester(top, front, b["rgb"], rois3d,
                                    score_threshold=args.score_threshold)
            save(f"{f.tag}_boxes3d.npy", boxes3d)
            save(f"{f.tag}_probs.npy", probs)
        print(f"3dop detections -> {args.out_dir}")

    elif args.command == "test_rpn_target":
        tester = tr.TesterRPNTarget(cfg, log_dir=args.out_dir, **weights)
        for i in range(n):
            f, b, (pts, num) = frame(i)
            if not len(f.gt_boxes3d):
                print(f"{f.tag}: no gt, skipped")
                continue
            with torch.inference_mode():
                top = lidar_to_top_batch(pts, cfg, num)
            tester(top, f.gt_boxes3d, f.gt_labels, seed=i)
            tester.dump_log("rpn_target", step=i)
            print(f"{f.tag}: {tester.anchors_details().strip()}")
        print(f"rpn_target images -> {args.out_dir}/rpn_target")

    elif args.command == "test_front":
        # the cylindrical front view as npy + png
        from ..utils.png import write_png
        for i in range(n):
            f, b, (pts, num) = frame(i)
            with torch.inference_mode():
                front = lidar_to_front_batch(pts, cfg, num)[0].cpu().numpy()
            save(f"{f.tag}_front.npy", front)
            lo, hi = front.min(), front.max()
            img = ((front - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
            write_png(os.path.join(args.out_dir, f"{f.tag}_front.png"),
                      img.transpose(1, 0, 2))
        print(f"front views -> {args.out_dir}")


if __name__ == "__main__":
    main()
