"""Offline preprocessing: voxelize a dataset and dump the reference
directory layout (:mod:`mv3d_tpu_torch.data.preprocess`).

Port of ``mv3d_tpu/cli/preprocess.py``, with the same flags, where the JAX
command's ``--cpu`` (its numpy oracle) is ``--device cpu``; the default
is the card:

    python -m mv3d_tpu_torch.cli.preprocess --kitti-object DIR -o OUT -b 4
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="MV3D offline preprocess")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--kitti-object", help="KITTI object dataset root")
    src.add_argument("--kitti-raw",
                     help="KITTI raw root (needs --date/--drive)")
    ap.add_argument("--date", default="2011_09_26")
    ap.add_argument("--drive", default="0005")
    ap.add_argument("--split", default="")
    ap.add_argument("-o", "--out-dir", required=True)
    ap.add_argument("-b", "--batch-size", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the views are voxelized")
    ap.add_argument("--no-images", action="store_true")
    from .common import add_config_args
    add_config_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Preprocess as the flags say; returns the number of frames."""
    args = parse_args(argv)

    from .common import resolve_config
    cfg = resolve_config(args)
    from ..data.kitti import KittiObjectDataset, KittiRawDataset
    from ..data.preprocess import Preprocessor
    from ..utils.timer import Timer

    pp = Preprocessor(args.out_dir, cfg, batch_size=args.batch_size,
                      device=args.device, save_images=not args.no_images)
    if args.kitti_object:
        ds = KittiObjectDataset(args.kitti_object, split_file=args.split,
                                cfg=cfg)
    else:
        ds = KittiRawDataset(args.kitti_raw, args.date, args.drive, cfg)
    t = Timer()
    done = pp.run(ds)
    dt = t.total_time()
    print(f"preprocessed {done} frames in {dt:.1f}s "
          f"({done/dt:.1f} frames/sec)")
    return done


if __name__ == "__main__":
    main()
