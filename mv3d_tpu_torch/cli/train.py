"""Train MV3D from a KITTI object directory.

Port of ``mv3d_tpu/cli/train.py``, with the same flags: ``-n`` tag, ``-i``
iterations, ``-t`` subnets to train, ``-w`` pretrained subnets to load,
``-c`` continue from saved progress, ``-b`` batch size, ``-l`` learning
rate, ``--loader-workers``, the dataset root and split files, the
checkpoint and log directories and ``cli/common.py``'s
``--dataset/--config/--set``. It trains on the card unless given
``--device cpu``:

    python -m mv3d_tpu_torch.cli.train --kitti-object DIR \\
        --train-split DIR/ImageSets/train.txt --val-split DIR/ImageSets/val.txt \\
        -b 2 --loader-workers 4
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="train MV3D")
    ap.add_argument("-n", "--tag", default="unknown_tag",
                    help="set log tag")
    ap.add_argument("-i", "--max-iter", type=int, default=1000,
                    help="max iterations")
    ap.add_argument("-t", "--targets", default="all",
                    help="comma list of subnets to train, or 'all'")
    ap.add_argument("-w", "--weights", default="",
                    help="comma list of pretrained subnets to load")
    ap.add_argument("-c", "--continue-train", action="store_true",
                    help="continue from saved progress")
    ap.add_argument("-b", "--batch-size", type=int, default=1)
    ap.add_argument("--loader-workers", type=int, default=1,
                    help="parallel batch-builder threads (ordered stream)")
    ap.add_argument("-l", "--lr", type=float, default=0.001)
    ap.add_argument("--kitti-object", required=True,
                    help="KITTI object dataset root")
    ap.add_argument("--train-split", default="", help="train split file")
    ap.add_argument("--val-split", default="", help="validation split file")
    ap.add_argument("--checkpoint-dir", default="checkpoint")
    ap.add_argument("--log-dir", default="log")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda, or cpu)")
    from .common import add_config_args
    add_config_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Train as the flags say; returns the last step's losses."""
    args = parse_args(argv)

    from .common import resolve_config
    cfg = resolve_config(args)
    from ..data.kitti import KittiObjectDataset
    from ..data.loader import BatchLoader
    from ..models.nets import SUBNET_NAMES
    from ..train.trainer import Trainer, resolve_device

    device = resolve_device(args.device)
    targets = (list(SUBNET_NAMES) if args.targets in ("all", "")
               else args.targets.split(","))
    weights = args.weights.split(",") if args.weights else []
    if weights == ["all"]:
        weights = list(SUBNET_NAMES)

    train_ds = KittiObjectDataset(args.kitti_object,
                                  split_file=args.train_split, cfg=cfg)
    val_ds = (KittiObjectDataset(args.kitti_object,
                                 split_file=args.val_split, cfg=cfg)
              if args.val_split else None)

    with BatchLoader(train_ds, cfg, batch_size=args.batch_size,
                     workers=args.loader_workers) as train_loader:
        val_loader = (BatchLoader(val_ds, cfg, batch_size=args.batch_size,
                                  workers=args.loader_workers)
                      if val_ds else None)
        trainer = None
        try:
            trainer = Trainer(
                train_loader, validation_set=val_loader,
                pre_trained_weights=weights, train_targets=targets, cfg=cfg,
                log_tag=args.tag, continue_train=args.continue_train,
                lr=args.lr, checkpoint_dir=args.checkpoint_dir,
                log_dir=args.log_dir, device=device)
            return trainer(max_iter=args.max_iter)
        finally:
            if trainer is not None:
                trainer.close()
            if val_loader:
                val_loader.close()


if __name__ == "__main__":
    main()
