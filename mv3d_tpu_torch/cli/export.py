"""Export a model as a serving artifact.

Port of ``mv3d_tpu/cli/export.py``: loads every subnet checkpoint of a tag
(or, with ``--random-init``, keeps a seeded initialization) and writes the
artifact of :mod:`mv3d_tpu_torch.serving` (weights, meta, config):

    python -m mv3d_tpu_torch.cli.export -n mytag --out artifacts/mv3d \\
        --batch-size 8

The JAX command's ``--platforms`` has no counterpart: the port's artifact
holds no compiled program, and ``load_serving`` picks the device.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Export an MV3D serving artifact (weights, meta, config)")
    ap.add_argument("-n", "--tag", default="unknown_tag")
    ap.add_argument("--checkpoint-dir", default="checkpoint")
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--score-threshold", type=float, default=0.05)
    ap.add_argument("--quantized", action="store_true",
                    help="freeze the uint16/uint8 quantized-transfer "
                         "signature (ops/quantize.py)")
    ap.add_argument("--random-init", action="store_true",
                    help="skip checkpoint loading (smoke/bench artifacts)")
    ap.add_argument("--device", default="cuda",
                    help="where the model is built (cuda, or cpu)")
    from .common import add_config_args
    add_config_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .common import resolve_config
    cfg = resolve_config(args)

    from ..serving import export_serving
    from ..train.trainer import MV3D, Predictor

    cls = MV3D if args.random_init else Predictor
    model = cls(cfg, log_tag=args.tag, checkpoint_dir=args.checkpoint_dir,
                device=args.device)
    out = export_serving(model.get_variables(), cfg, args.out,
                         batch_size=args.batch_size,
                         score_threshold=args.score_threshold,
                         quantized=args.quantized)
    print(f"exported serving artifact: {out}")
    return out


if __name__ == "__main__":
    main()
