"""Export a model as a frozen serving artifact.

Port of ``mv3d_tpu/cli/export.py``: loads every subnet checkpoint of a tag
(or, with ``--random-init``, keeps a seeded initialization), traces the
serving program on ``--device`` and writes the artifact of
:mod:`mv3d_tpu_torch.serving` (the ``torch.export`` program, weights,
meta, config):

    python -m mv3d_tpu_torch.cli.export -n mytag --out artifacts/mv3d \\
        --batch-size 8 --platforms cuda,cpu

``--arch avod`` exports AVOD (``config.avod_cars_config``) instead.

``--platforms`` names the devices the artifact may be served on (default:
the export device). The kernels are operators that the dispatcher picks
by device, so an artifact exported with ``--device cpu --platforms
cuda,cpu`` on a host without a card serves on the card and launches the
kernels there, as JAX's cross-lowering builds a TPU artifact on a CPU.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Export a frozen MV3D or AVOD serving artifact "
                    "(torch.export program, weights, meta, config)")
    ap.add_argument("-n", "--tag", default="unknown_tag")
    ap.add_argument("--checkpoint-dir", default="checkpoint")
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--score-threshold", type=float, default=0.05)
    ap.add_argument("--quantized", action="store_true",
                    help="freeze the uint16/uint8 quantized-transfer "
                         "signature (ops/quantize.py)")
    ap.add_argument("--platforms", default="",
                    help="comma list of the devices the artifact may run "
                         "on: cuda, cpu (default: the export device)")
    ap.add_argument("--random-init", action="store_true",
                    help="skip checkpoint loading (smoke/bench artifacts)")
    ap.add_argument("--device", default="cuda",
                    help="where the model is built and the program "
                         "traced (cuda, or cpu)")
    ap.add_argument("--arch", default="mv3d", choices=["mv3d", "avod"],
                    help="the detector: MV3D at --dataset's preset, or "
                         "AVOD's cars preset (config.avod_cars_config)")
    from .common import add_config_args
    add_config_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..config import avod_cars_config
    from .common import resolve_config
    cfg = resolve_config(args, avod_cars_config()
                         if args.arch == "avod" else None)

    from ..serving import export_serving
    from ..train.trainer import MV3D, Predictor

    cls = MV3D if args.random_init else Predictor
    model = cls(cfg, log_tag=args.tag, checkpoint_dir=args.checkpoint_dir,
                device=args.device)
    platforms = ([p.strip() for p in args.platforms.split(",") if p.strip()]
                 or None)
    out = export_serving(model, args.out, batch_size=args.batch_size,
                         score_threshold=args.score_threshold,
                         quantized=args.quantized, platforms=platforms)
    print(f"exported serving artifact: {out}")
    return out


if __name__ == "__main__":
    main()
