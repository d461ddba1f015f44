"""Shared CLI plumbing: config selection and overrides.

Port of ``mv3d_tpu/cli/common.py``: the dataset presets, a yaml/json
override file (``config_from_file``) and dotted key/value pairs
(``config_from_list``) over the port's own config tree.
"""

from __future__ import annotations

import argparse


def add_config_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--dataset", default="kitti",
                    choices=["kitti", "didi", "didi2"],
                    help="config preset")
    ap.add_argument("--config", default="",
                    help="yaml/json config override file")
    ap.add_argument("--set", nargs=2, action="append", dest="set_kv",
                    metavar=("KEY", "VALUE"), default=[],
                    help="dotted config override, e.g. --set rpn.nms_thresh "
                         "0.5")


def resolve_config(args: argparse.Namespace, base=None):
    """The preset ``--dataset`` names (or ``base``) with ``--config`` and
    ``--set`` laid over it."""
    from ..config import config_from_file, config_from_list, make_config
    cfg = make_config(args.dataset) if base is None else base
    if args.config:
        cfg = config_from_file(cfg, args.config)
    for k, v in args.set_kv:
        cfg = config_from_list(cfg, [k, v])
    return cfg
