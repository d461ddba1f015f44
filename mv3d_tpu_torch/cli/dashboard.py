"""Render the static training dashboard from a log dir.

Port of ``mv3d_tpu/cli/dashboard.py`` over
:func:`mv3d_tpu_torch.utils.dashboard.render_dashboard`:

    python -m mv3d_tpu_torch.cli.dashboard <log_dir> [-o out.html] [--watch N]

Point it at a Trainer's ``--log-dir`` during or after a run; ``--watch``
re-renders every N seconds (ctrl-C to stop).
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="metrics JSONL -> self-contained HTML dashboard")
    ap.add_argument("log_dir", help="Trainer log dir (metrics_*.jsonl)")
    ap.add_argument("-o", "--out", default="",
                    help="output html (default <log_dir>/dashboard.html)")
    ap.add_argument("--watch", type=float, default=0,
                    help="re-render every N seconds")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..utils.dashboard import render_dashboard
    while True:
        path = render_dashboard(args.log_dir, args.out or None)
        print(f"wrote {path}")
        if not args.watch:
            return path
        time.sleep(args.watch)


if __name__ == "__main__":
    main()
