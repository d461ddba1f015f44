"""How far the port's small training-step reference depends on its draw.

``chip_smoke.small_train_reference`` holds one f32 RPN-stage training step
of ``mv3d_tpu_torch`` on the card against the CPU, gradients within 1e-3 of
each tensor's max. This tool runs the same step pair for several seeds and
prints, per seed, whether the target masks agree, how many rgb ROI corners
moved by a pixel, the losses' relative differences and the three worst
gradient ratios (max |diff| / max |g|):

    python3 tools/torch_train_reference_draws.py 0 1 2        # card vs CPU
    python3 tools/torch_train_reference_draws.py --cpu-threads 1 6 0 1 2

With ``--cpu-threads A B`` both runs are on the CPU, with A and B threads,
so only the summation order differs. Run from the repository root; it
imports torch and the port, never jax.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import train_step_pair  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--cpu-threads", type=int, nargs=2, metavar=("A", "B"),
                    help="compare two CPU runs with A and B threads")
    opts = ap.parse_args(argv)
    if opts.cpu_threads:
        devices = (torch.device("cpu"),) * 2
        threads = tuple(opts.cpu_threads)
    else:
        devices = (torch.device("cpu"), torch.device("cuda"))
        threads = (None, None)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        for seed in opts.seeds:
            t0 = time.time()
            a, b = train_step_pair(np.random.RandomState(seed), devices,
                                   work, threads)
            masks = all(torch.equal(x, y)
                        for x, y in zip(a["masks"], b["masks"]))
            moved = int((a["rgb"] != b["rgb"]).sum())
            losses = ", ".join(
                f"{k} {abs(b['losses'][k] - v) / abs(v):.2g}"
                for k, v in a["losses"].items())
            ratios = sorted(
                ((b["grads"][n] - g).abs().max().item()
                 / max(g.abs().max().item(), 1e-30), n)
                for n, g in a["grads"].items())
            print(f"seed {seed}: masks equal {masks}, rgb corners moved "
                  f"{moved}, loss rel diffs {losses}; worst gradient "
                  f"ratios " + ", ".join(f"{n} {r:.2g}"
                                         for r, n in ratios[-3:])
                  + f" ({time.time() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
