"""Read the numbers a cell's correctness check compares, on many seeds in
one process, for the program as configured, for the control, or for the
witness.

    python3 h100bench/readings.py --workload <cell> --variant program \
        --seconds 3 --seeds 11 12 13 ... [--dump DIR]

The cell's pieces are found as a run finds them (``harness/spec.py``):
its driver by the mix's kind, and the family's reference
(``reference/<family>.py``) by the configuration's family. ``program``
runs the cell as its run does, at its own sizes and load, for a short
window; ``control`` runs the control: the program with the family's
``CONTROL_OVERRIDES`` laid over its configuration (for ``mv3d`` its own
int8 path, ``model.quant="int8"``, the nearest precision below the bf16
the configuration states). Both are judged against the check's reference
(the family's ``CHECK_OVERRIDES``: f32, TF32 off). ``witness`` builds no
program: it holds against the check's reference the reference at the
configuration's own precision (bf16) and, as ``fused``, the same under
the family's ``fused_epilogues()`` (each convolution's and dense layer's
product left in f32 into the BatchNorm after it, as a kernel that fuses
the BatchNorm into the product's epilogue would leave it: a sound change
that rounds differently). Each seed prints one JSON line a variant with
its numbers; with ``--dump`` each seed's answers, the reference's answers
at both precisions, the fused witness's, and the candidates near any of
them go to ``DIR/<cell>.<variant>.<seed>.npz``, from which
``h100bench/limits/<cell>.json`` was set (PERF.md). Needs the card and a
cell whose driver is ``serve_batch``'s kind.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

VARIANTS = ("program", "control", "witness")


NEAR_M = 3.0    # the candidates kept in a dump: this near a detection


def _save(path, **sets):
    """Each named list of batches of per-frame (boxes, probs) as arrays
    ``<name>.<batch>.<frame>.boxes`` / ``.probs``; of a candidate list
    (``cand*``) only those within ``NEAR_M`` of a detection of the frame
    in another list."""
    import numpy as np
    arrays = {}
    for name, batches in sets.items():
        for b, frames in enumerate(batches):
            for f, (boxes, probs) in enumerate(frames):
                if name.startswith("cand"):
                    g = np.concatenate(
                        [np.asarray(v[b][f][0]).reshape(-1, 8, 3)
                         for k, v in sets.items()
                         if not k.startswith("cand")])[:, None]
                    d = np.abs(np.asarray(boxes)[None] - g).max(axis=(2, 3))
                    near = (d <= NEAR_M).any(0)
                    boxes, probs = boxes[near], probs[near]
                arrays[f"{name}.{b}.{f}.boxes"] = np.asarray(boxes,
                                                             np.float32)
                arrays[f"{name}.{b}.{f}.probs"] = np.asarray(probs,
                                                             np.float32)
    np.savez_compressed(path, **arrays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", choices=VARIANTS, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)

    import torch

    from harness import spec
    if not torch.cuda.is_available():
        print("readings need the card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark(ROOT)
    cell, config, mix, limits, drv = spec.resolve(bench, args.workload)
    ref = spec.reference(config)
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    for seed in args.seeds:
        t = time.perf_counter()
        sets = {}
        if args.variant == "witness":
            inp = drv.inputs(config, mix, seed, "cuda")
            sets["got"], _, _ = drv.reference_answers(inp, "cuda",
                                                      overrides={})
            with ref.fused_epilogues():
                sets["fused"], _, _ = drv.reference_answers(
                    inp, "cuda", overrides={})
            line = {}
        else:
            over = ref.CONTROL_OVERRIDES if args.variant == "control" \
                else None
            res = drv.run(config, mix, limits, seed, args.seconds, False,
                          program_overrides=over, keep=True)
            kept = res.pop("kept")
            inp, sets["got"] = kept["inputs"], kept["answers"]
            line = {"attempted": res["attempted"],
                    "correct": res["correct"]}
        want, cand, rule = drv.reference_answers(inp, "cuda")
        for name, got in sets.items():
            _, numbers = drv.check(got, want, cand, rule, limits)
            print(json.dumps({
                "workload": cell["name"], "variant": args.variant,
                "answers": name, "seed": seed, **line, **numbers,
                "reference_detections": sum(len(p) for w in want
                                            for _, p in w),
                "run_s": time.perf_counter() - t}), flush=True)
        if args.dump:
            sets["want16"], sets["cand16"], _ = drv.reference_answers(
                inp, "cuda", overrides={})
            _save(os.path.join(args.dump, f"{cell['name']}.{args.variant}."
                               f"{seed}.npz"),
                  want32=want, cand32=cand, **sets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
