"""Read the numbers a cell's correctness check compares, on many seeds in
one process, for the program as configured, for the control, or for the
witness.

    python3 h100bench/readings.py --workload <cell> --variant program \
        --seconds 3 --seeds 11 12 13 ... [--dump DIR]

``program`` runs the cell as its run does, at its own sizes and load,
for a short window; ``int8`` runs the control: the program's own int8
path (``model.quant="int8"``), the nearest precision below the bf16 the
configuration states. Both are judged against the check's reference (f32,
TF32 off). ``witness`` builds no program: it holds against the check's
reference the reference at the configuration's own precision (bf16,
which the program matches bit for bit) and, as ``fused``, the same with
each convolution's and dense layer's product left in f32 into the
BatchNorm after it, as a kernel that fuses the BatchNorm into the
product's epilogue would leave it: a sound change that rounds
differently. Each seed prints one JSON line a variant with its numbers;
with ``--dump`` each seed's answers, the reference's answers at both
precisions, the fused witness's, and the candidates near any of them go
to ``DIR/<cell>.<variant>.<seed>.npz``, from which
``h100bench/limits/<cell>.json`` was set (PERF.md). Needs the card.
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

VARIANTS = {"program": None, "int8": {"model": {"quant": "int8"}},
            "witness": None}


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


def fused_epilogues():
    """A context in which the reference's bf16 convolutions and dense
    layers return their f32 products (bf16 inputs and weights, f32
    accumulation, no rounding of the output)."""
    import contextlib

    import torch

    from reference.mv3dref.models import backbone

    def unrounded(forward):
        def call(self, x):
            if self.compute_dtype != torch.bfloat16:
                return forward(self, x)
            r = lambda t: None if t is None else t.to(torch.bfloat16).float()
            if isinstance(self, backbone.Linear):
                return torch.nn.functional.linear(r(x), r(self.weight),
                                                  r(self.bias))
            return self._conv_forward(r(x), r(self.weight), r(self.bias))
        return call

    @contextlib.contextmanager
    def ctx():
        kept = backbone.Conv2d.forward, backbone.Linear.forward
        backbone.Conv2d.forward = unrounded(kept[0])
        backbone.Linear.forward = unrounded(kept[1])
        try:
            yield
        finally:
            backbone.Conv2d.forward, backbone.Linear.forward = kept
    return ctx()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", choices=sorted(VARIANTS), required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)

    import torch

    from harness import serve, spec
    if not torch.cuda.is_available():
        print("readings need the card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    config = spec.load_config(bench, cell["config"], ROOT)
    mix = spec.load_mix(cell["traffic"])
    limits = spec.load_limits(cell["name"])
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    for seed in args.seeds:
        t = time.perf_counter()
        sets = {}
        if args.variant == "witness":
            inp = serve.inputs(config, mix, seed, "cuda")
            sets["got"], _, _ = serve.reference_answers(inp, "cuda",
                                                        overrides={})
            with fused_epilogues():
                sets["fused"], _, _ = serve.reference_answers(
                    inp, "cuda", overrides={})
            line = {}
        else:
            res = serve.run(config, mix, limits, seed, args.seconds, False,
                            program_overrides=VARIANTS[args.variant],
                            keep=True)
            kept = res.pop("kept")
            inp, sets["got"] = kept["inputs"], kept["answers"]
            line = {"attempted": res["attempted"],
                    "correct": res["correct"]}
        want, cand, rule = serve.reference_answers(inp, "cuda")
        for name, got in sets.items():
            _, numbers = serve.check(got, want, cand, rule, limits)
            print(json.dumps({
                "workload": cell["name"], "variant": args.variant,
                "answers": name, "seed": seed, **line, **numbers,
                "reference_detections": sum(len(p) for w in want
                                            for _, p in w),
                "run_s": time.perf_counter() - t}), flush=True)
        if args.dump:
            sets["want16"], sets["cand16"], _ = serve.reference_answers(
                inp, "cuda", overrides={})
            _save(os.path.join(args.dump, f"{cell['name']}.{args.variant}."
                               f"{seed}.npz"),
                  want32=want, cand32=cand, **sets)
    return 0


if __name__ == "__main__":
    sys.exit(main())
