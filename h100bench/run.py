"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration file
and a traffic mix; the configuration's ``family`` names its reference
and its program adapter, and the mix's ``kind`` names the driver of the
program's entry point (``harness/spec.py``). With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics; with ``--trace 1``
the run profiles a bounded number of requests inside its window and
reports the cell's per-layer metrics, each read by its own reader under
``h100bench/metrics/``, with the device's busy and window seconds and a
breakdown. The last line of standard output is one JSON object; the
numbers the correctness check compared, each beside its limit, close
standard error and the line.

The run needs the card: without CUDA, or with fewer cards than the cell
asks for, it exits non-zero and prints no result. It also refuses to
print one when the process holds JAX, its libraries or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's kernel caches stay inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(var, os.path.join(ROOT, ".h100bench_cache", sub))
sys.path[:0] = [HERE, ROOT]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import guard, spec

    bench = spec.load_benchmark(ROOT)
    found = spec.resolve(bench, args.workload)
    cell = found.entry
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"the cell {cell['name']} needs {cell['chips']} CUDA "
              f"card(s); this machine has {cards}", file=sys.stderr)
        return 2
    res = found.driver.run(found.config, found.mix, found.limits, args.seed,
                           args.seconds, bool(args.trace), device="cuda",
                           t0=T0)

    kind = torch.cuda.get_device_name(0)
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              **res["device"], "power_limit": power_limit()}
    metrics = {}
    if args.trace:
        for m in spec.metrics_of(bench, cell["name"], "per_layer"):
            value = spec.load_reader(m["name"]).read(res["record"])
            if value is None:
                print(f"metric {m['name']}: nothing to read",
                      file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.metrics_of(bench, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                  "unit": m["unit"]}
    bad = guard.forbidden_loaded()
    if bad:
        print(f"refusing to report: the process holds {bad}",
              file=sys.stderr)
        return 3
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
