"""CUDA kernel launches per request of the frozen program: the kernels
the device ran in the traced window, over the traced requests. Every
request runs the same program on the same shapes, so the count is a whole
number; a fraction means the profiler lost records (or the program's
launches came to depend on the data), and is printed."""

import sys

from harness import trace


def read(rec):
    if not rec["requests"]:
        return None
    kernels = len(trace.in_window(rec, "kernel"))
    if not kernels:
        return None
    n = len(rec["requests"])
    if kernels % n:
        print(f"launches.serve: {kernels} kernels over {n} traced requests",
              file=sys.stderr)
    return kernels / n
