"""CUDA kernel launches per request of AVOD's frozen program:
``launches.serve``'s count (``metrics/launches.serve.py``), the kernels
the device ran in the traced window over the traced requests."""

from harness import spec


def read(rec):
    return spec.load_reader("launches.serve").read(rec)
