"""The plain AVOD reference of the port's tests: AVOD's forward pass in
plain PyTorch, importing nothing of the port or of JAX. It is the
benchmark's ``h100bench/reference/avodref/plain.py``, the one copy, so the
tests and the benchmark's check hold the port to the same code."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "h100bench", "reference"))

from avodref.plain import *  # noqa: E402,F401,F403
