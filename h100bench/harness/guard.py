"""What the benchmark's process may not hold: JAX, its libraries and the
JAX package, compared by the whole top-level name of each loaded module
(the port's package name begins with the JAX package's)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "mv3d_tpu")


def forbidden_loaded(modules: Iterable[str] = None,
                     forbidden: Iterable[str] = FORBIDDEN) -> List[str]:
    names = sys.modules if modules is None else modules
    bad = set(forbidden)
    return sorted({m.split(".", 1)[0] for m in names} & bad)
