"""Per-subnet checkpoints in the JAX package's npz layout.

Port of ``mv3d_tpu/train/checkpoint.py`` (npz backend): each subnet's
flax-style variables tree (``{"params": ..., "batch_stats": ...}``, see
:func:`mv3d_tpu_torch.convert.subnet_variables`) is saved flattened to
``a/b/c`` names in ``<checkpoint_dir>/<subnet>/<subnet>-<step>.npz``, so
a checkpoint written by either package loads in the other. Training
progress (the global step) sits in ``<log_dir>/train_progress/<tag>/
progress.txt``. The orbax backend is not ported (ROADMAP A6).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _save_npz(path: str, variables) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:   # a file object: savez appends no ".npz"
        np.savez_compressed(f, **_flatten(variables))
    os.replace(tmp, path)


class SubnetCheckpointer:
    """Saves and restores one subnet's variables tree (npz files)."""

    def __init__(self, name: str, checkpoint_dir: str,
                 backend: str = "npz"):
        if backend != "npz":
            raise NotImplementedError(
                f"checkpoint backend {backend!r}: only npz is ported "
                f"(ROADMAP A6)")
        self.name = name
        self.dir = os.path.join(checkpoint_dir, name)

    def _path(self, step) -> str:
        return os.path.join(self.dir, f"{self.name}-{step}.npz")

    def save(self, variables, step: int = 0) -> None:
        _save_npz(self._path(step), variables)

    def save_crash(self, variables) -> str:
        """Forensic checkpoint at ``<name>-crash.npz``, a name
        :meth:`latest_step` never selects, so a resume starts from the
        last good cadence checkpoint."""
        path = self._path("crash")
        _save_npz(path, variables)
        return path

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.dir):
            return None
        steps = []
        for f in os.listdir(self.dir):
            if f.startswith(self.name + "-") and f.endswith(".npz"):
                try:
                    steps.append(int(f[len(self.name) + 1:-4]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def load(self, step: Optional[int] = None):
        """The stored variables tree, or None if there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path(step)):
            return None
        with np.load(self._path(step)) as z:
            return _unflatten({k: z[k] for k in z.files})

    def clean(self) -> None:
        """Remove every saved weight of this subnet."""
        shutil.rmtree(self.dir, ignore_errors=True)


def save_progress(log_dir: str, tag: str, step: int) -> None:
    path = os.path.join(log_dir, "train_progress", tag)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "progress.txt"), "w") as f:
        f.write(str(step))


def load_progress(log_dir: str, tag: str) -> int:
    path = os.path.join(log_dir, "train_progress", tag, "progress.txt")
    if os.path.exists(path):
        with open(path) as f:
            return int(f.read().strip())
    return 0
