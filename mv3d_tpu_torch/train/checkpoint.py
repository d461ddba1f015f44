"""Per-subnet checkpoints: the JAX package's npz layout, or
``torch.distributed.checkpoint`` for a process group.

Port of ``mv3d_tpu/train/checkpoint.py``. Each subnet's flax-style
variables tree (``{"params": ..., "batch_stats": ...}``, see
:func:`mv3d_tpu_torch.convert.subnet_variables`) is saved flattened to
``a/b/c`` names:

  * ``npz`` (default): ``<checkpoint_dir>/<subnet>/<subnet>-<step>.npz``,
    so a checkpoint written by either package loads in the other;
  * ``dcp``: a ``torch.distributed.checkpoint`` directory
    ``<subnet>-<step>.dcp``, saved and loaded collectively by every rank
    of the default process group (or by one process without a group);
    written under a temporary name and renamed by rank 0. It takes the
    place of the JAX package's ``orbax`` backend, whose format the port
    cannot write: ``backend="orbax"`` raises.

Training progress (the global step) sits in ``<log_dir>/train_progress/
<tag>/progress.txt``.
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


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _save_dcp(path: str, variables) -> None:
    """Collective save of ``variables`` (f32 host arrays) as a
    ``torch.distributed.checkpoint`` directory at ``path``."""
    import torch
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    tmp = path + ".tmp"
    rank0 = not _distributed() or dist.get_rank() == 0
    if rank0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    if _distributed():
        dist.barrier()
    dcp.save({k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in _flatten(variables).items()}, checkpoint_id=tmp)
    if rank0:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    if _distributed():
        dist.barrier()


def _load_dcp(path: str):
    """Collective load of a :func:`_save_dcp` directory into host arrays,
    shaped by its metadata."""
    import torch
    import torch.distributed.checkpoint as dcp
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
             for k, m in meta.items()}
    dcp.load(state, checkpoint_id=path)
    return _unflatten({k: v.numpy() for k, v in state.items()})


_SUFFIX = {"npz": ".npz", "dcp": ".dcp"}


class SubnetCheckpointer:
    """Saves and restores one subnet's variables tree (npz files, or
    ``torch.distributed.checkpoint`` directories with ``backend="dcp"``)."""

    def __init__(self, name: str, checkpoint_dir: str,
                 backend: str = "npz"):
        if backend not in _SUFFIX:
            raise ValueError(
                f"checkpoint backend {backend!r}: expected 'npz' or 'dcp' "
                f"(the sharded backend; the port cannot write orbax's "
                f"format)")
        self.name = name
        self.backend = backend
        self.dir = os.path.join(checkpoint_dir, name)

    def _path(self, step) -> str:
        return os.path.join(self.dir,
                            f"{self.name}-{step}{_SUFFIX[self.backend]}")

    def _save(self, path: str, variables) -> None:
        if self.backend == "dcp":
            _save_dcp(path, variables)
        else:
            _save_npz(path, variables)

    def save(self, variables, step: int = 0) -> None:
        self._save(self._path(step), variables)

    def save_crash(self, variables) -> str:
        """Forensic checkpoint at ``<name>-crash.npz`` (``.dcp``), a name
        :meth:`latest_step` never selects, so a resume starts from the
        last good cadence checkpoint."""
        path = self._path("crash")
        self._save(path, variables)
        return path

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.dir):
            return None
        suffix = _SUFFIX[self.backend]
        steps = []
        for f in os.listdir(self.dir):
            if f.startswith(self.name + "-") and f.endswith(suffix):
                try:
                    steps.append(int(f[len(self.name) + 1:-len(suffix)]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def load(self, step: Optional[int] = None):
        """The stored variables tree (host arrays), or None if there is no
        checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path(step)):
            return None
        if self.backend == "dcp":
            return _load_dcp(self._path(step))
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
