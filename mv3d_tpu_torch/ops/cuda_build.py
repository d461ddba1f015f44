"""Build the port's CUDA kernels with nvcc at first use and load them.

Each source under ``mv3d_tpu_torch/csrc/`` has a plain C interface and is
compiled by nvcc into its own shared library in ``mv3d_tpu_torch/_build/``,
named by the source's stem and the hash of its text and the flags, so an
edited source rebuilds. The kernels' wrappers load their library with
ctypes (:func:`load_library`) and set the argument types themselves.
:func:`build_libraries` starts one nvcc per source, all at once, and keeps
what ptxas reports (registers, spills, static shared memory per kernel)
beside each library (:func:`ptxas_report`). :func:`launch` calls a
C entry point on a device's current stream with little host work.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Callable, List, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = tuple(os.path.join(CSRC, f) for f in (
    "voxelize_sweep.cu", "voxelize_padded.cu", "voxelize_heights.cu",
    "sort_radix.cu", "sort_merge.cu"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels need "
                           "the CUDA toolkit to build")
    return path


def library_path(source: str) -> str:
    """Where ``source``'s library lives once built (the hash covers the
    headers under ``csrc/`` too)."""
    src = b""
    for path in [source] + sorted(
            os.path.join(CSRC, h) for h in os.listdir(CSRC)
            if h.endswith(".cuh")):
        with open(path, "rb") as f:
            src += f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}_{digest[:16]}.so")


def _report_path(lib: str) -> str:
    return os.path.splitext(lib)[0] + ".ptxas.txt"


def ptxas_report(source: str) -> List[str]:
    """What ptxas said of each kernel of ``source``'s built library: per
    kernel one line with its registers, spills and static shared memory
    (dynamic shared memory is the launch's, not ptxas's)."""
    with open(_report_path(library_path(source))) as f:
        lines = [ln.strip() for ln in f]
    out, name = [], None
    for ln in lines:
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("spill" in ln or ln.startswith("ptxas info    : Used")):
            out.append(f"{name}: {ln.replace('ptxas info    : ', '')}")
    return out


def build_libraries(sources: Sequence[str]) -> List[str]:
    """Compile every source whose library is not built yet, one nvcc
    process each, all started together; returns the libraries' paths.
    Raises on any nvcc failure."""
    libs = [library_path(s) for s in sources]
    todo = [(s, lib) for s, lib in zip(sources, libs)
            if not os.path.exists(lib)]
    if not todo:
        return libs
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    running = []
    try:
        for src, lib in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((src, lib, tmp, proc))
        errors = []
        for src, lib, tmp, proc in running:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src} ({proc.returncode}):"
                              f"\n{out}")
            else:
                with open(_report_path(lib), "w") as f:
                    f.write(out)
                os.replace(tmp, lib)     # atomic: concurrent builds agree
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return libs


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """Load ``source``'s library (once); the first call builds every
    kernel of the port that is not built yet, in parallel."""
    sources = list(SOURCES) if source in SOURCES else [source]
    libs = build_libraries(sources)
    return ctypes.CDLL(libs[sources.index(source)])


# the current stream's raw handle without building a torch.cuda.Stream;
# torch builds for the CPU lack it (and launch nothing)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch(fn: Callable[..., int], device: torch.device, *args) -> int:
    """``fn(*args, stream)`` with ``stream`` the current CUDA stream of
    ``device``, made the current device for the call only where it is not
    already; returns what ``fn`` returns (a cudaError_t)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return launch(fn, torch.device("cuda", index), *args)
    stream = (_raw_stream(index) if _raw_stream is not None
              else torch.cuda.current_stream(index).cuda_stream)
    return fn(*args, stream)


def check_launch(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a cudaError."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
