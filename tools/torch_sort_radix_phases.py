"""Where the time of the cluster radix sort (K4, ``csrc/sort_radix.cu``) goes.

Builds two instrumented copies of the kernel's source into a temporary
directory (the checkout's source with ``clock64()`` marks inserted at the
phase boundaries), with clusters of 8 CTAs (as built for the port) and of
16 (the cluster size rewritten, and the non-portable size allowed), and
runs each on one card: rows of 65,536 keys at B=1 and B=8, keys
drawn as the serving path's voxel ids (3 digit passes) and in [0, 16) (1
pass). Prints, per case, the CUDA-event time per call without the Python
wrapper, a check against ``torch.sort(stable=True)`` + gathers, and the SM
cycles each phase of CTA 0 of row 0 took:

  load      global load of the slice into registers and shared memory
  plan      the cluster-wide min/max and the pass plan (one cluster barrier)
  rank      per pass: (from the second pass on, the cluster barrier and
            the reload that close the pass before) zeroing the warp
            counters and ranking the keys
  prefix    per pass: the warps' prefix, the CTA's totals, the digit scan
  stage     per pass: grouping the slice by digit in the stage
  barrier   per pass: the cluster barrier after the stage
  offsets   per pass: reading the 8 (16) CTAs' totals through DSMEM + scan
  send      per pass: the DSMEM copy of the stage to the row buffers
  store     the global store of the sorted slice

Needs one CUDA card and nvcc. Run from the repository root:

    python3 tools/torch_sort_radix_phases.py
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mv3d_tpu_torch.ops.cuda_build import NVCC_FLAGS, _nvcc  # noqa: E402

SOURCE = os.path.join(ROOT, "mv3d_tpu_torch", "csrc", "sort_radix.cu")
N = 65536
# (mark before the anchor?, anchor in the source, mark code)
MARKS = [
    (False, "namespace cg = cooperative_groups;",
     "\n#define TS(k) if (threadIdx.x == 0) trace[(blockIdx.y * "
     "kCluster + cluster.block_rank()) * 64 + (k)] = clock64();\n"),
    (True, "  uint32_t k[kItems];\n  uint32_t lo", "  TS(0);\n"),
    (True, "  // -- the row's min and max", "  TS(1);\n"),
    (False, "  if (passes == 0) cluster.sync();", "\n  TS(2);\n"),
    (True, "    // (2) per digit:", "    TS(3 + 8 * pass);\n"),
    (True, "    // (3) group the slice", "    TS(4 + 8 * pass);\n"),
    (True, "    cluster.sync();   // stages complete",
     "    TS(5 + 8 * pass);\n"),
    (True, "    // (4) each digit's first row", "    TS(6 + 8 * pass);\n"),
    (True, "    // (5) send the stage", "    TS(7 + 8 * pass);\n"),
    (True, "    // (6) reload the keys", "    TS(8 + 8 * pass);\n"),
    (True, "  for (int j = tid; j < count; j += kThreads) {\n    out_key",
     "  TS(40);\n"),
    (True, "\n}\n\n}  // namespace", "\n  TS(41);"),
]


def instrumented_source(cluster: int = 8) -> str:
    src = open(SOURCE).read()
    for before, anchor, code in MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, code + anchor if before else anchor + code)
    for old, new in (
            ("float* __restrict__ out_p2) {\n  extern",
             "float* __restrict__ out_p2, long long* trace) {\n  extern"),
            ("out_p1,\n                           out_p2);",
             "out_p1,\n                           out_p2, trace);"),
            ("float* out_p2, void* stream) {",
             "float* out_p2, void* stream, long long* trace) {"),
            ("constexpr int kCluster = 8;",
             f"constexpr int kCluster = {cluster};"),
            ("  cudaLaunchConfig_t config = {};",
             "  err = cudaFuncSetAttribute(sort_radix, "
             "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
             "  if (err != cudaSuccess) return static_cast<int>(err);\n"
             "  cudaLaunchConfig_t config = {};")):
        if src.count(old) != 1:
            raise RuntimeError(f"signature not found once: {old!r}")
        src = src.replace(old, new)
    return src


def build(cluster: int, work: str) -> ctypes.CDLL:
    cu = os.path.join(work, "sort_radix_phases.cu")
    with open(cu, "w") as f:
        f.write(instrumented_source(cluster))
    lib = os.path.join(work, f"sort_radix_phases_{cluster}.so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib, cu], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(lib)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    dll.mv3d_sort_radix.argtypes = [p, p, p, i64, i64, p, p, p, p, p]
    dll.mv3d_sort_radix.restype = ctypes.c_int
    return dll


def phases(row, passes):
    """Cycles per phase from one CTA's marks."""
    out = {"load": row[1] - row[0], "plan": row[2] - row[1]}
    prev = row[2]
    for p in range(passes):
        m = [row[3 + 8 * p + i] for i in range(6)]
        out[f"pass {p}"] = dict(rank=m[0] - prev, prefix=m[1] - m[0],
                                stage=m[2] - m[1], barrier=m[3] - m[2],
                                offsets=m[4] - m[3], send=m[5] - m[4])
        prev = m[5]
    out["store"] = row[41] - row[40]
    out["total"] = row[41] - row[0]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as work:
        libs = {c: build(c, work) for c in (8, 16)}
        for cluster, lib in libs.items():
            for label, hi, passes in (("voxel ids", 12_000_000, 3),
                                      ("[0, 16)", 16, 1)):
                for b in (1, 8):
                    key = torch.from_numpy(rng.randint(0, hi, (b, N)).astype(
                        np.int32)).to(dev)
                    p1, p2 = (torch.rand(b, N, device=dev) for _ in range(2))
                    out = [torch.empty_like(x) for x in (key, p1, p2)]
                    trace = torch.zeros(b * cluster, 64, dtype=torch.int64,
                                        device=dev)

                    def call():
                        err = lib.mv3d_sort_radix(
                            key.data_ptr(), p1.data_ptr(), p2.data_ptr(), b,
                            N, out[0].data_ptr(), out[1].data_ptr(),
                            out[2].data_ptr(),
                            torch.cuda.current_stream().cuda_stream,
                            trace.data_ptr())
                        if err:
                            raise RuntimeError(f"launch failed: {err}")

                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(200):
                        call()
                    end.record()
                    torch.cuda.synchronize()
                    want, order = torch.sort(key, stable=True)
                    ok = (torch.equal(out[0], want)
                          and torch.equal(out[1], torch.gather(p1, 1, order))
                          and torch.equal(out[2], torch.gather(p2, 1, order)))
                    print(f"cluster {cluster}, B={b}, keys {label}: "
                          f"{start.elapsed_time(end) / 200 * 1e3:.1f} us per "
                          f"call (CUDA events, no wrapper), equal to "
                          f"torch.sort + gathers: {ok}; SM cycles of CTA 0: "
                          f"{phases(trace[0].tolist(), passes)} [{card}]",
                          flush=True)
                    if not ok:
                        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
