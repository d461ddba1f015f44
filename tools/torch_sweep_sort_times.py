"""Card times of the fused BEV sweep (K1) and of the stable sort (K4) on
rows of 131,072, for the ``mv3d_tpu_torch`` package of a given checkout,
so that two versions of the kernels can be compared on one card in one
call (run them in turns: A, B, B, A).

For each batch size B = 1, 2, 8 (65,536 uniform points per frame drawn as
``bench.py`` draws them, quantized by the package's own ``_top_prep``):

  * K1 with f32 heights and with bf16 heights (where the package's sweep
    has no ``heights_dtype``, its f32 heights followed by ``.to(bf16)``,
    which is what that version's voxelizer did);
  * K4 on rows of 131,072 (the frame's ids and their mirror image);

each as the mean time per call with the wrapper (CUDA events over 200
calls), the device time per call (CUDA events over 50 calls enqueued
behind a spin kernel, so that they run back to back without the host),
its split by kernel (a torch.profiler trace of 50 calls) and the host
time per call (``time.perf_counter`` over 200 calls without a
synchronize). Every result is one JSON line on stdout, with the card's
name and power limit.

Run from the repository root on the card:

    python3 tools/torch_sweep_sort_times.py --package DIR --label NAME

``DIR`` is the root of the checkout whose package is timed (this one by
default); its kernels are built from its own sources into its own
``_build/``.
"""

import argparse
import importlib.util
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_helpers():
    """``chip_smoke.py`` of this checkout (its timing helpers), loaded by
    path: the timed package's checkout may hold an older one."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", default=ROOT,
                    help="root of the checkout whose mv3d_tpu_torch is "
                         "timed")
    ap.add_argument("--label", default="this checkout")
    opts = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_sweep_sort_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(opts.package))
    import mv3d_tpu_torch
    from mv3d_tpu_torch import kitti_config
    from mv3d_tpu_torch.ops import sort_bitonic as sb
    from mv3d_tpu_torch.ops import voxelize as vox
    from mv3d_tpu_torch.ops import voxelize_sweep as sweep
    package = os.path.abspath(opts.package)
    if not mv3d_tpu_torch.__file__.startswith(package):
        raise AssertionError(f"imported {mv3d_tpu_torch.__file__}, not the "
                             f"package under {package}")
    smoke = smoke_helpers()
    card = smoke.card_line()
    dev = torch.device("cuda")
    cfg = kitti_config()
    t = cfg.top
    n_cells, zn, n_pts = t.xn * t.yn, t.zn, cfg.pipeline.max_points
    has_dtype = "heights_dtype" in inspect.signature(
        sweep.scatter_top_fused_kernel).parameters

    def k1(f, v, r, dtype):
        if has_dtype:
            return sweep.scatter_top_fused_kernel(f, v, r, n_cells, zn,
                                                  dtype)
        out = sweep.scatter_top_fused_kernel(f, v, r, n_cells, zn)
        if dtype != torch.float32:
            return (out[0].to(dtype), *out[1:])
        return out

    def record(what, b, fn):
        host = smoke.host_us(fn)
        wrapped = smoke.cuda_ms(fn)
        dev_ms = smoke.device_ms(fn)
        parts = smoke.kernel_split(fn)
        print(json.dumps({
            "label": opts.label, "what": what, "B": b,
            "wrapper_us": wrapped * 1e3,
            "device_us": None if dev_ms is None else dev_ms * 1e3,
            "host_us": host, "by_kernel_us": {
                k: v * 1e3 for k, v in sorted(parts.items(),
                                              key=lambda kv: -kv[1])},
            "card": card}), flush=True)

    for b in (1, 2, 8):
        rng = np.random.RandomState(b)
        pts = np.stack([rng.uniform(t.x_min, t.x_max, (b, n_pts)),
                        rng.uniform(t.y_min, t.y_max, (b, n_pts)),
                        rng.uniform(t.z_min, t.z_max, (b, n_pts)),
                        rng.uniform(0, 1, (b, n_pts))], -1)
        _, _, f, v, r = vox._top_prep(
            torch.from_numpy(pts.astype(np.float32)).to(dev), cfg, None)
        r = torch.where(f < n_cells * zn, r, 0.0)
        for dtype in (torch.float32, torch.bfloat16):
            record(f"K1 {str(dtype)[6:]} heights", b,
                   lambda dtype=dtype: k1(f, v, r, dtype))
        rows = [torch.cat([x, x.flip(-1)], -1) for x in (f, v, r)]
        record("K4 n=131072", b, lambda: sb.bitonic_sort_kernel(*rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
