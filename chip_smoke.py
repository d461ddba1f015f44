"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Drives ``mv3d_tpu_torch`` — never jax — through its main path, the
lidar -> 3D-boxes inference of ``MV3D.predict_from_points`` at full KITTI
width (top view 800x600x27, rgb 375x1242, 65,536 points per frame, 30,000
anchors, 30 proposals per frame) with random weights from a seed:

  1. require CUDA; print the card's name and power limit;
  2. build the voxelizer sweep kernel from this checkout's source (nvcc);
  3. hold the kernel against its plain PyTorch version at the main path's
     shapes: bit-equal on the card and against the CPU;
  4. serve three requests (B=2, distinct clouds) through
     ``predict_from_points`` and check the kernel ran once per request,
     the outputs' shape and finiteness, the card's top view and occupancy
     against the CPU's, and a small f32 model on the card against the CPU;
  5. time the kernel against its plain version (CUDA events), and the
     serving path at B=1 and B=8: closed-loop requests, each waited for,
     over three windows of SERVE_WINDOW_S seconds after a warm-up window
     of SERVE_WARMUP_S seconds; per window
     the frames/s and the median and p90 request latency, then the median
     and the range of frames/s over the windows;
  6. only with ``--profile DIR``: torch.profiler over a few requests at
     B=1 and B=8; prints the card's busy time per request (union of kernel
     intervals), its idle share against the serving median latency, the
     requests' peak allocated memory and the ops with the most device
     time, and
     writes the profiler's table to ``DIR/profile_b{B}.txt``.

Any failure raises, so the exit code is non-zero and no result line is
printed. The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py [--profile DIR]

``make_cloud`` and ``small_reference`` are shared with the port's tests.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

# bench.py's score threshold: random weights give fg probs near 0.5, so
# the default 0.75 would leave NMS nothing to keep
THRESH = 0.05
# seconds per serving window, three windows per batch size, after a
# warm-up window
SERVE_WINDOW_S = 5.0
SERVE_WARMUP_S = 3.0


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after warm-up)."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_cloud(rng, b, n, cfg, tricky: bool):
    """(B, N, 4) clouds drawn as bench.py draws them; ``tricky`` adds points
    around the crop box, exact slice-boundary z values and duplicated
    positions with other reflectance (tests/test_voxelize.py). Also the
    clouds of the port's tests."""
    import numpy as np
    t = cfg.top
    pad = 1.0 if tricky else 0.0
    pts = np.stack([rng.uniform(t.x_min - pad, t.x_max + pad, (b, n)),
                    rng.uniform(t.y_min - pad, t.y_max + pad, (b, n)),
                    rng.uniform(t.z_min - pad, t.z_max + pad / 2, (b, n)),
                    rng.uniform(0, 1, (b, n))], axis=-1).astype(np.float32)
    if tricky:
        k = n // 50
        pts[:, :k, 2] = (t.z_min + t.z_div * rng.randint(1, t.zn, (b, k))
                         ).astype(np.float32)
        pts[:, k:2 * k, :3] = pts[:, :k, :3]
        pts[:, k:2 * k, 3] = pts[:, :k, 3] * 0.5 + 0.25
    return pts


def serve_window(model, batches, seconds: float):
    """Closed-loop serving for ``seconds``: one request at a time, each
    waited for, cycling through distinct batches. Returns the requests'
    latencies in seconds."""
    import torch
    lat = []
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        t0 = time.perf_counter()
        model.predict_from_points(*batches[len(lat) % len(batches)], THRESH)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return lat


def profile_serving(model, batches, b: int, median_s: float, out_dir: str,
                    card: str, n: int = 5):
    """torch.profiler over ``n`` requests of ``batches`` (B = ``b``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_mib = torch.cuda.memory_allocated() / 2 ** 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            model.predict_from_points(*batches[i % len(batches)], THRESH)
        torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20 - held_mib
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA")
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy_us, lo = busy_us + hi - lo, s
        hi = max(hi, e)
    busy_ms = (busy_us + hi - lo) / 1e3 / n
    avgs = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    ops = sorted((a for a in avgs if a.key.startswith("aten::")),
                 key=lambda a: -getattr(a, key))
    total = sum(getattr(a, key) for a in ops)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_b{b}.txt")
    with open(path, "w") as f:
        f.write(f"{card}\nB={b}, {n} requests\n")
        f.write(avgs.table(sort_by=key, row_limit=60))
    log(f"phase profile: B={b}: device busy {busy_ms:.2f} ms/request, idle "
        f"share {1 - busy_ms / (median_s * 1e3):.2f} of the serving median "
        f"latency {median_s * 1e3:.2f} ms, peak allocated {peak_mib:.0f} MiB "
        f"above the {held_mib:.0f} MiB held before the requests"
        f"; self device time of aten ops: " + ", ".join(
            f"{a.key} {getattr(a, key) / total:.0%}" for a in ops[:8])
        + f" [{card}] (table: {path})")


def small_reference(rng, dev):
    """A small f32 model from one seed, run on the card and on the CPU:
    RPN outputs, proposals and detections must agree.

    Tolerances: proposal and detection masks exact; RPN scores/deltas atol
    1e-4 and proposal rois atol 1e-3 (cuDNN and the CPU sum convs in
    different orders); fused probs atol 1e-4 and boxes3d atol 1e-3 m. An
    rgb ROI corner is an int32 truncation of the projected proposal, so a
    last-bit difference in the proposal can move it by a pixel, which
    changes that ROI's pooled rgb features: when any corner moved (they
    are counted and printed), probs are held to 1e-3 and boxes3d to 1e-2 m
    (measured on an H100 with 2 moved corners: 2.1e-4 and 2.9e-3 m)."""
    import numpy as np
    import torch
    from mv3d_tpu_torch import kitti_config
    from mv3d_tpu_torch.models.mv3d_net import project_to_rgb_roi
    from mv3d_tpu_torch.ops.boxes3d import top_box_to_box3d
    from mv3d_tpu_torch.ops.voxelize import lidar_to_top_batch
    from mv3d_tpu_torch.train.trainer import MV3D

    cfg = kitti_config()
    small = dataclasses.replace(
        cfg, top=dataclasses.replace(cfg.top, x_max=16.0, y_min=-6.0,
                                     y_max=6.0, x_div=0.2, y_div=0.2),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        image_width=96, image_height=64)
    pts = make_cloud(rng, 2, 2048, small, tricky=False)
    rgb = rng.rand(2, *small.rgb_shape).astype(np.float32)
    res = {}
    for d in (torch.device("cpu"), dev):
        net = MV3D(small, device=d, seed=1).model
        with torch.inference_mode():
            top, occ = lidar_to_top_batch(torch.from_numpy(pts).to(d), small,
                                          return_occ=True)
            rpn = net.top_rpn(top)
            dets, props = net.forward_inference(
                top, torch.from_numpy(rgb).to(d), None, THRESH, top_occ=occ)
            rgb_rois = project_to_rgb_roi(
                top_box_to_box3d(props.rois[..., 1:5], small), small)
        res[d.type] = [x.cpu() for x in (
            rpn["scores"], rpn["deltas"], props.mask, props.rois, rgb_rois,
            dets.mask, dets.probs, dets.boxes3d)]
    (s0, d0, pm0, r0, g0, m0, p0, b0) = res["cpu"]
    (s1, d1, pm1, r1, g1, m1, p1, b1) = res["cuda"]

    def err(a, b, mask=None):
        return (a - b)[mask].abs().max().item() if mask is not None \
            else (a - b).abs().max().item()

    if not torch.equal(pm0, pm1) or not torch.equal(m0, m1) or not m0.any():
        raise AssertionError("small f32 model: proposal or detection masks "
                             "differ between the card and the CPU (or no "
                             "live detection)")
    # a corner moved by a pixel changes that ROI's pooled rgb features
    moved = int((g0[pm0] != g1[pm1]).sum())
    fused = (1e-4, 1e-3) if moved == 0 else (1e-3, 1e-2)
    checks = {"rpn scores": (err(s0, s1), 1e-4),
              "rpn deltas": (err(d0, d1), 1e-4),
              "proposal rois": (err(r0, r1), 1e-3),
              "probs": (err(p0, p1, m0), fused[0]),
              "boxes3d": (err(b0, b1, m0), fused[1])}
    log("phase reference: small f32 model, card vs CPU: same "
        f"{int(pm0.sum())} proposals and {int(m0.sum())} live detections; "
        + ", ".join(f"{k} max|diff| {e:.3g} (tol {t:g})"
                    for k, (e, t) in checks.items())
        + f"; rgb ROI corners moved by a pixel: {moved}")
    for name, (e, tol) in checks.items():
        if not e <= tol:
            raise AssertionError(f"small f32 model: {name} differ by {e} "
                                 f"(> {tol}) between the card and the CPU")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the serving path; write tables here")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this test runs only on the card")
        return 1
    card = card_line()
    log(card)

    import numpy as np
    from mv3d_tpu_torch import kitti_config
    from mv3d_tpu_torch.ops import voxelize as vox
    from mv3d_tpu_torch.ops import voxelize_sweep as sweep
    from mv3d_tpu_torch.train.trainer import MV3D

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = kitti_config()
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, use_pallas_fused=True))
    t = cfg.top
    n_cells, zn, n_pts = t.xn * t.yn, t.zn, cfg.pipeline.max_points
    rng = np.random.RandomState(0)

    # -- 2. build --------------------------------------------------------
    t0 = time.time()
    sweep.build_library()
    sweep._library()
    log(f"phase build: voxelize_sweep built in {time.time() - t0:.2f} s")

    # -- 3. kernel vs plain at the main path's shapes --------------------
    def sweep_inputs(b, device):
        pts = torch.from_numpy(make_cloud(rng, b, n_pts, cfg, tricky=True))
        _, _, flat, val, refl = vox._top_prep(pts.to(device), cfg, None)
        refl = torch.where(flat < n_cells * zn, refl, 0.0)
        return flat, val, refl

    flat, val, refl = sweep_inputs(2, torch.device("cpu"))
    want = sweep.scatter_top_fused_plain(flat, val, refl, n_cells, zn)
    args = (flat.to(dev), val.to(dev), refl.to(dev), n_cells, zn)
    got = sweep.scatter_top_fused_kernel(*args)
    plain = sweep.scatter_top_fused_plain(*args)
    torch.cuda.synchronize()
    max_err = 0.0
    for name, g, p, w in zip(("heights", "count", "intensity"), got, plain,
                             want):
        if not (torch.equal(g, p) and torch.equal(g.cpu(), w)):
            raise AssertionError(f"sweep kernel {name} differs from its "
                                 f"plain version")
        max_err = max(max_err, (g - p).abs().max().item())
    log(f"phase kernel-vs-plain: B=2 N={n_pts} heights/count/intensity "
        f"bit-equal to the plain version on the card and on the CPU "
        f"(occupied cells {int((want[1] > 0).sum())})")
    kernel_ms = cuda_ms(lambda: sweep.scatter_top_fused_kernel(*args))
    plain_ms = cuda_ms(lambda: sweep.scatter_top_fused_plain(*args))

    # -- 4. serve three requests through the main path -------------------
    model = MV3D(cfg, device=dev, seed=0)
    requests = [(make_cloud(rng, 2, n_pts, cfg, tricky=False),
                 np.full(2, n_pts, np.int32),
                 rng.rand(2, *cfg.rgb_shape).astype(np.float32))
                for _ in range(3)]
    sweep.scatter_top_fused_batched.launches = 0
    outs = [model.predict_from_points(p, n, r, THRESH)
            for p, n, r in requests]
    torch.cuda.synchronize()
    launches = sweep.scatter_top_fused_batched.launches
    if launches != len(requests):
        raise AssertionError(f"sweep kernel launched {launches} times for "
                             f"{len(requests)} requests")
    for dets in outs:
        if tuple(dets.boxes3d.shape) != (2, cfg.rpn.nms_post_topn, 8, 3):
            raise AssertionError(f"boxes3d shape {tuple(dets.boxes3d.shape)}")
        if not (torch.isfinite(dets.boxes3d).all()
                and torch.isfinite(dets.probs).all()):
            raise AssertionError("non-finite detections")
    log(f"phase serve: 3 requests of B=2 at full KITTI width, sweep kernel "
        f"launches {launches}, live detections "
        f"{[int(d.mask.sum()) for d in outs]}")

    pts0 = torch.from_numpy(requests[0][0][:1])
    top_c, occ_c = vox.lidar_to_top_batch(pts0, cfg, return_occ=True)
    top_g, occ_g = vox.lidar_to_top_batch(pts0.to(dev), cfg, return_occ=True)
    if not (torch.equal(top_g[..., :zn + 1].cpu(), top_c[..., :zn + 1])
            and torch.equal(occ_g.cpu(), occ_c)):
        raise AssertionError("top view/occupancy on the card differ from "
                             "the CPU plain path")
    dens_err = (top_g[..., zn + 1].cpu() - top_c[..., zn + 1]).abs().max()
    if dens_err > 1e-6:
        raise AssertionError(f"density differs by {dens_err.item()}")
    log(f"phase top-view: card == CPU for one frame (heights, intensity, "
        f"occupancy bit-equal; density max |diff| {dens_err.item():.3g})")

    small_reference(rng, dev)

    # -- 5. timings --------------------------------------------------------
    times = {}
    for b in (1, 8):
        f, v, r = sweep_inputs(b, dev)
        times[b] = (cuda_ms(lambda: sweep.scatter_top_fused_kernel(
                        f, v, r, n_cells, zn)),
                    cuda_ms(lambda: sweep.scatter_top_fused_plain(
                        f, v, r, n_cells, zn)))
        log(f"phase timing: sweep B={b}: kernel {times[b][0] * 1e3:.1f} us, "
            f"plain {times[b][1] * 1e3:.1f} us [{card}]")
    for b in (1, 8):
        batches = [(torch.from_numpy(make_cloud(rng, b, n_pts, cfg, False)
                                     ).to(dev),
                    torch.full((b,), n_pts, dtype=torch.int32, device=dev),
                    torch.rand(b, *cfg.rgb_shape, device=dev))
                   for _ in range(4)]
        serve_window(model, batches, SERVE_WARMUP_S)
        fps, medians = [], []
        for w in range(3):
            lat = np.array(serve_window(model, batches, SERVE_WINDOW_S))
            fps.append(b * len(lat) / lat.sum())
            log(f"phase timing: serving B={b} window {w + 1}/3: "
                f"{len(lat)} requests in {lat.sum():.2f} s, "
                f"{fps[-1]:.2f} frames/s, latency median "
                f"{np.median(lat) * 1e3:.2f} ms, p90 "
                f"{np.percentile(lat, 90) * 1e3:.2f} ms [{card}]")
            medians.append(np.median(lat))
        log(f"phase timing: serving B={b}: {np.median(fps):.2f} frames/s, "
            f"median of 3 windows (range {min(fps):.2f}-{max(fps):.2f}) "
            f"[{card}]")
        if opts.profile:
            profile_serving(model, batches, b, float(np.median(medians)),
                            opts.profile, card)

    log(json.dumps({"kernels": [{
        "name": "voxelize_sweep", "route": "cuda",
        "source": "mv3d_tpu_torch/csrc/voxelize_sweep.cu",
        "replaces": "mv3d_tpu/ops/voxelize_pallas.py:220",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
