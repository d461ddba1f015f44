"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Drives ``mv3d_tpu_torch`` — never jax — through its five paths at full
KITTI width (top view 800x600x27, rgb 375x1242, 65,536 points per frame,
30,000 anchors), then the didi presets and the model options, int8
serving and data parallelism, with random weights from a seed, and holds
each of their hand-written kernels against its plain PyTorch version:

  * serving, hwc: ``MV3D.predict_from_points`` (lidar -> 3D boxes, 30
    proposals per frame) in the standard view layout, through the fused
    voxelizer sweep kernel (``voxelize_sweep``, K1: points binned by
    output tile, tiles swept in shared memory by persistent blocks and
    stored by asynchronous bulk copies);
  * serving, s2d2p: the same entry point in the JAX package's own serving
    configuration (``bench.py``: lane-padded folded view ``s2d2p`` in
    bf16, split conv stem, matmul ROI-align;
    ``mv3d_tpu_torch.serving_config``),
    through the lane-padded sweep kernel (``voxelize_padded``, K2: points
    binned by output tile, each tile swept in shared memory);
  * training: the staged ``Trainer`` (bf16 compute, f32 master weights)
    fed by the port's ``BatchLoader``, whose prefetch thread computes the
    BEV intensity/density plane on the host, so the card voxelizes only
    the heights, through the heights scatter-max kernel
    (``voxelize_heights``, K3);
  * serving over HTTP: an artifact of the hwc configuration at
    ``pipeline.voxel_order="pallas-sort"`` written by
    ``python -m mv3d_tpu_torch.cli.export`` and answered by
    ``mv3d_tpu_torch.cli.serve.make_server``; each request sorts its
    points with the stable sort kernel (``sort_radix``, K4: a radix sort,
    one thread-block cluster per frame, one launch) ahead of K1; the same
    configuration in process on uncropped sweeps of 131,072 points, longer
    than a cluster holds, sorts them as blocks of 65,536 in one radix
    launch and merges the runs stably (``sort_merge``, one launch per
    doubling), which the sort's wrapper picks by row length;
  * the training command from disk: ``mv3d_tpu_torch.cli.train`` over a
    KITTI object directory written by this script (8 frames of ~110,000
    raw points, PNGs at the four KITTI image sizes, decoded by the port's
    PNG reader and resized by its port of PIL's bilinear resample), B=2,
    4 ordered loader workers, with the validation interleave and its 3D
    IoU, the metrics JSONL, the dashboard and checkpoints: in the served
    s2d2p configuration without the host aux plane (K2 on every
    training step, eval step and validation prediction) and in hwc with
    the host aux plane (K3 on every training and eval step, K1 on every
    validation prediction);
  * the evaluation commands over that directory and the checkpoints the
    training command wrote: ``mv3d_tpu_torch.cli.test`` (every
    subcommand; K1 per frame in hwc, K2 in s2d2p), ``cli.preprocess``
    (K1 per batch), ``cli.tracking --eval`` over a raw drive (K1 per
    frame), ``cli.dashboard`` and ``cli.rehearsal --synthetic-fixture``
    (K3 per training step, K1 per prediction).

Phases:

  1. require CUDA; print the card's name and power limit;
  2. build the five kernels from this checkout's sources (one nvcc each,
     in parallel); print ptxas's registers, spills and shared memory of
     the K1, K2, K4 and merge kernels, K1's tile plan and how many radix
     clusters the card holds at once (cudaOccupancyMaxActiveClusters);
  3. hold each kernel against its plain version at its path's shapes (B=2,
     65,536 points per frame, K1 and K2 with f32 and bf16 heights):
     bit-equal on the card and against the CPU; K1 and K2 also on skewed
     clouds (all points in one tile, all in one cell, in the last partial
     tile, padding or pad lanes) at the KITTI width and at a small grid;
     K4 also against ``torch.sort(stable=True)`` + gathers, at n = 256,
     2,048, 8,192, 65,536 (radix) and 131,072 and 262,144 (radix blocks +
     1 or 2 merge passes) on keys that need 0 to 4 digit passes and ties
     across runs, one merge pass alone against its plain twin, and K1 on
     K4's output against K1 on the unsorted points (at 65,536 and 131,072
     points); then, on the card, the s2d2p pair and the s2d2 view
     equal the folded hwc view bit for bit (K2 against K1) and their
     unfolded occupancy the hwc occupancy; the front view
     (``use_front=True``, B=2 full-width clouds) on the card against the
     CPU, every point's pixel equal and the values within atol 5e-5;
  4. serve three requests (B=2, distinct clouds) in each in-process
     serving configuration and check that its kernel ran once per request
     and the other kernels not at all, the outputs' shape and finiteness,
     the card's top view and occupancy against the CPU's, and a small f32
     model on the card against the CPU; then export the pallas-sort
     artifact (B=2) and serve it over HTTP: /healthz, a single-frame, a
     two-frame and a JSON request and a malformed body (400); K4 and K1
     ran once per request; the answers are bit-equal to in-process
     ``ServingModel.predict_batch`` and to the same weights at
     ``voxel_order="sort"``; a quantized artifact answers one request as
     its in-process call does; two in-process requests of 131,072 points
     per frame at "pallas-sort" run the radix kernel, one merge pass and
     K1 once each;
  5. train at B=2 from an in-memory synthetic drive (raw-size clouds with
     3-8 planted gt cars per frame): 5 steps of ``top_view_rpn``, then 5
     of all subnets; check finite losses, one heights-kernel launch per
     step, frozen subnets bit-unchanged and trained ones moved in stage 1,
     BatchNorm statistics moved in every subnet that ran, and that a
     checkpoint loaded into a fresh ``MV3D`` gives bit-equal detections;
     then one small f32 training step on the card against the CPU, in
     hwc with the host aux plane and in the served s2d2p configuration
     (the split stem's backward);
  6. the training command: write the KITTI directory (ImageSets train 6 /
     val 2) and check that its PNGs decode to the arrays written and
     that the PNG helper (Average and Paeth rows in C) equals its numpy
     twin on every filter type; run ``cli.train.main`` in process in the
     served s2d2p configuration (12 iterations, a validation every 4,
     checkpoints every 5), resume it with ``-c`` (3 more: the step count
     continues), run it in hwc with the host aux plane (6 iterations)
     and again as ``python -m mv3d_tpu_torch.cli.train``; each run's
     kernel launches are counted (counts set to 0 just before, read just
     after) and held to the layout's rules, its losses finite, its
     validation rows carry ``iou`` in log.txt and the metrics JSONL, the
     dashboard and a checkpoint of every subnet exist;
  7. the evaluation commands (``eval-cmd``) over phase 6's directory and
     checkpoints, each in process with the kernel counts set to 0 just
     before and held to its frames just after, its wall time and frames/s
     printed: ``cli.test`` test_mv3d over the 8 frames, then in f32 on
     2 frames against the same command with ``--device cpu`` (equal
     detection counts, probs within 1e-3 and boxes3d within 1e-2 m, the
     serving phase's tolerance when an rgb ROI corner moves), export_kitti
     (lines parse back to the detections), test_single_mv3d, test_rpn,
     test_3dop, test_rpn_target, test_front and probe_rpn in hwc, and
     test_mv3d + export_kitti in s2d2p; ``cli.preprocess`` on the card,
     its top views bit-equal to ``--device cpu``'s; a raw drive (4
     frames, ``tracklet_labels.xml``) through ``cli.tracking --eval``;
     ``cli.dashboard``; ``cli.rehearsal --synthetic-fixture -i 2`` at
     full width; every output file is read back;
  8. ``options``: the didi presets and the model options at full width
     (``options_phase``), each path with the kernel counts set to 0 just
     before and read just after. didi (450 x 100 x 14, rgb 596 x 1368
     cropped from 1096 x 1368, 2,964 anchors) and didi2 (500 x 300 x 15,
     9,576 anchors): every kernel bit-equal to its plain version at the
     preset's grid on clouds holding the capture car's returns and
     filling the top slice (height values above 1), on the skewed cases
     and with K1 after K4 against K1 alone; 3 requests of B=2 in hwc (K1
     once each), in s2d2p (K2) and at "pallas-sort" (K4 and K1); 3
     training steps at B=2 with the host aux plane from a drive holding
     the capture car's returns (K3 once each; the loader crops them); for
     didi a small f32 model on the card against the CPU (the serving
     phase's tolerances, the moved rgb ROI corners counted) and
     ``cli.tracking --dataset didi --eval`` over a 4-frame drive in the
     bag converter's layout (K1 once a frame), its XML and CSVs read
     back. Each model option of ``OPTION_MODELS`` at KITTI width (the
     reference graph's deconvs with the 7x7/2 stem, with the VGG rgb
     trunk too, basic blocks, siamese, handcraft and learnable fusion): 2
     requests of B=2 (K1 once each), 1 training step at B=2 in hwc with
     the host aux plane (K3 once, finite losses) and a small f32 model on
     the card against the CPU; each configuration's wall ms per request
     and per step and its peak allocated memory printed;
  9. ``int8``: ``model.quant="int8"`` at full KITTI width
     (``int8_phase``): every distinct int8 product of the model
     (``torch._int_mm`` through ``ops.quantized.int_mm``'s padding) equal
     to the CPU's int32 sums; 3 requests of B=2 in hwc (K1 once each), in
     s2d2p (K2) and at "pallas-sort" (K4 and K1), with wall ms, peak
     memory and the share of the same configuration's bf16 detections
     the int8 model also finds; an int8 artifact exported by
     ``cli.export --set model.quant int8`` answering a two-frame request
     over HTTP (K4 and K1 once) bit-equal to in-process ``predict_batch``;
     a small f32 int8 model on the card against the CPU with the CPU's
     int8 activations replayed (``Int8Replay``);
  10. ``parallel``: ``mv3d_tpu_torch.parallel.mesh`` (``parallel_phase``).
     A one-rank NCCL group on the card: the small f32 model's sharded
     step (RPN stage, host plane, K3 once) against
     ``Trainer.fit_iteration`` on the same batch and draws
     (``compare_steps``), a ``"dcp"`` checkpoint round trip, sharded
     steps at full width in hwc (2, K3 once each) and s2d2p (1, K2 once)
     with wall ms and peak memory, sharded inference of 3 requests of
     B=2 in hwc (K1), at "pallas-sort" (K4 and K1) and int8 (K1), each
     bit-equal to ``predict_from_points``; then two spawned processes
     sharing the card over gloo, whose sharded step at 2 x 1 frames is
     held against the one-rank ``Trainer`` step at B=2 (a second NCCL
     rank needs a second card);
  11. time each kernel against its plain version and the one PyTorch call
     that computes the same function, where there is one (CUDA events, the
     wrapper included), at B=1, 2 and 8, beside the kernel's device time
     alone (CUDA events over calls enqueued behind a spin kernel, so they
     run back to back without the host); K1 (f32 and bf16 heights) and
     K4 on rows of 131,072 at B=1, 2 and 8 also by kernel (a
     torch.profiler trace) and on the host per call
     (``time.perf_counter`` over 200 calls without a synchronize), and
     where the host's time of a K1 call goes at B=1;
     each in-process serving configuration (hwc, hwc int8, s2d2p) at
     B=1 and B=8
     (closed loop, three windows of SERVE_WINDOW_S seconds after a warm-up
     window of SERVE_WARMUP_S seconds: per window frames/s and the median
     and p90 latency, then the median and range over the windows); a B=1
     artifact over HTTP (the same windows, request latency at the client;
     a /healthz round trip, the parse of one body and in-process
     ``ServingModel.predict`` on numpy to split it) beside in-process
     ``predict_from_points`` at "pallas-sort" and at "sort"; the training
     step at B=2 (three windows of TRAIN_WINDOW_STEPS steps after
     TRAIN_WARMUP_STEPS: ms/step and frames/s, median and range) with its
     peak allocated memory; the s2d2p and hwc training steps at B=2 fed
     by the disk loader (4 workers) and by batches held in memory; the
     disk loader alone at 1, 2 and 4 workers and one thread's time per
     frame by stage (velodyne, label, PNG decode, resize, crop and pad,
     aux plane);
  12. only with ``--profile DIR``: torch.profiler over a few requests of
     each serving configuration at B=1 and B=8 and a few training steps
     (the in-memory hwc step, the disk-fed s2d2p and hwc steps, the
     one-rank sharded hwc step):
     the card's busy time per request or step (union of kernel
     intervals), its idle share against the median wall time, peak
     allocated memory and the ops with the most device time; the
     profiler's tables go to DIR.

Any failure raises, so the exit code is non-zero and no result line is
printed. The line before the last is the kernels' JSON record (each
kernel's launches summed over the paths counted: K1 serving, hwc
validation predictions, the evaluation commands, the options phase and
the int8 and parallel phases' requests, K2 serving, the s2d2p command,
the s2d2p test commands, the didi s2d2p requests, the int8 s2d2p
requests and the sharded s2d2p step, K3 the training phase, the hwc
command, the rehearsal, the options phase's steps and the one-rank
sharded steps, K4 the HTTP requests, the didi and int8 "pallas-sort"
requests and the sharded "pallas-sort" inference); the last is
``{"ok": true,
"device": {...}}``. Checkpoints, serving artifacts, logs and the KITTI
directory go to ``checkpoint/chip_smoke`` and ``log/chip_smoke`` in the
checkout and are removed. Run from the repository root:

    python3 chip_smoke.py [--profile DIR]

``make_cloud``, ``SynthDrive``, ``small_reference``,
``small_train_reference``, ``sort_cases``, ``merge_passes``,
``check_sort``, ``check_sort_then_sweep``, ``sweep_cases``,
``check_sweep``, ``check_sweep_cases``, ``padded_cases``,
``check_padded_cases``, ``write_kitti_dir``, ``SERVED_FLAGS``,
``check_command_outputs`` and ``_metric_rows`` are shared with the port's
tests.
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

# bench.py's score threshold: random weights give fg probs near 0.5, so
# the default 0.75 would leave NMS nothing to keep
THRESH = 0.05
# seconds per serving window, three windows per batch size, after a
# warm-up window
SERVE_WINDOW_S = 3.0
SERVE_WARMUP_S = 2.0
# training steps per timing window, three windows, after the warm-up steps
TRAIN_WINDOW_STEPS = 5
TRAIN_WARMUP_STEPS = 3
# the H100 SXM's HBM rate (NVIDIA's data sheet), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
ROOT = os.path.dirname(os.path.abspath(__file__))


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


def car_corners(center, size, yaw):
    """(8, 3) corners of an upright box, in the JAX package's
    ``box3d_compose`` order: ``center`` is the bottom-face center,
    ``size`` (h, w, l)."""
    import numpy as np
    h, w, l = size
    xs = np.array([-l, -l, l, l, -l, -l, l, l]) / 2
    ys = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
    zs = np.array([0, 0, 0, 0, h, h, h, h], dtype=np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([c * xs - s * ys, s * xs + c * ys, zs], -1) + center


class SynthDrive:
    """An in-memory synthetic drive for the port's ``BatchLoader``:
    raw-size clouds drawn as bench.py draws them (``n_raw`` points
    uniform in the crop box widened by 10 m in x and y and by 0.3-0.4 m in
    z), uint8 rgb at the camera's size (``cfg.image_height`` x
    ``image_width``, which the loader crops to ``cfg.rgb_shape``), and per
    frame ``cars`` (lo, hi) gt
    cars (label 1) with 300 points planted inside each, so the RPN and
    fusion targets have positives. With ``ego`` each frame also holds
    ``ego`` returns of the capture car itself, inside the 4.7 x 2.1 m box
    around the origin that the didi presets' center-car filter crops."""

    def __init__(self, rng, cfg, n_frames: int, n_raw: int,
                 cars=(3, 8), ego: int = 0):
        import numpy as np
        from mv3d_tpu_torch.data.loader import Frame
        t = cfg.top
        # the camera's raw image: the loader crops it to cfg.rgb_shape
        h, w = cfg.image_height, cfg.image_width
        self.frames = []
        for i in range(n_frames):
            cloud = np.stack([
                rng.uniform(t.x_min - 10, t.x_max + 10, n_raw),
                rng.uniform(t.y_min - 10, t.y_max + 10, n_raw),
                rng.uniform(t.z_min - 0.3, t.z_max + 0.4, n_raw),
                rng.uniform(0, 1, n_raw)], 1)
            boxes, planted = [], []
            for _ in range(rng.randint(cars[0], cars[1] + 1)):
                size = (rng.uniform(1.4, 1.7), rng.uniform(1.5, 1.8),
                        rng.uniform(3.5, 4.5))
                center = (rng.uniform(t.x_min + 3, t.x_max - 3),
                          rng.uniform(t.y_min + 3, t.y_max - 3), -1.7)
                yaw = rng.uniform(-np.pi, np.pi)
                boxes.append(car_corners(np.array(center), size, yaw))
                local = rng.uniform(-0.5, 0.5, (300, 3)) * np.array(
                    [size[2], size[1], size[0]]) + [0, 0, size[0] / 2]
                c, s = np.cos(yaw), np.sin(yaw)
                xy = np.stack([c * local[:, 0] - s * local[:, 1],
                               s * local[:, 0] + c * local[:, 1]], 1)
                planted.append(np.concatenate([
                    xy + center[:2], local[:, 2:] + center[2],
                    rng.uniform(0, 1, (300, 1))], 1))
            if ego:
                planted.append(np.stack([rng.uniform(-2.3, 2.3, ego),
                                         rng.uniform(-1.0, 1.0, ego),
                                         rng.uniform(-1.5, 0.0, ego),
                                         rng.uniform(0.5, 1.0, ego)], 1))
            points = np.concatenate([np.concatenate(planted), cloud])
            self.frames.append(Frame(
                tag=f"{i:05d}", points=points.astype(np.float32),
                rgb=(rng.rand(h, w, 3) * 255).astype(np.uint8),
                gt_boxes3d=np.stack(boxes).astype(np.float32),
                gt_labels=np.ones(len(boxes), np.int32)))

    def __len__(self):
        return len(self.frames)

    def load_frame(self, i):
        return self.frames[i]


# the image sizes KITTI object frames come at (height, width)
KITTI_IMAGE_SIZES = ((370, 1224), (374, 1238), (375, 1242), (376, 1241))


def write_kitti_dir(root, drive, cfg, n_train, image_sizes=KITTI_IMAGE_SIZES,
                    rng=None):
    """Write ``drive``'s frames (a :class:`SynthDrive`) as a KITTI object
    directory: ``training/velodyne/*.bin``, ``training/label_2/*.txt`` (the
    gt cars in camera coordinates, made with the port's
    ``boxes3d_decompose`` and ``lidar_to_camera_points``),
    ``training/image_2/*.png`` (written by the port's encoder at the
    frames' ``image_sizes`` in turn, a smooth image with noise, the rows'
    filters cycling through all five types) and ``ImageSets/train.txt``
    (the first ``n_train`` tags) and ``val.txt`` (the rest). Returns
    {tag: the uint8 image written}."""
    import numpy as np
    import torch
    from mv3d_tpu_torch.ops.boxes3d import (boxes3d_decompose,
                                            lidar_to_camera_points)
    from mv3d_tpu_torch.utils.png import write_png
    rng = rng or np.random.RandomState(0)
    base = os.path.join(root, "training")
    for sub in ("velodyne", "label_2", "image_2"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    images, tags = {}, []
    for i, f in enumerate(drive.frames):
        tag = f"{i:06d}"
        tags.append(tag)
        f.points.astype(np.float32).tofile(
            os.path.join(base, "velodyne", tag + ".bin"))
        t, size, rot = (x.numpy() for x in boxes3d_decompose(
            torch.from_numpy(f.gt_boxes3d)))
        cam = lidar_to_camera_points(torch.from_numpy(t), cfg).numpy()
        with open(os.path.join(base, "label_2", tag + ".txt"), "w") as out:
            for c, (h, w, l), yaw in zip(cam, size, rot[:, 2]):
                ry = -yaw - np.pi / 2
                out.write(f"Car 0.00 0 0.00 0.00 0.00 50.00 50.00 {h:.6f} "
                          f"{w:.6f} {l:.6f} {c[0]:.6f} {c[1]:.6f} "
                          f"{c[2]:.6f} {ry:.6f}\n")
            out.write("DontCare -1 -1 -10 0 0 10 10 -1 -1 -1 -1000 -1000 "
                      "-1000 -10\n")
        h, w = image_sizes[i % len(image_sizes)]
        yy, xx = np.mgrid[:h, :w]
        smooth = (np.sin(xx / (40.0 + 7 * i))[..., None] * [60, 40, 20]
                  + np.cos(yy / (25.0 + 3 * i))[..., None] * [30, 50, 70])
        img = np.clip(smooth + 120 + rng.randint(0, 16, (h, w, 3)), 0, 255
                      ).astype(np.uint8)
        write_png(os.path.join(base, "image_2", tag + ".png"), img,
                  filters=np.arange(h) % 5)
        images[tag] = img
    for name, part in (("train", tags[:n_train]), ("val", tags[n_train:])):
        with open(os.path.join(root, "ImageSets", name + ".txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    return images


def closed_loop(call, seconds: float):
    """Closed-loop serving for ``seconds``: ``call(i)`` for request i, one
    at a time, each waited for (the card synchronized). Returns the
    requests' latencies in seconds."""
    import torch
    lat = []
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        t0 = time.perf_counter()
        call(len(lat))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return lat


def timed_windows(call, label: str, b: int, card: str) -> float:
    """A warm-up window of SERVE_WARMUP_S seconds, then three closed-loop
    windows of SERVE_WINDOW_S seconds of ``call``: per window frames/s and
    the median and p90 latency, then their medians and ranges. Returns
    the median of the windows' median latencies (s)."""
    import numpy as np
    closed_loop(call, SERVE_WARMUP_S)
    fps, medians, p90s = [], [], []
    for w in range(3):
        lat = np.array(closed_loop(call, SERVE_WINDOW_S))
        fps.append(b * len(lat) / lat.sum())
        medians.append(float(np.median(lat)))
        p90s.append(float(np.percentile(lat, 90)))
        log(f"phase timing: serving {label} B={b} window {w + 1}/3: "
            f"{len(lat)} requests in {lat.sum():.2f} s, "
            f"{fps[-1]:.2f} frames/s, latency median "
            f"{medians[-1] * 1e3:.2f} ms, p90 {p90s[-1] * 1e3:.2f} ms "
            f"[{card}]")
    log(f"phase timing: serving {label} B={b}: {np.median(fps):.2f} "
        f"frames/s, median of 3 windows (range {min(fps):.2f}-"
        f"{max(fps):.2f}); latency median {np.median(medians) * 1e3:.2f} "
        f"ms (range {min(medians) * 1e3:.2f}-{max(medians) * 1e3:.2f}), "
        f"p90 {np.median(p90s) * 1e3:.2f} ms (range "
        f"{min(p90s) * 1e3:.2f}-{max(p90s) * 1e3:.2f}) [{card}]")
    return float(np.median(medians))


def profile_calls(call, n: int, label: str, median_s: float, out_dir: str,
                  card: str):
    """torch.profiler over ``n`` calls of ``call``: the card's busy time
    per call (union of kernel intervals), its idle share against the
    median wall time ``median_s``, peak allocated memory and the aten ops
    with the most device time; the table goes to ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_mib = torch.cuda.memory_allocated() / 2 ** 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            call(i)
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
    path = os.path.join(out_dir, f"profile_{label.replace(' ', '_')}.txt")
    with open(path, "w") as f:
        f.write(f"{card}\n{label}, {n} calls\n")
        f.write(avgs.table(sort_by=key, row_limit=60))
    log(f"phase profile: {label}: device busy {busy_ms:.2f} ms/call, idle "
        f"share {1 - busy_ms / (median_s * 1e3):.2f} of the median wall "
        f"time {median_s * 1e3:.2f} ms, peak allocated {peak_mib:.0f} MiB "
        f"above the {held_mib:.0f} MiB held before the calls"
        f"; self device time of aten ops: " + ", ".join(
            f"{a.key} {getattr(a, key) / total:.0%}" for a in ops[:8])
        + f" [{card}] (table: {path})")
    return busy_ms


class Int8Replay:
    """Records the int8 activations and scales of every activation
    quantization of one run (``record``), then feeds them, in order, to
    the layers of another run (``replay``, on any device) in place of its
    own, counting the elements where that run's own quantization of its
    float input differs (at most one level each). The card's float convs
    differ from the CPU's in the last bits, which moves an element on a
    rounding boundary by a level, and unchecked the moves compound with
    depth (tests/test_torch_quantized.py)."""

    def __init__(self):
        self.records, self.moved, self.total = [], 0, 0

    def _swap(self, fn):
        import contextlib
        from mv3d_tpu_torch.ops import quantized as tq

        @contextlib.contextmanager
        def ctx():
            real = tq.quantize_activation
            tq.quantize_activation = lambda x, group=None: fn(real, x, group)
            try:
                yield
            finally:
                tq.quantize_activation = real
        return ctx()

    def record(self):
        def fn(real, x, group):
            q, s = real(x, group)
            self.records.append((q.cpu(), s.cpu()))
            return q, s
        return self._swap(fn)

    def replay(self):
        it = iter(list(self.records))

        def fn(real, x, group):
            own, _ = real(x, group)
            q, s = (t.to(x.device) for t in next(it))
            d = (own.int() - q.int()).abs()
            if int(d.max()) > 1:
                raise AssertionError("an int8 activation moved by more "
                                     "than one level")
            self.moved += int((d > 0).sum())
            self.total += d.numel()
            return q, s
        return self._swap(fn)


def small_reference(rng, dev, serving: bool = False, small=None,
                    label: str = ""):
    """A small f32 model from one seed, run on the card and on the CPU:
    RPN outputs, proposals and detections must agree. With ``serving``
    the model runs in ``mv3d_tpu_torch.serving_config`` (s2d2p pair in
    bf16, split stem, matmul ROI-align; compute stays f32). ``small``
    replaces the small KITTI config (a didi preset, a model option, the
    int8 model; ``label`` names it). An int8 model's card run takes the
    CPU run's int8 activations (``Int8Replay``): at most 1e-3 of its own
    may differ, by one level.

    Tolerances: proposal and detection masks exact; RPN scores/deltas atol
    1e-4 and proposal rois atol 1e-3 (cuDNN and the CPU sum convs in
    different orders); fused probs atol 1e-4 and boxes3d atol 1e-3 m. An
    rgb ROI corner is an int32 truncation of the projected proposal, so a
    last-bit difference in the proposal can move it by a pixel, which
    changes that ROI's pooled rgb features: when any corner moved (they
    are counted and printed), probs are held to 1e-3 and boxes3d to 1e-2 m
    (measured on an H100 with 2 moved corners: 2.1e-4 and 2.9e-3 m)."""
    import contextlib
    import numpy as np
    import torch
    from mv3d_tpu_torch import serving_config
    from mv3d_tpu_torch.models.mv3d_net import project_to_rgb_roi
    from mv3d_tpu_torch.ops.boxes3d import top_box_to_box3d
    from mv3d_tpu_torch.ops.voxelize import lidar_to_top_batch
    from mv3d_tpu_torch.train.trainer import MV3D

    if small is None:
        small = _small_config()
    if serving:
        small = serving_config(small)
    pts = make_cloud(rng, 2, 2048, small, tricky=False)
    rgb = rng.rand(2, *small.rgb_shape).astype(np.float32)
    res = []
    int8 = Int8Replay() if small.model.quant == "int8" else None
    for d in (torch.device("cpu"), dev):
        net = MV3D(small, device=d, seed=1).model
        ctx = (contextlib.nullcontext() if int8 is None
               else int8.record() if d.type == "cpu" else int8.replay())
        with torch.inference_mode(), ctx:
            top, occ = lidar_to_top_batch(torch.from_numpy(pts).to(d), small,
                                          return_occ=True)
            rpn = net.top_rpn(top)
            dets, props = net.forward_inference(
                top, torch.from_numpy(rgb).to(d), None, THRESH, top_occ=occ)
            rgb_rois = project_to_rgb_roi(
                top_box_to_box3d(props.rois[..., 1:5], small), small)
        res.append([x.cpu() for x in (
            rpn["scores"], rpn["deltas"], props.mask, props.rois, rgb_rois,
            dets.mask, dets.probs, dets.boxes3d)])
    (s0, d0, pm0, r0, g0, m0, p0, b0), (s1, d1, pm1, r1, g1, m1, p1, b1) = res

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
    log(f"phase reference: small f32 model {label}"
        f"({small.pipeline.view_layout}, {small.model.roi_align_impl} "
        f"ROI-align), card vs CPU: same "
        f"{int(pm0.sum())} proposals and {int(m0.sum())} live detections; "
        + ", ".join(f"{k} max|diff| {e:.3g} (tol {t:g})"
                    for k, (e, t) in checks.items())
        + f"; rgb ROI corners moved by a pixel: {moved}"
        + ("" if int8 is None else
           f"; int8 activations (the CPU's replayed): {int8.moved} of "
           f"{int8.total} off by one level on the card"))
    if int8 is not None and not int8.moved <= 1e-3 * int8.total:
        raise AssertionError(f"int8: {int8.moved} of {int8.total} "
                             f"activations moved")
    for name, (e, tol) in checks.items():
        if not e <= tol:
            raise AssertionError(f"small f32 model: {name} differ by {e} "
                                 f"(> {tol}) between the card and the CPU")


def _small_config():
    """A small f32 KITTI config (16 m x 12 m at 0.2 m, 96x64 rgb) for the
    card-against-CPU references."""
    from mv3d_tpu_torch import kitti_config
    cfg = kitti_config()
    return dataclasses.replace(
        cfg, top=dataclasses.replace(cfg.top, x_max=16.0, y_min=-6.0,
                                     y_max=6.0, x_div=0.2, y_div=0.2),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        pipeline=dataclasses.replace(cfg.pipeline, max_points=4096),
        image_width=96, image_height=64)


def train_step_pair(rng, devices, work_dir, threads=(None, None),
                    serving: bool = False):
    """One f32 training step of the RPN stage on the small config, with
    the same weights, batch (a 2-frame synthetic drive from ``rng``) and
    draws on each of ``devices`` (CPU runs with ``threads`` CPU threads
    where given). With ``serving`` the config is the served one
    (``serving_config``: the s2d2p pair, bf16 view, split stem, matmul
    ROI-align) without the host aux plane; compute stays f32. Returns one
    dict per device: losses, target masks, the fusion targets' rgb ROI
    corners, and top_view_rpn's gradients and updated parameters, all on
    the CPU."""
    import torch
    from mv3d_tpu_torch import serving_config
    from mv3d_tpu_torch.data.loader import frames_to_batch
    from mv3d_tpu_torch.models.mv3d_net import project_to_rgb_roi
    from mv3d_tpu_torch.train.trainer import Trainer

    cfg = _small_config()
    if serving:
        cfg = serving_config(cfg)
        cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, host_aux_channels=False))
    drive = SynthDrive(rng, cfg, 2, 8000, cars=(2, 3))
    batch = frames_to_batch(drive.frames, cfg)
    runs = []
    n_threads = torch.get_num_threads()
    for d, nt in zip(devices, threads):
        torch.set_num_threads(nt or n_threads)
        tr = Trainer(None, train_targets=("top_view_rpn",), cfg=cfg,
                     device=d, seed=1, checkpoint_dir=work_dir,
                     log_dir=work_dir)
        losses = tr.fit_iteration(batch)
        rpn_tg, fus_tg = tr.last_targets
        named = list(tr.model.top_rpn.named_parameters())
        runs.append(dict(
            losses=losses,
            masks=[x.cpu() for x in (rpn_tg.cls_mask, rpn_tg.labels,
                                     rpn_tg.pos_mask, fus_tg.mask,
                                     fus_tg.labels, fus_tg.pos_mask)],
            rgb=project_to_rgb_roi(fus_tg.rois3d.detach(), cfg).cpu(),
            grads={n: q.grad.cpu() for n, q in named},
            params={n: q.detach().cpu() for n, q in named}))
    torch.set_num_threads(n_threads)
    return runs


def small_train_reference(rng, dev, work_dir, serving: bool = False):
    """One f32 training step of the RPN stage (the loader's host aux
    plane, heights on the device; with ``serving`` the served s2d2p
    configuration, every channel on the device, through the split stem's
    backward) with the same weights, batch and draws on the card and on
    the CPU: losses, target masks, gradients and the updated parameters
    must agree.

    Tolerances (those of tests/test_torch_train.py): target masks exact;
    RPN losses rtol 1e-4; gradients within 1e-3 of each tensor's max |g|;
    the updated parameters within rtol 2.4e-7 + atol 1e-8 where |g| is
    above 1e-3 of the tensor's max (there the step's sign is certain).
    The fusion losses are held to rtol 1e-4, or 1e-2 when an rgb ROI
    corner moved by a pixel (counted and printed; see small_reference).

    The gradients depend on the draw: through the fusion loss, moved rgb
    corners and ReLU kinks move the trunk's gradients by more than 1e-3
    of their max on some draws, on the card and between two CPU thread
    counts alike (``tools/torch_train_reference_draws.py``). So ``main``
    and the card test pass a ``RandomState(2)`` of their own, not a
    generator that earlier phases have advanced."""
    import torch
    c, g = train_step_pair(rng, (torch.device("cpu"), dev), work_dir,
                           serving=serving)
    for a, b in zip(c["masks"], g["masks"]):
        if not torch.equal(a, b):
            raise AssertionError("small training step: target masks differ "
                                 "between the card and the CPU")
    if not c["masks"][2].any() or not c["masks"][5].any():
        raise AssertionError("small training step: no positive target")
    moved = int((c["rgb"] != g["rgb"]).sum())
    fuse_tol = 1e-4 if moved == 0 else 1e-2
    errs = {k: abs(g["losses"][k] - v) / abs(v)
            for k, v in c["losses"].items()}
    for k, e in errs.items():
        tol = 1e-4 if k.startswith("top") else fuse_tol
        if not e <= tol:
            raise AssertionError(f"small training step: {k} differs by "
                                 f"rel {e} (> {tol})")
    g_err = p_err = 0.0
    n_cmp = 0
    for n, gc in c["grads"].items():
        mx = gc.abs().max().item()
        e = (g["grads"][n] - gc).abs().max().item()
        if not e <= 1e-3 * mx:
            raise AssertionError(f"small training step: gradient of {n} "
                                 f"differs by {e} (> 1e-3 * {mx})")
        g_err = max(g_err, e / mx if mx else 0.0)
        sure = gc.abs() > 1e-3 * mx
        pc, pg = c["params"][n][sure], g["params"][n][sure]
        if not torch.allclose(pg, pc, rtol=2.4e-7, atol=1e-8):
            raise AssertionError(f"small training step: updated {n} "
                                 f"differs between the card and the CPU")
        p_err = max(p_err, (pg - pc).abs().max().item() if sure.any()
                    else 0.0)
        n_cmp += int(sure.sum())
    log(f"phase train-reference: small f32 RPN-stage step "
        f"({'s2d2p, split stem' if serving else 'hwc, host aux plane'}), "
        f"card vs CPU: "
        f"same target masks ({int(c['masks'][2].sum())} positive anchors, "
        f"{int(c['masks'][5].sum())} positive rois); loss rel diffs "
        + ", ".join(f"{k} {e:.2g}" for k, e in errs.items())
        + f"; gradients max |diff| / max |g| {g_err:.2g} (tol 1e-3); "
        f"updated params max |diff| {p_err:.3g} over {n_cmp} entries "
        f"(tol rtol 2.4e-7 + atol 1e-8); rgb ROI corners moved: {moved}")


def _snapshot(module):
    return ([q.detach().clone() for q in module.parameters()],
            [b.detach().clone() for n, b in module.named_buffers()
             if n.endswith(("running_mean", "running_var"))])


def _same(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def train_phase(cfg, dev, rng, work_dir, card):
    """The training path at full width: stage 1 (``top_view_rpn``) and
    stage 2 (all subnets), 5 steps each through ``Trainer.__call__``, fed
    by a ``BatchLoader`` over a synthetic drive; then the checkpoint round
    trip. Returns (trainer, loader, heights launches) for the timings."""
    import numpy as np
    import torch
    from mv3d_tpu_torch.data.loader import BatchLoader
    from mv3d_tpu_torch.models.nets import SUBNET_NAMES
    from mv3d_tpu_torch.ops import voxelize_heights as vh
    from mv3d_tpu_torch.ops import voxelize_sweep as sweep
    from mv3d_tpu_torch.train.trainer import MV3D, Trainer

    t0 = time.time()
    drive = SynthDrive(rng, cfg, 8, 110000)
    loader = BatchLoader(drive, cfg, batch_size=2, seed=0)
    kw = dict(cfg=cfg, device=dev, checkpoint_dir=work_dir,
              log_dir=work_dir)
    tr1 = Trainer(loader, train_targets=("top_view_rpn",), seed=0, **kw)
    before = {n: _snapshot(m) for n, m in tr1.model.subnets.items()}
    log(f"phase train: synthetic drive of {len(drive)} frames and the "
        f"trainer ready in {time.time() - t0:.1f} s")

    vh.scatter_max_batched.launches = 0
    sweep.scatter_top_fused_batched.launches = 0
    t0 = time.time()
    last1 = tr1(max_iter=5)
    torch.cuda.synchronize()
    launches1 = vh.scatter_max_batched.launches
    after = {n: _snapshot(m) for n, m in tr1.model.subnets.items()}
    if launches1 != 5 or sweep.scatter_top_fused_batched.launches:
        raise AssertionError(f"stage 1: heights kernel launched "
                             f"{launches1} times in 5 steps (sweep "
                             f"{sweep.scatter_top_fused_batched.launches})")
    if not np.isfinite(list(last1.values())).all():
        raise AssertionError(f"stage 1: non-finite losses {last1}")
    for n in SUBNET_NAMES:
        params_same = _same(before[n][0], after[n][0])
        stats_same = _same(before[n][1], after[n][1])
        if (n == "top_view_rpn") == params_same:
            raise AssertionError(f"stage 1: {n} params "
                                 f"{'unchanged' if params_same else 'moved'}")
        if (n != "front_feature") == stats_same:
            raise AssertionError(f"stage 1: {n} BatchNorm statistics "
                                 f"{'unchanged' if stats_same else 'moved'}")
    log(f"phase train: stage 1 (top_view_rpn) 5 steps of B=2 in "
        f"{time.time() - t0:.1f} s, heights kernel launches {launches1}, "
        f"last losses " + ", ".join(f"{k} {v:.4f}" for k, v in last1.items())
        + "; frozen subnets' params bit-unchanged, top_view_rpn moved; "
        "BatchNorm statistics moved in top_view_rpn, image_feature and "
        "fusion (front_feature does not run)")

    tr2 = Trainer(loader, seed=0, variables=tr1.get_variables(),
                  log_tag="stage2", **kw)
    del tr1
    before = {n: _snapshot(m) for n, m in tr2.model.subnets.items()}
    vh.scatter_max_batched.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    last2 = tr2(max_iter=5)
    torch.cuda.synchronize()
    launches2 = vh.scatter_max_batched.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    after = {n: _snapshot(m) for n, m in tr2.model.subnets.items()}
    if launches2 != 5:
        raise AssertionError(f"stage 2: heights kernel launched {launches2}"
                             f" times in 5 steps")
    if not np.isfinite(list(last2.values())).all():
        raise AssertionError(f"stage 2: non-finite losses {last2}")
    for n in ("top_view_rpn", "image_feature", "fusion"):
        if _same(before[n][0], after[n][0]) or _same(before[n][1],
                                                      after[n][1]):
            raise AssertionError(f"stage 2: {n} params or statistics did "
                                 f"not move")
    log(f"phase train: stage 2 (all subnets) 5 steps of B=2 in "
        f"{time.time() - t0:.1f} s, heights kernel launches {launches2}, "
        f"last losses " + ", ".join(f"{k} {v:.4f}" for k, v in last2.items())
        + f"; every subnet that ran moved; peak allocated {peak_gib:.2f} "
        f"GiB [{card}]")

    # the loop saved every subnet at its end: load them into a fresh MV3D
    fresh = MV3D(cfg, device=dev, seed=7, checkpoint_dir=work_dir,
                 log_tag="stage2", log_dir=work_dir)
    fresh.load_weights()
    batch = loader.load()
    # threshold 0: ten steps teach the random head to say "background",
    # and every roi must reach NMS for the comparison to hold something
    args = (batch["points"], batch["num_points"], batch["rgb"], 0.0)
    want = tr2.predict_from_points(*args, top_aux=batch["top_aux"])
    got = fresh.predict_from_points(*args, top_aux=batch["top_aux"])
    torch.cuda.synchronize()
    for k in ("mask", "probs", "boxes3d"):
        if not torch.equal(getattr(got, k), getattr(want, k)):
            raise AssertionError(f"checkpoint round trip: {k} differs")
    if not want.mask.any():
        raise AssertionError("checkpoint round trip: no live detection")
    log(f"phase train: checkpoint of stage 2 loaded into a fresh MV3D: "
        f"detections bit-equal ({int(want.mask.sum())} live, from the "
        f"host aux plane + heights kernel)")
    return tr2, loader, launches1 + launches2


def check_front_view(rng, cfg, dev, n_pts):
    """The cylindrical front view (``use_front=True``) of full-width clouds
    (B=2) on the card against the CPU: every point's pixel equal, the
    per-pixel means within atol 5e-5 (tests/test_torch_voxelize.py's; the
    card's ``index_add_`` sums in atomic order)."""
    import torch
    from mv3d_tpu_torch.ops import voxelize as vox
    front_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_front=True))
    pts = torch.from_numpy(make_cloud(rng, 2, n_pts, front_cfg, tricky=True))
    num = torch.tensor([n_pts, n_pts - 1000], dtype=torch.int32)
    pix_c = vox.front_pixels(pts, front_cfg, num)
    pix_g = vox.front_pixels(pts.to(dev), front_cfg, num.to(dev)).cpu()
    front_c = vox.lidar_to_front_batch(pts, front_cfg, num)
    front_g = vox.lidar_to_front_batch(pts.to(dev), front_cfg,
                                       num.to(dev)).cpu()
    moved = int((pix_c != pix_g).sum())
    n_pix = front_cfg.front.width * front_cfg.front.height
    err = (front_c - front_g).abs().max().item()
    log(f"phase front-view: B=2 N={n_pts} ({int((pix_c < n_pix).sum())} "
        f"points in the view), card vs CPU: {moved} points on another "
        f"pixel (tol 0), values max |diff| {err:.3g} (tol 5e-5)")
    if moved or not err <= 5e-5:
        raise AssertionError(f"front view on the card differs from the "
                             f"CPU: {moved} points moved, max |diff| {err}")


# the served configuration as ``cli.train`` flags: serving_config's fields
# (s2d2p in bf16, the matmul ROI-align) without the host aux plane
SERVED_FLAGS = ("--set", "pipeline.use_pallas_fused", "True",
                "--set", "pipeline.use_pallas_heights", "True",
                "--set", "pipeline.view_layout", "s2d2p",
                "--set", "pipeline.top_view_dtype", "bfloat16",
                "--set", "model.roi_align_impl", "matmul",
                "--set", "pipeline.host_aux_channels", "False")


def check_png_path(data_dir, images):
    """The images written to ``data_dir`` decode to the arrays written (the
    port's ``read_image``), their rows used all five filter types, and the
    C helper equals its numpy twin on every filter type."""
    import numpy as np
    from mv3d_tpu_torch.data.kitti import read_image
    from mv3d_tpu_torch.utils import png
    used = np.zeros(5, np.int64)
    for tag, img in images.items():
        path = os.path.join(data_dir, "training", "image_2", tag + ".png")
        if not np.array_equal(read_image(path), img):
            raise AssertionError(f"decoded {tag}.png differs from the "
                                 f"array written")
        with open(path, "rb") as f:
            used += np.bincount(png.row_filters(f.read()), minlength=5)
    if not used.all():
        raise AssertionError(f"the images' rows used filters {used}")
    img = next(iter(images.values()))
    for ftype in range(5):
        data = png.encode_png(img[:48, :96], ftype)
        got = png.decode_png(data)
        twin = png.decode_png(data, row_fn=png.unfilter_row_plain)
        if not (np.array_equal(got, img[:48, :96])
                and np.array_equal(twin, got)):
            raise AssertionError(f"PNG filter {ftype}: the C helper or its "
                                 f"numpy twin decodes wrongly")
    for ftype in (3, 4):     # whole rows of a frame, against the twin
        cand = png.filter_rows(img[:4].reshape(4, -1), 3)[ftype]
        prev = img[0].reshape(-1)
        a, b = cand[1].copy(), cand[1].copy()
        png.unfilter_row_kernel(ftype, a, prev, 3)
        png.unfilter_row_plain(ftype, b, prev, 3)
        if not (np.array_equal(a, b) and np.array_equal(
                a, img[1].reshape(-1))):
            raise AssertionError(f"PNG filter {ftype}: the C helper differs "
                                 f"from its numpy twin on a full row")
    log(f"phase train-cmd: {len(images)} PNGs at "
        f"{sorted({im.shape[:2] for im in images.values()})} decode to the "
        f"arrays written (rows per filter None/Sub/Up/Avg/Paeth "
        f"{'/'.join(str(int(u)) for u in used)}); the C helper equals its "
        f"numpy twin on every filter type")


def _metric_rows(log_dir, tag):
    with open(os.path.join(log_dir, f"metrics_{tag}.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def check_command_outputs(log_dir, ckpt_dir, tag, rows):
    """What a training command leaves: finite losses, validation rows
    with ``iou`` in the metrics JSONL and in log.txt, the dashboard, a
    checkpoint of every trained subnet (all four)."""
    import numpy as np
    from mv3d_tpu_torch.models.nets import SUBNET_NAMES
    keys = ("top_cls_loss", "top_reg_loss", "fuse_cls_loss",
            "fuse_reg_loss")
    if not rows or not all(np.isfinite([r[k] for k in keys]).all()
                           for r in rows):
        raise AssertionError(f"{tag}: no rows or a non-finite loss")
    val = [r for r in rows if r["phase"] == "validation"]
    if not val or not all("iou" in r and np.isfinite(r["iou"]) for r in val):
        raise AssertionError(f"{tag}: validation rows without iou")
    with open(os.path.join(log_dir, "log.txt")) as f:
        lines = [ln for ln in f if ln.lstrip().startswith("validation:")]
    if len(lines) < len(val) or not all("iou" in ln for ln in lines):
        raise AssertionError(f"{tag}: log.txt lacks validation iou lines")
    if not os.path.exists(os.path.join(log_dir, "dashboard.html")):
        raise AssertionError(f"{tag}: no dashboard.html")
    for name in SUBNET_NAMES:
        d = os.path.join(ckpt_dir, tag, name)
        if not (os.path.isdir(d) and any(f.endswith(".npz")
                                         for f in os.listdir(d))):
            raise AssertionError(f"{tag}: no checkpoint of {name}")
    return val


def run_main(main, argv, counters):
    """A command's ``main(argv)`` in process, every kernel's count set to
    0 just before and read just after. Returns (seconds, counts, what
    ``main`` returned)."""
    import torch
    for c in counters.values():
        c.launches = 0
    t0 = time.time()
    out = main(list(argv))
    torch.cuda.synchronize()
    return (time.time() - t0, {k: c.launches for k, c in counters.items()},
            out)


def run_train_main(argv, counters):
    """``mv3d_tpu_torch.cli.train.main(argv)`` through :func:`run_main`.
    Returns (seconds, counts)."""
    from mv3d_tpu_torch.cli import train as train_cli
    return run_main(train_cli.main, argv, counters)[:2]


def _expect(counts, want, label):
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: kernel launches {got}, expected "
                             f"{want}")


def train_command_phase(rng, cfg, dev, work_dir, counters):
    """The training command over a KITTI object directory on disk (8
    frames of ~110,000 raw points with 3-8 gt cars, PNGs at the four KITTI
    sizes; ImageSets train 6 / val 2), B=2, 4 loader workers: the served
    s2d2p configuration in process (12 iterations, a validation every 4,
    checkpoints every 5), a ``-c`` resume of 3, the hwc configuration
    with the host aux plane in process (6 iterations, one validation) and
    as users run it, ``python -m mv3d_tpu_torch.cli.train`` (the same).
    Returns (data_dir, {kernel: launches}) summed over the in-process
    runs."""
    t0 = time.time()
    data_dir = os.path.join(work_dir, "kitti")
    drive = SynthDrive(rng, cfg, 8, 110000)
    images = write_kitti_dir(data_dir, drive, cfg, 6, rng=rng)
    log(f"phase train-cmd: KITTI object directory of 8 frames written in "
        f"{time.time() - t0:.1f} s")
    check_png_path(data_dir, images)
    sets = os.path.join(data_dir, "ImageSets")
    common = ("--kitti-object", data_dir,
              "--train-split", os.path.join(sets, "train.txt"),
              "--val-split", os.path.join(sets, "val.txt"),
              "-b", "2", "--loader-workers", "4",
              "--checkpoint-dir", os.path.join(work_dir, "ckpt"),
              "--set", "rcnn.score_threshold", str(THRESH),
              "--set", "train.validation_every", "4",
              "--set", "train.ckpt_every", "5")
    total = {k: 0 for k in counters}

    def logs(tag):
        return ("-n", tag, "--log-dir", os.path.join(work_dir, "log_" + tag))

    secs, counts = run_train_main(common + SERVED_FLAGS + logs("s2d2p")
                                  + ("-i", "12"), counters)
    rows = _metric_rows(os.path.join(work_dir, "log_s2d2p"), "s2d2p")
    n_val = sum(r["phase"] == "validation" for r in rows)
    n_train = len(rows) - n_val
    _expect(counts, {"voxelize_padded": n_train + 2 * n_val,
                     "voxelize_sweep": 0, "voxelize_heights": 0,
                     "sort_radix": 0, "sort_merge": 0}, "s2d2p command")
    val = check_command_outputs(os.path.join(work_dir, "log_s2d2p"),
                                os.path.join(work_dir, "ckpt"), "s2d2p",
                                rows)
    for k in total:
        total[k] += counts[k]
    log(f"phase train-cmd: s2d2p (served configuration, no host aux "
        f"plane) 12 iterations in {secs:.1f} s: {n_train} training and "
        f"{n_val} validation steps, voxelize_padded launched "
        f"{counts['voxelize_padded']} times (one per training step, eval "
        f"step and validation prediction), no other kernel; validation iou "
        + ", ".join(f"{r['iou']:.4f}" for r in val) + "; losses finite; "
        "log.txt, metrics JSONL, dashboard.html and checkpoints of all "
        "four subnets written")

    secs, counts = run_train_main(common + SERVED_FLAGS + logs("s2d2p")
                                  + ("-i", "3", "-c"), counters)
    resumed = _metric_rows(os.path.join(work_dir, "log_s2d2p"),
                           "s2d2p")[len(rows):]
    steps = [r["step"] for r in resumed]
    n_val = sum(r["phase"] == "validation" for r in resumed)
    if steps != [12, 13, 14]:
        raise AssertionError(f"-c resume ran steps {steps}, not 12-14")
    _expect(counts, {"voxelize_padded": len(steps) + n_val},
            "s2d2p resume")
    total["voxelize_padded"] += counts["voxelize_padded"]
    log(f"phase train-cmd: -c resume continued at step 12 (steps {steps}, "
        f"{n_val} validation) in {secs:.1f} s")

    secs, counts = run_train_main(common + logs("hwc") + ("-i", "6"),
                                  counters)
    rows = _metric_rows(os.path.join(work_dir, "log_hwc"), "hwc")
    n_val = sum(r["phase"] == "validation" for r in rows)
    _expect(counts, {"voxelize_heights": len(rows), "voxelize_sweep": n_val,
                     "voxelize_padded": 0, "sort_radix": 0,
                     "sort_merge": 0}, "hwc command")
    check_command_outputs(os.path.join(work_dir, "log_hwc"),
                          os.path.join(work_dir, "ckpt"), "hwc", rows)
    for k in total:
        total[k] += counts[k]
    log(f"phase train-cmd: hwc (host aux plane) 6 iterations in {secs:.1f} "
        f"s: voxelize_heights {counts['voxelize_heights']} (one per "
        f"training and eval step), voxelize_sweep "
        f"{counts['voxelize_sweep']} (one per validation prediction)")

    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "mv3d_tpu_torch.cli.train", *common,
         *logs("hwc_cli"), "-i", "6"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"python -m mv3d_tpu_torch.cli.train failed "
                             f"({out.returncode}):\n{out.stderr[-4000:]}")
    rows = _metric_rows(os.path.join(work_dir, "log_hwc_cli"), "hwc_cli")
    check_command_outputs(os.path.join(work_dir, "log_hwc_cli"),
                          os.path.join(work_dir, "ckpt"), "hwc_cli", rows)
    log(f"phase train-cmd: python -m mv3d_tpu_torch.cli.train (hwc) "
        f"exited 0 in {time.time() - t0:.1f} s with {len(rows)} rows, "
        f"validation iou and every output on disk")
    return data_dir, total


def write_raw_drive(root, drive, cfg, date="2011_09_26", drive_id="0001",
                    didi: bool = False):
    """Write ``drive``'s frames (a :class:`SynthDrive`) as a KITTI raw
    drive, ``<root>/<date>/<date>_drive_<id>_sync/{velodyne_points/data,
    image_02/data}``, or with ``didi`` in the didi bag converter's layout
    ``<root>/<date>/<id>/...`` (PNGs at the frames' rgb size), with a
    ``tracklet_labels.xml`` (``data/tracklets.write_tracklets``) holding
    each frame's gt cars as one-pose tracklets."""
    import numpy as np
    import torch
    from mv3d_tpu_torch.data import tracklets
    from mv3d_tpu_torch.ops.boxes3d import boxes3d_decompose
    from mv3d_tpu_torch.utils.png import write_png
    base = os.path.join(root, date, drive_id if didi
                        else f"{date}_drive_{drive_id}_sync")
    for sub in ("velodyne_points", "image_02"):
        os.makedirs(os.path.join(base, sub, "data"), exist_ok=True)
    tracks = []
    for i, f in enumerate(drive.frames):
        f.points.astype(np.float32).tofile(os.path.join(
            base, "velodyne_points", "data", f"{i:010d}.bin"))
        write_png(os.path.join(base, "image_02", "data", f"{i:010d}.png"),
                  f.rgb)
        t, size, rot = (x.numpy() for x in boxes3d_decompose(
            torch.from_numpy(f.gt_boxes3d), cfg))
        for c, (h, w, l), yaw in zip(t, size, rot[:, 2]):
            tk = tracklets.Tracklet("Car", float(h), float(w), float(l),
                                    first_frame=i)
            tk.poses.append({"tx": float(c[0]), "ty": float(c[1]),
                             "tz": float(c[2]), "rx": 0.0, "ry": 0.0,
                             "rz": float(yaw)})
            tracks.append(tk)
    tracklets.write_tracklets(os.path.join(base, "tracklet_labels.xml"),
                              tracks)
    return base


def _detections(out_dir, tags):
    """{tag: (boxes3d, probs)} from a test_mv3d output directory, checked
    for shape and finiteness."""
    import numpy as np
    dets = {}
    for tag in tags:
        b = np.load(os.path.join(out_dir, f"{tag}_boxes3d.npy"))
        p = np.load(os.path.join(out_dir, f"{tag}_probs.npy"))
        if not (b.ndim == 3 and b.shape[1:] == (8, 3) and p.shape == (
                len(b),) and np.isfinite(b).all() and np.isfinite(p).all()):
            raise AssertionError(f"test_mv3d {tag}: detections of shape "
                                 f"{b.shape}/{p.shape} or not finite")
        dets[tag] = (b, p)
    return dets


def _check_kitti_txt(out_dir, dets, cfg, label):
    """export_kitti's files: one parseable line per detection, in score
    order, whose boxes parse back near the detections."""
    import numpy as np
    import torch
    from mv3d_tpu_torch.data.kitti import kitti_label_to_lidar_box3d
    from mv3d_tpu_torch.ops.boxes3d import boxes3d_decompose
    n = 0
    for tag, (boxes, probs) in dets.items():
        with open(os.path.join(out_dir, tag + ".txt")) as f:
            lines = f.read().splitlines()
        if len(lines) != len(boxes):
            raise AssertionError(f"{label} {tag}: {len(lines)} lines for "
                                 f"{len(boxes)} detections")
        if not lines:
            continue
        back, _ = kitti_label_to_lidar_box3d(lines, "Car",
                                             positive_only=False, cfg=cfg)
        order = np.argsort(-probs)
        t0 = boxes3d_decompose(torch.from_numpy(boxes[order]), cfg)[0]
        t1 = boxes3d_decompose(torch.from_numpy(back), cfg)[0]
        if not (t0 - t1).abs().max().item() < 0.05:
            raise AssertionError(f"{label} {tag}: KITTI lines do not parse "
                                 f"back to the detections")
        n += len(lines)
    return n


def eval_command_phase(rng, cfg, dev, work_dir, data_dir, counters, card):
    """The evaluation commands over phase 6's KITTI directory (8 frames)
    and its checkpoints (tags ``hwc`` and ``s2d2p``), on the card: every
    ``cli.test`` subcommand in hwc and test_mv3d + export_kitti in
    s2d2p, ``test_mv3d`` in f32 on the card against the same command on
    the CPU, ``cli.preprocess`` on the card against the CPU, a raw drive
    through ``cli.tracking --eval``, ``cli.dashboard`` and
    ``cli.rehearsal --synthetic-fixture``. Returns {kernel: launches}
    summed over the commands."""
    import numpy as np
    from mv3d_tpu_torch.cli import dashboard as dashboard_cli
    from mv3d_tpu_torch.cli import preprocess as preprocess_cli
    from mv3d_tpu_torch.cli import rehearsal as rehearsal_cli
    from mv3d_tpu_torch.cli import test as test_cli
    from mv3d_tpu_torch.cli import tracking as tracking_cli
    from mv3d_tpu_torch.data.kitti import KittiObjectDataset
    from mv3d_tpu_torch.data.tracklets import parse_tracklets
    from mv3d_tpu_torch.ops.boxes3d import box3d_compose
    from mv3d_tpu_torch.utils.png import read_png
    ckpt = os.path.join(os.path.dirname(work_dir), "train_cmd", "ckpt")
    tags = KittiObjectDataset(data_dir).tags
    total = {k: 0 for k in counters}
    none = {k: 0 for k in counters}

    def run(label, main, argv, want, frames=None):
        secs, counts, out = run_main(main, argv, counters)
        _expect(counts, {**none, **want}, label)
        for k in total:
            total[k] += counts[k]
        rate = f", {frames / secs:.2f} frames/s" if frames else ""
        log(f"phase eval-cmd: {label}: {secs:.2f} s{rate}; launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
            + f" [{card}]")
        return out

    def test(cmd, tag, out, *extra, config=()):
        # score gate 0: a few training steps leave every fg prob low
        return [cmd, "--kitti-object", data_dir, "-n", tag,
                "--checkpoint-dir", ckpt, "--out-dir",
                os.path.join(work_dir, out), "--score-threshold", "0.0",
                *config, *extra]

    # test_mv3d over the 8 frames in the trained hwc configuration (bf16)
    run("test_mv3d hwc (8 frames)", test_cli.main,
        test("test_mv3d", "hwc", "mv3d_hwc"), {"voxelize_sweep": 8}, 8)
    dets = _detections(os.path.join(work_dir, "mv3d_hwc"), tags)
    # the same command in f32 on the card and on the CPU, 2 frames
    f32 = ("--set", "model.compute_dtype", "float32")
    run("test_mv3d hwc f32 (2 frames)", test_cli.main,
        test("test_mv3d", "hwc", "mv3d_f32", "--limit", "2", config=f32),
        {"voxelize_sweep": 2}, 2)
    t0 = time.time()
    test_cli.main(test("test_mv3d", "hwc", "mv3d_f32_cpu", "--limit", "2",
                       "--device", "cpu", config=f32))
    cpu_s = time.time() - t0
    on_card = _detections(os.path.join(work_dir, "mv3d_f32"), tags[:2])
    on_cpu = _detections(os.path.join(work_dir, "mv3d_f32_cpu"), tags[:2])
    worst = [0.0, 0.0]
    for tag in tags[:2]:
        (b1, p1), (b0, p0) = on_card[tag], on_cpu[tag]
        if len(b1) != len(b0) or not len(b0):
            raise AssertionError(f"test_mv3d f32 {tag}: {len(b1)} "
                                 f"detections on the card, {len(b0)} on "
                                 f"the CPU")
        worst = [max(worst[0], float(np.abs(p1 - p0).max())),
                 max(worst[1], float(np.abs(b1 - b0).max()))]
    # the serving phase's tolerance when rgb ROI corners moved by a pixel
    if not (worst[0] <= 1e-3 and worst[1] <= 1e-2):
        raise AssertionError(f"test_mv3d f32 card vs CPU: probs "
                             f"{worst[0]:.3g}, boxes3d {worst[1]:.3g} m")
    log(f"phase eval-cmd: test_mv3d f32 card vs --device cpu ({cpu_s:.1f} "
        f"s on the CPU), 2 frames: detections "
        f"{[len(on_card[t][0]) for t in tags[:2]]} on both; probs max|diff| "
        f"{worst[0]:.3g} (tol 1e-3), boxes3d {worst[1]:.3g} m (tol 1e-2)")

    run("export_kitti hwc (8 frames)", test_cli.main,
        test("export_kitti", "hwc", "kitti_hwc"), {"voxelize_sweep": 8}, 8)
    n_lines = _check_kitti_txt(os.path.join(work_dir, "kitti_hwc"), dets,
                               cfg, "export_kitti hwc")
    run("test_single_mv3d hwc", test_cli.main,
        test("test_single_mv3d", "hwc", "single"), {"voxelize_sweep": 1}, 1)
    run("test_rpn hwc (2 frames)", test_cli.main,
        test("test_rpn", "hwc", "rpn", "--limit", "2"),
        {"voxelize_sweep": 2}, 2)
    for tag in tags[:2]:
        rois = np.load(os.path.join(work_dir, "rpn", f"{tag}_proposals.npy"))
        if not (rois.ndim == 2 and rois.shape[1] == 5 and len(rois)):
            raise AssertionError(f"test_rpn {tag}: proposals {rois.shape}")
    props = os.path.join(work_dir, "props")
    os.makedirs(props, exist_ok=True)
    np.save(os.path.join(props, f"{tags[0]}_rois3d.npy"), box3d_compose(
        [[10.0 + 3 * i, -4.0 + 2 * i, -1.7] for i in range(4)],
        [[1.5, 1.6, 4.0]] * 4, [[0, 0, 0.3 * i] for i in range(4)],
        cfg).numpy())
    run("test_3dop hwc (proposals for 1 of 2 frames)", test_cli.main,
        test("test_3dop", "hwc", "3dop", "--limit", "2", "--proposal-dir",
             props), {"voxelize_sweep": 1}, 1)
    _detections(os.path.join(work_dir, "3dop"), tags[:1])
    run("test_rpn_target hwc (2 frames)", test_cli.main,
        test("test_rpn_target", "hwc", "rpn_target", "--limit", "2"),
        {"voxelize_sweep": 2}, 2)
    run("test_front (2 frames)", test_cli.main,
        test("test_front", "hwc", "front", "--limit", "2"), {}, 2)
    run("probe_rpn hwc (2 frames)", test_cli.main,
        test("probe_rpn", "hwc", "probe", "--limit", "2"),
        {"voxelize_sweep": 2}, 2)
    pngs = ([os.path.join(work_dir, "rpn_target", "rpn_target",
                          f"rpn_target_{i:06d}.png") for i in range(2)]
            + [os.path.join(work_dir, "front", f"{t}_front.png")
               for t in tags[:2]]
            + [os.path.join(work_dir, "probe", f"{i:06d}", name)
               for i in range(2) for name in ("top.png", "camera.png")])
    shapes = {read_png(p).shape for p in pngs}
    front = np.load(os.path.join(work_dir, "front", f"{tags[0]}_front.npy"))
    if front.shape != cfg.front_shape or not np.isfinite(front).all():
        raise AssertionError(f"test_front: front view {front.shape}")
    log(f"phase eval-cmd: hwc outputs parse: {len(tags)} frames of "
        f"detections ({sum(len(b) for b, _ in dets.values())} in all), "
        f"{n_lines} KITTI lines parsing back to them, proposals, 3DOP "
        f"detections, {len(pngs)} PNGs of shapes {sorted(shapes)}")
    run("test_mv3d s2d2p (2 frames)", test_cli.main,
        test("test_mv3d", "s2d2p", "mv3d_s2d2p", "--limit", "2",
             config=SERVED_FLAGS), {"voxelize_padded": 2}, 2)
    sdets = _detections(os.path.join(work_dir, "mv3d_s2d2p"), tags[:2])
    run("export_kitti s2d2p (2 frames)", test_cli.main,
        test("export_kitti", "s2d2p", "kitti_s2d2p", "--limit", "2",
             config=SERVED_FLAGS), {"voxelize_padded": 2}, 2)
    _check_kitti_txt(os.path.join(work_dir, "kitti_s2d2p"), sdets, cfg,
                     "export_kitti s2d2p")

    # preprocess on the card (K1, batches of 4) against the CPU
    pre = os.path.join(work_dir, "pre")
    run("preprocess (8 frames, batches of 4)", preprocess_cli.main,
        ["--kitti-object", data_dir, "-o", pre, "-b", "4"],
        {"voxelize_sweep": 2}, 8)
    preprocess_cli.main(["--kitti-object", data_dir, "-o", pre + "_cpu",
                         "-b", "4", "--device", "cpu", "--no-images"])
    for tag in tags:
        with np.load(os.path.join(pre, "top", tag + ".npy.npz")) as a, \
                np.load(os.path.join(pre + "_cpu", "top",
                                     tag + ".npy.npz")) as b:
            if not np.array_equal(a["top_view"], b["top_view"]):
                raise AssertionError(f"preprocess {tag}: the card's top "
                                     f"view differs from the CPU's")
        for sub in ("rgb", "top_image"):
            read_png(os.path.join(pre, sub, tag + ".png"))
    log(f"phase eval-cmd: preprocess: the card's {len(tags)} top views "
        f"bit-equal to the CPU plain path's; rgb and top_image PNGs decode")

    # a raw drive through the tracking command with --eval
    raw = os.path.join(work_dir, "raw")
    write_raw_drive(raw, SynthDrive(rng, cfg, 4, 110000), cfg)
    pred = run("tracking --eval (raw drive, 4 frames)", tracking_cli.main,
               ["-n", "hwc", "--kitti-raw", raw, "--date", "2011_09_26",
                "--drive", "0001", "--out-dir", os.path.join(work_dir, "pred"),
                "--checkpoint-dir", ckpt, "--score-threshold", "0.0",
                "--eval"], {"voxelize_sweep": 4}, 4)
    n_tracks = len(parse_tracklets(pred))
    with open(os.path.join(os.path.dirname(pred), "iou_per_obj.csv")) as f:
        rows = f.read().splitlines()
    if rows[0] != "object_type,iou" or not rows[1].startswith("All,"):
        raise AssertionError(f"tracking --eval: iou_per_obj.csv {rows}")
    run("dashboard", dashboard_cli.main,
        [os.path.join(work_dir, "..", "train_cmd", "log_hwc")], {})

    # the rehearsal at full width: two stages of 2 iterations (re-run while
    # under 10 s), then predictions over its 4 fixture frames
    rh = os.path.join(work_dir, "rehearsal")
    secs, counts, res = run_main(rehearsal_cli.main, [
        "--synthetic-fixture", "--fixture-frames", "4", "-o", rh, "-i", "2",
        "-b", "2"], counters)
    steps = len(_metric_rows(os.path.join(rh, "log"), "rehearsal"))
    _expect(counts, {**none, "voxelize_heights": steps,
                     "voxelize_sweep": 4}, "rehearsal")
    for k in total:
        total[k] += counts[k]
    with open(os.path.join(rh, "eval", "pr_per_iou.csv")) as f:
        n_pr = len(f.read().splitlines())
    if n_pr != 9 or "All" not in res["iou_per_obj"]:
        raise AssertionError(f"rehearsal: pr_per_iou.csv has {n_pr} lines, "
                             f"iou_per_obj {res['iou_per_obj']}")
    log(f"phase eval-cmd: rehearsal --synthetic-fixture -i 2: {secs:.1f} s, "
        f"{steps} training steps (voxelize_heights {steps}), 4 predictions "
        f"(voxelize_sweep 4); tracking wrote {n_tracks} tracklets; "
        f"iou_per_obj {res['iou_per_obj']} [{card}]")
    return total


# the model options of phase ``options``, each alone and as the reference
# graph (the bilinear deconvs with the 7x7/2 stem)
OPTION_MODELS = (
    ("reference graph (upsample_features, 7x7/2 stem)",
     dict(upsample_features=True, stem_space_to_depth=False)),
    ("reference graph + VGG rgb trunk",
     dict(upsample_features=True, stem_space_to_depth=False,
          rgb_basenet="vgg")),
    ("basic blocks", dict(backbone_block="basic")),
    ("siamese fusion", dict(use_siamese_fusion=True)),
    ("handcraft fusion", dict(use_handcraft_fusion=True)),
    ("learnable fusion", dict(use_learnable_fusion=True)))


def with_model(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **kw))


def with_pipeline(cfg, **kw):
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **kw))


def didi_cloud(rng, b, n, cfg):
    """(B, N, 4) ``make_cloud`` tricky clouds (the top slice filled up to
    z_max and beyond) with a twentieth of the points the capture car's own
    returns, inside the center-car box the didi presets crop, some on its
    edges (|x| = 2.35, |y| = 1.05 in f32)."""
    import numpy as np
    pts = make_cloud(rng, b, n, cfg, tricky=True)
    k = n // 20
    pts[:, -k:] = np.stack([rng.uniform(-2.5, 2.5, (b, k)),
                            rng.uniform(-1.2, 1.2, (b, k)),
                            rng.uniform(-1.5, 0.5, (b, k)),
                            rng.uniform(0, 1, (b, k))], -1)
    q = k // 4
    pts[:, -q:, 0] = np.float32(4.7 / 2) * rng.choice([-1, 1], (b, q))
    pts[:, -2 * q:-q, 1] = np.float32(2.1 / 2) * rng.choice([-1, 1], (b, q))
    return pts.astype(np.float32)


def small_didi_config():
    """A small f32 didi config (24 m x 12 m at 0.2 m, z as didi's: 12
    slices and the top one's values up to 1.33; a 96 x 100 camera cropped
    by 30 + 20 rows) for the card-against-CPU reference."""
    from mv3d_tpu_torch.config import make_config
    cfg = make_config("didi")
    return dataclasses.replace(
        cfg, top=dataclasses.replace(cfg.top, x_min=-12, x_max=12,
                                     y_min=-6, y_max=6),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        pipeline=dataclasses.replace(cfg.pipeline, max_points=4096),
        image_width=96, image_height=100, image_crop_top=30,
        image_crop_bottom=20)


def check_kernels_at_grid(rng, cfg, dev, n_pts, label):
    """Each kernel against its plain version at ``cfg``'s grid (B=2, N =
    ``n_pts``) on ``didi_cloud`` clouds, bit-equal on the card and to the
    CPU: K1 and K2 (heights f32 and bf16) on the path's points and on the
    skewed cases (one tile, one cell, the last partial tile, padding / pad
    lanes), K3, K4 and K1 on K4's output against K1 alone. Returns
    {kernel: max |kernel - plain|} (0)."""
    import torch
    from mv3d_tpu_torch.ops import voxelize as vox
    from mv3d_tpu_torch.ops import voxelize_heights as vh
    from mv3d_tpu_torch.ops import voxelize_padded as vp
    from mv3d_tpu_torch.ops import voxelize_sweep as sweep
    t = cfg.top
    n_cells, zn = t.xn * t.yn, t.zn
    n_flat = n_cells * zn
    n_sc = (t.xn // 2) * vox.folded_pad_width(t.yn)
    pts = torch.from_numpy(didi_cloud(rng, 2, n_pts, cfg))
    valid, _, flat, val, refl = vox._top_prep(pts, cfg, None)
    top_val = val[flat % zn == zn - 1].max().item()
    if not top_val > 1.0:
        raise AssertionError(f"{label}: the top slice's values stay <= 1")
    refl = torch.where(flat < n_flat, refl, 0.0)
    cpu = (flat, val, refl)
    err = {}
    occupied, err["voxelize_sweep"] = check_sweep(cpu, dev, n_cells, zn,
                                                  label)
    cases, e = check_sweep_cases(rng, dev, 2, n_pts, n_cells, zn)
    err["voxelize_sweep"] = max(err["voxelize_sweep"], e)
    tile, n_tiles, _ = sweep.tile_plan(2 * n_cells, zn)
    _, _, pf, pv, pr = vox._top_prep(pts, cfg, None, s2d="pad")
    pr = torch.where(pf < n_sc * 128, pr, 0.0)
    (p_occ, _), err["voxelize_padded"] = check_padded((pf, pv, pr), dev,
                                                      n_sc, zn, label)
    p_cases, e = check_padded_cases(rng, dev, 2, n_pts, n_sc, zn)
    err["voxelize_padded"] = max(err["voxelize_padded"], e)
    want = vh.scatter_max_plain(flat, val, n_flat)
    args = (flat.to(dev), val.to(dev), n_flat)
    got, plain = vh.scatter_max_kernel(*args), vh.scatter_max_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got, plain) and torch.equal(got.cpu(), want)):
        raise AssertionError(f"heights kernel differs from its plain "
                             f"version ({label})")
    err["voxelize_heights"] = (got - plain).abs().max().item()
    err["sort_radix"] = check_sort(*cpu, dev, label)
    check_sort_then_sweep(*(x.to(dev) for x in cpu), n_cells, zn)
    dropped = int((~valid).sum())
    log(f"phase options: kernels at the {label} grid ({t.xn} x {t.yn} x "
        f"{zn}: {n_cells} cells per frame, K1 tiles of {tile} cells, "
        f"{n_tiles} at B=2, the last holding "
        f"{2 * n_cells - (n_tiles - 1) * tile}; K2 {n_sc} supercells, "
        f"tiles of {vp.tile_plan(n_sc)[0]}), B=2 N={n_pts} with the "
        f"capture car's returns and the top slice filled (values up to "
        f"{top_val:.4f}; {dropped} points cropped): voxelize_sweep "
        f"(occupied {occupied}; skewed {cases}), voxelize_padded (occupied "
        f"{p_occ}; skewed {p_cases}), voxelize_heights, sort_radix and the "
        f"sweep after the sort bit-equal to their plain versions on the "
        f"card and on the CPU")
    return err


def _peak_mib():
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 20


def options_phase(rng, dev, work_dir, counters, requests, card):
    """Phase ``options``: the didi presets and the model options at full
    width, with random weights from a seed; each path driven with the
    kernels' counts set to 0 just before and read just after.

    didi and didi2: the kernels at their grids (``check_kernels_at_grid``),
    3 requests of B=2 in hwc (K1 once each), in s2d2p (K2) and at
    ``voxel_order="pallas-sort"`` with 65,536 points (K4 and K1), 3
    training steps at B=2 with the host aux plane from an in-memory drive
    holding the capture car's returns (K3 once each); a small f32 didi
    model on the card against the CPU; ``cli.tracking --dataset didi
    --eval`` over a 4-frame drive in the bag converter's layout (K1 once a
    frame), its XML and CSVs read back. Each model option of
    ``OPTION_MODELS`` at KITTI width: 2 of ``requests`` (K1 once each), 1
    training step at B=2 in hwc with the host aux plane (K3 once), a small
    f32 model on the card against the CPU. Prints each configuration's
    wall ms per request and per step and its peak allocated memory.
    Returns {kernel: launches} summed over the paths."""
    import numpy as np
    import torch
    from mv3d_tpu_torch import kitti_config, serving_config
    from mv3d_tpu_torch.cli import tracking as tracking_cli
    from mv3d_tpu_torch.config import make_config
    from mv3d_tpu_torch.data.loader import BatchLoader
    from mv3d_tpu_torch.data.tracklets import parse_tracklets
    from mv3d_tpu_torch.train.trainer import MV3D, Trainer
    total = {k: 0 for k in counters}
    none = {k: 0 for k in counters}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    def serve(model, reqs, want, label):
        torch.cuda.reset_peak_memory_stats()
        times = []
        add(serve_requests(model, reqs, counters, {**none, **want}, times))
        log(f"phase options: {label}: {len(reqs)} requests of B=2, wall ms "
            f"per request " + ", ".join(f"{t:.1f}" for t in times)
            + f" (the first with its first-call set-up); peak allocated "
            f"{_peak_mib():.0f} MiB [{card}]")

    def train(cfg, loader, steps, label, tag):
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(loader, cfg=cfg, device=dev, seed=0, log_tag=tag,
                     checkpoint_dir=os.path.join(work_dir, "ckpt"),
                     log_dir=os.path.join(work_dir, "log"))
        for c in counters.values():
            c.launches = 0
        times = []
        for _ in range(steps):
            batch = loader.load()
            t0 = time.time()
            losses = tr.fit_iteration(batch)
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
            if not np.isfinite(list(losses.values())).all():
                raise AssertionError(f"{label}: non-finite losses {losses}")
        counts = {k: c.launches for k, c in counters.items()}
        _expect(counts, {**none, "voxelize_heights": steps}, label)
        add(counts)
        log(f"phase options: {label}: {steps} training step"
            f"{'s' if steps > 1 else ''} of B=2 (host "
            f"aux plane), voxelize_heights {steps}; wall ms per step "
            + ", ".join(f"{t:.1f}" for t in times) + "; losses "
            + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
            + f"; peak allocated {_peak_mib():.0f} MiB [{card}]")
        return tr

    for preset in ("didi", "didi2"):
        cfg = make_config(preset)
        n_pts = cfg.pipeline.max_points
        t = cfg.top
        check_kernels_at_grid(rng, cfg, dev, n_pts, preset)
        reqs = [(didi_cloud(rng, 2, n_pts, cfg), np.full(2, n_pts, np.int32),
                 rng.rand(2, *cfg.rgb_shape).astype(np.float32))
                for _ in range(3)]
        hwc = with_pipeline(cfg, use_pallas_fused=True)
        for name, c, want in (
                ("hwc", hwc, {"voxelize_sweep": 3}),
                ("s2d2p", serving_config(cfg), {"voxelize_padded": 3}),
                ("hwc at pallas-sort", with_pipeline(
                    hwc, voxel_order="pallas-sort"),
                 {"sort_radix": 3, "voxelize_sweep": 3})):
            model = MV3D(c, device=dev, seed=0)
            serve(model, reqs, want, f"{preset} ({t.xn} x {t.yn} x "
                  f"{t.channels}, rgb {cfg.rgb_shape[0]} x "
                  f"{cfg.rgb_shape[1]} cropped from {cfg.image_height} x "
                  f"{cfg.image_width}, {cfg.num_anchors} anchors) {name}")
            del model
        drive = SynthDrive(rng, cfg, 4, 110000, cars=(2, 4), ego=3000)
        with BatchLoader(drive, cfg, batch_size=2, seed=0) as loader:
            batch = loader.load()
            live = np.arange(n_pts) < batch["num_points"][:, None]
            p = batch["points"]
            if ((np.abs(p[..., 0]) <= np.float32(2.35))
                    & (np.abs(p[..., 1]) <= np.float32(1.05)) & live).any():
                raise AssertionError(f"{preset}: the loader kept the "
                                     f"capture car's returns")
            tr = train(cfg, loader, 3, f"{preset} training", preset)
            tr.save_weights(step=3)
            del tr
        if preset == "didi":
            small_reference(rng, dev, small=small_didi_config(),
                            label="didi ")
            raw = os.path.join(work_dir, "raw")
            write_raw_drive(raw, SynthDrive(rng, cfg, 4, 110000, ego=3000),
                            cfg, date="1", drive_id="15", didi=True)
            secs, counts, pred = run_main(tracking_cli.main, [
                "-n", "didi", "--kitti-raw", raw, "--date", "1", "--drive",
                "15", "--dataset", "didi", "--out-dir",
                os.path.join(work_dir, "pred"), "--checkpoint-dir",
                os.path.join(work_dir, "ckpt"), "--score-threshold", "0.0",
                "--eval", "--device", dev.type], counters)
            _expect(counts, {**none, "voxelize_sweep": 4},
                    "tracking --dataset didi")
            add(counts)
            n_tracks = len(parse_tracklets(pred))
            with open(os.path.join(os.path.dirname(pred),
                                   "iou_per_obj.csv")) as f:
                rows = f.read().splitlines()
            with open(os.path.join(os.path.dirname(pred),
                                   "pr_per_iou.csv")) as f:
                n_pr = len(f.read().splitlines())
            if rows[0] != "object_type,iou" or not rows[1].startswith(
                    "All,") or n_pr != 9:
                raise AssertionError(f"tracking --dataset didi: CSVs {rows}"
                                     f", pr_per_iou.csv {n_pr} lines")
            log(f"phase options: tracking --dataset didi --eval over a "
                f"4-frame bag-converter drive: {secs:.2f} s, "
                f"voxelize_sweep 4, {n_tracks} tracklets in the XML, "
                f"iou_per_obj {rows[1:]} [{card}]")

    cfg = kitti_config()
    serve_cfg = with_pipeline(cfg, use_pallas_fused=True)
    drive = SynthDrive(rng, cfg, 2, 110000)
    with BatchLoader(drive, cfg, batch_size=2, seed=0) as loader:
        for label, opts in OPTION_MODELS:
            model = MV3D(with_model(serve_cfg, **opts), device=dev, seed=0)
            serve(model, requests[:2], {"voxelize_sweep": 2},
                  f"KITTI {label}, hwc")
            del model
            tr = train(with_model(cfg, **opts), loader, 1,
                       f"KITTI {label} training", "option")
            del tr
            small_reference(rng, dev, small=with_model(_small_config(),
                                                       **opts),
                            label=f"{label} ")
    return total


def int8_products(model, request):
    """The distinct (M, K, N) int8 products of one request through
    ``model`` (``ops.quantized.int_mm``'s operands, before padding)."""
    from mv3d_tpu_torch.ops import quantized as tq
    shapes, real = set(), tq.int_mm

    def record(a, b_t):
        shapes.add((a.shape[0], a.shape[1], b_t.shape[0]))
        return real(a, b_t)

    tq.int_mm = record
    try:
        model.predict_from_points(*request, THRESH)
    finally:
        tq.int_mm = real
    return sorted(shapes)


def detections_agree(float_dets, int8_dets, tol_m: float = 0.5):
    """The share of the float model's live detections that the int8 model
    also finds (a live int8 box whose 8 corners are each within ``tol_m``
    of the float box's), and the mean |prob difference| over those."""
    import numpy as np
    found, total, dprob = 0, 0, []
    for fd, qd in zip(float_dets, int8_dets):
        for i in range(fd.mask.shape[0]):
            fb = fd.boxes3d[i][fd.mask[i]].float().cpu().numpy()
            fp = fd.probs[i][fd.mask[i]].float().cpu().numpy()
            qb = qd.boxes3d[i][qd.mask[i]].float().cpu().numpy()
            qp = qd.probs[i][qd.mask[i]].float().cpu().numpy()
            total += len(fb)
            if not len(qb):
                continue
            dist = np.linalg.norm(fb[:, None] - qb[None], axis=-1).max(-1)
            j = dist.argmin(1)
            hit = dist[np.arange(len(fb)), j] < tol_m
            found += int(hit.sum())
            dprob += list(np.abs(fp[hit] - qp[j[hit]]))
    return (found / max(total, 1), total,
            float(np.mean(dprob)) if dprob else float("nan"))


def int8_phase(rng, dev, work_dir, counters, requests, card):
    """Phase ``int8``: ``model.quant="int8"`` at full KITTI width, each
    path driven with the kernels' counts set to 0 just before and read
    just after. Every distinct int8 product of the model (``torch._int_mm``
    through ``int_mm``'s padding) equals the CPU's int32 sums at its shape;
    3 requests of B=2 in hwc (K1), in the s2d2p serving configuration (K2)
    and at "pallas-sort" (K4 + K1), with wall ms per request and peak
    memory; the share of the bf16 model's detections (the same
    configuration and weights) the int8 model also finds; an int8
    artifact exported by ``cli.export --set model.quant int8`` answers a
    two-frame request over HTTP (K4 + K1 once) bit-equal to in-process
    ``predict_batch``; a small f32 int8 model on the card
    against the CPU (``Int8Replay``). Returns ({kernel: launches}, the hwc
    int8 model for the timings)."""
    import io
    import numpy as np
    import torch
    from mv3d_tpu_torch import kitti_config, serving_config
    from mv3d_tpu_torch.ops import quantized as tq
    from mv3d_tpu_torch.serving import load_serving
    from mv3d_tpu_torch.train.trainer import MV3D
    total = {k: 0 for k in counters}
    none = {k: 0 for k in counters}
    cfg = with_pipeline(kitti_config(), use_pallas_fused=True)
    int8 = with_model(cfg, quant="int8")

    t0 = time.time()
    hwc = MV3D(int8, device=dev, seed=0)
    shapes = int8_products(hwc, requests[0])
    g = torch.Generator().manual_seed(0)
    for m, k, n in shapes:
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        if not torch.equal(tq.int_mm(a.to(dev), b.to(dev)).cpu(),
                           tq.int_mm(a, b)):
            raise AssertionError(f"int8 product {m} x {k} x {n}: the card's "
                                 f"int32 sums differ from the CPU's")
    log(f"phase int8: {len(shapes)} distinct int8 products (M x K x N) of "
        f"the KITTI model at B=2, from {min(shapes)} to {max(shapes)}: "
        f"torch._int_mm on the card (padded to M > 16, K and N multiples "
        f"of 8) equals the CPU's int32 sums exactly "
        f"({time.time() - t0:.1f} s)")

    for name, c, want in (
            ("hwc", int8, {"voxelize_sweep": 3}),
            ("s2d2p", with_model(serving_config(kitti_config()),
                                 quant="int8"), {"voxelize_padded": 3}),
            ("hwc at pallas-sort", with_pipeline(int8,
                                                 voxel_order="pallas-sort"),
             {"sort_radix": 3, "voxelize_sweep": 3})):
        model = hwc if name == "hwc" else MV3D(c, device=dev, seed=0)
        torch.cuda.reset_peak_memory_stats()
        times, outs = [], []
        for fn in counters.values():
            fn.launches = 0
        for p, n, r in requests:
            t1 = time.time()
            outs.append(model.predict_from_points(p, n, r, THRESH))
            torch.cuda.synchronize()
            times.append((time.time() - t1) * 1e3)
        counts = {k: fn.launches for k, fn in counters.items()}
        _expect(counts, {**none, **want}, f"int8 {name}")
        for k in total:
            total[k] += counts[k]
        for d in outs:
            if not (torch.isfinite(d.boxes3d).all()
                    and torch.isfinite(d.probs).all()):
                raise AssertionError(f"int8 {name}: non-finite detections")
        float_model = MV3D(with_model(c, quant="none"), device=dev, seed=0)
        share, n_float, dprob = detections_agree(
            [float_model.predict_from_points(*r, THRESH) for r in requests],
            outs)
        del float_model
        log(f"phase int8: {name} (int8): 3 requests of B=2 at full KITTI "
            f"width, kernel launches {counts}; wall ms per request "
            + ", ".join(f"{t:.1f}" for t in times)
            + f" (the first with its first-call set-up); peak allocated "
            f"{_peak_mib():.0f} MiB; live detections "
            f"{[int(d.mask.sum()) for d in outs]}; of the bf16 model's "
            f"{n_float} live detections {share:.3f} found by the int8 model "
            f"(corners within 0.5 m; mean |prob diff| {dprob:.4f}) [{card}]")
        if name != "hwc":
            del model

    art = export_artifact(work_dir, "artifact_int8", 2,
                          extra=("--set", "model.quant", "int8"))
    pts = make_cloud(rng, 2, cfg.pipeline.max_points, cfg, tricky=False)
    rgb = rng.rand(2, *cfg.rgb_shape).astype(np.float32)
    served = load_serving(art, device=dev)
    if served.cfg.model.quant != "int8":
        raise AssertionError("the int8 artifact's config lost quant='int8'")
    with LocalServer(art) as server:
        for fn in counters.values():
            fn.launches = 0
        with np.load(io.BytesIO(http_post(server.port, npz_body(
                points_0=pts[0], rgb_0=rgb[0], points_1=pts[1],
                rgb_1=rgb[1])))) as z:
            answer = [(z[f"boxes3d_{i}"], z[f"probs_{i}"]) for i in range(2)]
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
    _expect(counts, {**none, "sort_radix": 1, "voxelize_sweep": 1},
            "int8 artifact over HTTP")
    for k in total:
        total[k] += counts[k]
    want = served.predict_batch([(pts[0], rgb[0]), (pts[1], rgb[1])])
    for (gb, gp), (wb, wp) in zip(answer, want):
        if not (np.array_equal(gb, wb) and np.array_equal(gp, wp)):
            raise AssertionError("int8 artifact: HTTP answer differs from "
                                 "in-process predict_batch")
    log(f"phase int8: artifact (B=2, pallas-sort, quant=int8) exported by "
        f"the CLI and served over HTTP: a two-frame request, kernel "
        f"launches {counts}, live detections {[len(p) for _, p in answer]},"
        f" bit-equal to in-process predict_batch")
    del served
    small_reference(rng, dev, small=with_model(_small_config(),
                                               quant="int8"),
                    label="int8 ")
    return total, hwc


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_state(tr):
    """A trainer's subnets' state dicts and Adam's moments, on the CPU,
    by ``subnet.parameter``."""
    state = {f"{n}.{k}": v.detach().cpu().clone()
             for n, m in tr.model.subnets.items()
             for k, v in m.state_dict().items()}
    adam = {}
    for name, module in tr.model.subnets.items():
        for pname, p in module.named_parameters():
            st = tr.optimizer.state.get(p)
            if st:
                adam[f"{name}.{pname}"] = {k: v.detach().cpu().clone()
                                           for k, v in st.items()}
    return state, adam


def rgb_corners(targets, cfg):
    """The rgb ROI corners of a step's fusion targets, on the CPU."""
    from mv3d_tpu_torch.models.mv3d_net import project_to_rgb_roi
    return project_to_rgb_roi(targets[1].rois3d.detach(), cfg).cpu()


def compare_steps(got, want, lr: float, label: str, corners):
    """One RPN-stage training step's (losses, state, Adam moments) against
    a reference's. ``corners`` is (got, want) of the fusion targets' rgb
    ROI corners, (B, R, 4) each: an rgb ROI corner is an int truncation
    of a proposal, which the two BatchNorm computations' last bits can
    move by a pixel, and a moved corner changes that ROI's pooled rgb
    features (see ``small_train_reference``).

    Tolerances: RPN losses rtol 1e-5, the fusion losses rtol 1e-4 (1e-2
    where a corner moved); BatchNorm statistics rtol 1e-4 and atol 1e-5 of
    the tensor's magnitude (at least 1), the fusion head's too where no
    corner moved, and where some did, atol 1e-5 + 4 f of the magnitude,
    f the share of the ROIs whose corners moved (each moved ROI shifts a
    statistic over all ROIs by at most its share of the features' range);
    Adam's moments within 1e-4 relative L2 per tensor (the RPN's
    gradients do not reach through the fusion head); parameters within
    2.1 lr, and where the gradient's sign is sure (|m| > 1e-3 of the
    tensor's max) within 0.1 lr but for at most 1e-3 of them. Returns a
    summary."""
    import torch
    (gl, gs, ga), (wl, ws, wa) = got, want
    moved_rois = (corners[0] != corners[1]).any(-1)
    share = moved_rois.float().mean().item()
    worst = {"loss": 0.0, "stat": 0.0, "fusion stat": 0.0, "moment": 0.0}
    for k, w in wl.items():
        e = abs(gl[k] - w) / max(abs(w), 1e-30)
        worst["loss"] = max(worst["loss"], e)
        tol = 1e-5 if k.startswith("top") else (1e-2 if share else 1e-4)
        if not e <= tol:
            raise AssertionError(f"{label}: {k} {gl[k]} vs {w}")
    n_sure = n_apart = 0
    for k, w in ws.items():
        g = gs[k]
        if k.endswith(("running_mean", "running_var")):
            fusion = k.startswith("fusion.")
            mag = max(1.0, w.abs().max().item())
            tol = (1e-5 + (4 * share if fusion else 0.0)) * mag
            e = ((g - w).abs() - 1e-4 * w.abs()).max().item()
            key = "fusion stat" if fusion else "stat"
            worst[key] = max(worst[key], (g - w).abs().max().item() / mag)
            if not e <= tol:
                raise AssertionError(f"{label}: statistic {k} differs")
        elif k in wa:
            m = wa[k]["exp_avg"]
            sure = m.abs() > 1e-3 * m.abs().max()
            if not (g - w).abs().max().item() <= 2.1 * lr:
                raise AssertionError(f"{label}: parameter {k} differs")
            n_apart += int((((g - w).abs() > 0.1 * lr + 2.4e-7 * w.abs())
                            & sure).sum())
            n_sure += int(sure.sum())
            for mk in ("exp_avg", "exp_avg_sq"):
                rel = ((ga[k][mk] - wa[k][mk]).norm()
                       / wa[k][mk].norm().clamp(min=1e-30)).item()
                worst["moment"] = max(worst["moment"], rel)
                if not rel < 1e-4:
                    raise AssertionError(f"{label}: Adam {mk} of {k} "
                                         f"differs by {rel}")
        elif not k.endswith("num_batches_tracked"):
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: {k} differs")
    if not n_apart <= 1e-3 * n_sure:
        raise AssertionError(f"{label}: {n_apart} of {n_sure} parameters "
                             f"apart")
    return (f"losses {' '.join(f'{k} {v:.6g}' for k, v in gl.items())}, "
            f"rel diff at most {worst['loss']:.2g}; rgb ROI corners moved "
            f"in {int(moved_rois.sum())} of {moved_rois.numel()} ROIs; "
            f"statistics max |diff| / magnitude: RPN and trunks "
            f"{worst['stat']:.3g}, fusion head {worst['fusion stat']:.3g}; "
            f"Adam moments rel L2 {worst['moment']:.3g} (tol 1e-4), "
            f"parameters apart by more than 0.1 lr {n_apart} of {n_sure}")


PARALLEL_LR = 1e-3


def small_train_config():
    """The small f32 config with the JAX trainer's host aux plane and
    heights kernel (K3 on every step)."""
    return with_pipeline(_small_config(), host_aux_channels=True,
                         use_pallas_heights=True)


def gloo_step_worker(rank, world, init, batch_path, out_dir, device):
    """One process of the two that share the card (``device``) over gloo
    (the port's groups take NCCL on the card; gloo is joined here
    directly): the small f32 model's sharded training step at 2 x 1
    frames; writes its losses, state, Adam moments, rgb ROI corners and
    K3 launches."""
    import pickle
    import torch
    from mv3d_tpu_torch.ops import voxelize_heights as vh
    from mv3d_tpu_torch.parallel import mesh as pm
    from mv3d_tpu_torch.train.trainer import Trainer
    with open(batch_path, "rb") as f:
        batch = pickle.load(f)
    torch.backends.cudnn.allow_tf32 = False      # as main() sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device, 0)
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group("gloo", init_method=init,
                                         rank=rank, world_size=world)
    mesh = pm.make_mesh(devices=dev)
    tr = Trainer(None, cfg=small_train_config(), device=dev, seed=1,
                 lr=PARALLEL_LR, train_targets=("top_view_rpn",),
                 checkpoint_dir=os.path.join(out_dir, f"ck{rank}"),
                 log_dir=os.path.join(out_dir, f"log{rank}"))
    pm.replicate(tr.model, mesh)
    step = pm.make_sharded_train_step(
        tr.model, tr.optimizer, tr.train_targets, mesh,
        schedule=tr.schedule)
    vh.scatter_max_batched.launches = 0
    losses = step(pm.shard_batch(batch, mesh),
                  torch.Generator().manual_seed(2))
    launches = vh.scatter_max_batched.launches
    torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((losses, *train_state(tr), launches,
                     rgb_corners(step.last_targets, tr.cfg)), f)


def parallel_phase(rng, dev, work_dir, counters, requests, card,
                   profile_dir=None):
    """Phase ``parallel``: ``mv3d_tpu_torch.parallel.mesh`` on the card.

    A one-rank NCCL group (a second NCCL rank needs a second card): the
    small f32 model's sharded training step of the RPN stage (hwc with
    the host plane, K3; every subnet runs in train mode)
    against ``Trainer.fit_iteration`` on the same batch and draws;
    sharded training steps at full KITTI width in hwc with the host plane
    (2, K3 each) and in the s2d2p serving configuration (1, K2) with
    their wall ms and peak memory (with ``profile_dir``, torch.profiler
    over 2 more hwc steps); sharded inference of 3 requests of B=2
    in hwc (K1), at "pallas-sort" (K4 + K1) and int8 (K1), each bit-equal
    to ``predict_from_points``; a ``"dcp"`` checkpoint saved and restored
    bit-equal. Then two processes sharing the card over gloo (which takes
    CUDA tensors for all-reduce and broadcast, all the step needs) run the
    small model's sharded step at 2 x 1 frames, held against the one-rank
    ``Trainer`` step at B=2 (``compare_steps``). Returns {kernel:
    launches} of the one-rank paths."""
    import multiprocessing
    import pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    from mv3d_tpu_torch import kitti_config, serving_config
    from mv3d_tpu_torch.data.loader import BatchLoader, frames_to_batch
    from mv3d_tpu_torch.parallel import mesh as pm
    from mv3d_tpu_torch.train.checkpoint import SubnetCheckpointer
    from mv3d_tpu_torch.train.trainer import MV3D, Trainer
    total = {k: 0 for k in counters}
    none = {k: 0 for k in counters}

    def counted(fn, want, label):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        _expect(counts, {**none, **want}, label)
        for k in total:
            total[k] += counts[k]
        return out, counts

    t0 = time.time()
    pm.init_process_group(dev, 0, 1, f"tcp://localhost:{free_port()}")
    try:
        mesh = pm.make_mesh()
        small = small_train_config()
        batch = frames_to_batch(SynthDrive(rng, small, 2, 8000,
                                           cars=(2, 3)).frames, small)
        batch = {k: v for k, v in batch.items() if k != "tags"}
        kw = dict(cfg=small, device=dev, seed=1, lr=PARALLEL_LR,
                  train_targets=("top_view_rpn",),
                  checkpoint_dir=os.path.join(work_dir, "ck"),
                  log_dir=os.path.join(work_dir, "log"))
        ref = Trainer(None, log_tag="ref", **kw)
        want = (ref.fit_iteration(batch), *train_state(ref))
        tr = Trainer(None, log_tag="sharded", **kw)
        step = pm.make_sharded_train_step(
            tr.model, tr.optimizer, tr.train_targets, mesh,
            schedule=tr.schedule)
        losses, _ = counted(lambda: step(batch, tr.generator),
                            {"voxelize_heights": 1},
                            "one-rank sharded step (small)")
        want_corners = rgb_corners(ref.last_targets, small)
        summary = compare_steps(
            (losses, *train_state(tr)), want, PARALLEL_LR,
            "one-rank NCCL step", (rgb_corners(step.last_targets, small),
                                   want_corners))
        log(f"phase parallel: one-rank NCCL group, the small f32 model's "
            f"sharded step (the RPN stage, hwc with the host plane; "
            f"voxelize_heights 1) against Trainer.fit_iteration on the same "
            f"batch and draws: {summary}")
        ck = SubnetCheckpointer("fusion", os.path.join(work_dir, "dcp"),
                                backend="dcp")
        saved = tr.get_variables()["fusion"]
        ck.save(saved, step=1)
        loaded = ck.load()

        def leaves(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from leaves(v, f"{prefix}{k}/")
                else:
                    yield prefix + k, np.asarray(v)

        got = dict(leaves(loaded))
        if not (got.keys() == dict(leaves(saved)).keys() and all(
                np.array_equal(got[k], v) for k, v in leaves(saved))):
            raise AssertionError("dcp checkpoint round trip differs")
        log(f"phase parallel: \"dcp\" checkpoint of the fusion subnet "
            f"({len(got)} arrays) saved and restored over the NCCL group "
            f"bit-equal")
        del ref, tr, step

        cfg = kitti_config()
        train_cfg = with_pipeline(cfg, host_aux_channels=True,
                                  use_pallas_heights=True)
        drive = SynthDrive(rng, cfg, 4, 110000)
        with BatchLoader(drive, train_cfg, batch_size=2, seed=0) as loader:
            for label, c, n, want_k in (
                    ("hwc, host plane", train_cfg, 2,
                     {"voxelize_heights": 1}),
                    ("s2d2p", with_pipeline(serving_config(cfg),
                                            host_aux_channels=False), 1,
                     {"voxelize_padded": 1})):
                torch.cuda.reset_peak_memory_stats()
                tr = Trainer(None, cfg=c, device=dev, seed=0,
                             checkpoint_dir=os.path.join(work_dir, "ck"),
                             log_dir=os.path.join(work_dir, "log"))
                step = pm.make_sharded_train_step(
                    tr.model, tr.optimizer, tr.train_targets, mesh,
                    schedule=tr.schedule)
                times = []
                for _ in range(n):
                    b = loader.load()
                    if c.pipeline.view_layout == "s2d2p":
                        b.pop("top_aux", None)
                    t1 = time.time()
                    losses, _ = counted(lambda: step(b, tr.generator),
                                        want_k, f"sharded step {label}")
                    times.append((time.time() - t1) * 1e3)
                    if not np.isfinite(list(losses.values())).all():
                        raise AssertionError(f"sharded step {label}: "
                                             f"losses {losses}")
                if profile_dir and n > 1:
                    profile_calls(lambda i: step(loader.load(), tr.generator),
                                  2, "sharded train step B=2 hwc",
                                  times[-1] / 1e3, profile_dir, card)
                log(f"phase parallel: one-rank sharded training step at "
                    f"full KITTI width, B=2, {label}: {n} step"
                    f"{'s' if n > 1 else ''}, wall ms "
                    + ", ".join(f"{t:.1f}" for t in times)
                    + " (the first with its first-call set-up); losses "
                    + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
                    + f"; peak allocated {_peak_mib():.0f} MiB [{card}]")
                del tr, step

        serve_cfg = with_pipeline(cfg, use_pallas_fused=True)
        for label, c, want_k in (
                ("hwc", serve_cfg, {"voxelize_sweep": 3}),
                ("hwc at pallas-sort", with_pipeline(
                    serve_cfg, voxel_order="pallas-sort"),
                 {"sort_radix": 3, "voxelize_sweep": 3}),
                ("hwc int8", with_model(serve_cfg, quant="int8"),
                 {"voxelize_sweep": 3})):
            model = MV3D(c, device=dev, seed=0)
            infer = pm.make_sharded_infer_step(model.model, mesh, THRESH)
            outs, counts = counted(
                lambda: [infer(p, r, n) for p, n, r in requests], want_k,
                f"sharded inference {label}")
            for (p, n, r), got in zip(requests, outs):
                ref = model.predict_from_points(p, n, r, THRESH)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"sharded inference {label} "
                                         f"differs from predict_from_points")
            log(f"phase parallel: one-rank sharded inference {label}, 3 "
                f"requests of B=2: kernel launches {counts}, bit-equal to "
                f"predict_from_points (live detections "
                f"{[int(d.mask.sum()) for d in outs]})")
            del model, infer
    finally:
        dist.destroy_process_group()

    # two processes on the one card over gloo
    t1 = time.time()
    batch_path = os.path.join(work_dir, "batch.pkl")
    with open(batch_path, "wb") as f:
        pickle.dump(batch, f)
    ctx = multiprocessing.get_context("spawn")
    init = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=gloo_step_worker,
                         args=(r, 2, init, batch_path, work_dir, dev.type))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + 300
    for p in procs:
        p.join(max(deadline - time.time(), 1.0))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if hung or [p.exitcode for p in procs] != [0, 0]:
        raise AssertionError(f"two-process gloo step: hung {hung}, exit "
                             f"codes {[p.exitcode for p in procs]}")
    res = []
    for r in range(2):
        with open(os.path.join(work_dir, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    if res[0][0] != res[1][0] or not all(
            torch.equal(v, res[1][1][k]) for k, v in res[0][1].items()):
        raise AssertionError("two-process gloo step: the ranks differ")
    summary = compare_steps(res[0][:3], want, PARALLEL_LR,
                            "two-process gloo step",
                            (torch.cat([r[4] for r in res]), want_corners))
    log(f"phase parallel: two processes on the one card over gloo, the "
        f"small f32 model's sharded step at 2 x 1 frames against the "
        f"one-process Trainer step at B=2: {summary}; the ranks bit-equal; "
        f"voxelize_heights {res[0][3]} and {res[1][3]} "
        f"({time.time() - t1:.1f} s; the phase {time.time() - t0:.1f} s)")
    return total


def step_windows(step, label, card, b=2):
    """TRAIN_WARMUP_STEPS calls of ``step(i)``, then three windows of
    TRAIN_WINDOW_STEPS: ms/step and frames/s per window, then the median
    and range. Returns the median ms/step."""
    import numpy as np
    import torch
    for i in range(TRAIN_WARMUP_STEPS):
        step(i)
    torch.cuda.synchronize()
    step_ms = []
    for w in range(3):
        t0 = time.perf_counter()
        for i in range(TRAIN_WINDOW_STEPS):
            step(i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) / TRAIN_WINDOW_STEPS * 1e3)
        log(f"phase timing: {label} window {w + 1}/3: {step_ms[-1]:.1f} "
            f"ms/step, {b * 1e3 / step_ms[-1]:.2f} frames/s [{card}]")
    med = float(np.median(step_ms))
    log(f"phase timing: {label}: {med:.1f} ms/step, {b * 1e3 / med:.2f} "
        f"frames/s, median of 3 windows of {TRAIN_WINDOW_STEPS} steps "
        f"(range {min(step_ms):.1f}-{max(step_ms):.1f} ms/step) [{card}]")
    return med


def loader_timing(data_dir, cfg, label, card):
    """The disk loader alone: frames/s of ``BatchLoader`` (B=2, 8
    batches counted from its construction) at 1, 2 and 4 workers, one
    thread's ms per frame by stage over the directory's frames, and how
    much each stage on another thread slows the main thread's op
    dispatch (``loader_interference``)."""
    import numpy as np
    from mv3d_tpu_torch.data import host_aux
    from mv3d_tpu_torch.data.kitti import (KittiObjectDataset,
                                           kitti_label_to_lidar_box3d,
                                           read_image, read_velodyne)
    from mv3d_tpu_torch.data.loader import (BatchLoader, frames_to_batch,
                                            prepare_rgb)
    ds = KittiObjectDataset(data_dir, cfg=cfg)
    rates = []
    for workers in (1, 2, 4):
        t0 = time.perf_counter()
        with BatchLoader(ds, cfg, batch_size=2, workers=workers) as bl:
            for _ in range(8):
                bl.load()
            rates.append(16 / (time.perf_counter() - t0))
    stages = {k: [] for k in ("velodyne", "label", "png decode", "resize",
                              "crop and pad", "aux plane")}
    png0 = ds._p("image_2", ds.tags[0], ".png")
    pts0 = read_velodyne(ds._p("velodyne", ds.tags[0], ".bin"))
    img0 = read_image(png0)
    loops = {"png decode": lambda: read_image(png0),
             "resize": lambda: prepare_rgb(img0, cfg),
             "crop and pad": lambda: host_aux.crop_pad(
                 pts0, cfg.pipeline.max_points, cfg),
             "whole frame": lambda: frames_to_batch([ds.load_frame(0)], cfg)}
    if cfg.pipeline.host_aux_channels:
        loops["aux plane"] = lambda: host_aux.lidar_to_top_aux(
            host_aux.crop_pad(pts0, cfg.pipeline.max_points, cfg)[0], cfg)
    for tag in ds.tags:
        t = [time.perf_counter()]
        pts = read_velodyne(ds._p("velodyne", tag, ".bin"))
        t.append(time.perf_counter())
        with open(ds._p("label_2", tag, ".txt")) as f:
            kitti_label_to_lidar_box3d(f.readlines(), positive_only=False,
                                       cfg=cfg)
        t.append(time.perf_counter())
        img = read_image(ds._p("image_2", tag, ".png"))
        t.append(time.perf_counter())
        prepare_rgb(img, cfg)
        t.append(time.perf_counter())
        padded, k = host_aux.crop_pad(pts, cfg.pipeline.max_points, cfg)
        t.append(time.perf_counter())
        if cfg.pipeline.host_aux_channels:
            host_aux.lidar_to_top_aux(padded[:k], cfg)
        t.append(time.perf_counter())
        for name, a, b in zip(stages, t, t[1:]):
            stages[name].append(b - a)
    log(f"phase timing: disk loader alone, {label} (B=2, 8 batches from "
        f"construction): " + ", ".join(
            f"{w} worker{'s' * (w > 1)} {r:.1f} frames/s"
            for w, r in zip((1, 2, 4), rates))
        + "; one thread's ms/frame by stage: " + ", ".join(
            f"{k} {np.mean(v) * 1e3:.1f}" for k, v in stages.items()
            if k != "aux plane" or cfg.pipeline.host_aux_channels)
        + f" [{card}]")
    loader_interference(loops, label, card)


def host_op_rate(seconds: float = 1.0) -> float:
    """Tiny CPU tensor ops a second on this thread: a stand-in for the
    training step's host work, which dispatches one op after another."""
    import torch
    x = torch.zeros(64, 64)
    n, end = 0, time.perf_counter() + seconds
    while time.perf_counter() < end:
        x = x + 1
        n += 1
    return n / seconds


def loader_interference(stages, label, card):
    """How much each loader stage, looped on one other thread, slows the
    main thread's op dispatch (``host_op_rate``): the share of the
    interpreter lock and of the core a loader worker takes from the
    training step's host side."""
    import threading
    alone = host_op_rate()
    out = []
    for name, fn in stages.items():
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                fn()

        worker = threading.Thread(target=loop)
        worker.start()
        time.sleep(0.05)
        out.append((name, host_op_rate() / alone))
        stop.set()
        worker.join()
    log(f"phase timing: disk loader, {label}: the main thread's op rate "
        f"beside one thread looping each stage, relative to alone "
        f"({alone:.0f} ops/s): " + ", ".join(f"{k} {v:.2f}" for k, v in out)
        + f" [{card}]")


def train_command_timing(data_dir, cfg, dev, work_dir, card, profile_dir):
    """The training step at B=2 fed by the disk loader (4 workers; s2d2p
    also 1 and 2) and by three batches held in memory, in the served
    s2d2p configuration and in hwc with the host aux plane; the loader
    alone; with ``profile_dir`` each disk-fed step under
    torch.profiler."""
    from mv3d_tpu_torch import serving_config
    from mv3d_tpu_torch.data.kitti import KittiObjectDataset
    from mv3d_tpu_torch.data.loader import BatchLoader
    from mv3d_tpu_torch.train.trainer import Trainer
    served = serving_config(cfg)
    served = dataclasses.replace(served, pipeline=dataclasses.replace(
        served.pipeline, host_aux_channels=False))
    split = os.path.join(data_dir, "ImageSets", "train.txt")
    for label, c in (("s2d2p", served), ("hwc", cfg)):
        ds = KittiObjectDataset(data_dir, split_file=split, cfg=c)
        tr = Trainer(None, cfg=c, device=dev, log_tag="timing_" + label,
                     checkpoint_dir=os.path.join(work_dir, "ckpt"),
                     log_dir=os.path.join(work_dir, "log_timing"))
        for workers in ((1, 2) if label == "s2d2p" else ()):
            with BatchLoader(ds, c, batch_size=2, workers=workers) as loader:
                step_windows(lambda i: tr.fit_iteration(loader.load()),
                             f"train {label} B=2 from disk ({workers} loader "
                             f"worker{'s' * (workers > 1)})", card)
        with BatchLoader(ds, c, batch_size=2, workers=4) as loader:
            med = step_windows(lambda i: tr.fit_iteration(loader.load()),
                               f"train {label} B=2 from disk (4 loader "
                               f"workers)", card)
            if profile_dir:
                busy = profile_calls(lambda i: tr.fit_iteration(
                    loader.load()), 3, f"train {label} B=2 step from disk",
                    med / 1e3, profile_dir, card)
            held = [loader.load() for _ in range(3)]
        mem = step_windows(lambda i: tr.fit_iteration(held[i % 3]),
                           f"train {label} B=2 from memory", card)
        if profile_dir:
            log(f"phase profile: train {label} B=2: idle share "
                f"{1 - busy / mem:.2f} of the memory-fed step's median "
                f"{mem:.1f} ms [{card}]")
        tr.close()
        del tr, held
    for label, c in (("s2d2p", served), ("hwc", cfg)):
        loader_timing(data_dir, c, label, card)


def kernel_bounds(b, n_points, n_cells, zn, n_sc):
    """Least card time (ms) of each kernel's work at batch ``b``: its bytes
    (each input read once, each output written once) over the HBM rate;
    the work is a few integer ops per byte, far below the card's peak
    rate, so bytes bound both. K1 at f32 heights (``voxelize_sweep``) and
    at bf16 heights (``voxelize_sweep_bf16``); K2 at the serving path's
    bf16 heights (``voxelize_padded``) and with f32 heights
    (``voxelize_padded_f32``). K4 (``sort_radix``) reads and writes an
    i32 key and two f32 payloads per point; on rows of ``2 * n_points``,
    the length the long-row route is timed at, a whole sort and one merge
    pass alike move the row once each way (``sort_merge``). No bound
    counts the digit passes or merges, which no sort can reach."""
    n_flat = n_cells * zn

    def sweep_bytes(h_bytes):
        return b * (n_points * 12 + n_flat * h_bytes + n_cells * 8)

    heights_bytes = b * (n_points * 8 + n_flat * 4)
    sort_bytes = b * n_points * 12 * 2

    def padded_bytes(h_bytes):
        return b * (n_points * 12 + n_sc * 128 * h_bytes + n_sc * 4 * 8)

    return {name: nbytes / HBM_BYTES_PER_S * 1e3 for name, nbytes in (
        ("voxelize_sweep", sweep_bytes(4)),
        ("voxelize_sweep_bf16", sweep_bytes(2)),
        ("voxelize_heights", heights_bytes),
        ("voxelize_padded", padded_bytes(2)),
        ("voxelize_padded_f32", padded_bytes(4)),
        ("sort_radix", sort_bytes), ("sort_merge", 2 * sort_bytes))}


def device_ms(fn, iters: int = 50):
    """Device time per call of ``fn`` in ms, the host's share left out:
    a spin kernel (``torch.cuda._sleep``) holds the stream while ``iters``
    calls are enqueued behind it, so they run back to back; CUDA events
    time them from the spin's end. The spin is made longer than the
    enqueue (measured first), and the run is taken again with a longer
    spin, up to three times, while the host took longer than the spin;
    None (not measured) after that."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 5 * iters
    torch.cuda.synchronize()
    spin_ms = 2 * enqueue_ms + 5.0
    for _ in range(3):
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < spin_ms:
            return start.elapsed_time(end) / iters
        spin_ms *= 4
    return None


def kernel_split(fn, iters: int = 50) -> dict:
    """{kernel name: device ms per call} of ``fn`` from torch.profiler:
    the trace with the most device records of three (the profiler now
    and then drops some or all of a short trace's records), or {} where
    even that one lost some (a count that is no whole multiple of
    ``iters``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [(e.name.replace("(anonymous namespace)::", "").split("(")[0],
                  e.time_range.end - e.time_range.start)
                 for e in prof.events() if e.device_type.name == "CUDA"]
        if len(spans) > len(best):
            best = spans
    if not best or len(best) % iters:
        return {}
    per = {}
    for name, us in best:
        per[name] = per.get(name, 0.0) + us / 1e3 / iters
    return per


def us_text(ms) -> str:
    """A time in ms as us, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


def host_us(fn, iters: int = 200) -> float:
    """Host time per call of ``fn`` in us: ``time.perf_counter`` over
    ``iters`` calls without a synchronize (what the calling thread pays
    to enqueue), after warm-up."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def host_breakdown(inputs, n_cells, zn, card):
    """Where the host's time of one K1 call goes at B=1 (``host_us`` of
    each piece): the whole wrapper; its input checks and ``contiguous``;
    the four ``torch.empty``; entering and leaving ``torch.cuda.device``
    (skipped where the device is current); the stream looked up through
    ``torch.cuda.current_stream`` and through the raw handle the wrapper
    uses; the ctypes call and its five enqueued operations are the rest."""
    import torch
    from mv3d_tpu_torch.ops import cuda_build
    from mv3d_tpu_torch.ops import voxelize_sweep as sweep
    f, v, r = inputs
    dev = f.device
    bsz, n = f.shape
    tile, n_tiles, _ = sweep.tile_plan(bsz * n_cells, zn)

    def allocs():
        return (torch.empty(bsz, n_cells * zn, device=dev),
                torch.empty(bsz, n_cells, device=dev),
                torch.empty(bsz, n_cells, device=dev),
                torch.empty(2 * n_tiles + 1 + 2 * bsz * n,
                            dtype=torch.int32, device=dev))

    def checks():
        sweep.check_inputs(f, v, r)
        return [t.contiguous() for t in (f, v, r)]

    def context():
        with torch.cuda.device(dev):
            pass

    parts = {"whole call": host_us(lambda: sweep.scatter_top_fused_kernel(
                 f, v, r, n_cells, zn)),
             "checks + contiguous": host_us(checks),
             "4 x torch.empty": host_us(allocs),
             "torch.cuda.device context": host_us(context),
             "torch.cuda.current_stream": host_us(
                 lambda: torch.cuda.current_stream(dev).cuda_stream),
             "raw stream handle": host_us(
                 lambda: cuda_build._raw_stream(dev.index or 0))
             if cuda_build._raw_stream is not None else 0.0}
    rest = parts["whole call"] - sum(
        parts[k] for k in ("checks + contiguous", "4 x torch.empty",
                           "raw stream handle"))
    log("phase timing: voxelize_sweep B=1 host time per call (us): "
        + ", ".join(f"{k} {t:.2f}" for k, t in parts.items())
        + f"; the ctypes call with its enqueues and the rest {rest:.2f} "
        f"[{card}]")


def sort_library(key, p1, p2):
    """K4's function as one PyTorch call: ``torch.sort(stable=True)`` and
    two gathers (timed beside the kernel; the port never calls it)."""
    import torch
    skey, order = torch.sort(key, dim=-1, stable=True)
    return skey, torch.gather(p1, -1, order), torch.gather(p2, -1, order)


def sort_cases(rng, b, n):
    """K4's hard inputs: (B, n) int32 keys whose radix sort needs 0 to 4
    digit passes: all equal (0; stability alone decides the order), heavy
    ties in one byte (values in [0, 16): 1), [0, 4096) (2), voxel ids in
    [0, 12,000,000) as the path's (3) and negative with the int32
    extremes (4); and ties across runs (1 pass): the first half of a row
    from {0, 5, 10}, the second from {5, 10, 15}, so every merge of two
    runs meets equal keys on both sides. Each with two f32 payloads."""
    import numpy as np
    neg = rng.randint(-1000, 1000, (b, n))
    neg[:, :4] = np.array([-2 ** 31, 2 ** 31 - 1, -1, 0])[:n]
    runs = 5 * rng.randint(0, 3, (b, n))
    runs[:, n // 2:] += 5
    keys = {"equal": np.full((b, n), 7), "ties": rng.randint(0, 16, (b, n)),
            "wide": rng.randint(0, 4096, (b, n)),
            "voxel": rng.randint(0, 12_000_000, (b, n)), "negative": neg,
            "runs": runs}
    return {kind: (k.astype(np.int32), rng.rand(b, n).astype(np.float32),
                   rng.rand(b, n).astype(np.float32))
            for kind, k in keys.items()}


def merge_passes(n):
    """Merge launches K4 makes for a row of ``n``: 0 up to the radix
    capacity (65,536), then one per doubling."""
    return max(0, (n // 65536).bit_length() - 1)


def check_sort(key, p1, p2, dev, label):
    """K4 on the card against its plain radix twin on the card and on the
    CPU and against ``sort_library``: sorted keys and payloads bit-equal;
    one radix launch and ``merge_passes(n)`` merge launches. Takes CPU
    arrays or tensors; returns max |kernel - plain| (0)."""
    import torch
    from mv3d_tpu_torch.ops import sort_bitonic as sb
    cpu = [torch.as_tensor(x) for x in (key, p1, p2)]
    want = sb.bitonic_sort_plain(*cpu)
    args = [x.to(dev) for x in cpu]
    before = (sb.bitonic_sort_batched.launches,
              sb.merge_pass_kernel.launches)
    got = sb.bitonic_sort_kernel(*args)
    ran = (sb.bitonic_sort_batched.launches - before[0],
           sb.merge_pass_kernel.launches - before[1])
    if ran != (1, merge_passes(cpu[0].shape[1])):
        raise AssertionError(f"sort kernel: radix and merge launches {ran} "
                             f"({label})")
    plain = sb.bitonic_sort_plain(*args)
    lib = sort_library(*args)
    torch.cuda.synchronize()
    for name, g, p, w, l in zip(("key", "p1", "p2"), got, plain, want, lib):
        if not (torch.equal(g, p) and torch.equal(g.cpu(), w)
                and torch.equal(g, l)):
            raise AssertionError(f"sort kernel {name} differs from its plain "
                                 f"twin or torch.sort ({label})")
    return max((g.double() - p.double()).abs().max().item()
               for g, p in zip(got, plain))


def sweep_cases(rng, b, n, n_cells, zn):
    """K1's skewed inputs, (B, n) int32 ``flat`` and f32 ``hval``/``refl``
    over ``n_cells`` cells of ``zn`` slices: every frame's points in one
    tile's span of cells (the second of the kernel's plan), all in one
    cell (qz ties, decided by the lowest index), all in the frame's last
    cells (the batch's last tile is partial where B * n_cells is no
    multiple of the tile) with a tenth of them padding, and all padding.
    Values lie in [0, 1), with many ties, as the quantizer's do."""
    import numpy as np
    from mv3d_tpu_torch.ops.voxelize_sweep import tile_plan
    tile = tile_plan(b * n_cells, zn)[0]
    n_flat = n_cells * zn

    def vals():
        return rng.choice(np.float32([0.0, 1e-3, 0.25, 0.5, 0.75]), (b, n))

    def cells_in(lo, hi):
        lo, hi = min(lo, n_cells - 1), min(hi, n_cells)
        return rng.randint(lo, max(hi, lo + 1), (b, n)) * zn \
            + rng.randint(0, zn, (b, n))

    tail = cells_in(n_cells - tile // 2, n_cells)
    tail[:, ::10] = n_flat + rng.randint(0, 1000, (b, (n + 9) // 10))
    cases = {
        "one tile": (cells_in(tile, 2 * tile), vals()),
        "one cell": ((n_cells // 2) * zn + rng.randint(0, 3, (b, n)),
                     rng.choice(np.float32([0.25, 0.5]), (b, n))),
        "last tile": (tail, vals()),
        "padding": (n_flat + rng.randint(0, 1000, (b, n)), vals()),
    }
    return {kind: (f.astype(np.int32), v.astype(np.float32),
                   rng.rand(b, n).astype(np.float32))
            for kind, (f, v) in cases.items()}


def check_sweep(cpu, dev, n_cells, zn, label):
    """K1 on the card against its plain version on the card and on the
    CPU, heights in f32 and bf16: bit-equal, one launch each. ``cpu`` is
    (flat, hval, refl) on the CPU. Returns (occupied cells, max |kernel -
    plain| (0))."""
    import torch
    from mv3d_tpu_torch.ops import voxelize_sweep as sweep
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        want = sweep.scatter_top_fused_plain(*cpu, n_cells, zn, dtype)
        args = (*(x.to(dev) for x in cpu), n_cells, zn, dtype)
        before = sweep.scatter_top_fused_batched.launches
        got = sweep.scatter_top_fused_kernel(*args)
        if sweep.scatter_top_fused_batched.launches != before + 1:
            raise AssertionError(f"sweep kernel: no launch counted ({label})")
        plain = sweep.scatter_top_fused_plain(*args)
        torch.cuda.synchronize()
        for name, g, p, w in zip(("heights", "count", "intensity"), got,
                                 plain, want):
            if not (g.dtype == p.dtype and torch.equal(g, p)
                    and torch.equal(g.cpu(), w)):
                raise AssertionError(f"sweep kernel {name} ({dtype}, "
                                     f"{label}) differs from its plain "
                                     f"version")
            err = max(err, (g.float() - p.float()).abs().max().item())
    return int((want[1] > 0).sum()), err


def check_sweep_cases(rng, dev, b, n, n_cells, zn):
    """K1 on ``sweep_cases`` (``check_sweep``, f32 and bf16 heights).
    Returns the kinds' occupied cells and the max |kernel - plain| (0)."""
    import torch
    occupied, err = {}, 0.0
    for kind, case in sweep_cases(rng, b, n, n_cells, zn).items():
        occupied[kind], e = check_sweep(
            [torch.from_numpy(x) for x in case], dev, n_cells, zn, kind)
        err = max(err, e)
    return occupied, err


def check_sort_then_sweep(flat, val, refl, n_cells, zn):
    """K1 on K4's output equals K1 on the unsorted points, bit for bit
    (the sort is stable, so equal ``flat`` keep their order and K1's
    lowest-index tie rule picks the same point)."""
    import torch
    from mv3d_tpu_torch.ops import sort_bitonic as sb
    from mv3d_tpu_torch.ops import voxelize_sweep as sweep
    ordered = sb.bitonic_sort_kernel(flat, val, refl)
    got = sweep.scatter_top_fused_kernel(*ordered, n_cells, zn)
    want = sweep.scatter_top_fused_kernel(flat, val, refl, n_cells, zn)
    torch.cuda.synchronize()
    for name, g, w in zip(("heights", "count", "intensity"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"sweep {name} after the sort differs from "
                                 f"the sweep of the unsorted points")
    return int((want[1] > 0).sum())


def check_padded_kernel(rng, cfg, dev, n_pts):
    """K2 against its plain version at the s2d2p path's shapes (B=2, tricky
    clouds), heights in f32 and bf16: bit-equal on the card and to the
    CPU. Returns the max |kernel - plain| (0)."""
    import torch
    from mv3d_tpu_torch.ops import voxelize as vox
    from mv3d_tpu_torch.ops import voxelize_padded as vp
    t = cfg.top
    n_sc = (t.xn // 2) * vox.folded_pad_width(t.yn)
    pts = torch.from_numpy(make_cloud(rng, 2, n_pts, cfg, tricky=True))
    _, _, flat, val, refl = vox._top_prep(pts, cfg, None, s2d="pad")
    refl = torch.where(flat < n_sc * 128, refl, 0.0)
    (occupied, slots), err = check_padded((flat, val, refl), dev, n_sc,
                                          t.zn, "path clouds")
    log(f"phase kernel-vs-plain: voxelize_padded B=2 N={n_pts} "
        f"n_sc={n_sc} heights f32 and bf16: heights/count/intensity "
        f"bit-equal to the plain version on the card and on the CPU "
        f"(occupied cells {occupied}, nonzero height slots {slots})")
    return err


def check_padded(cpu, dev, n_sc, zn, label):
    """K2 on the card against its plain version on the card and on the
    CPU, heights in f32 and bf16: bit-equal. ``cpu`` is (flat, hval,
    refl) on the CPU. Returns ((occupied cells, nonzero height slots),
    max |kernel - plain| (0))."""
    import torch
    from mv3d_tpu_torch.ops import voxelize_padded as vp
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        want = vp.scatter_top_padded_plain(*cpu, n_sc, zn, dtype)
        args = (*(x.to(dev) for x in cpu), n_sc, zn, dtype)
        got = vp.scatter_top_padded_kernel(*args)
        plain = vp.scatter_top_padded_plain(*args)
        torch.cuda.synchronize()
        for name, g, p, w in zip(("heights", "count", "intensity"), got,
                                 plain, want):
            if not (torch.equal(g, p) and torch.equal(g.cpu(), w)):
                raise AssertionError(f"lane-padded kernel {name} ({dtype}, "
                                     f"{label}) differs from its plain "
                                     f"version")
            err = max(err, (g.float() - p.float()).abs().max().item())
    return (int((want[1] > 0).sum()), int((want[0] > 0).sum())), err


def padded_cases(rng, b, n, n_sc, zn):
    """K2's skewed inputs, (B, n) int32 ``flat`` and f32 ``hval``/``refl``
    over ``n_sc`` supercells: all points in one tile of the kernel's plan
    (the second), all in one cell (qz ties, decided by the lowest index),
    all in the last (partial) tile with a tenth of them padding, and
    lanes uniform over all 128 (those >= 4*zn are padding). Values lie in
    [0, 1), with many ties, as the quantizer's do (it moves an exact slice
    boundary to the slice below with value 1, never to 0 above), so equal
    qz = s_eff + v means an equal slot."""
    import numpy as np
    from mv3d_tpu_torch.ops.voxelize_padded import LANES, tile_plan
    tile_sc, n_tiles, _ = tile_plan(n_sc)
    last = (n_tiles - 1) * tile_sc

    def lanes(size):
        sub = rng.randint(0, 4, size)
        return sub * zn + rng.randint(0, zn, size)

    def vals():
        return rng.choice(np.float32([0.0, 1e-3, 0.25, 0.5, 0.75]), (b, n))

    one_tile = rng.randint(tile_sc, min(2 * tile_sc, n_sc), (b, n))
    cell = (n_sc // 2) * LANES + zn + rng.randint(0, 3, (b, n))
    tail = rng.randint(last, n_sc, (b, n)) * LANES + lanes((b, n))
    tail[:, ::10] = n_sc * LANES + rng.randint(0, 1000, (b, (n + 9) // 10))
    cases = {
        "one tile": (one_tile * LANES + lanes((b, n)), vals()),
        "one cell": (cell, rng.choice(np.float32([0.25, 0.5]), (b, n))),
        "last tile": (tail, vals()),
        "pad lanes": (rng.randint(0, n_sc, (b, n)) * LANES
                      + rng.randint(0, LANES, (b, n)), vals()),
    }
    return {kind: (f.astype(np.int32), v.astype(np.float32),
                   rng.rand(b, n).astype(np.float32))
            for kind, (f, v) in cases.items()}


def check_padded_cases(rng, dev, b, n, n_sc, zn):
    """K2 on ``padded_cases`` against its plain version on the card and on
    the CPU, heights in f32 and bf16: bit-equal. Returns the kinds'
    occupied cells and the max |kernel - plain| (0)."""
    import torch
    occupied, err = {}, 0.0
    for kind, case in padded_cases(rng, b, n, n_sc, zn).items():
        (occupied[kind], _), e = check_padded(
            [torch.from_numpy(x) for x in case], dev, n_sc, zn, kind)
        err = max(err, e)
    return occupied, err


def check_folded_views(rng, cfg, dev, n_pts):
    """On the card, for one batch: the s2d2p pair (K2) and the s2d2 view
    (K1, folded numbering) equal the fold of the hwc view (K1) bit for
    bit, and their unfolded occupancy the hwc occupancy."""
    import torch
    from mv3d_tpu_torch.ops import voxelize as vox
    t = cfg.top
    pts = torch.from_numpy(make_cloud(rng, 2, n_pts, cfg, tricky=True)
                           ).to(dev)

    def with_layout(layout):
        return dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, view_layout=layout))

    top, occ = vox.lidar_to_top_batch(pts, with_layout("hwc"),
                                      return_occ=True)
    for layout, fold in (("s2d2p", vox.fold_view_s2d2p),
                         ("s2d2", vox.fold_view_s2d2)):
        ftop, focc = vox.lidar_to_top_batch(pts, with_layout(layout),
                                            return_occ=True)
        want = fold(top)
        same = (all(torch.equal(a, b) for a, b in zip(ftop, want))
                if layout == "s2d2p" else torch.equal(ftop, want))
        if not same:
            raise AssertionError(f"{layout} view differs from the folded "
                                 f"hwc view on the card")
        if not torch.equal(vox.unfold_occ4(focc, t.xn, t.yn), occ):
            raise AssertionError(f"{layout} occupancy differs from the hwc "
                                 f"occupancy on the card")
    torch.cuda.synchronize()
    log(f"phase folded-vs-standard: on the card, B=2 N={n_pts} "
        f"({cfg.pipeline.top_view_dtype} view): the s2d2p pair (K2) equals "
        f"fold_view_s2d2p of the hwc view (K1) and the s2d2 view (K1, "
        f"folded numbering) fold_view_s2d2 of it, bit for bit; unfolded "
        f"occupancies equal the hwc occupancy ({int((occ > 0).sum())} "
        f"occupied cells)")


def serve_requests(model, requests, counters, want, times=None):
    """Serve ``requests`` through ``model.predict_from_points`` with the
    kernels' counts set to 0 just before; check each detection batch and
    that each counter reads ``want[name]`` just after. Appends each
    request's wall ms (host clock, synchronized) to ``times`` where
    given. Returns the counts."""
    import torch
    for fn in counters.values():
        fn.launches = 0
    outs = []
    for p, n, r in requests:
        t0 = time.time()
        outs.append(model.predict_from_points(p, n, r, THRESH))
        torch.cuda.synchronize()
        if times is not None:
            times.append((time.time() - t0) * 1e3)
    counts = {name: fn.launches for name, fn in counters.items()}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want} for "
                             f"{len(requests)} requests")
    cfg = model.cfg
    for dets in outs:
        if tuple(dets.boxes3d.shape) != (2, cfg.rpn.nms_post_topn, 8, 3):
            raise AssertionError(f"boxes3d shape {tuple(dets.boxes3d.shape)}")
        if not (torch.isfinite(dets.boxes3d).all()
                and torch.isfinite(dets.probs).all()):
            raise AssertionError("non-finite detections")
    log(f"phase serve: {cfg.pipeline.view_layout} "
        f"({cfg.pipeline.top_view_dtype} view, {cfg.model.roi_align_impl} "
        f"ROI-align, voxel_order={cfg.pipeline.voxel_order}): "
        f"{len(requests)} requests of B=2 x {requests[0][0].shape[1]} points "
        f"at full {cfg.dataset_type} width, kernel launches {counts}, live "
        f"detections "
        f"{[int(d.mask.sum()) for d in outs]}")
    return counts


def check_top_view_card_vs_cpu(cfg, points, dev):
    """One frame's top view and occupancy on the card against the CPU's:
    bit-equal but density (1 f32 ulp of log; in a bf16 view 1 bf16 ulp)."""
    import torch
    from mv3d_tpu_torch.ops import voxelize as vox
    pts = torch.from_numpy(points[:1])
    top_c, occ_c = vox.lidar_to_top_batch(pts, cfg, return_occ=True)
    top_g, occ_g = vox.lidar_to_top_batch(pts.to(dev), cfg, return_occ=True)
    layout = cfg.pipeline.view_layout
    if layout == "s2d2p":
        exact = [(top_g[0], top_c[0]), (top_g[1][..., :4], top_c[1][..., :4])]
        dens = (top_g[1][..., 4:], top_c[1][..., 4:])
    else:
        zn = cfg.top.zn
        exact = [(top_g[..., :zn + 1], top_c[..., :zn + 1])]
        dens = (top_g[..., zn + 1], top_c[..., zn + 1])
    exact.append((occ_g, occ_c))
    if not all(torch.equal(g.cpu(), c) for g, c in exact):
        raise AssertionError(f"{layout} top view/occupancy on the card "
                             f"differ from the CPU plain path")
    g, c = dens[0].cpu().float(), dens[1].float()
    dens_err = (g - c).abs().max().item()
    ulp = 2.0 ** -8 if cfg.pipeline.top_view_dtype == "bfloat16" else 1e-6
    if dens_err > ulp:
        raise AssertionError(f"{layout} density differs by {dens_err}")
    log(f"phase top-view: {layout} card == CPU for one frame (heights, "
        f"intensity, occupancy bit-equal; density max |diff| "
        f"{dens_err:.3g}, tol {ulp:g})")


def serve_timing(model, label, rng, cfg, dev, n_pts, profile_dir, card,
                 sizes=(1, 8)):
    """Closed-loop serving windows of ``model.predict_from_points`` at each
    batch size of ``sizes`` (``timed_windows``), then, with
    ``profile_dir``, a torch.profiler pass of 5 requests each."""
    import torch
    for b in sizes:
        batches = [(torch.from_numpy(make_cloud(rng, b, n_pts, cfg, False)
                                     ).to(dev),
                    torch.full((b,), n_pts, dtype=torch.int32, device=dev),
                    torch.rand(b, *cfg.rgb_shape, device=dev))
                   for _ in range(4)]

        def call(i):
            model.predict_from_points(*batches[i % len(batches)], THRESH)

        median_s = timed_windows(call, label, b, card)
        if profile_dir:
            profile_calls(call, 5, f"serving {label} B={b}", median_s,
                          profile_dir, card)
        del batches


def npz_body(**arrays) -> bytes:
    """An uncompressed ``.npz`` request body."""
    import io
    import numpy as np
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def http_post(port: int, body: bytes, accept=None) -> bytes:
    """POST ``body`` to the local server's /predict; the response body."""
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=body, method="POST",
        headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def export_artifact(work_dir: str, name: str, batch_size: int,
                    quantized: bool = False, extra=()) -> str:
    """``python -m mv3d_tpu_torch.cli.export --random-init`` of the hwc
    serving configuration at ``voxel_order="pallas-sort"`` (KITTI preset,
    ``use_pallas_fused``; weights from seed 0; ``extra`` arguments, e.g.
    ``--set model.quant int8``) into ``work_dir/name``."""
    from mv3d_tpu_torch.cli import export as cli_export
    argv = ["--random-init", "--out", os.path.join(work_dir, name),
            "--checkpoint-dir", work_dir, "--batch-size", str(batch_size),
            "--score-threshold", str(THRESH),
            "--set", "pipeline.use_pallas_fused", "True",
            "--set", "pipeline.voxel_order", "pallas-sort", *extra]
    return cli_export.main(argv + (["--quantized"] if quantized else []))


class LocalServer:
    """``mv3d_tpu_torch.cli.serve.make_server`` over ``artifact`` on a free
    local port, served from a thread; stopped on leaving the block."""

    def __init__(self, artifact: str):
        import threading
        from mv3d_tpu_torch.cli.serve import make_server
        self.srv = make_server(artifact, port=0)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join()


def serve_http(rng, cfg, dev, work_dir, counters):
    """The HTTP path at full KITTI width: export the pallas-sort artifact at
    B=2 through the CLI and serve it; GET /healthz, POST a single-frame
    npz, a two-frame npz and a JSON request, and a malformed body (400),
    with the kernels' counts set to 0 just before and read just after
    (K4 and K1 once per request, K2 and K3 never). Then the answers must
    equal in-process ``ServingModel.predict_batch`` and the same weights
    at ``voxel_order="sort"`` bit for bit, with live detections; and a
    quantized artifact's answer its in-process call. Returns the counts."""
    import io
    import json
    import urllib.error
    import urllib.request
    import numpy as np
    import torch
    from mv3d_tpu_torch.serving import ServingModel, load_serving
    from mv3d_tpu_torch.train.trainer import MV3D

    t0 = time.time()
    art = export_artifact(work_dir, "artifact_b2", 2)
    pts = make_cloud(rng, 4, cfg.pipeline.max_points, cfg, tricky=False)
    rgb = rng.rand(4, *cfg.rgb_shape).astype(np.float32)
    frames = [[(pts[0], rgb[0])], [(pts[1], rgb[1]), (pts[2], rgb[2])],
              [(pts[3], rgb[3])]]
    single = npz_body(points=pts[0], rgb=rgb[0])
    with LocalServer(art) as server:
        for fn in counters.values():
            fn.launches = 0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/healthz", timeout=60) as r:
            meta = json.loads(r.read())
        with np.load(io.BytesIO(http_post(server.port, single))) as z:
            answers = [[(z["boxes3d"], z["probs"])]]
        with np.load(io.BytesIO(http_post(server.port, npz_body(
                points_0=pts[1], rgb_0=rgb[1], points_1=pts[2],
                rgb_1=rgb[2])))) as z:
            answers.append([(z[f"boxes3d_{i}"], z[f"probs_{i}"])
                            for i in range(2)])
        got = json.loads(http_post(server.port, npz_body(
            points=pts[3], rgb=rgb[3]), accept="application/json"))
        answers.append([(np.asarray(got["boxes3d"], np.float32).reshape(
            -1, 8, 3), np.asarray(got["probs"], np.float32))])
        try:
            http_post(server.port, b"not-an-npz")
            raise AssertionError("malformed body: expected HTTP 400")
        except urllib.error.HTTPError as e:
            if e.code != 400 or "error" not in json.loads(e.read()):
                raise AssertionError(f"malformed body: HTTP {e.code}")
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counters.items()}
    want = {"voxelize_sweep": 3, "voxelize_padded": 0,
            "voxelize_heights": 0, "sort_radix": 3, "sort_merge": 0}
    if counts != want:
        raise AssertionError(f"HTTP requests: kernel launches {counts}, "
                             f"expected {want}")
    if meta["status"] != "ok" or meta["batch_size"] != 2:
        raise AssertionError(f"healthz: {meta}")
    served = load_serving(art, device=dev)
    sort_cfg = dataclasses.replace(served.cfg, pipeline=dataclasses.replace(
        served.cfg.pipeline, voxel_order="sort"))
    by_sort = ServingModel(MV3D(sort_cfg, device=dev,
                                variables=served.model.get_variables()),
                           served.meta)
    for ref, what in ((served, "in-process predict_batch"),
                      (by_sort, "voxel_order='sort'")):
        for ans, fr in zip(answers, frames):
            for (gb, gp), (wb, wp) in zip(ans, ref.predict_batch(fr)):
                if not (np.array_equal(gb, wb) and np.array_equal(gp, wp)):
                    raise AssertionError(f"HTTP answer differs from {what}")
    live = [len(p) for ans in answers for _, p in ans]
    if not sum(live):
        raise AssertionError("HTTP requests: no live detection")
    log(f"phase serve-http: artifact (B=2, pallas-sort) exported by the "
        f"CLI and served over HTTP: healthz ok, a single-frame, a "
        f"two-frame and a JSON request, a malformed body -> 400; kernel "
        f"launches {counts}; live detections {live}, bit-equal to "
        f"in-process predict_batch and to voxel_order='sort' "
        f"({time.time() - t0:.1f} s)")
    del served, by_sort

    qart = export_artifact(work_dir, "artifact_q", 1, quantized=True)
    with LocalServer(qart) as server:
        with np.load(io.BytesIO(http_post(server.port, single))) as z:
            qb, qp = z["boxes3d"], z["probs"]
    wb, wp = load_serving(qart, device=dev).predict(pts[0], rgb[0])
    if not (np.array_equal(qb, wb) and np.array_equal(qp, wp)):
        raise AssertionError("quantized artifact: HTTP answer differs from "
                             "its in-process call")
    log(f"phase serve-http: quantized artifact (uint16 xyz + uint8 "
        f"reflectance) answers bit-equal to its in-process call ({len(qp)} "
        f"live detections; {len(answers[0][0][1])} for the f32 artifact)")
    return counts


def http_timing(rng, cfg, dev, n_pts, work_dir, profile_dir, card):
    """Latency of a B=1 pallas-sort artifact over HTTP (client clock, npz
    bodies of 4 distinct frames prepared ahead) and the median of 20
    ``GET /healthz`` round trips; to split it, the host's parse of one
    body (``np.load``) and in-process ``ServingModel.predict`` (numpy in
    and out), on the calling thread and on a new thread per call as the
    server runs it; beside them in-process ``predict_from_points`` of the
    same weights on device tensors at "pallas-sort" and at "sort"."""
    import io
    import threading
    import urllib.request
    import numpy as np
    from mv3d_tpu_torch.serving import load_serving
    from mv3d_tpu_torch.train.trainer import MV3D
    art = export_artifact(work_dir, "artifact_b1", 1)
    pts = make_cloud(rng, 4, n_pts, cfg, tricky=False)
    rgb = rng.rand(4, *cfg.rgb_shape).astype(np.float32)
    bodies = [npz_body(points=p, rgb=r) for p, r in zip(pts, rgb)]
    with LocalServer(art) as server:
        timed_windows(lambda i: http_post(server.port, bodies[i % 4]),
                      "HTTP pallas-sort", 1, card)
        health = []
        for _ in range(20):
            t0 = time.perf_counter()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/healthz",
                    timeout=60) as r:
                r.read()
            health.append(time.perf_counter() - t0)
    log(f"phase timing: GET /healthz round trip: median "
        f"{np.median(health) * 1e3:.2f} ms over 20 [{card}]")
    parse = []
    for body in bodies * 5:
        t0 = time.perf_counter()
        with np.load(io.BytesIO(body)) as z:
            z["points"], z["rgb"]
        parse.append(time.perf_counter() - t0)
    log(f"phase timing: np.load of one {len(bodies[0]) / 1e6:.2f} MB request "
        f"body: median {np.median(parse) * 1e3:.2f} ms over 20 [{card}]")
    served = load_serving(art, device=dev)
    timed_windows(lambda i: served.predict(pts[i % 4], rgb[i % 4]),
                  "in-process ServingModel.predict pallas-sort", 1, card)

    def in_new_thread(i):
        # as the server runs each request: on a thread of its own
        t = threading.Thread(target=served.predict,
                             args=(pts[i % 4], rgb[i % 4]))
        t.start()
        t.join()

    timed_windows(in_new_thread, "in-process ServingModel.predict "
                  "pallas-sort, a new thread per call", 1, card)
    model = served.model
    serve_timing(model, "in-process pallas-sort", rng, cfg, dev, n_pts,
                 profile_dir, card, sizes=(1,))
    sort_cfg = dataclasses.replace(model.cfg, pipeline=dataclasses.replace(
        model.cfg.pipeline, voxel_order="sort"))
    serve_timing(MV3D(sort_cfg, device=dev,
                      variables=model.get_variables()),
                 "in-process sort", rng, cfg, dev, n_pts, None, card,
                 sizes=(1,))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile serving and training; write tables "
                         "here")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this test runs only on the card")
        return 1
    t_start = time.time()

    def started(phase):
        log(f"phase {phase}: from {time.time() - t_start:.0f} s")

    card = card_line()
    log(card)

    import numpy as np
    from mv3d_tpu_torch import kitti_config, serving_config
    from mv3d_tpu_torch.ops import cuda_build
    from mv3d_tpu_torch.ops import sort_bitonic as sb
    from mv3d_tpu_torch.ops import voxelize as vox
    from mv3d_tpu_torch.ops import voxelize_heights as vh
    from mv3d_tpu_torch.ops import voxelize_padded as vp
    from mv3d_tpu_torch.ops import voxelize_sweep as sweep
    from mv3d_tpu_torch.ops.sort import merge_runs_stable
    from mv3d_tpu_torch.train.trainer import MV3D

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = kitti_config()
    serve_cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, use_pallas_fused=True))
    pad_cfg = serving_config(cfg)
    # the JAX package's training configuration: host aux plane, heights
    # through the Pallas kernel on the accelerator
    train_cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, host_aux_channels=True, use_pallas_heights=True))
    t = cfg.top
    n_cells, zn, n_pts = t.xn * t.yn, t.zn, cfg.pipeline.max_points
    n_flat = n_cells * zn
    n_sc = (t.xn // 2) * vox.folded_pad_width(t.yn)
    rng = np.random.RandomState(0)
    work_dirs = [os.path.join(ROOT, d, "chip_smoke")
                 for d in ("checkpoint", "log")]
    for d in work_dirs:
        shutil.rmtree(d, ignore_errors=True)
    counters = {"voxelize_sweep": sweep.scatter_top_fused_batched,
                "voxelize_padded": vp.scatter_top_padded_batched,
                "voxelize_heights": vh.scatter_max_batched,
                "sort_radix": sb.bitonic_sort_batched,
                "sort_merge": sb.merge_pass_kernel}

    # -- 2. build the five kernels, one nvcc each, in parallel ------------
    t0 = time.time()
    cuda_build.build_libraries(cuda_build.SOURCES)
    for load in (sweep._library, vp._library, vh._library,
                 sb._radix_library, sb._merge_library):
        load()
    log(f"phase build: voxelize_sweep, voxelize_padded, voxelize_heights, "
        f"sort_radix and sort_merge built in {time.time() - t0:.2f} s")
    radix = sb._radix_library()
    tile, n_tiles, smem = sweep.tile_plan(2 * n_cells, zn)
    for src, note in (
            (sweep.SOURCE, f"tile_sweep: tiles of {tile} cells, {n_tiles} "
             f"at B=2, {smem} B of dynamic shared memory per block (two "
             f"tile buffers, f32 and bf16 heights alike); persistent grid "
             f"of up to 4 blocks, as shared memory allows, on each of "
             f"{torch.cuda.get_device_properties(0).multi_processor_count} "
             f"SMs"),
            (vp.SOURCE, f"tile_sweep dynamic shared memory "
             f"{vp.tile_plan(n_sc)[2]} B per block"),
            (sb.RADIX_SOURCE, f"sort_radix dynamic shared memory "
             f"{radix.mv3d_sort_radix_smem()} B per CTA, clusters of 8 "
             f"CTAs; cudaOccupancyMaxActiveClusters "
             f"{radix.mv3d_sort_radix_max_clusters()} (rows of 65,536 in "
             f"one wave)"),
            (sb.MERGE_SOURCE, "merge_pass: tiles of 2,048 outputs, 256 "
             "threads")):
        log(f"phase build: ptxas, {os.path.basename(src)}: "
            + "; ".join(cuda_build.ptxas_report(src)) + f"; {note}")

    started("kernels against their plain versions")
    # -- 3. each kernel against its plain version -------------------------
    def prep(b, device, s2d=False):
        """Quantized tricky clouds: K1/K3's row-major ids, or with
        ``s2d="pad"`` K2's lane-padded ids."""
        pts = torch.from_numpy(make_cloud(rng, b, n_pts, cfg, tricky=True))
        _, _, flat, val, refl = vox._top_prep(pts.to(device), cfg, None,
                                              s2d=s2d)
        dump = n_sc * 128 if s2d else n_flat
        return flat, val, torch.where(flat < dump, refl, 0.0)

    flat, val, refl = prep(2, torch.device("cpu"))
    occupied, sweep_err = check_sweep((flat, val, refl), dev, n_cells, zn,
                                      "path clouds")
    log(f"phase kernel-vs-plain: voxelize_sweep B=2 N={n_pts} "
        f"heights (f32 and bf16)/count/intensity bit-equal to the plain "
        f"version on the card and on the CPU (occupied cells {occupied})")
    for b, n, nc in ((2, n_pts, n_cells), (2, 2048, 1000)):
        occupied, err = check_sweep_cases(rng, dev, b, n, nc, zn)
        sweep_err = max(sweep_err, err)
        plan = sweep.tile_plan(b * nc, zn)
        log(f"phase kernel-vs-plain: voxelize_sweep B={b} N={n} "
            f"n_cells={nc} ({plan[1]} tiles of {plan[0]} cells, the last "
            f"holding {b * nc - (plan[1] - 1) * plan[0]}) on skewed clouds, "
            f"heights f32 and bf16: bit-equal to the plain version on the "
            f"card and on the CPU (occupied cells {occupied})")
    args = (flat.to(dev), val.to(dev), refl.to(dev), n_cells, zn)
    padded_err = check_padded_kernel(rng, cfg, dev, n_pts)
    for b, n, ns in ((2, n_pts, n_sc), (2, 2048, 200)):
        occupied, err = check_padded_cases(rng, dev, b, n, ns, zn)
        padded_err = max(padded_err, err)
        log(f"phase kernel-vs-plain: voxelize_padded B={b} N={n} n_sc={ns} "
            f"(tiles of {vp.tile_plan(ns)[0]} supercells) on skewed clouds, "
            f"heights f32 and bf16: bit-equal to the plain version on the "
            f"card and on the CPU (occupied cells {occupied})")
    want_h = vh.scatter_max_plain(flat, val, n_flat)
    hargs = (flat.to(dev), val.to(dev), n_flat)
    got_h = vh.scatter_max_kernel(*hargs)
    plain_h = vh.scatter_max_plain(*hargs)
    frame = torch.arange(2, device=dev)[:, None] * n_flat
    lib_idx = torch.where(hargs[0] < n_flat, hargs[0].long() + frame,
                          2 * n_flat).reshape(-1)

    def heights_library(idx=lib_idx, v=hargs[1].reshape(-1),
                        n=2 * n_flat):
        return torch.zeros(n + 1, device=dev).scatter_reduce_(0, idx, v,
                                                              "amax")

    lib_h = heights_library()
    torch.cuda.synchronize()
    if not (torch.equal(got_h, plain_h) and torch.equal(got_h.cpu(), want_h)
            and torch.equal(got_h.reshape(-1), lib_h[:-1])):
        raise AssertionError("heights kernel differs from its plain "
                             "version or the scatter_reduce_ call")
    heights_err = (got_h - plain_h).abs().max().item()
    log(f"phase kernel-vs-plain: voxelize_heights B=2 N={n_pts} "
        f"n_flat={n_flat} bit-equal to the plain version on the card and "
        f"on the CPU, and to one scatter_reduce_ call (nonzero "
        f"{int((want_h > 0).sum())})")
    sort_err = check_sort(flat, val, refl, dev, f"path inputs B=2 "
                          f"N={n_pts}")
    occupied = check_sort_then_sweep(*args)
    log(f"phase kernel-vs-plain: sort_radix B=2 N={n_pts} (the path's "
        f"flat/val/refl): one launch; keys and payloads bit-equal to the "
        f"plain radix twin on the card and on the CPU and to "
        f"torch.sort(stable=True) + gathers; K1 on the sorted points equals "
        f"K1 on the unsorted ones bit for bit ({occupied} occupied cells)")
    merge_err = 0.0
    for n in (256, 2048, 8192, n_pts, 2 * n_pts, 4 * n_pts):
        for kind, case in sort_cases(rng, 2, n).items():
            err = check_sort(*case, dev, f"{kind} n={n}")
            if n > sb.RADIX_CAPACITY:
                merge_err = max(merge_err, err)
            else:
                sort_err = max(sort_err, err)
    log(f"phase kernel-vs-plain: sort_radix B=2 at n = 256, 2048, 8192, "
        f"{n_pts}, and sort_radix blocks + sort_merge at n = {2 * n_pts} "
        f"and {4 * n_pts} (above the radix capacity {sb.RADIX_CAPACITY}; "
        f"1 and 2 merge passes) on keys that need 0-4 digit passes (all "
        f"equal, ties in [0, 16), [0, 4096), voxel ids, negative with the "
        f"int32 extremes) and ties across runs: bit-equal to the plain "
        f"radix twin on the card and on the CPU and to torch.sort, one "
        f"radix launch and one merge launch per pass")
    long_rows = [torch.cat([x, x.flip(-1)], -1) for x in args[:3]]
    check_sort(*(x.cpu() for x in long_rows), dev,
               f"path inputs B=2 N={2 * n_pts}")
    occupied = check_sort_then_sweep(*long_rows, n_cells, zn)
    # one merge pass alone, on the path's rows sorted in blocks
    runs = sb.radix_sort_kernel(*(x.reshape(4, n_pts) for x in long_rows))
    runs = tuple(x.reshape(2, 2 * n_pts) for x in runs)
    merged = tuple(torch.empty_like(x) for x in runs)

    def merge_pass():
        sb.merge_pass_kernel([x.data_ptr() for x in runs], 2, 2 * n_pts,
                             n_pts, [x.data_ptr() for x in merged], dev)

    merge_pass()
    for g, w in zip(merged, merge_runs_stable(list(runs), n_pts)):
        if not torch.equal(g, w):
            raise AssertionError("a merge pass differs from its plain twin")
    log(f"phase kernel-vs-plain: sort_radix blocks + sort_merge B=2 "
        f"N={2 * n_pts} (the path's flat/val/refl, twice): bit-equal as "
        f"above; K1 on the sorted points equals K1 on the unsorted ones "
        f"({occupied} occupied cells)")
    pflat, pval, prefl = prep(2, dev, s2d="pad")
    bf16 = torch.bfloat16
    timed = {"voxelize_sweep": (
                 cuda_ms(lambda: sweep.scatter_top_fused_kernel(*args)),
                 cuda_ms(lambda: sweep.scatter_top_fused_plain(*args)),
                 None),
             "voxelize_padded": (
                 cuda_ms(lambda: vp.scatter_top_padded_kernel(
                     pflat, pval, prefl, n_sc, zn, bf16)),
                 cuda_ms(lambda: vp.scatter_top_padded_plain(
                     pflat, pval, prefl, n_sc, zn, bf16)),
                 None),
             "voxelize_heights": (
                 cuda_ms(lambda: vh.scatter_max_kernel(*hargs)),
                 cuda_ms(lambda: vh.scatter_max_plain(*hargs)),
                 cuda_ms(heights_library)),
             "sort_radix": (
                 cuda_ms(lambda: sb.radix_sort_kernel(*args[:3])),
                 cuda_ms(lambda: sb.bitonic_sort_plain(*args[:3]), 20),
                 cuda_ms(lambda: sort_library(*args[:3])))}
    timed["sort_merge"] = (
        cuda_ms(merge_pass),
        cuda_ms(lambda: merge_runs_stable(list(runs), n_pts)),
        cuda_ms(lambda: sort_library(*runs)))
    device = {"voxelize_sweep": device_ms(
                  lambda: sweep.scatter_top_fused_kernel(*args)),
              "voxelize_padded": device_ms(
                  lambda: vp.scatter_top_padded_kernel(pflat, pval, prefl,
                                                       n_sc, zn, bf16)),
              "voxelize_heights": device_ms(
                  lambda: vh.scatter_max_kernel(*hargs)),
              "sort_radix": device_ms(
                  lambda: sb.radix_sort_kernel(*args[:3])),
              "sort_merge": device_ms(merge_pass)}
    padded_f32 = (cuda_ms(lambda: vp.scatter_top_padded_kernel(
                      pflat, pval, prefl, n_sc, zn)),
                  cuda_ms(lambda: vp.scatter_top_padded_plain(
                      pflat, pval, prefl, n_sc, zn)),
                  device_ms(lambda: vp.scatter_top_padded_kernel(
                      pflat, pval, prefl, n_sc, zn)))
    del got_h, plain_h, lib_h, lib_idx, pflat, pval, prefl
    del long_rows, runs, merged
    check_folded_views(rng, pad_cfg, dev, n_pts)
    check_front_view(rng, cfg, dev, n_pts)

    started("serving")
    # -- 4. serve three requests through each serving path ----------------
    requests = [(make_cloud(rng, 2, n_pts, cfg, tricky=False),
                 np.full(2, n_pts, np.int32),
                 rng.rand(2, *cfg.rgb_shape).astype(np.float32))
                for _ in range(3)]
    model = MV3D(serve_cfg, device=dev, seed=0)
    serve_launches = serve_requests(
        model, requests, counters,
        {"voxelize_sweep": 3, "voxelize_padded": 0,
         "voxelize_heights": 0, "sort_radix": 0,
         "sort_merge": 0})["voxelize_sweep"]
    check_top_view_card_vs_cpu(serve_cfg, requests[0][0], dev)
    small_reference(rng, dev)
    pad_model = MV3D(pad_cfg, device=dev, seed=0)
    padded_launches = serve_requests(
        pad_model, requests, counters,
        {"voxelize_sweep": 0, "voxelize_padded": 3,
         "voxelize_heights": 0, "sort_radix": 0,
         "sort_merge": 0})["voxelize_padded"]
    check_top_view_card_vs_cpu(pad_cfg, requests[0][0], dev)
    small_reference(rng, dev, serving=True)
    http_launches = serve_http(rng, serve_cfg, dev, work_dirs[0],
                               counters)["sort_radix"]
    # uncropped sweeps longer than a cluster holds: radix blocks, then one
    # merge pass per request
    long_model = MV3D(dataclasses.replace(serve_cfg, pipeline=dataclasses.
                                          replace(serve_cfg.pipeline,
                                                  voxel_order="pallas-sort")),
                      device=dev, seed=0)
    long_requests = [(make_cloud(rng, 2, 2 * n_pts, cfg, tricky=False),
                      np.full(2, 2 * n_pts, np.int32), rgb)
                     for _, _, rgb in requests[:2]]
    long_launches = serve_requests(
        long_model, long_requests, counters,
        {"voxelize_sweep": 2, "voxelize_padded": 0,
         "voxelize_heights": 0, "sort_radix": 2,
         "sort_merge": 2})["sort_merge"]
    del long_model, long_requests

    started("training")
    # -- 5. train at full width, then a small step against the CPU -------
    trainer, loader, train_launches = train_phase(
        train_cfg, dev, rng, work_dirs[0], card)
    small_train_reference(np.random.RandomState(2), dev,
                          os.path.join(work_dirs[0], "small"))
    small_train_reference(np.random.RandomState(2), dev,
                          os.path.join(work_dirs[0], "small_s2d2p"),
                          serving=True)

    started("the training command")
    # -- 6. the training command over a KITTI directory on disk -----------
    cmd_dir = os.path.join(work_dirs[1], "train_cmd")
    data_dir, cmd_launches = train_command_phase(rng, cfg, dev, cmd_dir,
                                                 counters)

    started("the evaluation commands")
    # -- 7. the evaluation commands over phase 6's data and checkpoints ---
    eval_launches = eval_command_phase(
        rng, cfg, dev, os.path.join(work_dirs[1], "eval_cmd"), data_dir,
        counters, card)

    started("options")
    # -- 8. the didi presets and the model options at full width ----------
    option_launches = options_phase(
        rng, dev, os.path.join(work_dirs[1], "options"), counters, requests,
        card)

    started("int8")
    # -- 9. int8 serving at full width ------------------------------------
    int8_launches, int8_model = int8_phase(
        rng, dev, os.path.join(work_dirs[0], "int8"), counters, requests,
        card)

    started("parallel")
    # -- 10. data parallelism: one NCCL rank, then two gloo processes -----
    parallel_dir = os.path.join(work_dirs[1], "parallel")
    os.makedirs(parallel_dir, exist_ok=True)
    parallel_launches = parallel_phase(rng, dev, parallel_dir, counters,
                                       requests, card, opts.profile)
    new_paths = [option_launches, int8_launches, parallel_launches]

    started("timings")
    # -- 11. timings -------------------------------------------------------
    bounds = {b: kernel_bounds(b, n_pts, n_cells, zn, n_sc)
              for b in (1, 2, 8)}
    for name, (k_ms, p_ms, l_ms) in timed.items():
        log(f"phase timing: {name} B=2"
            + (f" n={2 * n_pts}, one pass of runs of {n_pts}"
               if name == "sort_merge" else "")
            + f": kernel {k_ms * 1e3:.1f} us with the wrapper, "
            f"{us_text(device[name])} on the device; plain "
            f"{p_ms * 1e3:.1f} us, library call "
            + (f"{l_ms * 1e3:.1f} us" if l_ms is not None else "none")
            + f", bound {bounds[2][name] * 1e3:.1f} us"
            + (" (bf16 heights)" if name == "voxelize_padded" else "")
            + (" (f32 heights)" if name == "voxelize_sweep" else "")
            + f" [{card}]")
    log(f"phase timing: voxelize_padded B=2 f32 heights: kernel "
        f"{padded_f32[0] * 1e3:.1f} us with the wrapper, "
        f"{us_text(padded_f32[2])} on the device; plain "
        f"{padded_f32[1] * 1e3:.1f} us, bound "
        f"{bounds[2]['voxelize_padded_f32'] * 1e3:.1f} us [{card}]")

    def both(kernel):
        """(ms with the wrapper, ms on the device) per call of kernel."""
        return cuda_ms(kernel), device_ms(kernel)

    def us(pair):
        return (f"kernel {pair[0] * 1e3:.1f} us with the wrapper, "
                f"{us_text(pair[1])} on the device")

    for b in (1, 8):
        f, v, r = prep(b, dev)
        idx = torch.where(f < n_flat, f.long() + torch.arange(
            b, device=dev)[:, None] * n_flat, b * n_flat).reshape(-1)
        k3 = both(lambda: vh.scatter_max_kernel(f, v, n_flat))
        p3, l3 = (cuda_ms(lambda: vh.scatter_max_plain(f, v, n_flat)),
                  cuda_ms(lambda: torch.zeros(
                      b * n_flat + 1, device=dev).scatter_reduce_(
                          0, idx, v.reshape(-1), "amax")))
        log(f"phase timing: voxelize_heights B={b}: {us(k3)}; plain "
            f"{p3 * 1e3:.1f} us, scatter_reduce_ {l3 * 1e3:.1f} us, bound "
            f"{bounds[b]['voxelize_heights'] * 1e3:.1f} us [{card}]")
        del idx
        k4 = both(lambda: sb.radix_sort_kernel(f, v, r))
        p4, l4 = (cuda_ms(lambda: sb.bitonic_sort_plain(f, v, r), 20),
                  cuda_ms(lambda: sort_library(f, v, r)))
        log(f"phase timing: sort_radix B={b}: {us(k4)}; plain "
            f"{p4 * 1e3:.1f} us, torch.sort + gathers {l4 * 1e3:.1f} us, "
            f"bound {bounds[b]['sort_radix'] * 1e3:.1f} us [{card}]")
        del f, v, r
        f, v, r = prep(b, dev, s2d="pad")
        k2 = both(lambda: vp.scatter_top_padded_kernel(f, v, r, n_sc, zn,
                                                       bf16))
        p2 = cuda_ms(lambda: vp.scatter_top_padded_plain(f, v, r, n_sc, zn,
                                                         bf16))
        log(f"phase timing: voxelize_padded B={b} (bf16 heights): {us(k2)}; "
            f"plain {p2 * 1e3:.1f} us, bound "
            f"{bounds[b]['voxelize_padded'] * 1e3:.1f} us [{card}]")
        del f, v, r

    def split(fn):
        """The device time of ``fn`` by kernel, largest first, in us per
        call (``kernel_split``)."""
        parts = kernel_split(fn)
        return "by kernel: " + (", ".join(
            f"{k} {v * 1e3:.1f}"
            for k, v in sorted(parts.items(), key=lambda kv: -kv[1]))
            or "not measured")

    # K1 in f32 and bf16 and K4's long rows at B = 1, 2, 8: with the
    # wrapper, on the device (by kernel) and on the host per call
    for b in (1, 2, 8):
        f, v, r = prep(b, dev)
        for dtype in (torch.float32, bf16):
            def k1(dtype=dtype):
                return sweep.scatter_top_fused_kernel(f, v, r, n_cells, zn,
                                                      dtype)
            h_us, k_ms, d_ms = host_us(k1), cuda_ms(k1), device_ms(k1)
            p_ms = cuda_ms(lambda: sweep.scatter_top_fused_plain(
                f, v, r, n_cells, zn, dtype), 20)
            name = ("voxelize_sweep" if dtype == torch.float32
                    else "voxelize_sweep_bf16")
            log(f"phase timing: voxelize_sweep B={b} {str(dtype)[6:]} "
                f"heights: kernel {k_ms * 1e3:.1f} us with the wrapper, "
                f"{us_text(d_ms)} on the device ({split(k1)}), "
                f"{h_us:.1f} us on the host per call; plain "
                f"{p_ms * 1e3:.1f} us, bound {bounds[b][name] * 1e3:.1f} us "
                f"[{card}]")
        rows = [torch.cat([x, x.flip(-1)], -1) for x in (f, v, r)]
        h_us = host_us(lambda: sb.bitonic_sort_kernel(*rows))
        k_ms = cuda_ms(lambda: sb.bitonic_sort_kernel(*rows))
        d_ms = device_ms(lambda: sb.bitonic_sort_kernel(*rows))
        log(f"phase timing: sort_radix blocks + sort_merge B={b} "
            f"n={2 * n_pts}: kernels {k_ms * 1e3:.1f} us with the wrapper, "
            f"{us_text(d_ms)} on the device "
            f"({split(lambda: sb.bitonic_sort_kernel(*rows))}), "
            f"{h_us:.1f} us on the host per call; torch.sort + gathers "
            f"{cuda_ms(lambda: sort_library(*rows)) * 1e3:.1f} us, plain "
            f"{cuda_ms(lambda: sb.bitonic_sort_plain(*rows), 10) * 1e3:.1f}"
            f" us, bound {bounds[b]['sort_merge'] * 1e3:.1f} us [{card}]")
        del f, v, r, rows
    host_breakdown(prep(1, dev), n_cells, zn, card)
    for label, m in (("hwc", model), ("hwc int8", int8_model),
                     ("s2d2p", pad_model)):
        serve_timing(m, label, rng, cfg, dev, n_pts, opts.profile, card)
    del model, pad_model, int8_model
    http_timing(rng, serve_cfg, dev, n_pts, work_dirs[0], opts.profile,
                card)

    torch.cuda.reset_peak_memory_stats()
    med = step_windows(lambda i: trainer.fit_iteration(loader.load()),
                       "train B=2 (all subnets, bf16, host aux plane, "
                       "in-memory drive)", card)
    log(f"phase timing: train B=2: peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    if opts.profile:
        profile_calls(lambda i: trainer.fit_iteration(loader.load()), 3,
                      "train B=2 step", med / 1e3, opts.profile, card)
    loader.close()
    del trainer
    train_command_timing(data_dir, cfg, dev, cmd_dir, card, opts.profile)
    for d in work_dirs:
        shutil.rmtree(d, ignore_errors=True)

    record = {"voxelize_sweep": dict(
                  source="mv3d_tpu_torch/csrc/voxelize_sweep.cu",
                  replaces="mv3d_tpu/ops/voxelize_pallas.py:220",
                  launches=serve_launches + cmd_launches["voxelize_sweep"]
                  + eval_launches["voxelize_sweep"]
                  + sum(x["voxelize_sweep"] for x in new_paths),
                  max_abs_err=sweep_err),
              "voxelize_padded": dict(
                  source="mv3d_tpu_torch/csrc/voxelize_padded.cu",
                  replaces="mv3d_tpu/ops/voxelize_pallas.py:886",
                  launches=padded_launches
                  + cmd_launches["voxelize_padded"]
                  + eval_launches["voxelize_padded"]
                  + sum(x["voxelize_padded"] for x in new_paths),
                  max_abs_err=padded_err),
              "voxelize_heights": dict(
                  source="mv3d_tpu_torch/csrc/voxelize_heights.cu",
                  replaces="mv3d_tpu/ops/voxelize_pallas.py:46",
                  launches=train_launches
                  + cmd_launches["voxelize_heights"]
                  + eval_launches["voxelize_heights"]
                  + sum(x["voxelize_heights"] for x in new_paths),
                  max_abs_err=heights_err),
              "sort_radix": dict(
                  source="mv3d_tpu_torch/csrc/sort_radix.cu",
                  replaces="mv3d_tpu/ops/sort_pallas.py:73",
                  launches=http_launches
                  + sum(x["sort_radix"] for x in new_paths),
                  max_abs_err=sort_err),
              "sort_merge": dict(
                  source="mv3d_tpu_torch/csrc/sort_merge.cu",
                  replaces="mv3d_tpu/ops/sort_pallas.py:73",
                  launches=long_launches
                  + sum(x["sort_merge"] for x in new_paths),
                  max_abs_err=merge_err)}
    log(f"chip_smoke: every phase passed in {time.time() - t_start:.0f} s")
    log(json.dumps({"kernels": [dict(
        name=name, route="cuda", **rec, ms=timed[name][0],
        plain_ms=timed[name][1], bound_ms=bounds[2][name],
        bound_by="bytes", library_ms=timed[name][2])
        for name, rec in record.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
