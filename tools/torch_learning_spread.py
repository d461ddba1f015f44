"""The spread of the learning gate's held-out 3D IoU.

Runs the gate of ``tests/test_torch_generalization.py`` (``cli.rehearsal``
on the 10-frame synthetic fixture split 8/2, JAX's tiny overrides, two
stages of 150 iterations at B=2, the 2 held-out frames scored) several
times in this process, and prints for each run its held-out IoU, its PR
point at IoU 0.1, the detections' (tx, ty), each held-out frame's live
proposals and largest fg logit over the anchors the empty-anchor filter
keeps (the proposal layer drops an anchor whose fg logit is at or under
-0.5), and its wall time; at the end every run's IoU again with their
spread and how many runs fell at or under the floor (0.30) or within
0.05 above it.

On the card the atomic reductions make each run's training differ: run
``--runs`` times at the command's model seed (0). ``--seeds`` runs once
at each of the given model seeds instead (the trainers' ``seed``; the
fixture and its split stay the command's), which shows the spread on
the CPU too. With ``--deterministic`` PyTorch's deterministic algorithms
are switched on (cuBLAS then needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8``
set before the process starts). Run from the repository root:

    python3 tools/torch_learning_spread.py --runs 8
    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 tools/torch_learning_spread.py \\
        --runs 2 --deterministic
    python3 tools/torch_learning_spread.py --device cpu --seeds 1 2 3

Work files go to ``log/learning_spread_<pid>`` in the checkout and are
removed.
"""

import argparse
import functools
import json
import os
import re
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def heldout_proposals(out, cfg_path, device):
    """(live proposals, largest kept fg logit) of each held-out frame,
    from the run's saved weights."""
    import argparse as _argparse
    import torch
    from mv3d_tpu_torch.cli.common import resolve_config
    from mv3d_tpu_torch.data.kitti import KittiObjectDataset
    from mv3d_tpu_torch.data.loader import frames_to_batch
    from mv3d_tpu_torch.ops.proposal import rpn_proposals
    from mv3d_tpu_torch.ops.voxelize import lidar_to_top_batch
    from mv3d_tpu_torch.train.trainer import Predictor
    cfg = resolve_config(_argparse.Namespace(dataset="kitti",
                                             config=cfg_path, set_kv=[]))
    pred = Predictor(cfg, log_tag="rehearsal", device=device,
                     checkpoint_dir=os.path.join(out, "checkpoint"))
    ds = KittiObjectDataset(os.path.join(out, "fixture"), cfg=cfg,
                            split_file=os.path.join(out, "splits",
                                                    "val.txt"))
    model = pred.model.eval()
    rows = []
    with torch.inference_mode():
        for i in range(len(ds)):
            batch = frames_to_batch([ds.load_frame(i)], cfg)
            top, occ = lidar_to_top_batch(
                torch.as_tensor(batch["points"], device=device), cfg,
                torch.as_tensor(batch["num_points"], device=device),
                return_occ=True)
            rgb = torch.as_tensor(batch["rgb"], device=device)
            rpn = model.extract_features(top, rgb, None)["rpn"]
            inside = model.anchor_mask(top, occ)
            fg = rpn["scores"].reshape(1, -1, 2)[..., 1].float()
            props = rpn_proposals(rpn["scores"], rpn["deltas"],
                                  model.anchors, inside, cfg)
            rows.append((int(props.mask.sum()),
                         round(float(fg[inside].max()), 3)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="one run at each of these model seeds")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--deterministic", action="store_true")
    opts = ap.parse_args(argv)
    import torch
    if opts.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 1
    if opts.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    import chip_smoke
    from mv3d_tpu_torch.cli import rehearsal
    from mv3d_tpu_torch.train import trainer as trainer_mod

    work = os.path.join(ROOT, "log", f"learning_spread_{os.getpid()}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg_path = os.path.join(work, "tiny.json")
    with open(cfg_path, "w") as f:
        json.dump(chip_smoke.TINY_OVERRIDES, f)
    card = (chip_smoke.card_line() if opts.device == "cuda"
            else f"CPU, {torch.get_num_threads()} threads")
    print(card)
    seeds = opts.seeds if opts.seeds is not None else [0] * opts.runs
    mode = "deterministic" if opts.deterministic else "default"
    trainer_cls = trainer_mod.Trainer
    ious = []
    try:
        for i, seed in enumerate(seeds):
            out = os.path.join(work, f"run{i}")
            t0 = time.time()
            # the command builds its trainers from the module's name
            trainer_mod.Trainer = functools.partial(trainer_cls, seed=seed)
            try:
                res = rehearsal.main([
                    "--synthetic-fixture", "--fixture-frames", "10", "-o",
                    out, "-i", "150", "-b", "2", "--score-threshold", "0.05",
                    "--split-fraction", "0.8", "--config", cfg_path,
                    "--device", opts.device])
            finally:
                trainer_mod.Trainer = trainer_cls
            secs = time.time() - t0
            with open(os.path.join(out, "pred",
                                   "tracklet_labels_pred.xml")) as f:
                dets = re.findall(r"<tx>([-0-9.]+)</tx>\s*<ty>([-0-9.]+)"
                                  r"</ty>", f.read())
            ious.append(res["iou_per_obj"]["All"])
            print(f"learning gate run {i} (model seed {seed}, {mode} "
                  f"algorithms, {opts.device}): held-out IoU {ious[-1]:.4f},"
                  f" PR@0.1 {res['pr_per_iou'][0.1]}, detections (tx, ty) "
                  f"{[(round(float(a), 2), round(float(b), 2)) for a, b in dets]}"
                  f", held-out frames (live proposals, largest fg logit) "
                  f"{heldout_proposals(out, cfg_path, opts.device)}, "
                  f"{secs:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    floor = chip_smoke.IOU_FLOOR
    print(f"learning gate, {len(ious)} runs (model seeds {seeds}, {mode} "
          f"algorithms): held-out IoU {[round(x, 4) for x in ious]}; min "
          f"{min(ious):.4f}, median {statistics.median(ious):.4f}, max "
          f"{max(ious):.4f}; at or under {floor}: "
          f"{sum(x <= floor for x in ious)}; within 0.05 above it: "
          f"{sum(floor < x <= floor + 0.05 for x in ious)} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
