"""AVOD's two NMS calls on the card at the benchmark cell's own frames,
against the plain greedy loop.

For each seed, the frames and weights of ``avod_cars.serve-b8-hwc`` are
drawn as a run of the cell draws them (``h100bench/harness``), the port's
AVOD runs each batch of 8 on the card, and the proposal NMS (every
anchor's BEV box in metres, the empty ones masked, IoU 0.8, 300 kept)
and the final NMS (the proposals' top-view pixel boxes, 0.01, "+1", 100
kept) are each run through ``ops.nms.nms_topk`` (the ``mv3d::nms_topk``
kernel) and through the reference's plain greedy loop
(``h100bench/reference/avodref/plain.greedy``) on the same scores, sorted
stably. Prints one JSON line a seed: frames whose picks are identical to
the index, of each call, the boxes visited, the kernel's launches a
batch, the device launches of one proposal NMS at max_out 256, 300, 1,024
and 4,096, and the card. Run from the repository root on the card:

    python3 tools/torch_avod_nms_frames.py --seeds 3000000301 3000000302
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "avod_cars.serve-b8-hwc"


def _same(nms_topk, greedy, boxes, scores, valid, thr, max_out, off):
    """Frames whose ``nms_topk`` picks equal the plain loop's, the visits,
    and ``nms_topk``'s picks and mask."""
    import torch
    idx, mask, visited = nms_topk(boxes, scores, valid, thr, max_out, off)
    live = torch.where(valid, scores.float(), -torch.inf)
    order = torch.sort(live, dim=1, descending=True, stable=True)[1]
    same = 0
    for f in range(scores.shape[0]):
        o = order[f][live[f][order[f]] > -torch.inf]
        keep = greedy(boxes[f][o].cpu().numpy(), off, thr, max_out)
        same += idx[f][mask[f]].tolist() == o[keep].tolist()
    return same, visited.tolist(), idx, mask


def _launches(fn) -> int:
    """Kernels (and fills) the card ran for ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "h100bench"), ROOT]
    import torch
    from harness import serve_batch, spec
    from mv3d_tpu_torch.ops import boxes3d as box3d_ops
    from mv3d_tpu_torch.ops.nms import nms_topk
    from mv3d_tpu_torch.ops.nms_topk import nms_topk_kernel
    from mv3d_tpu_torch.ops.voxelize import lidar_to_bev_avod
    from mv3d_tpu_torch.serving.export import config_from_dict
    from mv3d_tpu_torch.train.trainer import MV3D
    from reference.avodref.plain import greedy, inputs

    found = spec.resolve(spec.load_benchmark(ROOT), CELL)
    dev = torch.device("cuda")
    ok = True
    for seed in args.seeds:
        inp = serve_batch.inputs(found.config, found.mix, seed, dev)
        cfg = config_from_dict(inp.tree)
        work = tempfile.mkdtemp()
        model = MV3D(cfg, device=dev, checkpoint_dir=work, log_dir=work)
        model.model.load_state_dict(inp.state)
        net = model.model.eval()
        row = {"seed": seed, "frames": 0, "proposal_same": 0,
               "final_same": 0, "visited": []}
        launches0 = nms_topk_kernel.launches
        with torch.inference_mode():
            for batch in inp.batches:
                pts, num, rgb = inputs(batch, inp.batch, inp.ref_cfg, dev)
                top, counts = lidar_to_bev_avod(pts, cfg, num.int())
                bev_map, img_map = net.features(top, rgb)
                inside = net.anchor_mask(counts)
                score, props = net.rpn_outputs(bev_map, img_map, inside)
                boxes = box3d_ops.anchor_bev_boxes(props)
                same, visited, idx, kept = _same(
                    nms_topk, greedy, boxes, score, inside,
                    cfg.rpn.nms_thresh, cfg.rpn.nms_post_topn, 0.0)
                row["proposal_same"] += same
                row["visited"] += visited
                chosen = torch.gather(props, 1,
                                      idx[..., None].expand(-1, -1, 6))
                probs, corners = net.decode(
                    chosen, *net.second_stage_outputs(bev_map, img_map,
                                                      chosen))
                top_boxes = box3d_ops.box3d_to_top_box(corners, cfg)
                same = _same(nms_topk, greedy, top_boxes, probs, kept,
                             cfg.rcnn.nms_thresh, cfg.avod.final_topn,
                             1.0)[0]
                row["final_same"] += same
                row["frames"] += len(batch)
            # the launches of one proposal NMS at other max_out
            row["launches_by_max_out"] = {
                m: _launches(lambda: nms_topk(boxes, score, inside,
                                              cfg.rpn.nms_thresh, m, 0.0))
                for m in (256, 300, 1024, 4096)}
        row["kernel_launches_a_batch"] = ((nms_topk_kernel.launches
                                           - launches0) / len(inp.batches))
        ok &= row["proposal_same"] == row["final_same"] == row["frames"]
        print(json.dumps(row), flush=True)
        del model, net
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"ok": bool(ok), "card": smi.stdout.strip()}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
