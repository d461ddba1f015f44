"""The NMS kernel (``mv3d::nms_topk``, ``csrc/nms_topk.cu``) on the card:
its picks against the plain greedy loop, and its time beside the stock
batched ``greedy_nms`` it stands in for.

Boxes at AVOD's sizes (``avod_cars_config``): the 89,600 anchors' BEV
boxes in metres with random offsets, scored at random on a coarse grid
(so ties occur), a share of them invalid, suppressed at IoU 0.8 down to
300 (the served proposal NMS, offset 0) and to 1,024 (AVOD's training
value); and 300 top-view pixel boxes at 0.01 down to 100 (the final NMS,
"+1" pixels). For each batch size (1, 2, 8):

  * the kernel's kept positions, counts and visited counts equal the CPU
    twin's (``ops.nms.nms_sorted_plain``), and ``ops.nms.nms_topk``'s picks
    equal ``ops.nms.greedy_nms``'s where the latter fits (K up to 16,384:
    its (B, K, K) intermediates are 4 K^2 bytes a frame each);
  * the kernel's device microseconds a call (CUDA events over 200 calls,
    the sort excluded) and ``nms_topk``'s with the sort and gathers;
    ``greedy_nms``'s milliseconds a call at K = 16,384 (the yardstick)
    and at the final NMS's 300, with its launches (``torch.profiler``).

``chip_smoke.py``'s ``check_nms_topk`` holds the kernel at B=8 on every
run of the smoke; this script adds B = 1 and 2 and the yardstick.

Prints one JSON line per case and the card's name and power limit. Run
from the repository root on the card:

    python3 tools/torch_nms_topk_times.py
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _boxes(gen, cfg, bsz, k, device):
    import torch
    from mv3d_tpu_torch.ops import boxes3d as box3d_ops
    from mv3d_tpu_torch.ops.anchors import avod_anchors
    anchors = torch.from_numpy(avod_anchors(cfg)[0])[:k]
    a = anchors[None].expand(bsz, -1, -1).clone()
    a[..., :2] += torch.randn(a[..., :2].shape, generator=gen) * 0.3
    a[..., 3:5] *= torch.exp(torch.randn(a[..., 3:5].shape, generator=gen)
                             * 0.1)
    boxes = box3d_ops.anchor_bev_boxes(a)
    scores = torch.randint(0, 4096, (bsz, k), generator=gen).float() / 4096
    valid = torch.rand(bsz, k, generator=gen) < 0.4
    return boxes.to(device), scores.to(device), valid.to(device)


def _events_us(fn, n=200):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def _launches(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    from mv3d_tpu_torch.config import avod_cars_config
    from mv3d_tpu_torch.ops import library  # noqa: F401
    from mv3d_tpu_torch.ops import nms as nms_ops
    from mv3d_tpu_torch.ops.nms_topk import nms_topk_kernel

    dev = torch.device("cuda")
    cfg = avod_cars_config()
    gen = torch.Generator().manual_seed(20)
    ok = True
    cases = [("proposal", 89600, 300, 0.8, 0.0),
             ("proposal-1024", 89600, 1024, 0.8, 0.0),
             ("proposal-16k", 16384, 1024, 0.8, 0.0),
             ("final", 300, 100, 0.01, 1.0)]
    for name, k, max_out, thr, off in cases:
        for bsz in (1, 2, 8):
            boxes, scores, valid = _boxes(gen, cfg, bsz, k, dev)
            if off:
                boxes = torch.floor(boxes * 10.0)    # pixel boxes
            live = torch.where(valid, scores, -torch.inf)
            s_sorted, order = torch.sort(live, dim=1, descending=True,
                                         stable=True)
            b_sorted = torch.gather(boxes, 1,
                                    order[..., None].expand(-1, -1, 4))
            b_sorted, s_sorted = b_sorted.contiguous(), s_sorted.contiguous()
            got = nms_topk_kernel(b_sorted, s_sorted, max_out, thr, off)
            want = nms_ops.nms_sorted_plain(b_sorted.cpu(), s_sorted.cpu(),
                                            max_out, thr, off)
            same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            row = {"case": name, "B": bsz, "K": k, "max_out": max_out,
                   "kept": got[1].tolist(), "visited": got[2].tolist(),
                   "kernel_equals_plain": same}
            if k <= 16384:
                # greedy_nms's rule is the "+1" one: nms_topk at offset 1
                gi, gm = nms_ops.greedy_nms(boxes, scores, valid, thr,
                                            max_out)
                ti, tm, _ = nms_ops.nms_topk(boxes, scores, valid, thr,
                                             max_out, 1.0)
                row["equals_greedy_nms"] = bool(
                    torch.equal(gm, tm) and torch.equal(gi[gm], ti[tm]))
                ok &= row["equals_greedy_nms"]
                row["greedy_nms_us"] = _events_us(
                    lambda: nms_ops.greedy_nms(boxes, scores, valid, thr,
                                               max_out), n=3)
                row["greedy_nms_launches"] = _launches(
                    lambda: nms_ops.greedy_nms(boxes, scores, valid, thr,
                                               max_out))
            ok &= same
            row["kernel_us"] = _events_us(
                lambda: nms_topk_kernel(b_sorted, s_sorted, max_out, thr,
                                        off))
            row["nms_topk_us"] = _events_us(
                lambda: nms_ops.nms_topk(boxes, scores, valid, thr, max_out,
                                         off))
            row["nms_topk_launches"] = _launches(
                lambda: nms_ops.nms_topk(boxes, scores, valid, thr, max_out,
                                         off))
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"ok": bool(ok), "card": smi.stdout.strip()}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
