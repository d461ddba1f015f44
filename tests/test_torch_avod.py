"""AVOD on the port (``model.arch == "avod"``): the network, its ops and
its served artifact against the plain reference ``tests/avod_reference.py``
(the benchmark's ``h100bench/reference/avodref/plain.py``, which imports
nothing of the port) on the CPU, at a tiny size with seeded random
weights.

Tolerances: the BEV is compared exactly (the same quantization and max
on both sides). The network's values are compared in f32 at 1e-5
relative and absolute: both sides run the same f32 operations on the
CPU, but the program's convolutions run channels-last and the
reference's NCHW, which may sum in another order (the worst seen is
0.0). Proposals, detections and their order are compared exactly where
the scores carry no near-tie, which random weights at these sizes do not
give.
"""

import dataclasses
import io
import os
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import avod_reference as ref  # noqa: E402

from mv3d_tpu_torch.config import avod_cars_config, kitti_config  # noqa: E402
from mv3d_tpu_torch.ops import boxes3d as box3d_ops  # noqa: E402
from mv3d_tpu_torch.ops import nms as nms_ops  # noqa: E402
from mv3d_tpu_torch.ops.anchors import avod_anchors  # noqa: E402
from mv3d_tpu_torch.ops.voxelize import lidar_to_bev_avod  # noqa: E402
from mv3d_tpu_torch.serving.export import (export_serving,  # noqa: E402
                                           load_serving)
from mv3d_tpu_torch.train.trainer import MV3D  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
HEADS = {".cls_fc8.weight": 0.01, ".reg_fc8.weight": 0.01,
         ".cls_out.weight": 0.01, ".off_out.weight": 0.001,
         ".ang_out.weight": 0.01}


def tiny_config(view_dtype="float32"):
    """AVOD's configuration over an 8 x 8 m BEV and a 64 x 96 image,
    1,024 anchors, 64 proposals, in f32."""
    cfg = avod_cars_config()
    return dataclasses.replace(
        cfg, top=dataclasses.replace(cfg.top, x_max=8.0, y_min=-4.0,
                                     y_max=4.0),
        image_width=96, image_height=64,
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        rpn=dataclasses.replace(cfg.rpn, nms_post_topn=64),
        pipeline=dataclasses.replace(cfg.pipeline, max_points=4096,
                                     top_view_dtype=view_dtype))


def drive(seed, n_frames=2):
    """Frames of a ground plane from 3 m out at the sensor's -1.73 m and
    three car-sized clusters, with random images."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_frames):
        g = np.stack([rng.uniform(3, 8, 1500), rng.uniform(-4, 4, 1500),
                      -1.73 + rng.normal(0, 0.02, 1500),
                      rng.uniform(0, 1, 1500)], 1)
        parts = [g]
        for _ in range(3):
            cx, cy = rng.uniform(4, 7), rng.uniform(-3, 3)
            parts.append(np.stack([cx + rng.uniform(-2, 2, 400),
                                   cy + rng.uniform(-0.8, 0.8, 400),
                                   rng.uniform(-1.7, -0.3, 400),
                                   rng.uniform(0, 1, 400)], 1))
        out.append((np.concatenate(parts).astype(np.float32),
                    (rng.rand(64, 96, 3) * 255).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(program MV3D, reference net, frames): seeded weights, the heads'
    last layers at Faster R-CNN's scales, BatchNorm calibrated on the
    frames by the reference."""
    torch.set_num_threads(4)
    cfg = tiny_config()
    d = tmp_path_factory.mktemp("avod")
    model = MV3D(cfg, device="cpu", seed=3, checkpoint_dir=str(d),
                 log_dir=str(d))
    state = model.model.state_dict()
    gen = torch.Generator().manual_seed(4)
    for k in state:
        for suffix, std in HEADS.items():
            if k.endswith(suffix):
                state[k] = torch.randn(state[k].shape, generator=gen) * std
    net = ref.AvodReference(ref.spec_from_tree(dataclasses.asdict(cfg)))
    net.load_state_dict(state)
    frames = drive(0)
    state = ref.calibrate(net, frames, 2)
    net.load_state_dict(state)
    model.model.load_state_dict(state)
    return model, net, frames


def _batch(frames, net):
    return ref.inputs(frames, 2, net.spec, "cpu")


def test_preset_sizes():
    """The cars preset: a 700 x 800 x (5 + 1) BEV, a 360 x 1200 image, the
    three poolings' BEV padding of 4 rows, 89,600 anchors."""
    cfg = avod_cars_config()
    assert (cfg.top.xn, cfg.top.yn, cfg.top.zn) == (700, 800, 5)
    assert cfg.rgb_shape == (360, 1200, 3)
    anchors, bases, stride, grid = avod_anchors(cfg)
    assert anchors.shape == (89600, 6) and stride == 5
    assert grid == (140, 160) and len(bases) == 4
    assert (cfg.rpn.nms_thresh, cfg.rpn.nms_post_topn) == (0.8, 300)
    assert (cfg.rcnn.nms_thresh, cfg.avod.final_topn) == (0.01, 100)
    assert -cfg.top.xn % 8 == 4
    assert kitti_config().model.arch == "mv3d"


@pytest.mark.parametrize("view_dtype", ["float32", "bfloat16"])
def test_bev_equals_reference_exactly(view_dtype):
    """The 6-channel BEV (five height slices and the log-16 density) and
    the point counts, bit for bit, in f32 and in the bf16 view."""
    cfg = tiny_config(view_dtype)
    spec = ref.spec_from_tree(dataclasses.asdict(cfg))
    pts, num, _ = ref.inputs(drive(1), 2, spec, "cpu")
    got, counts = lidar_to_bev_avod(pts, cfg, num.int())
    want, want_counts = ref.bev(pts, num, spec)
    assert got.dtype == getattr(torch, view_dtype)
    assert got.shape == (2, 80, 80, 6)
    assert torch.equal(got, want) and torch.equal(counts, want_counts)
    assert float(got[..., 5].max()) > 0.5 and float(counts.sum()) > 1000


def test_pyramids_and_rpn_match_reference(pair):
    """Both views' 32-channel maps, the non-empty anchors, their objectness
    and proposals."""
    model, net, frames = pair
    pts, num, rgb = _batch(frames, net)
    cfg = model.cfg
    top, counts = lidar_to_bev_avod(pts, cfg, num.int())
    with torch.no_grad():
        bev_map, img_map = model.model.features(top, rgb)
        maps = net.features(top, rgb)
        torch.testing.assert_close(bev_map, maps[0], **TOL)
        torch.testing.assert_close(img_map, maps[1], **TOL)
        inside = model.model.anchor_mask(counts)
        assert torch.equal(inside, ref.non_empty(counts, net.cells,
                                                 net.spec))
        assert 0 < int(inside.sum()) < inside.numel()
        score, props = model.model.rpn_outputs(bev_map, img_map, inside)
        for f in range(2):
            idx = torch.nonzero(inside[f])[:, 0]
            want_s, want_p = net.rpn_scores(maps, f, idx)
            torch.testing.assert_close(score[f, idx], want_s, **TOL)
            torch.testing.assert_close(props[f, idx], want_p, **TOL)
            assert bool((score[f][~inside[f]] == -torch.inf).all())


def test_detections_match_reference_eager_and_frozen(pair, tmp_path):
    """Final boxes and probabilities, eager and through a frozen artifact,
    with the counters it returns; the artifact's detections equal the
    eager ones bit for bit."""
    model, net, frames = pair
    want = ref.detect(net, frames, 2, 0.05)
    pts, num, rgb = _batch(frames, net)
    dets, counters = model.predict_from_points(pts, num.int(), rgb, 0.05,
                                               counters=True)
    for f in range(2):
        m = dets.mask[f]
        assert int(m.sum()) == len(want[f][1]) > 0
        torch.testing.assert_close(dets.probs[f][m],
                                   torch.from_numpy(want[f][1]), **TOL)
        torch.testing.assert_close(dets.boxes3d[f][m],
                                   torch.from_numpy(want[f][0]), **TOL)
    inside = model.model.anchor_mask(lidar_to_bev_avod(pts, model.cfg,
                                                       num.int())[1])
    assert counters[:, 0].tolist() == inside.sum(1).tolist()
    assert bool((counters[:, 1] >= 64).all())

    art = export_serving(model, str(tmp_path / "art"), batch_size=2,
                         score_threshold=0.05)
    served = load_serving(art, device="cpu")
    assert served.meta["output_names"][-1] == "counters"
    assert served.meta["counter_names"] == ["anchors", "nms_visited"]
    got = served.predict_batch(frames)
    for f in range(2):
        np.testing.assert_array_equal(got[f][1], dets.probs[f][
            dets.mask[f]].numpy())
        np.testing.assert_array_equal(got[f][0], dets.boxes3d[f][
            dets.mask[f]].numpy())


def test_serving_records_counters_under_a_profiler(pair, tmp_path):
    """While a profiler runs, a served request records its frames' summed
    counters as ``mv3d.count.<name>=<value>`` ranges, beside the stage
    ranges of AVOD's program; the export command writes an AVOD artifact
    (``--arch avod``) that the serve command answers from over HTTP."""
    from torch.profiler import ProfilerActivity, profile

    from mv3d_tpu_torch.cli import export as cli_export
    from mv3d_tpu_torch.cli import serve as cli_serve

    model, net, frames = pair
    art = export_serving(model, str(tmp_path / "art"), batch_size=2)
    served = load_serving(art, device="cpu")
    served.predict_batch(frames)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        served.predict_batch(frames)
    names = {e.name for e in prof.events()}
    counts = {n.split("=")[0]: int(n.split("=")[1]) for n in names
              if n.startswith("mv3d.count.")}
    pts, num, rgb = _batch(frames, net)
    _, counters = model.predict_from_points(pts, num.int(), rgb,
                                            counters=True)
    assert counts == {"mv3d.count.anchors": int(counters[:, 0].sum()),
                      "mv3d.count.nms_visited": int(counters[:, 1].sum())}
    stages = {"voxelize", "bev_pyramid", "img_pyramid", "rpn",
              "proposal_nms", "second_stage", "detect"}
    assert {"mv3d.program." + s for s in stages} <= names

    # the export command's AVOD, served by the serve command
    cli = str(tmp_path / "cli")
    cli_export.main(["--random-init", "--arch", "avod", "--device", "cpu",
                     "--out", cli, "--set", "top.x_max", "8.0", "--set",
                     "top.y_min", "-4.0", "--set", "top.y_max", "4.0",
                     "--set", "image_width", "96", "--set", "image_height",
                     "64", "--set", "rpn.nms_post_topn", "64", "--set",
                     "pipeline.max_points", "4096"])
    art = load_serving(cli, device="cpu")
    assert art.meta["counter_names"] == ["anchors", "nms_visited"]
    srv = cli_serve.make_server(cli, port=0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        buf = io.BytesIO()
        np.savez(buf, points=frames[0][0], rgb=frames[0][1])
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/predict",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            with np.load(io.BytesIO(r.read())) as z:
                boxes = z["boxes3d"]
    finally:
        srv.shutdown()
        srv.server_close()
    np.testing.assert_array_equal(boxes, art.predict(*frames[0])[0])


def _nms_case(seed, bsz=3, k=300, levels=20):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(bsz, k, 2, generator=g) * 50
    wh = torch.rand(bsz, k, 2, generator=g) * 10 + 1
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.randint(0, levels, (bsz, k), generator=g).float()
    valid = torch.rand(bsz, k, generator=g) > 0.2
    valid[-1] = False                                   # an empty frame
    return boxes, scores, valid


@pytest.mark.parametrize("max_out", [1, 5, 50, 300])
@pytest.mark.parametrize("seed", [0, 1])
def test_nms_topk_twin_equals_greedy(seed, max_out):
    """``nms_topk``'s picks are ``greedy_nms``'s to the index, ties (20
    score levels) included, whether ``max_out`` is reached early or never,
    with an empty frame; ``visited`` is the position of the last keep plus
    one, or every live box."""
    boxes, scores, valid = _nms_case(seed)
    gi, gm = nms_ops.greedy_nms(boxes, scores, valid, 0.3, max_out)
    ti, tm, visited = nms_ops.nms_topk(boxes, scores, valid, 0.3, max_out)
    assert torch.equal(gm, tm)
    assert torch.equal(gi[gm], ti[tm])
    assert int(tm[-1].sum()) == 0 and int(visited[-1]) == 0
    for f in range(2):
        n_live = int(valid[f].sum())
        if int(tm[f].sum()) < max_out:
            assert int(visited[f]) == n_live
        else:
            assert max_out <= int(visited[f]) <= n_live


def test_nms_topk_metre_boxes_offset_zero():
    """Offset 0 (boxes in metres): the plain loop of the reference keeps the
    same boxes."""
    boxes, scores, valid = _nms_case(5, levels=1000)
    idx, mask, _ = nms_ops.nms_topk(boxes, scores, valid, 0.8, 40,
                                    offset=0.0)
    for f in range(3):
        live = torch.nonzero(valid[f])[:, 0]
        order = live[torch.sort(scores[f, live], descending=True,
                                stable=True)[1]]
        keep = ref.greedy(boxes[f, order].numpy(), 0.0, 0.8, 40)
        assert idx[f][mask[f]].tolist() == order[keep].tolist()


def test_int8_transposed_conv_and_biased_dense_are_exact_on_integers():
    """The int8 transposed conv (zero-dilated input, flipped kernel) and an
    int8 dense layer with a bias equal the float ones where every operand
    is an integer in [-127, 127] and each scale is 1 (an amax of 127)."""
    import torch.nn.functional as F
    from mv3d_tpu_torch.models.avod_net import ConvTranspose2dTF
    from mv3d_tpu_torch.models.backbone import Linear
    g = torch.Generator().manual_seed(7)
    x = torch.randint(-127, 128, (2, 5, 4, 6), generator=g).float()
    x[0, 0, 0, 0] = 127
    up = ConvTranspose2dTF(5, 3, 3, 2, quant="int8").eval()
    w = torch.randint(-127, 128, (5, 3, 3, 3), generator=g).float()
    w[0, :, 2, 2] = 127        # each output channel's amax, once flipped
    up.weight.data.copy_(w)
    torch.testing.assert_close(up(x), F.conv_transpose2d(x, w, None, 2),
                               rtol=0, atol=0)
    dense = Linear(6, 4)
    dense.quant = "int8"
    dense.eval()
    wd = torch.randint(-127, 128, (4, 6), generator=g).float()
    wd[:, 0] = 127
    dense.weight.data.copy_(wd)
    dense.bias.data.copy_(torch.arange(4.0) - 1.5)
    xd = torch.randint(-127, 128, (3, 6), generator=g).float()
    xd[0, 0] = -127
    torch.testing.assert_close(dense(xd), xd @ wd.T + dense.bias,
                               rtol=0, atol=0)


def test_int8_reaches_every_layer_but_the_heads(pair):
    """``model.quant = "int8"`` (the benchmark's control): every conv,
    transposed conv and FC layer takes int8 products but the heads' last
    layers; the answers move off the float network's."""
    from mv3d_tpu_torch.models.avod_net import ConvTranspose2dTF
    from mv3d_tpu_torch.models.backbone import COMPUTE_LAYERS
    model, net, frames = pair
    cfg = model.cfg
    q = MV3D(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, quant="int8")), device="cpu", seed=3)
    q.model.load_state_dict(model.model.state_dict())
    heads = {"rpn.cls_fc8", "rpn.reg_fc8", "second_stage.cls_out",
             "second_stage.off_out", "second_stage.ang_out"}
    layers = {n: m.quant for n, m in q.model.named_modules()
              if isinstance(m, COMPUTE_LAYERS + (ConvTranspose2dTF,))}
    assert {n for n, v in layers.items() if v != "int8"} == heads
    assert sum(".ConvTranspose_0" in n for n in layers) == 6
    pts, num, rgb = _batch(frames, net)
    got = q.predict_from_points(pts, num.int(), rgb, 0.05)
    want = model.predict_from_points(pts, num.int(), rgb, 0.05)
    assert not torch.equal(got.probs, want.probs)


def test_avod_refuses_a_setting_it_does_not_read():
    """A field AVOD does not read (MV3D's ROI-align, its RPN's pre-NMS cut)
    cannot be set on an AVOD configuration; the preset sets none."""
    from mv3d_tpu_torch.models.avod_net import AVODNet
    cfg = tiny_config()
    assert cfg.unread_changed() == [] == avod_cars_config().unread_changed()
    for bad in (dataclasses.replace(cfg, model=dataclasses.replace(
                    cfg.model, roi_align_impl="matmul")),
                dataclasses.replace(cfg, rpn=dataclasses.replace(
                    cfg.rpn, nms_pre_topn=2000))):
        with pytest.raises(ValueError, match="does not read"):
            AVODNet(bad)


def test_box4c_round_trip():
    """box3d -> box_4c -> box3d keeps the footprint's centre, the sides
    (length the longer), the heights, and the yaw modulo 180 degrees; a
    box_4c of a rectangle survives the fit unchanged; the angle vector
    turns a box by 90 (sides swapped) or 180 degrees without moving its
    corners' set."""
    g = torch.Generator().manual_seed(7)
    n = 64
    b3 = torch.stack([torch.rand(n, generator=g) * 60,
                      torch.rand(n, generator=g) * 60 - 30,
                      -1.73 + torch.rand(n, generator=g) * 0.2,
                      3.5 + torch.rand(n, generator=g),
                      1.5 + torch.rand(n, generator=g) * 0.3,
                      1.4 + torch.rand(n, generator=g) * 0.3,
                      (torch.rand(n, generator=g) * 2 - 1) * np.pi], 1)
    b4 = box3d_ops.box3d_to_box4c(b3, -1.73)
    back = box3d_ops.box4c_to_box3d(b4, -1.73)
    torch.testing.assert_close(back[:, :6], b3[:, :6], rtol=0, atol=1e-4)
    turn = torch.remainder(back[:, 6] - b3[:, 6] + np.pi / 2, np.pi)
    torch.testing.assert_close(turn, torch.full_like(turn, np.pi / 2),
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(box3d_ops.box3d_to_box4c(back, -1.73)[:, 8:],
                               b4[:, 8:], rtol=0, atol=1e-5)
    corners = box3d_ops.box3d_corners(back)
    for ang in (b3[:, 6:7] + np.pi / 2, b3[:, 6:7] + np.pi):
        vec = torch.cat([torch.cos(ang), torch.sin(ang)], 1)
        turned = box3d_ops.align_orientation(back, vec)
        c2 = box3d_ops.box3d_corners(turned)
        d = (c2[:, :4, None, :2] - corners[:, None, :4, :2]).norm(dim=-1)
        assert float(d.amin(-1).amax()) < 1e-4
        diff = torch.remainder(turned[:, 6] - ang[:, 0] + np.pi, 2 * np.pi)
        assert float((diff - np.pi).abs().max()) <= np.pi / 4 + 1e-5


def test_port_and_reference_anchors_agree():
    """The program's anchors and footprints are the reference's."""
    cfg = tiny_config()
    spec = ref.spec_from_tree(dataclasses.asdict(cfg))
    anchors, bases, stride, (gh, gw) = avod_anchors(cfg)
    want, cells = ref.anchors(spec)
    assert torch.equal(torch.from_numpy(anchors), want)
    i = np.repeat(np.arange(gh), gw * len(bases))
    j = np.tile(np.repeat(np.arange(gw), len(bases)), gh)
    b = np.tile(bases, (gh * gw, 1))
    np.testing.assert_array_equal(
        np.stack([stride * i + b[:, 1], stride * i + b[:, 3],
                  stride * j + b[:, 0], stride * j + b[:, 2]], 1), cells)


@pytest.mark.cuda
def test_nms_topk_kernel_equals_plain_on_card():
    """The kernel against its plain twin at AVOD's proposal sizes (B=2,
    89,600 boxes, 300 and 1,024 kept at 0.8, metres) and its final NMS (300
    pixel boxes, 100 kept at 0.01, "+1"): identical kept positions,
    counts and visits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from mv3d_tpu_torch.ops.nms_topk import nms_topk_kernel
    cfg = avod_cars_config()
    g = torch.Generator().manual_seed(1)
    a = torch.from_numpy(avod_anchors(cfg)[0])[None].repeat(2, 1, 1)
    a[..., :2] += torch.randn(a[..., :2].shape, generator=g) * 0.3
    for k, max_out, thr, off in ((89600, 300, 0.8, 0.0),
                                 (89600, 1024, 0.8, 0.0),
                                 (300, 100, 0.01, 1.0)):
        boxes = box3d_ops.anchor_bev_boxes(a[:, :k])
        if off:
            boxes = torch.floor(boxes * 10)
        scores = torch.randint(0, 512, (2, k), generator=g).float()
        scores[torch.rand(2, k, generator=g) > 0.4] = -torch.inf
        s, order = torch.sort(scores, dim=1, descending=True, stable=True)
        b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        got = nms_topk_kernel(b.cuda().contiguous(), s.cuda().contiguous(),
                              max_out, thr, off)
        want = nms_ops.nms_sorted_plain(b, s, max_out, thr, off)
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y)
