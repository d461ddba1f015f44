"""The ``avod`` family's cell, ``avod_cars.serve-b8-hwc``, on the CPU: its
pieces are found by name, its configuration file is the port's
``avod_cars_config()`` as run and holds only what AVOD reads, and a tiny
run is correct while a planted fault is not, and a traced one reads the
program's counters."""

from __future__ import annotations

import pytest
import torch

from h100bench_tiny import ROOT
from harness import serve_batch, spec
from test_h100bench_faults import _answer_altered

CELL = "avod_cars.serve-b8-hwc"
# AVOD's configuration over a 16 x 12 m BEV (3,072 anchors), a 64 x 96
# image and 64 proposals, in the published widths
TINY = {"top": {"x_max": 16.0, "y_min": -6.0, "y_max": 6.0},
        "image_width": 96, "image_height": 64,
        "rpn": {"nms_post_topn": 64}, "pipeline": {"max_points": 4096}}
SEED = 2 ** 31 + 11


def _tiny():
    bench = spec.load_benchmark(ROOT)
    found = spec.resolve(bench, CELL)
    config = dict(found.config)
    config["config"] = spec.merged(config["config"], TINY)
    config["sensor"] = dict(config["sensor"], azimuth_step_deg=1.0)
    mix = dict(found.mix, batch=2, pool_frames=4, warmup_requests=1,
               trace_requests=2, card_requests=2)
    return config, mix, found.limits


def _run(traced=False, **kw):
    config, mix, limits = _tiny()
    kw.setdefault("device", "cpu")
    return serve_batch.run(config, mix, limits, seed=SEED, seconds=1.0,
                           traced=traced, **kw)


def test_the_cells_pieces_are_found_by_name():
    bench = spec.load_benchmark(ROOT)
    found = spec.resolve(bench, CELL)
    assert found.entry["chips"] == 1
    assert found.config["family"] == "avod"
    assert found.driver is serve_batch
    assert spec.reference(found.config).__name__ == "reference.avod"
    assert spec.program(found.config).__name__ == "programs.avod"
    assert set(found.limits) == {"unaccounted_share"}
    names = {m["name"] for m in spec.metrics_of(bench, CELL, "per_layer")}
    assert names == {
        "card_ms.avod." + s for s in (
            "voxelize", "bev_pyramid", "img_pyramid", "rpn", "proposal_nms",
            "second_stage", "detect")} | {
        "mfu.avod.serve", "launches.avod.serve", "voxelize_sweep_roofline",
        "nms_topk_roofline", "anchors.avod", "nms_visited.avod",
        "bn_relu_ms.avod"}
    for name in names:
        assert spec.load_reader(name).read({"requests": []}) is None


def test_the_configuration_file_is_the_preset_as_run():
    from mv3d_tpu_torch.config import avod_cars_config
    from mv3d_tpu_torch.serving.export import config_from_dict
    found = spec.resolve(spec.load_benchmark(ROOT), CELL)
    assert config_from_dict(found.config["config"]) == avod_cars_config()
    assert config_from_dict(spec.run_config(found.config, found.mix)) \
        == avod_cars_config()
    assert found.config["reduced"] == []
    tree = found.config["config"]
    for key in avod_cars_config().UNREAD:
        head, _, leaf = key.partition(".")
        assert (leaf not in tree.get(head, {})) if leaf \
            else head not in tree, key


def test_a_tiny_run_is_correct_and_a_fault_is_not():
    sound = _run()
    assert sound["correct"] and sound["attempted"] > 0
    assert sound["reference_detections"] > 0
    assert sound["checks"]["unaccounted_share"]["value"] < 0.05
    altered = _run(wrap=_answer_altered)
    assert not altered["correct"]
    c = altered["checks"]["unaccounted_share"]
    assert c["value"] > c["limit"]


def test_a_traced_tiny_run_reads_the_counters():
    """The two counters come from the served program through the trace's
    host events; the stage readers find their ranges (no card here, so no
    device time); the FLOPs are the reference's."""
    res = _run(traced=True)
    rec = res["record"]
    anchors = spec.load_reader("anchors.avod").read(rec)
    visited = spec.load_reader("nms_visited.avod").read(rec)
    assert anchors is not None and 0 < anchors <= 3072
    assert visited is not None and 64 <= visited <= anchors
    assert spec.load_reader("card_ms.avod.rpn").read(rec) == 0.0
    assert rec["flops_per_frame"] > 0
    assert rec["sizes"]["nms_calls"] == [[3072, 64], [64, 100]]


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(device="cuda")
    assert res["correct"]
