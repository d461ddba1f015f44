"""A cell at the port's tiny test sizes, for the benchmark's CPU checks:
the kitti configuration over the tiny grid, the serve mix at two frames a
batch, a sensor with 1-degree steps."""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402

TINY = {
    "top": {"x_max": 16.0, "y_min": -6.0, "y_max": 6.0, "x_div": 0.2,
            "y_div": 0.2},
    "front": {"width": 64, "height": 32},
    "rpn": {"nms_pre_topn": 200, "nms_post_topn": 16},
    "rcnn": {"batch_size": 32},
    "pipeline": {"max_points": 2048, "max_gt": 8},
    "image_width": 96, "image_height": 64,
}


def tiny_cell(name: str = "kitti.serve-b8"):
    """(config, mix, limits) of ``name`` cut to the tiny sizes."""
    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, name)
    config = spec.load_config(bench, cell["config"], ROOT)
    config["config"] = spec.merged(config["config"], TINY)
    config["sensor"]["azimuth_step_deg"] = 1.0
    mix = spec.load_mix(cell["traffic"])
    mix.update(batch=2, pool_frames=4, warmup_requests=1, trace_requests=2,
               card_requests=2)
    return config, mix, spec.load_limits(cell["name"])
