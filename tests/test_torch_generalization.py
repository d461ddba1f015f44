"""The port's learning gate: the counterpart of
``tests/test_generalization.py::test_heldout_generalization``.

``mv3d_tpu_torch.cli.rehearsal.main`` trains on 8 frames of the synthetic
fixture (10 frames, the JAX command's draws, split 8/2) in the two-stage
schedule (150 iterations a stage, B=2) and scores the 2 held-out frames:
their mean 3D IoU must clear the JAX gate's floor, 0.30 (the JAX
package's records give 0.52). Every held-out pose is an independent draw,
so a model that only memorized the training frames scores about 0. Same
fixture, overrides (JAX's ``TINY_OVERRIDES``), flags, floor and
assertions as the JAX test; the port runs with ``--device cpu`` here and
with ``--device cuda`` in ``chip_smoke.py``'s ``learning`` phase.

Two faults, each also in the JAX package, held the port at 0.000 (the
JAX gate, run on the CPU, scores 0.000 too): the loader kept the first
``max_points`` (2048) of a fixture frame's 7,000 points, all ground, so
no car reached the views (``data/host_aux.crop_pad`` now keeps an evenly
spaced subset, ``within_budget``); and the rehearsal's prediction XML
dropped every car right of the sensor (the tracking saver's
``0 < ty < 8`` gate). The proposal layer ranks the RPN's raw logits, as
the JAX package's does, and keeps no anchor whose fg logit is at or
under -0.5: a held-out frame whose RPN ends there gets no detection.
Measured on an 8-core CPU host with torch's default threads: held-out
IoU 0.509; the result depends on the run's reduction order (one thread:
0.2148, one held-out frame without a proposal;
``tools/torch_learning_spread.py``).

Marked ``slow``: two 150-iteration stages take about 80 s on an 8-core
CPU host.
"""

import json
import os

import pytest

from test_cli_mains import TINY_OVERRIDES
from test_generalization import IOU_FLOOR


@pytest.mark.slow
def test_heldout_generalization(tmp_path):
    from mv3d_tpu_torch.cli.rehearsal import main

    cfgfile = tmp_path / "tiny.json"
    cfgfile.write_text(json.dumps(TINY_OVERRIDES))
    out = str(tmp_path / "gen")
    res = main(["--synthetic-fixture", "--fixture-frames", "10", "-o", out,
                "-i", "150", "-b", "2", "--score-threshold", "0.05",
                "--split-fraction", "0.8", "--config", str(cfgfile),
                "--device", "cpu"])

    with open(os.path.join(out, "splits", "train.txt")) as f:
        train_tags = set(f.read().split())
    with open(os.path.join(out, "splits", "val.txt")) as f:
        val_tags = set(f.read().split())
    assert len(val_tags) == 2 and len(train_tags) == 8
    assert not (train_tags & val_tags)

    iou = res["iou_per_obj"]["All"]
    assert iou > IOU_FLOOR, (
        f"held-out 3D IoU {iou:.3f} <= floor {IOU_FLOOR}: the port stopped "
        f"generalizing to unseen poses (train tags {sorted(train_tags)})")

    lo = min(res["pr_per_iou"])
    pr = res["pr_per_iou"][lo]
    assert pr["recall"] > 0.0 and pr["precision"] > 0.0, res["pr_per_iou"]

    assert os.path.exists(os.path.join(out, "eval", "iou_per_obj.csv"))
    assert os.path.exists(os.path.join(out, "eval", "pr_per_iou.csv"))
    print(f"generalization gate (port): held-out IoU {iou:.3f} "
          f"(floor {IOU_FLOOR}), PR@{lo}: {pr}")
