"""A whole run of the serving cell at the tiny sizes on the CPU (the
look for a card skipped), with the timed path sound, broken underneath,
or replaced by the control: ``correct`` is true only for the sound run.
One more case runs the cell itself on the card, where there is one."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from h100bench_tiny import HERE, ROOT, tiny_cell
from harness import compare, serve_batch


def _run(**kw):
    config, mix, limits = tiny_cell()
    # a drive whose frames hold detections at the tiny sizes, so that a
    # missing or moved answer has something to miss
    return serve_batch.run(config, mix, limits, seed=2 ** 31 + 7,
                           seconds=1.0, traced=False, device="cpu", **kw)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"] and res["attempted"] > 0 and not res["failed"]
    assert res["reference_detections"] > 0
    # the f32 reference rounds otherwise than the bf16 program
    assert res["checks"]["unaccounted_share"]["value"] > 0.0
    assert set(res["e2e"]) == {"card_ms_per_frame", "peak_mem_mib",
                               "setup_s"}


def _half_left_out(fn):
    """Answers only for the first half of each batch: the rest come back
    empty."""
    def call(frames):
        out = fn(frames)
        half = len(out) // 2
        empty = (np.zeros((0, 8, 3), np.float32), np.zeros(0, np.float32))
        return out[:half] + [empty] * (len(out) - half)
    return call


def _answer_altered(fn):
    """Each batch's first answer moved by 0.5 m where it is produced."""
    def call(frames):
        out = fn(frames)
        boxes, probs = out[0]
        return [(boxes + np.float32(0.5), probs)] + out[1:]
    return call


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
def test_a_broken_path_is_not_correct(fault):
    res = _run(wrap=fault)
    assert not res["correct"]
    assert not compare.passed(res["checks"])


def test_the_control_is_not_correct():
    """The program's int8 path judged against the f32 reference."""
    res = _run(program_overrides={"model": {"quant": "int8"}})
    assert not res["correct"]


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "kitti.serve-b8", "--seed", "7", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
