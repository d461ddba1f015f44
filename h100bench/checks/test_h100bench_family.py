"""A second architecture enters the benchmark as new files only.

A copy of the benchmark gains a family (its reference module, its
program adapter and a configuration), a traffic mix of a new kind with
its driver, a limits file and the entries in ``BENCHMARK.json``; its cell
is found as a run finds it and runs end to end at the tiny sizes on the
CPU, while every file the benchmark had hashes as it did. The harness
and ``run.py`` name no family: no import of the port or of a reference,
no MV3D configuration key or layer name."""

from __future__ import annotations

import ast
import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys

import torch

from h100bench_tiny import HERE, ROOT

FAMILY = "mv3dtwin"
CELL = "twin.serve-twin"
# the new family's heads start at scales of their own
TWIN_HEAD_STD = {".rpn_score.weight": 0.02, ".rpn_delta.weight": 0.005,
                 ".score.weight": 0.02, ".box_3.weight": 0.002}

NEW_FILES = {
    f"h100bench/reference/{FAMILY}.py": (
        '"""A second family: MV3D\'s reference under another name, its\n'
        'heads started at scales of their own."""\n\n'
        "from .mv3d import *  # noqa: F401,F403\n\n"
        f"HEAD_STD = {TWIN_HEAD_STD!r}\n"),
    f"h100bench/programs/{FAMILY}.py": (
        '"""The second family\'s program: MV3D\'s adapter."""\n\n'
        "from .mv3d import served  # noqa: F401\n"),
    "h100bench/harness/serve_twin.py": (
        '"""A second kind of mix: the ``serve_batch`` driver under another\n'
        'name."""\n\n'
        "from .serve_batch import run  # noqa: F401\n"),
    f"h100bench/limits/{CELL}.json": json.dumps({"unaccounted_share": 0.12}),
}

# run inside the copy: resolve the new cell as run.py does, then run it
# at the tiny sizes, sound and with an answer altered where it is produced
SCRIPT = f"""
import json, os, sys
sys.path.insert(0, os.path.join(os.getcwd(), "h100bench", "checks"))
import torch
from h100bench_tiny import tiny_cell
from harness import spec
from test_h100bench_faults import _answer_altered
found = spec.resolve(spec.load_benchmark(), {CELL!r})
ref = spec.reference(found.config)
config, mix, limits = tiny_cell({CELL!r})
out = {{"driver": found.driver.__name__, "reference": ref.__name__,
        "program": spec.program(found.config).__name__,
        "head_std": ref.HEAD_STD}}
for name, wrap in (("sound", None), ("altered", _answer_altered)):
    res = found.driver.run(config, mix, limits, seed=2 ** 31 + 7,
                           seconds=1.0, traced=False, device="cpu",
                           wrap=wrap, keep=True)
    state = res["kept"]["inputs"].state
    out[name] = {{"correct": res["correct"], "attempted": res["attempted"],
                  "failed": res["failed"], "checks": res["checks"],
                  "box_3_std": [float(v.float().std()) for k, v in
                                state.items() if k.endswith(".box_3.weight")]}}
print(json.dumps(out))
"""


def _hashes(root: str):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _add_cell(dst: str, bench: dict) -> dict:
    """The new family's, kind's and cell's files and entries, written into
    the copy at ``dst``; returns the appended ``BENCHMARK.json``."""
    for rel, text in NEW_FILES.items():
        path = os.path.join(dst, rel)
        assert not os.path.exists(path), rel
        with open(path, "w") as f:
            f.write(text)
    with open(os.path.join(HERE, "configs", "kitti.json")) as f:
        config = json.load(f)
    config.update(name="twin", family=FAMILY)
    with open(os.path.join(dst, "h100bench", "configs", "twin.json"),
              "w") as f:
        json.dump(config, f)
    with open(os.path.join(HERE, "traffic", "serve-b8.json")) as f:
        mix = json.load(f)
    mix["kind"] = "serve_twin"
    with open(os.path.join(dst, "h100bench", "traffic", "serve-twin.json"),
              "w") as f:
        json.dump(mix, f)
    new = copy.deepcopy(bench)
    new["configs"].append({
        "name": "twin", "source": "https://arxiv.org/abs/1611.07759",
        "file": "h100bench/configs/twin.json", "reduced": [],
        "why": "a second family, for the check"})
    new["workloads"].append({
        "name": CELL, "config": "twin", "traffic": "serve-twin",
        "chips": 1, "why": "a second family under a new kind of mix"})
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(new, f, indent=1)
    return new


def test_a_second_family_enters_as_new_files(tmp_path):
    dst = str(tmp_path / "checkout")
    shutil.copytree(HERE, os.path.join(dst, "h100bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    before = _hashes(os.path.join(dst, "h100bench"))
    assert before == _hashes(HERE)
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    new = _add_cell(dst, bench)

    # the port comes from the repository, the benchmark from the copy
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, cwd=dst, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert (got["driver"], got["reference"], got["program"]) == (
        "harness.serve_twin", f"reference.{FAMILY}", f"programs.{FAMILY}")
    assert got["head_std"] == TWIN_HEAD_STD
    sound, altered = got["sound"], got["altered"]
    assert sound["correct"] and sound["attempted"] > 0
    assert not sound["failed"]
    assert not altered["correct"]
    assert (altered["checks"]["unaccounted_share"]["value"]
            > altered["checks"]["unaccounted_share"]["limit"])
    # the weights were drawn with the new family's head table
    assert sound["box_3_std"] and all(
        abs(s / TWIN_HEAD_STD[".box_3.weight"] - 1.0) < 0.1
        for s in sound["box_3_std"])

    if not torch.cuda.is_available():
        # run.py finds the new cell, then stops at the look for a card
        run = subprocess.run(
            [sys.executable, os.path.join("h100bench", "run.py"),
             "--workload", CELL, "--seed", "1", "--seconds", "1",
             "--trace", "0"],
            capture_output=True, text=True, cwd=dst, env=env, timeout=300)
        assert run.returncode == 2 and run.stdout == ""
        assert f"the cell {CELL} needs 1 CUDA card" in run.stderr

    after = _hashes(os.path.join(dst, "h100bench"))
    assert {k: after[k] for k in before} == before
    added = {os.path.join("configs", "twin.json"),
             os.path.join("traffic", "serve-twin.json")} | {
        os.path.relpath(k, "h100bench") for k in NEW_FILES}
    assert set(after) - set(before) == added
    for key in ("configs", "workloads"):
        assert new[key][:len(bench[key])] == bench[key]
    assert {k: v for k, v in new.items() if k not in ("configs", "workloads")
            } == {k: v for k, v in bench.items()
                  if k not in ("configs", "workloads")}


# what only a family's own files may name
MV3D_KEYS = {"top", "rcnn", "rpn", "pipeline", "model", "front", "rgb_shape"}
MV3D_LAYERS = ("rpn_score", "rpn_delta", ".score.", "box_3")


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant):
                yield body[0].value


def test_the_harness_names_no_family():
    paths = [os.path.join(HERE, "run.py")] + [
        os.path.join(HERE, "harness", f)
        for f in sorted(os.listdir(os.path.join(HERE, "harness")))
        if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        docs = {id(d) for d in _docstrings(tree)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                names = []
            for name in names:
                assert name.split(".")[0] not in (
                    "mv3d_tpu_torch", "reference", "programs"), (path, name)
            if isinstance(node, ast.Attribute):
                assert node.attr not in MV3D_KEYS, (path, node.attr)
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert node.value not in MV3D_KEYS, (path, node.value)
                assert not any(n in node.value for n in MV3D_LAYERS), (
                    path, node.value)
