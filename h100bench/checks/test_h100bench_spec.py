"""BENCHMARK.json and the files the harness finds by its names."""

from __future__ import annotations

import dataclasses
import json
import os
import re

import pytest

from h100bench_tiny import HERE, ROOT
from harness import compare, spec

BENCH = spec.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_and_units_keep_to_the_contract():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    assert BENCH["paths"] == ["h100bench"]
    assert not {d for _, dirs, _ in os.walk(HERE) for d in dirs} & {
        "tests", "tools", "docs"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_are_found_by_name(cell):
    w = spec.cell(BENCH, cell)
    config = spec.load_config(BENCH, w["config"], ROOT)
    mix = spec.load_mix(w["traffic"])
    limits = spec.load_limits(cell)
    assert config["name"] == w["config"] and config["reduced"] == []
    assert config["family"] == "mv3d" and mix["kind"] == "serve_batch"
    found = spec.resolve(BENCH, cell)
    assert (found.entry, found.config, found.mix, found.limits) == (
        w, config, mix, limits)
    assert callable(found.driver.run)
    assert spec.reference(config).__name__ == "reference.mv3d"
    assert set(limits) == set(compare.NAMES)
    e2e = {m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metrics_of(BENCH, cell, "per_layer")
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(spec.load_reader(m["name"]).read)


@pytest.mark.parametrize("name", ["kitti", "didi2"])
def test_config_file_is_the_preset_as_run(name):
    """The file's tree is the preset at its published sizes, and both the
    program and the reference build their configuration from it."""
    from mv3d_tpu_torch.config import make_config
    from mv3d_tpu_torch.serving.export import config_from_dict

    from reference import mv3d as ref
    tree = spec.load_config(BENCH, name, ROOT)["config"]
    want = json.loads(json.dumps(dataclasses.asdict(make_config(name))))
    assert tree == want
    assert config_from_dict(tree) == make_config(name)
    assert dataclasses.asdict(ref.config_from_dict(tree)) == \
        dataclasses.asdict(make_config(name))


def test_unknown_cell_names_the_cells():
    with pytest.raises(KeyError, match="kitti.serve-b8"):
        spec.cell(BENCH, "no-such-cell")


@pytest.mark.parametrize("family", [None, "", "mv3d.twin", "../mv3d"])
def test_a_config_without_a_family_module_names_its_file(tmp_path, family):
    config = json.loads(open(os.path.join(HERE, "configs",
                                          "kitti.json")).read())
    if family is None:
        del config["family"]
    else:
        config["family"] = family
    (tmp_path / "lone.json").write_text(json.dumps(config))
    bench = {"configs": [{"name": "lone", "file": "lone.json"}]}
    with pytest.raises(KeyError, match="lone.json names no family"):
        spec.load_config(bench, "lone", str(tmp_path))


@pytest.mark.parametrize("kind", ["", "serve-batch", "harness.spec.x"])
def test_a_kind_that_names_no_module_is_refused(kind):
    with pytest.raises(KeyError, match="names no driver"):
        spec.driver({"kind": kind})


def test_merged_lays_nested_values_over():
    base = {"a": {"b": 1, "c": 2}, "d": 3}
    assert spec.merged(base, {"a": {"c": 5}}) == {"a": {"b": 1, "c": 5},
                                                  "d": 3}
    assert base["a"]["c"] == 2


def test_benchmark_fits_the_check_budget():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
