"""Find a cell's pieces by the names ``BENCHMARK.json`` and its files
give them.

  * ``h100bench/configs/<config>.json``  the model configuration as run,
    whose ``family`` names its architecture;
  * ``h100bench/reference/<family>.py``  the family's plain reference and
    what the harness needs to know of the family;
  * ``h100bench/programs/<family>.py``   the family's adapter to the
    port's entry points;
  * ``h100bench/traffic/<traffic>.json`` the traffic mix's parameters,
    whose ``kind`` names its driver;
  * ``h100bench/harness/<kind>.py``      the driver of that kind of mix;
  * ``h100bench/metrics/<metric>.py``    one reader per per-layer metric;
  * ``h100bench/limits/<cell>.json``     the limits of the cell's check.

A later cell, mix, kind, configuration, architecture or metric is added
as new files and entries; no file here names one.
"""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Any, Dict, List, NamedTuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
# a family or a kind names a module
MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> Dict[str, Any]:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_entry(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(bench: Dict[str, Any], name: str,
                root: str = ROOT) -> Dict[str, Any]:
    """The configuration file of ``name``; its ``family`` has to name a
    module (a file without one is refused, naming the file)."""
    path = config_entry(bench, name)["file"]
    config = _load_json(os.path.join(root, path))
    if not MODULE.match(str(config.get("family", ""))):
        raise KeyError(f"{path} names no family: its \"family\" key has to "
                       f"name h100bench/reference/<family>.py and "
                       f"h100bench/programs/<family>.py")
    return config


def reference(config: Dict[str, Any]) -> ModuleType:
    """The configuration's family's reference module
    (``h100bench/reference/<family>.py``)."""
    return importlib.import_module("reference." + config["family"])


def program(config: Dict[str, Any]) -> ModuleType:
    """The configuration's family's program adapter
    (``h100bench/programs/<family>.py``)."""
    return importlib.import_module("programs." + config["family"])


def driver(mix: Dict[str, Any]) -> ModuleType:
    """The driver of the mix's ``kind`` (``h100bench/harness/<kind>.py``):
    its ``run(config, mix, limits, seed, seconds, traced, device, t0)``
    runs the cell once."""
    kind = str(mix.get("kind", ""))
    if not MODULE.match(kind):
        raise KeyError(f"the traffic mix's kind {kind!r} names no driver "
                       f"module")
    return importlib.import_module("harness." + kind)


class Cell(NamedTuple):
    """A cell's entry and the pieces it names."""
    entry: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    driver: ModuleType


def resolve(bench: Dict[str, Any], name: str, root: str = ROOT,
            here: str = HERE) -> Cell:
    """The cell ``name`` with its configuration, mix, limits and driver."""
    entry = cell(bench, name)
    mix = load_mix(entry["traffic"], here)
    return Cell(entry, load_config(bench, entry["config"], root), mix,
                load_limits(name, here), driver(mix))


def load_mix(name: str, here: str = HERE) -> Dict[str, Any]:
    return _load_json(os.path.join(here, "traffic", name + ".json"))


def load_limits(cell_name: str, here: str = HERE) -> Dict[str, float]:
    return _load_json(os.path.join(here, "limits", cell_name + ".json"))


def metrics_of(bench: Dict[str, Any], cell_name: str, kind: str
               ) -> List[Dict[str, Any]]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics the cell
    reports: those that list it under ``workloads``, and those without a
    list (a per-layer metric without one goes wherever the end-to-end
    metric it moves is reported)."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_reader(metric: str, here: str = HERE):
    """The module ``h100bench/metrics/<metric>.py``: its ``read(rec)``
    returns the metric's value from a traced run's record, or None where
    the record holds nothing to read."""
    path = os.path.join(here, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """``base`` with the nested dict ``over`` laid over it."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def run_config(config: Dict[str, Any], mix: Dict[str, Any]
               ) -> Dict[str, Any]:
    """The configuration tree the cell runs: the configuration file's
    ``config`` with the mix's ``overrides`` laid over it."""
    return merged(config["config"], mix.get("overrides", {}))
