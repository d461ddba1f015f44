"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

  * ``h100bench/configs/<config>.json``  the model configuration as run;
  * ``h100bench/traffic/<traffic>.json`` the traffic mix's parameters;
  * ``h100bench/metrics/<metric>.py``    one reader per per-layer metric;
  * ``h100bench/limits/<cell>.json``     the limits of the cell's check.

A later cell, mix, configuration or metric is added as new files and
entries; no file here names one.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


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
    return _load_json(os.path.join(root, config_entry(bench, name)["file"]))


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
