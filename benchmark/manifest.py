"""``BENCHMARK.json`` and the files its names lead to.

A cell names a configuration and a traffic mix; the harness finds each by
name, with no list of them in code:

- ``benchmark/configs/<config>.json``: the sizes, precision and source;
  its ``family`` names ``benchmark/families/<family>.py``, which builds the
  program's models from seeded weights and holds the comparison with the
  plain reference;
- ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters;
- ``benchmark/cells/<cell>.json``: the cell's limits for ``correct``;
- ``benchmark/metrics/<metric>.py``: one reader per metric;
- ``benchmark/rooflines/<op>.py`` and ``benchmark/flops/<family>.py``:
  the bounds and operation counts those readers use.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def load_module(kind: str, name: str, bench_dir: str = HERE):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots and
    dashes)."""
    path = os.path.join(bench_dir, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with everything its names lead to."""

    def __init__(self, name: str, root: str = ROOT, bench_dir: str = HERE):
        man = manifest(root)
        cells = {w["name"]: w for w in man["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.bench_dir = bench_dir
        self.spec = cells[name]
        self.chips = int(self.spec["chips"])
        configs = {c["name"]: c for c in man["configs"]}
        self.config_entry = configs[self.spec["config"]]
        self.config = load_json(root, self.config_entry["file"])
        self.family = load_module("families", self.config["family"], bench_dir)
        self.traffic = load_json(bench_dir, "traffic", self.spec["traffic"] + ".json")
        self.prompts = load_json(bench_dir, self.traffic["prompts"])
        self.limits: Dict[str, float] = load_json(bench_dir, "cells", name + ".json")["limits"]
        self.end_to_end = [m for m in man["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in man["per_layer"] if self._reports(m)]
        self.readers = {m["name"]: load_module("metrics", m["name"], bench_dir)
                        for m in self.end_to_end + self.per_layer}
        self.run_seconds = int(man["run_seconds"])

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end
