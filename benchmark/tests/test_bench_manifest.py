"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files; a file dropped into a copy is found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import manifest
from benchmark.tests import tiny

ROOT = manifest.ROOT
MAN = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16 and 1 <= len(MAN["per_layer"]) <= 128


def test_names_units_and_text_fields():
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    for group in (MAN["configs"], MAN["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in ([w["why"] for w in MAN["workloads"]] + [c["why"] for c in MAN["configs"]]
                 + [c["source"] for c in MAN["configs"]] + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_an_end_to_end_metric():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_workloads_and_configs():
    configs = {c["name"] for c in MAN["configs"]}
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert configs == {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] == c["reduced"]


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_every_cell_resolves_by_name(name):
    cell = manifest.Cell(name)
    assert cell.config["family"] in ("sd15", "flux")
    for fn in ("configure", "build", "pipeline_kwargs", "instrument", "check_steps", "check"):
        assert callable(getattr(cell.family, fn))
    assert cell.traffic["width"] and cell.prompts["prompts"]
    assert cell.limits
    reported = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert reported == set(cell.readers)
    assert "setup_s" in reported and len(cell.end_to_end) >= 2 and cell.per_layer
    for reader in cell.readers.values():
        assert callable(reader.read)
        for op in getattr(reader, "OPS", ()):
            mod = manifest.load_module("rooflines", op)
            assert callable(mod.shapes) and callable(mod.bound_s)
    for kind in ("unet", "vae", "clip") if cell.config["family"] == "sd15" else (
            "flux", "vae", "clip", "t5"):
        assert callable(manifest.load_module("flops", kind).count)


@pytest.mark.parametrize("kind", ["config", "traffic", "metric"])
def test_a_dropped_in_file_is_found_by_name(tmp_path, kind):
    """A new configuration, traffic mix or metric needs its file and its
    manifest entry, and no edit of any file already there."""
    tiny.make_root(str(tmp_path))
    bench = tmp_path / "benchmark"
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = {"name": "new-cell", "config": "tiny-sd15", "traffic": "tiny-txt2img", "chips": 1,
            "why": "test"}
    if kind == "config":
        cfg = dict(tiny.CONFIGS["tiny-sd15"], source="test2")
        (bench / "configs" / "tiny-sd15b.json").write_text(json.dumps(cfg))
        man["configs"].append({"name": "tiny-sd15b", "source": "test2", "reduced": [],
                               "file": "benchmark/configs/tiny-sd15b.json", "why": "test"})
        cell["config"] = "tiny-sd15b"
    elif kind == "traffic":
        spec = dict(tiny.TRAFFIC["tiny-txt2img"], width=256, height=256)
        (bench / "traffic" / "tiny-256.json").write_text(json.dumps(spec))
        cell["traffic"] = "tiny-256"
    else:
        (bench / "metrics" / "images.py").write_text("def read(run):\n    return len(run.images)\n")
        man["end_to_end"].append({"name": "images", "unit": "count", "better": "higher",
                                  "bound": 0.01, "source": "host_clock"})
    man["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (bench / "cells" / "new-cell.json").write_text(json.dumps({"limits": tiny.LIMITS}))
    found = manifest.Cell("new-cell", root=str(tmp_path), bench_dir=str(bench))
    if kind == "config":
        assert found.config["source"] == "test2"
    elif kind == "traffic":
        assert found.traffic["width"] == 256
    else:
        assert "images" in found.readers and found.readers["images"].read(
            type("R", (), {"images": [1, 2]})()) == 2


def test_files_are_named_as_names():
    for dirpath, dirnames, filenames in os.walk(manifest.HERE):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            assert NAME.match(f) or f.startswith("__"), f


def test_the_kernel_builds_are_ignored():
    """The port builds its kernels into build/ inside the checkout."""
    assert "build/" in open(os.path.join(ROOT, ".gitignore")).read().split()
