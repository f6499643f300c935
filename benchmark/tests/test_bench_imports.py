"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under ``benchmark/``, and nothing of the program in the plain
reference. Names are compared whole, by their top-level part:
``lightdiffusion_next_tpu_torch`` is the port and is not
``lightdiffusion_next_tpu``."""

from __future__ import annotations

import ast
import glob
import os

import pytest

from benchmark import harness, manifest

JAX_NAMES = {"jax", "jaxlib", "flax", "lightdiffusion_next_tpu"}
PROGRAM = "lightdiffusion_next_tpu_torch"


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(glob.glob(os.path.join(manifest.HERE, "**", "*.py"), recursive=True))
REFERENCE = sorted(glob.glob(os.path.join(manifest.HERE, "reference", "*.py")))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, manifest.HERE))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", REFERENCE, ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert PROGRAM not in names
    assert names <= {"__future__", "math", "typing", "numpy", "torch", "scipy", "benchmark"}


def test_reference_imports_only_the_yardstick_of_the_benchmark():
    for path in REFERENCE:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("benchmark"):
                assert node.module in ("benchmark.reference", "benchmark.weights"), path


def test_the_port_is_not_the_jax_package(monkeypatch):
    """The run-time check compares whole top-level names."""
    monkeypatch.setitem(__import__("sys").modules, "lightdiffusion_next_tpu_torch_x", object())
    assert "lightdiffusion_next_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(__import__("sys").modules, "jaxlib.fake", object())
    assert harness.forbidden_modules() == ["jaxlib.fake"]
