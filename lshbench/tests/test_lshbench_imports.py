"""Nothing the benchmark runs loads JAX or the JAX package `repro`,
compared by whole top-level module names (`repro_torch` is the program
and passes), and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from lshbench import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sorted(HERE.rglob("*.py")):
        assert not imported_top_names(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        assert imported_top_names(path) <= {"__future__", "torch"}, path


def test_whole_top_level_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_probe",
                        types.ModuleType("repro_torch_probe"))
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.probe",
                        types.ModuleType("repro.probe"))
    assert "repro" in harness.forbidden_modules()


RUN = """
import importlib.util, json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src", {tests!r}]
spec = importlib.util.spec_from_file_location("run", {root!r} + "/lshbench/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
from tiny import run as run_cell, tiny_cell
for name in {cells!r}:
    assert run_cell(tiny_cell(name))["correct"]
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


@pytest.mark.parametrize("cells", [["lj1m-can16-hamming.device8192",
                                    "lj1m-1node-sparse.batch1024"]])
def test_a_run_loads_no_forbidden_module(cells):
    code = RUN.format(root=str(ROOT), tests=str(HERE / "tests"), cells=cells)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "lshbench" in loaded
    assert not loaded & set(harness.FORBIDDEN)
