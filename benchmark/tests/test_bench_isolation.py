"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: gdpt_tpu_torch is not gdpt_tpu."""

import ast
import subprocess
import sys
import types

import pytest

from benchmark.harness import session
from benchmark.tests.conftest import CELLS, ROOT, cpu_run, load_cell


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_benchmark_source_imports_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not set(_imports(path)) & session.FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert "gdpt_tpu_torch" not in set(_imports(path)), path


def test_a_run_loads_no_jax():
    code = ("import sys, io, time\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from benchmark.tests.conftest import load_cell, cpu_run\n"
            f"cpu_run(load_cell({CELLS[0]!r}))\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    names = set(p.stdout.split())
    assert "gdpt_tpu_torch" in names and not names & session.FORBIDDEN


def test_a_run_holding_jax_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as e:
        cpu_run(load_cell(CELLS[0]))
    assert e.value.code == 3


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gdpt_tpu_torch_extra", types.ModuleType("x"))
    res, out, _ = cpu_run(load_cell(CELLS[0]))
    assert res["correct"] and out.strip()
