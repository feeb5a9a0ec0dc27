"""The port stands alone: no jax and nothing of gdpt_tpu in gdpt_tpu_torch
or chip_smoke.py, CUDA by default, the CPU only when asked for."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import render
from gdpt_tpu_torch.scene import presets

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "gdpt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gdpt_tpu")


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "id", getattr(node.func, "attr", "")) in
              ("__import__", "import_module")):
            yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported_names(tree) if _forbidden(n)]
    assert not bad, f"{path}: imports {bad}"


def test_render_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        render.render(presets.cornell_box(4, 4, spp=1))


def test_render_on_cpu_when_asked():
    img = render.render(presets.cornell_box(8, 8, spp=1, max_depth=3), device="cpu")
    assert img.shape == (8, 8, 3) and img.dtype == np.float32
    assert np.isfinite(img).all() and img.mean() > 0


def test_package_runs_with_jax_unimportable():
    """A process where `import jax` and `import gdpt_tpu` fail renders."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['gdpt_tpu'] = None\n"
        "from gdpt_tpu_torch.integrators import render\n"
        "from gdpt_tpu_torch.scene import presets\n"
        "img = render.render(presets.cornell_box(4, 4, spp=1, max_depth=2), device='cpu')\n"
        "assert img.mean() > 0\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_cuda_or_package(tmp_path, where):
    """Without a card (this CPU host) or without the package beside it,
    chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
