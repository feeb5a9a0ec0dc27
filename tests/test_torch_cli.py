"""The port's command-line entry point (cli.py, __main__.py), on the CPU.

    python -m gdpt_tpu_torch scene.xml [-o out.exr] [--spp N] [--seed S]
        [--checkpoint-every N] [--profile DIR] [--device cuda|cpu] [-t N]

The scene files are written by scene/xml_writer.py into tmp_path.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gdpt_tpu_torch import cli
from gdpt_tpu_torch.core import image as timage
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.scene import parser, presets, xml_writer

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]


def _cbox_xml(tmp_path, integrator="path", spp=2, **kw):
    return xml_writer.write_scene(str(tmp_path), **presets.cornell_box_parts(
        8, 8, spp, integrator, 3), **kw)


def test_main_writes_the_in_process_render(tmp_path):
    xml = _cbox_xml(tmp_path)
    out = str(tmp_path / "out.exr")
    cli.main([xml, "-o", out, "--device", "cpu", "--seed", "4", "-t", "8"])
    scene, _ = parser.parse_scene(xml)
    np.testing.assert_array_equal(timage.read_exr(out),
                                  trender.render(scene, seed=4, device="cpu"))


def test_output_name_from_the_scene_and_spp_override(tmp_path, monkeypatch):
    xml = _cbox_xml(tmp_path, output="named.pfm")
    monkeypatch.chdir(tmp_path)
    cli.main([xml, "--device", "cpu", "--spp", "3"])
    scene, name = parser.parse_scene(xml, spp=3)
    assert name == "named.pfm"
    np.testing.assert_array_equal(timage.read_pfm(str(tmp_path / "named.pfm")),
                                  trender.render(scene, device="cpu"))


@pytest.mark.parametrize("integrator", ["gradpath", "depth"])
def test_other_integrators(tmp_path, integrator):
    xml = _cbox_xml(tmp_path, integrator)
    out = str(tmp_path / "out.exr")
    cli.main([xml, "-o", out, "--device", "cpu"])
    scene, _ = parser.parse_scene(xml)
    np.testing.assert_array_equal(timage.read_exr(out), trender.render(scene, device="cpu"))


def test_module_runs_as_a_subprocess(tmp_path):
    xml = _cbox_xml(tmp_path)
    out = tmp_path / "sub.exr"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "gdpt_tpu_torch", xml, "-o", str(out),
                           "--spp", "1", "--device", "cpu"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Wrote" in proc.stdout
    img = timage.read_exr(str(out))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0


def test_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([_cbox_xml(tmp_path), "-o", str(tmp_path / "x.exr")])
    assert not (tmp_path / "x.exr").exists()


def test_subprocess_without_a_card_fails_naming_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "gdpt_tpu_torch", _cbox_xml(tmp_path)],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA" in proc.stderr


def test_checkpoint_every(tmp_path):
    xml = _cbox_xml(tmp_path, spp=4)
    out = str(tmp_path / "ck.exr")
    cli.main([xml, "-o", out, "--device", "cpu", "--checkpoint-every", "2"])
    with np.load(out + ".ckpt.npz") as ck:
        assert int(ck["samples_done"]) == 4 and ck["acc"].shape == (3, 64)
    scene, _ = parser.parse_scene(xml)
    np.testing.assert_allclose(timage.read_exr(out), trender.render(scene, device="cpu"),
                               atol=1e-6)
    # A second run resumes from the finished checkpoint and renders nothing more.
    cli.main([xml, "-o", out, "--device", "cpu", "--checkpoint-every", "2"])
    np.testing.assert_allclose(timage.read_exr(out), trender.render(scene, device="cpu"),
                               atol=1e-6)


def test_profile_writes_a_trace(tmp_path):
    xml = _cbox_xml(tmp_path, spp=1)
    cli.main([xml, "-o", str(tmp_path / "p.exr"), "--device", "cpu", "--profile",
              str(tmp_path / "trace")])
    trace = tmp_path / "trace" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    assert (tmp_path / "p.exr").exists()


def test_main_module_runs_nothing_when_imported():
    import importlib

    importlib.import_module("gdpt_tpu_torch.__main__")
