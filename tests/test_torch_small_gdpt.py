"""The port's small_gdpt example (gdpt_tpu_torch/examples/small_gdpt.py)
against the reference's examples/small_gdpt_tpu.py, on the CPU.

smallpt_scene at 32x24, 2 spp (eight spheres: brute force, a Disney metal
and a rough dielectric ball, depth 8) is built by both packages, held leaf
for leaf, and rendered by both packages' render_gradpath: the primal, the
brute-force primal and both gradients at the gate of
tests/test_torch_gdpt_perray.py (at least 99% of values within rtol 1e-3 /
atol 1e-4, each buffer's mean within 0.1% of the primal's) on the pixels
where the reference's primal is finite (all but one, NaN there and 0 in
the port), and the reconstruction against the reference's Poisson solve of
the port's buffers (the reference's own is lost to the NaN). main() writes
the prototype's four PFMs, which read back as the render's buffers.
"""

import dataclasses
import os

import numpy as np
import pytest

from gdpt_tpu_torch.examples import small_gdpt

from test_torch_bench import reference_script
from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_volpath import gate

_CACHE = {}


def _reference_example():
    return reference_script("examples/small_gdpt_tpu.py")


def _renders():
    if "r" not in _CACHE:
        from gdpt_tpu.integrators import gdpt as jgdpt
        from gdpt_tpu_torch.integrators import gdpt as tgdpt

        js = _reference_example().smallpt_scene(32, 24, spp=2)
        ts = small_gdpt.smallpt_scene(32, 24, spp=2)
        jr, ja = jgdpt.render_gradpath(js, return_aux=True)
        tr, ta = tgdpt.render_gradpath(ts, return_aux=True, device="cpu")
        _CACHE["r"] = (js, ts, dict(ja, recon=jr), dict(ta, recon=tr))
    return _CACHE["r"]


def test_scenes_are_equal():
    from test_torch_scene import _assert_tree

    js, ts, _, _ = _renders()
    _assert_tree(js.device, ts.device)
    assert dataclasses.asdict(js.static) == dataclasses.asdict(ts.static)
    assert ts.static.use_brute_force and ts.static.n_spheres == 8


@pytest.mark.parametrize("name", ["primal", "primal_bf", "gx", "gy"])
def test_render_gradpath_matches_reference(name):
    """The buffers at the gate on every pixel where the reference's primal
    is finite. At this size one lane's primal is NaN in the reference's
    compiled program and 0 in the port, as in the reference's own program
    run without jit (ROADMAP.md C); every other pixel agrees."""
    _, _, ref, port = _renders()
    fin = np.isfinite(np.asarray(ref["primal"])).all(axis=-1)
    assert (~fin).sum() <= 1 and np.isfinite(np.asarray(port[name])).all()
    scale = float(np.mean(np.asarray(ref["primal"])[fin]))
    gate(np.asarray(port[name])[fin], np.asarray(ref[name])[fin], scale)


def test_reconstruction_matches_the_reference_solve():
    """The reference's reconstruction is lost to that NaN pixel (its
    screened-Poisson solve spreads it, and its render zeroes the
    non-finite result); the port's is held against the reference's solve
    of the port's own primal and gradients."""
    import jax.numpy as jnp
    from gdpt_tpu.ops import poisson as jpoisson

    js, _, ref, port = _renders()
    assert not np.asarray(ref["recon"]).any()
    want = np.asarray(jpoisson.screened_poisson_solve(
        *(jnp.asarray(port[k]) for k in ("primal", "gx", "gy")),
        js.static.options.gdpt_alpha))
    gate(np.asarray(port["recon"]), want, float(np.mean(port["primal"])))


def test_main_writes_the_prototypes_images(tmp_path, monkeypatch):
    from gdpt_tpu_torch.core import image

    monkeypatch.chdir(tmp_path)
    recon, aux = small_gdpt.main(["2", "--width", "32", "--height", "24", "--device", "cpu",
                                  "--out", "recon.pfm"])
    assert sorted(os.listdir(tmp_path)) == ["image.pfm", "image_dx.pfm", "image_dy.pfm",
                                            "recon.pfm"]
    np.testing.assert_array_equal(image.read_pfm(str(tmp_path / "recon.pfm")), recon)
    np.testing.assert_array_equal(image.read_pfm(str(tmp_path / "image_dx.pfm")),
                                  np.abs(aux["gx"]))
    _, _, _, port = _renders()
    np.testing.assert_array_equal(recon, port["recon"])
