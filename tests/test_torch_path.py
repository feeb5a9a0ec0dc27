"""The port's brute-force path render against gdpt_tpu's, on the CPU.

Both packages render the same preset with the same seed and spp; their
RNG streams are bit-identical, so images are compared pixel by pixel.
Tolerance: at least 99% of pixel values within rtol 1e-3 / atol 1e-4 and
the image mean within 0.1%, because f32 transcendental ulps (XLA vs
torch log/sin/cos/sqrt) can flip a rare edge or Russian-roulette test.
"""

import os

import numpy as np
import pytest

from gdpt_tpu.core import image as gimage
from gdpt_tpu.integrators import path_soa as jpath
from gdpt_tpu.scene import build as jbuild
from gdpt_tpu.scene import model as jmodel
from gdpt_tpu.scene import presets as jpresets
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.scene import build as tbuild
from gdpt_tpu_torch.scene import model as tmodel
from gdpt_tpu_torch.scene import presets as tpresets

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cbox_path.exr")


def _spheres(M, build):
    """Two checkerboard walls, a diffuse sphere and a sphere light, built
    with one package's own model and build modules."""
    from gdpt_tpu_torch.core import transform as xf

    wall = M.TriangleMesh(
        positions=np.array([[-4, -1, 4], [4, -1, 4], [4, -1, -4], [-4, -1, -4],
                            [-4, 5, 3], [4, 5, 3]], np.float64),
        indices=np.array([[0, 1, 2], [0, 2, 3], [0, 1, 5], [0, 5, 4]]),
        material_id=0)
    shapes = [wall,
              M.Sphere(center=np.array([0.0, 0.0, 1.0]), radius=1.0, material_id=1),
              M.Sphere(center=np.array([1.5, 2.5, -0.5]), radius=0.4, material_id=0,
                       area_light_id=0)]
    cam = M.Camera(cam_to_world=xf.look_at([0, 1, -6], [0, 0.5, 0], [0, 1, 0]),
                   fov=45.0, width=16, height=16, filter_kind=2, filter_param=0.5)
    opts = M.RenderOptions(samples_per_pixel=2, max_depth=4)
    checker = M.CheckerboardTexture(np.array([0.7, 0.6, 0.5]), np.array([0.1, 0.3, 0.2]),
                                    uscale=3.0, vscale=2.0)
    mats = [M.Lambertian(checker), M.Lambertian(np.array([0.2, 0.5, 0.8]))]
    return build.build_scene(cam, mats, shapes, [M.DiffuseAreaLight(2, np.full(3, 12.0))],
                             options=opts)


CONFIGS = {
    "depth3": (lambda p: p.cornell_box(16, 16, spp=2, max_depth=3), 3),
    "while": (lambda p: p.cornell_box(16, 16, spp=2, max_depth=-1), 3),
    "spheres": (None, 7),
}
_CACHE = {}


def _renders(name):
    """(reference image, rays, port image, rays), rendered once per config."""
    if name not in _CACHE:
        make, seed = CONFIGS[name]
        if make is None:
            js, ts = _spheres(jmodel, jbuild), _spheres(tmodel, tbuild)
        else:
            js, ts = make(jpresets), make(tpresets)
        ja, jr = jpath.render_soa(js, seed=seed, return_stats=True)
        ta, tr = trender.render(ts, seed=seed, device="cpu", return_stats=True)
        _CACHE[name] = (np.asarray(ja), jr, ta, tr)
    return _CACHE[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_matches_reference(name):
    ja, _, ta, _ = _renders(name)
    assert ta.shape == ja.shape and ta.dtype == np.float32
    assert np.isfinite(ta).all() and ta.mean() > 0
    assert np.isclose(ta, ja, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert abs(float(ta.mean()) - float(ja.mean())) <= 1e-3 * float(ja.mean())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ray_count_matches_reference(name):
    _, jr, _, tr = _renders(name)
    assert tr == jr


def test_golden_cbox_path():
    """The reference's cbox_path golden (tests/test_goldens.py) passes its
    own gate on the port's CPU render."""
    golden = gimage.read_exr(GOLDEN)
    img = trender.render(tpresets.cornell_box(width=64, height=64, spp=32, max_depth=5),
                         seed=42, device="cpu")
    scale = max(float(np.abs(golden).mean()), 1e-3)
    assert float(np.sqrt(((img - golden) ** 2).mean())) / scale < 0.05
