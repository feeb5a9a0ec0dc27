"""The port's gradient-domain render (gradpath) of the material box
against gdpt_tpu's, on the CPU.

The box (scene/presets.material_box) holds every material kind, image
textures and an image envmap, built by either package's own modules
(tests/test_torch_materials_render.py). At its non-Lambertian vertices
the offsets cannot reconnect and take the replay shift (the base path's
random numbers replayed at the offset vertex, the pdf-ratio Jacobian),
so these are the tests that hold the replay shift against the
reference. Gates of tests/test_torch_gdpt.py: recon, primal, primal_bf,
gx and gy each with at least 99% of values within rtol 1e-3 / atol 1e-4
and the mean within 0.1% of the primal's mean; ray counts within 0.1%
(f32 transcendental ulps can flip a rare lobe choice, shadow or
Russian-roulette test). Brute force through the banded loop here;
force_bvh through the wavefront lane pool in
tests/test_torch_materials_gdpt_bvh.py (each reference render compiles
for about a minute on this CPU, so each has a file and a worker of its
own).

The reference's gradpath adds nothing for a base ray that misses under
an envmap (its only emission term at the primary vertex is
gdpt_tpu/integrators/gdpt_soa.py:129, zero off the scene's surfaces); the
envmap reaches gradpath only through NEE and the light pdf. The port
copies this, and a test pins it on the furnace.

The gpu-marked tests render the 32x32 box on the card and on the CPU
and hold the reconstruction and gradients together; jax is imported only
inside the reference helpers, so they run with --noconftest.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import gdpt_soa as tgdpt
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_materials_render import gate, port_box, reference_box
from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

SEED = 5
BUFFERS = ["recon", "primal", "primal_bf", "gx", "gy"]
_CACHE = {}


def reference(kind):
    """({buffer: image}, rays) of gdpt_tpu's render, once per process."""
    key = ("ref", kind)
    if key not in _CACHE:
        from gdpt_tpu.integrators import gdpt_soa as jgdpt

        recon, aux, rays = jgdpt.render_gradpath_soa(
            reference_box(kind == "bvh", integrator="gradpath"), seed=SEED, return_aux=True,
            return_stats=True)
        bufs = {k: np.asarray(v) for k, v in aux.items()}
        bufs["recon"] = np.asarray(recon)
        _CACHE[key] = (bufs, rays)
    return _CACHE[key]


def port(kind):
    key = ("port", kind)
    if key not in _CACHE:
        scene = port_box(kind == "bvh", integrator="gradpath")
        recon, aux, rays = trender.render(scene, seed=SEED, device="cpu", return_aux=True,
                                          return_stats=True)
        _CACHE[key] = (dict(aux, recon=recon), rays)
    return _CACHE[key]


def check_buffer(kind, name):
    ref = reference(kind)[0]
    gate(port(kind)[0][name], ref[name], float(ref["primal"].mean()))


def check_rays(kind):
    ref_rays, rays = reference(kind)[1], port(kind)[1]
    assert rays > 5 * 256 * 2 and abs(rays - ref_rays) <= 1e-3 * ref_rays


@pytest.mark.parametrize("name", BUFFERS)
def test_gradpath_matches_reference(name):
    check_buffer("brute", name)


def test_gradpath_ray_count_matches_reference():
    check_rays("brute")


def test_every_scene_takes_the_gradient_domain_render():
    scene = port_box(False, integrator="gradpath")
    assert len(scene.static.used_material_kinds) == 9 and scene.static.envmap_is_image
    assert tgdpt.supports_soa_gdpt(scene)


def test_primary_miss_under_an_envmap_adds_nothing():
    """As the reference's: a base ray that leaves the scene contributes
    nothing to gradpath's primal (path sees the envmap there), and the
    sphere's pixels still see the envmap, through NEE alone."""
    scene = tpresets.furnace_sphere(albedo=0.6, emission=1.0, width=16, height=16, spp=4)
    grad = scene._replace(static=dataclasses.replace(
        scene.static, options=dataclasses.replace(scene.static.options, integrator="gradpath")))
    _, aux = trender.render(grad, seed=1, device="cpu", return_aux=True)
    path = trender.render(scene, seed=1, device="cpu")
    np.testing.assert_allclose(path[0, 0], 1.0, atol=1e-4)
    assert float(np.abs(aux["primal"][0, 0]).max()) == 0.0
    assert float(aux["primal"][8, 8].min()) > 0.0


def check_cuda_vs_cpu(bvh):
    """The 32x32 box's gradpath on the card against the CPU render:
    reconstruction and gradients (theirs held to the primal's mean)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = port_box(bvh, width=32, height=32, integrator="gradpath")
    a, aux_a = trender.render(scene, seed=3, device="cuda", return_aux=True)
    b, aux_b = trender.render(scene, seed=3, device="cpu", return_aux=True)
    scale = float(aux_b["primal"].mean())
    gate(a, b, scale)
    for name in ("gx", "gy"):
        gate(aux_a[name], aux_b[name], scale)


@pytest.mark.gpu
def test_cuda_gradpath_matches_cpu():
    check_cuda_vs_cpu(False)
