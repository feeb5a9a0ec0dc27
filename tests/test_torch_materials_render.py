"""The port's `path` render of the material box against gdpt_tpu's, on
the CPU, and the port's furnace tests.

The material box (scene/presets.material_box) holds every material kind,
a spectrum and a float image texture and an image envmap. A helper
builds the same 16x16, 2 spp box with either package's own model and
build modules; the host scenes are held leaf for leaf equal before
anything is rendered. Both packages then render it with the same seed:
their RNG streams are bit-identical, so images are compared pixel by
pixel at the path slice's gate (tests/test_torch_path.py: at least 99% of
values within rtol 1e-3 / atol 1e-4, the mean within 0.1%; f32
transcendental ulps can flip a rare lobe choice, edge or
Russian-roulette test) and ray counts are equal. Brute force (21
primitives) and force_bvh (two small icosphere balls added, packet
table and wavefront). The reference's scene carried across by
convert.scene_from_numpy renders the port's own image, bit for bit.

The furnace: the reference's furnace.exr golden at its own gate (RMSE
under 5% of the golden's mean), and the closed forms of
tests/test_integrators.py (sphere pixels converge to albedo x emission,
background pixels see the envmap exactly; albedo 1 is energy
conserving).

The gpu-marked test renders the 32x32 box on the card and on the CPU and
holds them together at the same gate; this file imports jax only inside
the reference helpers, so it runs with --noconftest where jax is absent.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

SEED = 5
# Two small balls stand in for ICOSPHERE_BALLS on the BVH box (80
# triangles each): the Disney BSDF mesh and the rough dielectric mesh.
SMALL_BALLS = [(1, (368.0, 100.0, 351.0), 100.0), (1, (186.0, 60.0, 169.0), 60.0)]
BVH_FIELDS = ("bvh_bbox_min", "bvh_bbox_max", "bvh_first", "bvh_count", "bvh_miss",
              "bvh_prim_order")
_CACHE = {}


def material_box(M, build, xf, bvh, width=16, height=16, spp=2, integrator="path", **kw):
    """The material box built with one package's own modules."""
    if bvh:
        kw.setdefault("balls", SMALL_BALLS)
    return tpresets.build_material_box(M, build, xf, width, height, spp, bvh=bvh,
                                       integrator=integrator, **kw)


def port_box(bvh, **kw):
    from gdpt_tpu_torch.core import transform as xf
    from gdpt_tpu_torch.scene import build
    from gdpt_tpu_torch.scene import model as M

    return material_box(M, build, xf, bvh, **kw)


def reference_box(bvh, **kw):
    from gdpt_tpu.core import transform as xf
    from gdpt_tpu.scene import build
    from gdpt_tpu.scene import model as M

    return material_box(M, build, xf, bvh, **kw)


def gate(a, ref, mean_scale):
    assert a.shape == ref.shape and a.dtype == np.float32
    assert np.isfinite(a).all() and np.abs(a).mean() > 0
    assert np.isclose(a, ref, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert abs(float(a.mean()) - float(ref.mean())) <= 1e-3 * mean_scale


def _renders(kind):
    """(reference image, rays, port image, rays) of the path render."""
    if kind not in _CACHE:
        from gdpt_tpu.integrators import path_soa as jpath

        bvh = kind == "bvh"
        ja, jr = jpath.render_soa(reference_box(bvh), seed=SEED, return_stats=True)
        ta, tr = trender.render(port_box(bvh), seed=SEED, device="cpu", return_stats=True)
        _CACHE[kind] = (np.asarray(ja), jr, ta, tr)
    return _CACHE[kind]


@pytest.mark.parametrize("bvh", [False, True])
def test_host_scenes_are_equal(bvh):
    """Material tables, texture pools, envmap tables and everything else
    of the two packages' scenes, leaf for leaf; the same SceneStatic. The
    BVH arrays are left out: the port builds its tree natively, held to
    validity and to the reference's render by tests/test_torch_bvh.py."""
    from test_torch_scene import _assert_tree

    js, ts = reference_box(bvh), port_box(bvh)
    _assert_tree(js.device, ts.device, extra=BVH_FIELDS)
    assert dataclasses.asdict(js.static) == dataclasses.asdict(ts.static)
    st = ts.static
    assert len(st.used_material_kinds) == 9 and st.has_envmap and st.envmap_is_image
    assert st.spec_image_slots[0] and st.float_tex_slots[0] == 2
    assert st.use_brute_force != bvh
    pool3, pool1 = ts.device.pool3, ts.device.pool1
    assert pool3.n_levels.shape[0] == 2 and pool1.n_levels.shape[0] == 1


def test_carried_scene_renders_the_same_image():
    """The reference's scene carried across (its tables as numpy leaves)
    renders the port's own image."""
    import jax

    from gdpt_tpu_torch import convert

    js = reference_box(False)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(js.device)]
    carried = convert.scene_from_numpy(leaves, dataclasses.asdict(js.static), device="cpu")
    img, rays = trender.render(carried, seed=SEED, device="cpu", return_stats=True)
    np.testing.assert_array_equal(img, _renders("brute")[2])
    assert rays == _renders("brute")[3]


@pytest.mark.parametrize("kind", ["brute", "bvh"])
def test_path_matches_reference(kind):
    ja, _, ta, _ = _renders(kind)
    gate(ta, ja, float(ja.mean()))


@pytest.mark.parametrize("kind", ["brute", "bvh"])
def test_path_ray_count_matches_reference(kind):
    _, jr, _, tr = _renders(kind)
    assert tr == jr and tr > 16 * 16 * 2 * 3


def test_furnace_golden():
    """tests/goldens/furnace.exr (tests/test_goldens.py:30-33) at its own
    gate on the port's CPU render."""
    import os

    from gdpt_tpu.core import image as gimage

    golden = gimage.read_exr(os.path.join(os.path.dirname(__file__), "goldens", "furnace.exr"))
    img = trender.render(tpresets.furnace_sphere(albedo=0.6, width=32, height=32, spp=64),
                         seed=42, device="cpu")
    scale = max(float(np.abs(golden).mean()), 1e-3)
    assert float(np.sqrt(((img - golden) ** 2).mean())) / scale < 0.05


def test_furnace_closed_form():
    """Mirrors tests/test_integrators.py:125-134."""
    img = trender.render(tpresets.furnace_sphere(albedo=0.6, emission=1.0, width=24, height=24,
                                                 spp=96, max_depth=-1), seed=1, device="cpu")
    c = img.shape[0] // 2
    assert abs(img[c - 3:c + 3, c - 3:c + 3].mean() - 0.6) < 0.02
    # Background pixels see the envmap exactly.
    np.testing.assert_allclose(img[0, 0], 1.0, atol=1e-4)


def test_furnace_white_is_white():
    """Mirrors tests/test_integrators.py:137-143: albedo 1 with Russian
    roulette returns the envmap everywhere (energy conservation)."""
    img = trender.render(tpresets.furnace_sphere(albedo=1.0, emission=0.5, width=16, height=16,
                                                 spp=128, max_depth=-1), seed=2, device="cpu")
    assert abs(img.mean() - 0.5) < 0.02


@pytest.mark.gpu
@pytest.mark.parametrize("bvh", [False, True])
def test_cuda_render_matches_cpu(bvh):
    """The 32x32 material box on the card (K1/K2, or the packet table and
    K3) against the same render on the CPU (plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = port_box(bvh, width=32, height=32)
    a, ra = trender.render(scene, seed=3, device="cuda", return_stats=True)
    b, rb = trender.render(scene, seed=3, device="cpu", return_stats=True)
    gate(a, b, float(b.mean()))
    assert abs(ra - rb) <= 1e-3 * rb
