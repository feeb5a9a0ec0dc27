"""The port's AOV integrators (integrators/aux.py) against gdpt_tpu's
render_aux, on the CPU.

The port casts every pixel's primary ray as one batch through the SoA
casts (K1's or K3's plain version here); the reference walks each ray on
its own. Tolerance: values within rtol 1e-5 / atol 1e-6, except pixels
whose primary ray a grazing hit flips between the two walks (ROADMAP.md
section C, "Grazing rays"): at most 0.5% of the pixels. Plus the
reference's cbox_depth golden at its own bound.
"""

import dataclasses
import os

import numpy as np
import pytest

from gdpt_tpu.core import image as jimage
from gdpt_tpu.integrators import aux as jaux
from gdpt_tpu.scene import presets as jpresets
from gdpt_tpu_torch.integrators import aux as taux
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

KINDS = list(taux.AUX_KINDS)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cbox_depth.exr")


def _scenes(pkg, name):
    if name == "cbox":
        return pkg.cornell_box(16, 16, integrator="depth")
    if name == "cbox_bvh":
        return pkg.cornell_box(16, 16, integrator="depth", force_bvh=True)
    # The material box with image textures (reflectance of the back wall).
    if pkg is jpresets:
        from gdpt_tpu.core import transform as jxf
        from gdpt_tpu.scene import build as jbuild
        from gdpt_tpu.scene import model as jmodel

        return tpresets.build_material_box(jmodel, jbuild, jxf, 16, 16, 1, image_px=32, seed=2)
    return tpresets.material_box(16, 16, 1, image_px=32, seed=2)


def _assert_aux(got, ref, slack=0.0):
    assert got.shape == ref.shape and got.dtype == np.float32
    close = (np.abs(got - ref) <= 1e-6 + 1e-5 * np.abs(ref) + slack).all(axis=-1)
    assert close.mean() >= 0.995, f"{(~close).sum()} of {close.size} pixels differ"


def _normal_slack(js, ts):
    """A sphere's normal is (position - center) / r, so a hit distance
    that differs by a few ulp between the two casts (the CPU sqrt of the
    sphere test; ROADMAP.md section C) moves it by about that much over
    r: each pixel's normal may differ by twice its depth difference over
    the smallest sphere radius, beyond the gate's rtol and atol."""
    dj = np.asarray(jaux.render_aux(js.device, js.static, "depth"))[..., 0]
    dt = taux.render_aux(ts, "depth")[..., 0]
    r = float(ts.device.geom.sph_radius.min()) if ts.static.n_spheres else np.inf
    return (2.0 * np.abs(dt - dj) / r)[..., None]


@pytest.mark.parametrize("scene", ["cbox", "cbox_bvh", "box"])
@pytest.mark.parametrize("kind", KINDS)
def test_aux_matches_reference(scene, kind):
    """All five kinds on the Cornell box (brute force and BVH) and on the
    material box (image textures, spheres)."""
    js, ts = _scenes(jpresets, scene), _scenes(tpresets, scene)
    assert ts.static.use_brute_force is (scene != "cbox_bvh")
    ref = np.asarray(jaux.render_aux(js.device, js.static, kind))
    got = trender.render(ts._replace(static=_with(ts.static, kind)), device="cpu")
    _assert_aux(got, ref, _normal_slack(js, ts) if kind == "shading_normal" else 0.0)
    if kind in ("depth", "shading_normal", "ray_differential") or scene == "box":
        assert np.abs(got).max() > 0  # mean curvature (spheres) and mip levels (images)


def _with(static, kind):
    return dataclasses.replace(static, options=dataclasses.replace(static.options,
                                                                   integrator=kind))


@pytest.mark.parametrize("kind,param", [(0, 1.0), (1, 1.0), (2, 0.5), (0, 1.7), (1, 2.0),
                                        (2, 0.3)])
def test_pixel_centre_rays_match_the_reference(kind, param):
    """The AOV pass's rays (primary_rays_soa at u = 0.5) against the
    reference's sample_primary at screen (x + 0.5) / w, for box, tent and
    gaussian filters: the pixel fraction takes the same f32 steps, so
    directions differ by at most an ulp of the transform's sums."""
    import jax
    import jax.numpy as jnp
    import torch

    from gdpt_tpu.scene import camera as jcam
    from gdpt_tpu_torch.integrators import path_soa as tpath
    from gdpt_tpu_torch.scene import build as tbuild

    w, h = 13, 9
    parts = tpresets.cornell_box_parts(w, h, 1)
    parts["camera"] = dataclasses.replace(parts["camera"], filter_kind=kind, filter_param=param)
    ts, js = tbuild.build_scene(**parts), jpresets.cornell_box(w, h, 1)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)

    def one(x, y):
        screen = jnp.stack([(x + 0.5) / w, (y + 0.5) / h])
        return jcam.sample_primary(js.device.camera, w, h, kind, param, screen)

    jo, jd = jax.vmap(one)(jnp.asarray(xs.ravel()), jnp.asarray(ys.ravel()))
    to, td = tpath.primary_rays_soa(ts.static, ts.device.camera, torch.from_numpy(xs.ravel()),
                                    torch.from_numpy(ys.ravel()), 0.5, 0.5)
    np.testing.assert_array_equal(torch.stack(tuple(to), -1).numpy(), np.asarray(jo))
    np.testing.assert_allclose(torch.stack(tuple(td), -1).numpy(), np.asarray(jd), rtol=0,
                               atol=6e-8)


def test_golden_cbox_depth():
    """The reference's cbox_depth golden (tests/test_goldens.py: 64x64
    depth) passes its own gate on the port's CPU render."""
    golden = jimage.read_exr(GOLDEN)
    img = trender.render(tpresets.cornell_box(width=64, height=64, integrator="depth"),
                         device="cpu")
    scale = max(float(np.abs(golden).mean()), 1e-3)
    assert float(np.sqrt(((img - golden) ** 2).mean())) / scale < 0.05


def test_return_stats_counts_one_ray_a_pixel():
    img, rays = trender.render(tpresets.cornell_box(8, 6, integrator="depth"), device="cpu",
                               return_stats=True)
    assert img.shape == (6, 8, 3) and rays == 48


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="albedo"):
        taux.render_aux(tpresets.cornell_box(4, 4), "albedo")
