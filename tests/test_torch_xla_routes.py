"""render.render(..., packet=False) against gdpt_tpu's default CPU route.

On a backend other than a TPU the reference builds no packet table
(GDPT_PACKET unset): a BVH of triangles takes its packed walk
(traverse_soa.intersect_bvh_packed), a BVH that holds spheres its
per-lane walk (intersect_bvh_soa). The port takes the same walks with
packet=False. Scenes, each built with either package's own modules and
rendered with the same seed:

- the force_bvh Cornell box, 16x16, `path` and `gradpath` (the packed
  walk);
- the 16x16 material box with two small icosphere balls, nine spheres in
  its BVH (more than SPH_BRUTE_MAX), `path` (the per-lane walk);
- the medium box cut to two level-1 balls, a 16^3 grid and depth 4,
  16x16 at 2 spp, `volpath` (the packed walk).

Gates: the path slice's (at least 99% of values within rtol 1e-3 /
atol 1e-4, the mean within 0.1%), gradpath's own for every buffer
(tests/test_torch_gdpt.py: gradient means within 0.1% of the primal's
mean), ray counts within 0.1% (shadow rays on the light can flip with
an ulp, ROADMAP.md C). The per-ray oracle `path.trace_path` through
render_samples gives the default route's image with packet=False.

tests/test_torch_xla_routes_super16.py holds max_table_mb=0 to the
reference's GDPT_PACKET=1 GDPT_MAX_TABLE_MB=0.
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import render as trender

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

SEED = 5
SMALL_BALLS = [(1, (368.0, 100.0, 351.0), 100.0), (1, (186.0, 60.0, 169.0), 60.0)]
GRAD_BUFFERS = ["recon", "primal", "primal_bf", "gx", "gy"]
_CACHE = {}


def build(name, package):
    """The scene `name` built with `package`'s ("port" or "reference") own
    model, build and transform modules."""
    if package == "port":
        from gdpt_tpu_torch.core import transform as xf
        from gdpt_tpu_torch.scene import build as B
        from gdpt_tpu_torch.scene import model as M
        from gdpt_tpu_torch.scene import presets as P
    else:
        from gdpt_tpu.core import transform as xf
        from gdpt_tpu.scene import build as B
        from gdpt_tpu.scene import model as M
        from gdpt_tpu.scene import presets as P
    from gdpt_tpu_torch.scene import presets as tpresets

    if name in ("cbox_path", "cbox_gradpath"):
        return P.cornell_box(width=16, height=16, spp=2, max_depth=3, force_bvh=True,
                             integrator=name.split("_")[1])
    if name == "material_path":
        return tpresets.build_material_box(M, B, xf, 16, 16, 2, bvh=True, balls=SMALL_BALLS)
    if name == "medium_volpath":
        return tpresets.build_medium_box(M, B, xf, 16, 16, 2, balls=SMALL_BALLS, grid_res=16,
                                         max_depth=4)
    if name == "icosphere_path":  # the Cornell walls around a 320-triangle icosphere
        from test_torch_bvh import icosphere_box

        return icosphere_box(P if package == "reference" else tpresets, M, B, xf, 16, 16, 2)
    raise ValueError(name)


def reference_render(name):
    """({buffer: image}, rays) of the reference's render of `name`, on
    the route its environment picks."""
    scene = build(name, "reference")
    integrator = scene.static.options.integrator
    if integrator == "gradpath":
        from gdpt_tpu.integrators import gdpt_soa as jgdpt

        recon, aux, rays = jgdpt.render_gradpath_soa(scene, seed=SEED, return_aux=True,
                                                     return_stats=True)
        return dict({k: np.asarray(v) for k, v in aux.items()}, recon=np.asarray(recon)), rays
    if integrator == "volpath":
        from gdpt_tpu.integrators import volpath_soa as jvol

        img, rays = jvol.render_volpath_soa(scene, seed=SEED, return_stats=True)
    else:
        from gdpt_tpu.integrators import path_soa as jpath

        img, rays = jpath.render_soa(scene, seed=SEED, return_stats=True)
    return {"image": np.asarray(img)}, rays


def port_render(name, **route):
    scene = build(name, "port")
    if scene.static.options.integrator == "gradpath":
        recon, aux, rays = trender.render(scene, seed=SEED, device="cpu", return_aux=True,
                                          return_stats=True, **route)
        return dict(aux, recon=recon), rays
    img, rays = trender.render(scene, seed=SEED, device="cpu", return_stats=True, **route)
    return {"image": img}, rays


def gate(a, ref, mean_scale):
    assert a.shape == ref.shape and a.dtype == np.float32
    assert np.isfinite(a).all() and np.abs(a).mean() > 0
    assert np.isclose(a, ref, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert abs(float(a.mean()) - float(ref.mean())) <= 1e-3 * mean_scale


def check_route(name, ours, ref):
    """Every buffer at its gate and the ray counts within 0.1%."""
    (bufs, rays), (ref_bufs, ref_rays) = ours, ref
    scale = float(ref_bufs["primal" if "primal" in ref_bufs else "image"].mean())
    assert set(bufs) == set(ref_bufs)
    for k in ref_bufs:
        gate(bufs[k], ref_bufs[k], scale)
    assert rays > 16 * 16 * 2 and abs(rays - ref_rays) <= 1e-3 * ref_rays


def _both(name):
    if name not in _CACHE:
        _CACHE[name] = (port_render(name, packet=False), reference_render(name))
    return _CACHE[name]


@pytest.mark.parametrize("name", ["cbox_path", "cbox_gradpath", "material_path",
                                  "medium_volpath"])
def test_packet_false_matches_reference_default_route(name, monkeypatch):
    for var in ("GDPT_PACKET", "GDPT_MAX_TABLE_MB"):
        monkeypatch.delenv(var, raising=False)
    check_route(name, *_both(name))


def test_routes_take_the_walk_they_name():
    """packet=False walks the packed table on a triangle BVH and the BVH
    arrays where spheres are in it; the reference's default view on the
    CPU holds the same kind of table and no packet table."""
    from gdpt_tpu.integrators import path_soa as jpath
    from gdpt_tpu_torch.integrators import path_soa as tpath

    for name, packed in (("cbox_path", True), ("material_path", False)):
        g = tpath.scene_soa_from_aos(build(name, "port"), packet=False).geom
        jg = jpath.scene_soa_from_aos(build(name, "reference")).geom
        assert g.packet is None and jg.packet is None and g.sup16 is None
        assert (g.bvh_nodes48 is not None) == packed == (jg.bvh_nodes48 is not None)


def test_perray_oracle_with_packet_false_equals_default():
    """path.trace_path through render_samples: the packed walk's casts
    give the packet kernel's image and rays."""
    from gdpt_tpu_torch.integrators import path

    scene = build("cbox_path", "port")
    a, ra = trender.render_samples(scene, path.trace_path, seed=SEED, return_stats=True,
                                   packet=False)
    b, rb = trender.render_samples(scene, path.trace_path, seed=SEED, return_stats=True)
    np.testing.assert_array_equal(a, b)
    assert ra == rb and a.mean() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("route", [dict(packet=False), dict(max_table_mb=0)])
def test_cuda_routes_match_cpu(route):
    """The material box (per-lane walk, super16 with spheres) and the
    force_bvh Cornell box (packed walk, super16) on the card against the
    CPU at the path gate, with equal ray counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in ("cbox_path", "material_path"):
        scene = build(name, "port")
        a, ra = trender.render(scene, seed=SEED, device="cuda", return_stats=True, **route)
        b, rb = trender.render(scene, seed=SEED, device="cpu", return_stats=True, **route)
        gate(a, b, float(b.mean()))
        assert ra == rb
