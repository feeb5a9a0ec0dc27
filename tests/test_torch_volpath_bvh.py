"""The port's volumetric wavefront renderer (BVH scenes) against
gdpt_tpu's, and against the port's own banded loop, on the CPU.

Two BVH scenes, built with either package's own modules and held leaf
for leaf equal (the BVH arrays aside: tests/test_torch_bvh.py holds the
port's native tree to the reference's renders):

- "spheres": the volpath grid scene of tests/test_torch_volpath.py with
  force_bvh, 24x24 at 4 spp: three spheres and no triangle, so the
  packet table is empty and the spheres are tested beside the walk;
- "box": scene/presets.medium_box cut to two level-1 icosphere balls, a
  16^3 grid and depth 8, 16x16 at 12 spp: a heterogeneous medium filling
  the Cornell room inside a 12-triangle box of material -1, the camera
  outside in vacuum.

Both are rendered through the wavefront pool with a pool of 2,048 lanes
(`pool=` here, GDPT_VOL_POOL for the reference), small enough that the
work queue drains with the pool full and the tail compaction halves it.
Port against reference: the path slice's gate (at least 99% of values
within rtol 1e-3 / atol 1e-4, the mean within 0.1%; f32 transcendental
ulps can flip a rare test) and equal ray counts. Port wavefront against
port banded loop: equal ray counts and images within rtol 5e-4 / atol
2e-6, the reference's own test (tests/test_soa.py,
test_volpath_wavefront_matches_banded): the same samples summed in f32
in another order.

The gpu-marked tests hold the card's 32x32 renders against the CPU's,
and K3 against its plain version on every batch the volumetric
wavefront hands it (the main casts and the shadow segments).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import volpath_soa as tvol
from gdpt_tpu_torch.scene import build as tbuild
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_volpath import check_cuda_vs_cpu, gate, scene_args

SEED = 5
POOL = 2048
KINDS = ["spheres", "box"]
SMALL_BALLS = [(1, (368.0, 100.0, 351.0), 100.0), (1, (186.0, 60.0, 169.0), 60.0)]
BVH_FIELDS = ("bvh_bbox_min", "bvh_bbox_max", "bvh_first", "bvh_count", "bvh_miss",
              "bvh_prim_order")
_CACHE = {}


def _scene(kind, M, build, xf, width=None, height=None):
    if kind == "spheres":
        args = dict(scene_args("grid", width=width or 24, height=height or 24, spp=4),
                    force_bvh=True)
        return tpresets.build_volpath_scene(M, build, xf, **args)
    return tpresets.build_medium_box(M, build, xf, width or 16, height or 16, 12,
                                     balls=SMALL_BALLS, grid_res=16, max_depth=8)


def port_scene(kind, **kw):
    from gdpt_tpu_torch.core import transform as xf
    from gdpt_tpu_torch.scene import model as M

    return _scene(kind, M, tbuild, xf, **kw)


def reference_scene(kind):
    from gdpt_tpu.core import transform as xf
    from gdpt_tpu.scene import build
    from gdpt_tpu.scene import model as M

    return _scene(kind, M, build, xf)


def _reference(kind):
    """(image, rays, iterations) of gdpt_tpu's wavefront render."""
    key = ("ref", kind)
    if key not in _CACHE:
        from gdpt_tpu.integrators import volpath_soa as jvol

        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GDPT_VOL_POOL", str(POOL))
            img, rays = jvol.render_volpath_soa(reference_scene(kind), seed=SEED,
                                                return_stats=True)
        _CACHE[key] = (np.asarray(img), rays, jvol._vol_wavefront_accum.last_iters)
    return _CACHE[key]


def _port(kind, wavefront):
    """(image, rays, iterations, final pool width) of the port's render."""
    key = ("port", kind, wavefront)
    if key not in _CACHE:
        scene = tbuild.scene_to(port_scene(kind), "cpu")
        img, rays = tvol.render_volpath_soa(scene, seed=SEED, return_stats=True,
                                            wavefront=wavefront, pool=POOL)
        acc = tvol._vol_wavefront_accum
        _CACHE[key] = (img, rays, acc.last_iters, acc.last_pool)
    return _CACHE[key]


@pytest.mark.parametrize("kind", KINDS)
def test_host_scenes_are_equal(kind):
    from test_torch_scene import _assert_tree

    js, ts = reference_scene(kind), port_scene(kind)
    _assert_tree(js.device, ts.device, extra=BVH_FIELDS)
    assert dataclasses.asdict(js.static) == dataclasses.asdict(ts.static)
    assert not ts.static.use_brute_force


def test_sphere_scene_has_an_empty_triangle_table():
    """No triangle: the packet table is built over nothing, and the three
    spheres ride outside the walk."""
    from gdpt_tpu_torch.accel import traverse_soa as trs
    from gdpt_tpu_torch.integrators import path_soa as tpath

    scene = port_scene("spheres")
    st = scene.static
    assert st.n_tris == 0 and st.n_spheres == 3 and trs._sph_outside(st)
    assert tpath.scene_soa_from_aos(scene).geom.packet is not None


@pytest.mark.parametrize("kind", KINDS)
def test_wavefront_matches_reference(kind):
    ja, jr, jiters = _reference(kind)
    ta, tr, titers, pool = _port(kind, True)
    gate(ta, ja, float(ja.mean()))
    assert tr == jr and titers == jiters
    assert pool < POOL  # the tail compaction ran


@pytest.mark.parametrize("kind", KINDS)
def test_wavefront_matches_banded(kind):
    a, ra, _, _ = _port(kind, True)
    b, rb, _, _ = _port(kind, False)
    assert ra == rb
    np.testing.assert_allclose(a, b, rtol=5e-4, atol=2e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_volpath_matches_cpu(kind):
    """The 32x32 BVH scenes through the packet table and K3 on the card
    against the plain versions on the CPU."""
    check_cuda_vs_cpu(port_scene(kind, width=32, height=32))


@pytest.mark.gpu
def test_k3_on_volpath_batches():
    """K3 equals its plain version bit for bit (t and prim) on every
    batch the volumetric wavefront hands it in the medium box."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gdpt_tpu_torch.accel import packet_kernels as pk

    seen, walk = [], pk.trace_packets

    def recording(tab, *rays, **kw):
        seen.append((tab, rays, kw))
        return walk(tab, *rays, **kw)

    pk.trace_packets = recording
    try:
        tvol.render_volpath_soa(tbuild.scene_to(port_scene("box"), "cuda"), seed=1)
    finally:
        pk.trace_packets = walk
    assert len(seen) > 10 and not any(kw.get("any_hit") for _, _, kw in seen)
    for tab, rays, kw in seen:
        t, prim = walk(tab, *rays, **kw)
        t0, prim0 = pk.trace_packets_plain(tab, *rays, n_tris=kw.get("n_tris"))
        assert torch.equal(t.view(torch.int32), t0.view(torch.int32))
        assert torch.equal(prim, prim0)
