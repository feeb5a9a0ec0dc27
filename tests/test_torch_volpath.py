"""The port's volumetric render (volpath, versions 6 and 0) against
gdpt_tpu's, on the CPU: the banded loop of brute-force scenes.

Four scenes of the volpath test family (scene/presets.volpath_scene),
built with either package's own modules by
presets.build_volpath_scene and held leaf for leaf equal before they are
rendered, at 16x16 and 2 spp:

- "homog": the homogeneous, isotropic preset, depth 6;
- "grid": a varying, chromatic 16^3 density grid whose max is several
  times its mean (delta tracking takes null collisions), an albedo grid,
  HG g = 0.6, the diffuse sphere, depth 6;
- "null": the grid medium inside a sphere of material -1, the camera,
  a light and the diffuse sphere outside it in vacuum (passthrough,
  medium transitions, shadow rays across the boundary), depth 6;
- "deep": homogeneous HG g = 0.3 at unbounded depth (a lane runs up to
  65 bounce bodies) with Russian roulette.

Both packages render with the same seed; their RNG streams are
bit-identical, so images are compared pixel by pixel at the path
slice's gate (at least 99% of values within rtol 1e-3 / atol 1e-4, the
mean within 0.1%: f32 transcendental ulps, XLA's against torch's, can
flip a rare free-flight, real-collision or Russian-roulette test), and
ray counts are equal. A reference scene carried across by
convert.scene_from_numpy is the port's own scene, leaf for leaf, and
renders its image bit for bit. The BVH renders (the wavefront pool) are
tests/test_torch_volpath_bvh.py's.

The gpu-marked tests render the 32x32 grid scene on the card and on the
CPU and hold them together at the same gate, and hold K1 against its
plain version on every batch the volumetric render hands it; this file
imports jax only inside the reference helpers, so it runs with
--noconftest where jax is absent.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.integrators import volpath_soa as tvol
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

SEED = 5
KINDS = ["homog", "grid", "null", "deep"]
_CACHE = {}


def scene_args(kind, width=16, height=16, spp=2):
    """build_volpath_scene's keywords for one scene of the family."""
    base = dict(version=6, width=width, height=height, spp=spp, max_depth=6)
    grid = dict(density=tpresets.medium_grid(16, 3, 0.8), albedo=tpresets.albedo_grid(16, 4),
                g=0.6, with_diffuse_sphere=True)
    return {
        "homog": base,
        "grid": dict(base, **grid),
        "null": dict(base, density=tpresets.medium_grid(16, 3, 1.5),
                     albedo=np.array([0.9, 0.7, 0.8]), g=-0.4, with_diffuse_sphere=True,
                     null_boundary=True),
        "deep": dict(base, max_depth=-1, g=0.3, with_diffuse_sphere=True),
    }[kind]


def port_scene(kind, **kw):
    from gdpt_tpu_torch.core import transform as xf
    from gdpt_tpu_torch.scene import build
    from gdpt_tpu_torch.scene import model as M

    return tpresets.build_volpath_scene(M, build, xf, **dict(scene_args(kind), **kw))


def reference_scene(kind, **kw):
    from gdpt_tpu.core import transform as xf
    from gdpt_tpu.scene import build
    from gdpt_tpu.scene import model as M

    return tpresets.build_volpath_scene(M, build, xf, **dict(scene_args(kind), **kw))


def gate(a, ref, mean_scale):
    assert a.shape == ref.shape and a.dtype == np.float32
    assert np.isfinite(a).all() and np.abs(a).mean() > 0
    assert np.isclose(a, ref, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert abs(float(a.mean()) - float(ref.mean())) <= 1e-3 * mean_scale


def _renders(kind):
    """(reference image, rays, port image, rays) of the volpath render."""
    if kind not in _CACHE:
        from gdpt_tpu.integrators import volpath_soa as jvol

        ja, jr = jvol.render_volpath_soa(reference_scene(kind), seed=SEED, return_stats=True)
        ta, tr = trender.render(port_scene(kind), seed=SEED, device="cpu", return_stats=True)
        _CACHE[kind] = (np.asarray(ja), jr, ta, tr)
    return _CACHE[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_host_scenes_are_equal(kind):
    from test_torch_scene import _assert_tree

    js, ts = reference_scene(kind), port_scene(kind)
    _assert_tree(js.device, ts.device)
    assert dataclasses.asdict(js.static) == dataclasses.asdict(ts.static)
    st = ts.static
    assert st.use_brute_force and st.options.integrator == "volpath"
    assert st.media_is_hetero == ((kind in ("grid", "null")),)


@pytest.mark.parametrize("kw", [dict(version=6, width=16, height=16, spp=2),
                                dict(version=0, hetero=True, grid_res=4, g=0.6,
                                     with_diffuse_sphere=True, force_bvh=True)])
def test_preset_is_the_reference_preset(kw):
    """presets.volpath_scene is gdpt_tpu's volpath_scene, leaf for leaf
    (the BVH arrays aside: tests/test_torch_bvh.py holds the port's
    native tree to the reference's renders)."""
    from gdpt_tpu.scene import presets as jpresets

    from test_torch_scene import _assert_tree

    bvh = ("bvh_bbox_min", "bvh_bbox_max", "bvh_first", "bvh_count", "bvh_miss",
           "bvh_prim_order")
    js, ts = jpresets.volpath_scene(**kw), tpresets.volpath_scene(**kw)
    _assert_tree(js.device, ts.device, extra=bvh)
    assert dataclasses.asdict(js.static) == dataclasses.asdict(ts.static)


@pytest.mark.parametrize("kind", KINDS)
def test_volpath_matches_reference(kind):
    ja, _, ta, _ = _renders(kind)
    gate(ta, ja, float(ja.mean()))


@pytest.mark.parametrize("kind", KINDS)
def test_volpath_ray_count_matches_reference(kind):
    _, jr, _, tr = _renders(kind)
    assert tr == jr and tr > 16 * 16 * 2 * 2


def test_loops_ran():
    """The grid scene's renders took null collisions in free flight and
    within shadow segments; the null-boundary scene's shadow rays crossed
    the boundary (a second segment); the deep scene ran past depth 6."""
    reads = {}
    for kind in ("grid", "null", "deep"):
        for k in tvol.HOST_READS:
            tvol.HOST_READS[k] = 0
        trender.render(port_scene(kind, spp=1), seed=SEED, device="cpu")
        reads[kind] = dict(tvol.HOST_READS)
    assert reads["grid"]["flight"] > 2 * reads["grid"]["bounce"]
    assert reads["grid"]["collision"] > 2 * reads["grid"]["segment"]
    assert reads["null"]["segment"] > 2 * reads["null"]["bounce"]
    assert reads["deep"]["bounce"] > 8


@pytest.mark.parametrize("kind", ["homog", "grid", "null"])
def test_carried_scene_is_the_port_scene(kind):
    """The reference's scene with its media (homogeneous; a density grid
    with an albedo grid; a density grid with a constant albedo) carried
    across leaf for leaf is the port's own scene, and renders its image
    bit for bit."""
    import jax

    from gdpt_tpu_torch import convert

    from test_torch_scene import _assert_tree

    js = reference_scene(kind)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(js.device)]
    carried = convert.scene_from_numpy(leaves, dataclasses.asdict(js.static), device="cpu")
    _assert_tree(js.device, carried.device)
    assert carried.static == port_scene(kind).static
    if kind == "grid":
        img, rays = trender.render(carried, seed=SEED, device="cpu", return_stats=True)
        np.testing.assert_array_equal(img, _renders(kind)[2])
        assert rays == _renders(kind)[3]


@pytest.mark.parametrize("what", ["mesh", "queue", "version 1", "version 2", "version 3",
                                  "version 4", "version 5"])
def test_what_is_not_ported_raises(what):
    """An oversized wavefront queue raises, and so does a sharded render
    asked for the wavefront (sharding, which raised NotImplementedError
    before it was ported, takes the banded loop; tests/test_torch_sharding.py
    holds it to the reference). Versions 1-5, which raised
    NotImplementedError before the per-ray rungs were ported, now render
    (tests/test_torch_volpath_rungs*.py hold them to the reference)."""
    scene = port_scene("homog")
    if what.startswith("version"):
        scene = port_scene("homog", version=int(what[-1]), width=6, height=6, spp=1)
        img = trender.render(scene, device="cpu")
        assert img.shape == (6, 6, 3) and np.isfinite(img).all() and img.mean() > 0
    elif what == "queue":
        with pytest.raises(ValueError, match="2\\^32"):
            tvol.render_volpath_soa(scene, spp=2 ** 24, wavefront=True)
    else:
        from gdpt_tpu_torch.parallel import sharding

        with pytest.raises(ValueError, match="banded"):
            tvol.render_volpath_soa(scene, mesh=sharding.make_mesh(["cpu"]), wavefront=True)


@pytest.mark.parametrize("what", ["on_chunk", "init_acc", "start_sample"])
def test_what_this_slice_ported_works(what):
    """The checkpoint arguments, which raised NotImplementedError before
    they were ported: on_chunk fires after the pass with the (3, n) sums,
    a zero init_acc gives the uninterrupted render bit for bit, and a
    resume from start_sample gives it to within f32 rounding (the
    uninterrupted pass sums both samples in f32 before the float64
    accumulation, the resumed one each alone; atol 1e-6, as
    tests/test_checkpoint.py holds the reference)."""
    scene = port_scene("homog")
    fired = []

    def keep(acc, done):
        fired.append((acc.copy(), done))

    straight = tvol.render_volpath_soa(scene, seed=SEED)
    if what == "on_chunk":
        got = tvol.render_volpath_soa(scene, seed=SEED, on_chunk=keep)
        assert [d for _, d in fired] == [2] and fired[0][0].shape == (3, 256)
        np.testing.assert_array_equal(got, straight)
    elif what == "init_acc":
        got = tvol.render_volpath_soa(scene, seed=SEED, init_acc=np.zeros((3, 256)))
        np.testing.assert_array_equal(got, straight)
    else:
        tvol.render_volpath_soa(scene, spp=1, seed=SEED, on_chunk=keep)
        got = tvol.render_volpath_soa(scene, spp=2, seed=SEED, start_sample=1,
                                      init_acc=fired[-1][0])
        np.testing.assert_allclose(got, straight, atol=1e-6)
    with pytest.raises(ValueError, match="banded"):
        tvol.render_volpath_soa(scene, wavefront=True, start_sample=1)


def test_version_0_is_version_6():
    """Versions 0 and 6 name the same production rung."""
    a = trender.render(port_scene("grid", version=0, spp=1), seed=SEED, device="cpu")
    b = trender.render(port_scene("grid", spp=1), seed=SEED, device="cpu")
    np.testing.assert_array_equal(a, b)


def check_cuda_vs_cpu(scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, ra = trender.render(scene, seed=3, device="cuda", return_stats=True)
    b, rb = trender.render(scene, seed=3, device="cpu", return_stats=True)
    gate(a, b, float(b.mean()))
    assert ra == rb


@pytest.mark.gpu
def test_cuda_volpath_matches_cpu():
    """The 32x32 grid scene through K1 on the card against the plain
    versions on the CPU."""
    check_cuda_vs_cpu(port_scene("grid", width=32, height=32))


@pytest.mark.gpu
def test_k1_on_volpath_batches():
    """K1 equals its plain version bit for bit on every batch of a
    volumetric render: the main casts and the shadow segments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gdpt_tpu_torch.accel import brute_kernels as bk

    seen, k1 = [], bk.intersect_brute

    def recording(*args):
        seen.append(args)
        return k1(*args)

    bk.intersect_brute = recording
    try:
        trender.render(port_scene("null", width=32, height=32, spp=1), seed=1, device="cuda")
    finally:
        bk.intersect_brute = k1
    assert len(seen) > 10
    for args in seen:
        for a, b in zip(k1(*args), bk.intersect_brute_plain(*args)):
            assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b)


def test_ops_per_loop_iteration():
    """The volumetric loops' cost in launches: torch operations
    dispatched over a render of the grid scene, per host read of a loop
    condition, stay under 200 (the inner loops' (3, N) rows, the shared
    RNG words and the joint density and albedo taps)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    scene = port_scene("grid", width=32, height=32, spp=1)
    for k in tvol.HOST_READS:
        tvol.HOST_READS[k] = 0
    with Count():
        trender.render(scene, seed=SEED, device="cpu")
    per_read = Count.n / sum(tvol.HOST_READS.values())
    print(f"{Count.n} ops, {tvol.HOST_READS}, {per_read:.1f} per loop iteration")
    assert per_read < 200
