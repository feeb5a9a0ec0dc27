"""The port's gradient-domain render (gradpath) against gdpt_tpu's, on
the CPU.

Both packages render the same preset with the same seed and spp through
their SoA gradient-domain path tracers (5-path lockstep, then the
screened-Poisson solve); their RNG streams are bit-identical, so the
reconstruction and every auxiliary buffer are compared pixel by pixel:
brute-force scenes through the banded loop, BVH scenes through the
wavefront lane pool.

Tolerances: port vs reference at the path slice's gate, at least 99% of
values within rtol 1e-3 / atol 1e-4 and the buffer's mean within 0.1%
(the gradient buffers, whose means are differences near zero, within
0.1% of the primal's mean): f32 transcendental ulps (XLA vs torch) can
flip a rare edge, shadow or Russian-roulette test. Ray counts within 0.1%
for the same reason (the reference's own jitted and eager traces differ
by a few shadow rays). Within the port, wavefront vs banded and tail
compaction on vs off within 2e-6 absolute (the same samples summed in f32
in another order); the dual walk vs the solo walk on the same 16-wide
table: identical images, as each ray's walk is the same.
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import gdpt_soa as tgdpt
from gdpt_tpu_torch.integrators import path_soa as tpath
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)
from test_torch_path import _spheres

SEED = 5
BUFFERS = ["recon", "primal", "primal_bf", "gx", "gy"]
_CACHE = {}


def _box(presets, bvh, **kw):
    args = dict(width=16, height=16, spp=2, max_depth=3, integrator="gradpath", force_bvh=bvh)
    args.update(kw)
    return presets.cornell_box(**args)


def _reference(kind):
    """{buffer: image}, rays of gdpt_tpu's render, once per process."""
    key = ("ref", kind)
    if key not in _CACHE:
        from gdpt_tpu.integrators import gdpt_soa as jgdpt
        from gdpt_tpu.scene import presets as jpresets

        recon, aux, rays = jgdpt.render_gradpath_soa(
            _box(jpresets, kind == "bvh"), seed=SEED, return_aux=True, return_stats=True)
        bufs = {k: np.asarray(v) for k, v in aux.items()}
        bufs["recon"] = np.asarray(recon)
        stats = None
        if kind == "bvh":
            stats = (jgdpt._gdpt_wavefront_accum.last_iters,
                     jgdpt._gdpt_wavefront_accum.last_occupancy)
        _CACHE[key] = (bufs, rays, stats)
    return _CACHE[key]


def _port(kind, **kw):
    """{buffer: image}, rays of the port's render of the brute-force box
    ("brute": banded loop) or the force_bvh box ("bvh": wavefront; other
    keyword sets are cached under their own key)."""
    key = ("port", kind, tuple(sorted(kw.items())))
    if key not in _CACHE:
        scene = _box(tpresets, kind != "brute")
        recon, aux, rays = tgdpt.render_gradpath_soa(scene, seed=SEED, return_aux=True,
                                                     return_stats=True, **kw)
        stats = (tgdpt._gdpt_wavefront_accum.last_iters,
                 tgdpt._gdpt_wavefront_accum.last_occupancy)
        _CACHE[key] = (dict(aux, recon=recon), rays, stats)
    return _CACHE[key]


def _gate(a, ref, mean_scale):
    assert a.shape == ref.shape == (16, 16, 3) and a.dtype == np.float32
    assert np.isfinite(a).all() and np.abs(a).mean() > 0
    assert np.isclose(a, ref, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert abs(float(a.mean()) - float(ref.mean())) <= 1e-3 * mean_scale


@pytest.mark.parametrize("name", BUFFERS)
@pytest.mark.parametrize("kind", ["brute", "bvh"])
def test_gradpath_matches_reference(kind, name):
    ref = _reference(kind)[0]
    got = _port(kind)[0]
    _gate(got[name], ref[name], float(ref["primal"].mean()))


@pytest.mark.parametrize("kind", ["brute", "bvh"])
def test_ray_count_matches_reference(kind):
    ref_rays, rays = _reference(kind)[1], _port(kind)[1]
    assert rays > 5 * 256 * 2 and abs(rays - ref_rays) <= 1e-3 * ref_rays


def test_wavefront_iterations_and_occupancy_match_reference():
    """Same pool, same refill rule (a quarter of the pool idle), same
    chunking: the port's wavefront takes the reference's iterations at
    the reference's occupancy."""
    (ref_iters, ref_occ), (iters, occ) = _reference("bvh")[2], _port("bvh")[2]
    assert iters == ref_iters and iters % 6 == 0
    assert abs(occ - ref_occ) < 1e-3


def test_one_sample_buffer_by_buffer():
    """trace_gdpt_soa, the 5-path lockstep for one sample per pixel,
    against the reference's: all six buffers lane by lane."""
    import jax.numpy as jnp
    from gdpt_tpu.integrators import gdpt_soa as jgdpt
    from gdpt_tpu.integrators import path_soa as jpath
    from gdpt_tpu.scene import presets as jpresets

    js, ts = _box(jpresets, False), _box(tpresets, False)
    n = 256
    jout, jrays = jgdpt.trace_gdpt_soa(
        js.static, js.device.camera, jpath.scene_soa_from_aos(js), jnp.zeros(n), jnp.zeros(n),
        jnp.arange(n, dtype=jnp.uint32), jnp.uint32(SEED), jnp.uint32(1))
    tout, trays = tgdpt.trace_gdpt_soa(
        ts.static, ts.device.camera, tpath.scene_soa_from_aos(ts), None, None,
        torch.arange(n), SEED, 1)
    assert abs(float(trays) - float(jrays)) <= 1e-3 * float(jrays)
    for name, a, b in zip(tout._fields, tout, jout):
        got = np.stack([c.numpy() for c in a], -1)
        ref = np.stack([np.asarray(c) for c in b], -1)
        assert np.isclose(got, ref, rtol=1e-3, atol=1e-4).mean() >= 0.99, name
    assert float(np.abs(np.stack([c.numpy() for c in tout.gx_here])).sum()) > 0


@pytest.mark.parametrize("name", BUFFERS)
def test_wavefront_matches_banded(name):
    a, ra, _ = _port("bvh")
    b, rb, _ = _port("bvh", wavefront=False)
    assert ra == rb
    np.testing.assert_allclose(a[name], b[name], rtol=0, atol=2e-6)


@pytest.mark.parametrize("compact", [True, False])
def test_tail_compaction(compact, monkeypatch):
    """Unbounded depth (Russian roulette): a 2048-lane pool over 2560
    items drains through a shrink to 1024 lanes (lanes that are dead but
    not yet harvested are kept): the image is the banded loop's either
    way."""
    shrinks = []
    real = tgdpt._gdpt_shrink_pool
    monkeypatch.setattr(tgdpt, "_gdpt_shrink_pool",
                        lambda st, n, keep: shrinks.append(n) or real(st, n, keep))
    scene = _box(tpresets, True, max_depth=-1)
    got = tgdpt.render_gradpath_soa(scene, spp=10, seed=SEED, return_stats=True, pool=2048,
                                    compact=compact)
    assert (shrinks == [1024]) == compact and (compact or not shrinks)
    if "banded10" not in _CACHE:
        _CACHE["banded10"] = tgdpt.render_gradpath_soa(scene, spp=10, seed=SEED,
                                                       return_stats=True, wavefront=False)
    ref = _CACHE["banded10"]
    assert got[1] == ref[1]
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-6)


def test_dual_walk_renders_the_solo_image():
    solo, rays_s, _ = _port("bvh16", packet_wide=16)
    dual, rays_d, _ = _port("bvh16", packet_wide=16, packet_dual=True)
    assert rays_s == rays_d
    for name in BUFFERS:
        np.testing.assert_array_equal(dual[name], solo[name])
    wide, _, _ = _port("bvh")  # the 32-wide table: another tree, the same surfaces
    np.testing.assert_allclose(solo["recon"], wide["recon"], rtol=1e-3, atol=1e-4)


def test_dual_walk_with_a_32_wide_table_raises():
    scene = _box(tpresets, True)
    with pytest.raises(ValueError, match="16"):
        tgdpt.render_gradpath_soa(scene, packet_wide=32, packet_dual=True)
    with pytest.raises(ValueError, match="16"):
        trender.render(scene, device="cpu", packet_dual=True)


@pytest.mark.parametrize("kind", ["brute", "bvh"])
def test_render_entry_point(kind, monkeypatch):
    """render.render dispatches "gradpath" to the SoA renderer on the device
    asked for, and insists on CUDA when none is."""
    scene = _box(tpresets, kind == "bvh")
    img, rays = trender.render(scene, seed=SEED, device="cpu", return_stats=True)
    np.testing.assert_array_equal(img, _port(kind)[0]["recon"])
    assert rays == _port(kind)[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.render(scene)


def test_sphere_light_scene_matches_reference():
    from gdpt_tpu.integrators import gdpt_soa as jgdpt
    from gdpt_tpu.scene import build as jbuild
    from gdpt_tpu.scene import model as jmodel
    from gdpt_tpu_torch.scene import build as tbuild
    from gdpt_tpu_torch.scene import model as tmodel

    js, ts = _spheres(jmodel, jbuild), _spheres(tmodel, tbuild)
    ref, jaux = jgdpt.render_gradpath_soa(js, seed=7, return_aux=True)
    got, taux = tgdpt.render_gradpath_soa(ts, seed=7, return_aux=True)
    scale = float(np.asarray(jaux["primal"]).mean())
    _gate(got, np.asarray(ref), scale)
    for name in ("primal", "gx", "gy"):
        _gate(taux[name], np.asarray(jaux[name]), scale)


@pytest.mark.parametrize("what", ["mesh", "queue"])
def test_what_is_not_ported_raises(what):
    scene = _box(tpresets, True)
    if what == "queue":
        with pytest.raises(ValueError, match="2\\^32"):
            tgdpt.render_gradpath_soa(scene, spp=2 ** 24, wavefront=True)
    else:
        # Sharding raised NotImplementedError before it was ported
        # (tests/test_torch_sharding.py holds it to the reference); a
        # sharded render takes the banded loop, so wavefront=True raises.
        from gdpt_tpu_torch.parallel import sharding

        with pytest.raises(ValueError, match="banded"):
            tgdpt.render_gradpath_soa(scene, mesh=sharding.make_mesh(["cpu"]), wavefront=True)


@pytest.mark.parametrize("what", ["on_chunk", "init_acc", "start_sample", "integrator"])
def test_what_this_slice_ported_works(what):
    """The checkpoint arguments of the gradient-domain render and the AOV
    integrators, which raised NotImplementedError before they were
    ported: on_chunk fires after every pass with the (6, 3, n) sums, a
    zero init_acc and a resume from start_sample give the uninterrupted
    banded render bit for bit (one sample a pass on this BVH box), and a
    "depth" scene renders."""
    if what == "integrator":
        img = trender.render(_box(tpresets, False, integrator="depth"), device="cpu")
        assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.max() > 0
        return
    scene = _box(tpresets, True)
    fired = []

    def keep(acc, done):
        fired.append((acc.copy(), done))

    straight = tgdpt.render_gradpath_soa(scene, seed=7, wavefront=False)
    if what == "on_chunk":
        got = tgdpt.render_gradpath_soa(scene, seed=7, on_chunk=keep)
        assert [d for _, d in fired] == [1, 2] and fired[0][0].shape == (6, 3, 256)
    elif what == "init_acc":
        got = tgdpt.render_gradpath_soa(scene, seed=7, init_acc=np.zeros((6, 3, 256)))
    else:
        tgdpt.render_gradpath_soa(scene, spp=1, seed=7, on_chunk=keep)
        got = tgdpt.render_gradpath_soa(scene, spp=2, seed=7, start_sample=1,
                                        init_acc=fired[-1][0])
    np.testing.assert_array_equal(got, straight)
    with pytest.raises(ValueError, match="banded"):
        tgdpt.render_gradpath_soa(scene, wavefront=True, **{
            "on_chunk": dict(on_chunk=keep), "init_acc": dict(init_acc=np.zeros((6, 3, 256))),
            "start_sample": dict(start_sample=1)}[what])


def test_supports_soa_gdpt():
    """Every scene takes the SoA gradient-domain render, as the
    reference's: a kind that no material of the scene has is evaluated
    and never selected, so the image is the same."""
    from gdpt_tpu_torch.scene import model as tmodel

    scene = _box(tpresets, False)
    assert tgdpt.supports_soa_gdpt(scene)
    import dataclasses

    other = scene._replace(static=dataclasses.replace(
        scene.static, used_material_kinds=(tmodel.MAT_LAMBERTIAN, 3)))
    assert tgdpt.supports_soa_gdpt(other)
    np.testing.assert_array_equal(trender.render(other, seed=SEED, device="cpu"),
                                  _port("brute")[0]["recon"])
