"""The port's wavefront renderer and its BVH path render, on the CPU.

A small BVH scene (the Cornell box's walls and light around a 320-
triangle icosphere) is rendered by the port's wavefront renderer, by the
port's banded loop and by gdpt_tpu (its wavefront renderer over the
Pallas packet kernel in interpret mode, GDPT_PACKET=1). All three draw
the same RNG streams per (pixel, sample), so images are compared pixel
by pixel.

Tolerances: wavefront vs banded within 2e-6 absolute (the same samples,
summed in f32 on the device in another order, then in f64 on the host);
port vs reference at the brute-force slice's gate: at least 99% of
values within rtol 1e-3 / atol 1e-4 and the image mean within 0.1% (f32
transcendental ulps can flip a rare edge or Russian-roulette test).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gdpt_tpu_torch import convert
from gdpt_tpu_torch.integrators import path_soa as tpath
from gdpt_tpu_torch.integrators import render as trender

from test_torch_bvh import port_box, reference_box
from test_torch_packet import one_thread  # noqa: F401 (autouse fixture)

SEED = 3
_CACHE = {}


def _reference(monkeypatch):
    """(scene, image, rays, occupancy) of gdpt_tpu's render of the 16x16,
    2 spp box, once per process."""
    if "ref" not in _CACHE:
        monkeypatch.setenv("GDPT_PACKET", "1")
        from gdpt_tpu.integrators import path_soa as jpath

        js = reference_box(16, 16, 2)
        assert not js.static.use_brute_force
        img, rays = jpath.render_soa(js, seed=SEED, return_stats=True)
        _CACHE["ref"] = (js, np.asarray(img), rays, jpath.render_soa_wavefront.last_occupancy)
    return _CACHE["ref"]


def _port(kind):
    if kind not in _CACHE:
        scene = port_box(16, 16, 2)
        _CACHE[kind] = tpath.render_soa(scene, seed=SEED, return_stats=True,
                                        wavefront=kind == "wavefront")
        if kind == "wavefront":
            _CACHE["occupancy"] = tpath.render_soa_wavefront.last_occupancy
    return _CACHE[kind]


def _gate(a, ref):
    assert a.shape == ref.shape and a.dtype == np.float32
    assert np.isfinite(a).all() and a.mean() > 0
    assert np.isclose(a, ref, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert abs(float(a.mean()) - float(ref.mean())) <= 1e-3 * float(ref.mean())


@pytest.mark.parametrize("kind", ["wavefront", "banded"])
def test_bvh_render_matches_reference(kind, monkeypatch):
    _, ref, ref_rays, _ = _reference(monkeypatch)
    img, rays = _port(kind)
    _gate(img, ref)
    assert rays == ref_rays


def test_wavefront_matches_banded_and_reference_occupancy(monkeypatch):
    a, ra = _port("wavefront")
    b, rb = _port("banded")
    assert ra == rb
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    # Same pool, same regeneration order, same chunking: same occupancy.
    occupancy = _reference(monkeypatch)[3]
    assert abs(_CACHE["occupancy"] - occupancy) < 1e-6


def test_render_entry_point_takes_the_wavefront_for_bvh_scenes(monkeypatch):
    """render.render on a scene above 128 primitives goes build_scene ->
    BVH -> packet table -> walk -> wavefront renderer; a scene carried
    over from gdpt_tpu leaf by leaf renders the same image."""
    calls = []
    real = tpath.render_soa_wavefront
    monkeypatch.setattr(tpath, "render_soa_wavefront",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    scene = port_box(16, 16, 2)
    assert scene.static.n_tris > 128 and scene.bvh_builder in ("native", "numpy")
    img = trender.render(scene, seed=SEED, device="cpu")
    assert calls == [1]
    np.testing.assert_array_equal(img, _port("wavefront")[0])
    import jax

    js = _reference(monkeypatch)[0]
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(js.device)]
    carried = convert.scene_from_numpy(leaves, dataclasses.asdict(js.static), device="cpu")
    assert carried.device.geom.bvh_count.shape[0] > 0 and carried.bvh_builder == ""
    np.testing.assert_allclose(trender.render(carried, seed=SEED, device="cpu"), img,
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("compact", [True, False])
def test_tail_compaction(compact, monkeypatch):
    """32x32, 2 spp fills a 2048-lane pool; once the queue is empty and
    at most 1024 paths survive (unbounded depth, Russian roulette) they
    are compacted into 1024 lanes. The image is the banded loop's either
    way."""
    shrinks = []
    real = tpath._shrink_pool_state
    monkeypatch.setattr(tpath, "_shrink_pool_state",
                        lambda st, n, *a, **k: shrinks.append(n) or real(st, n, *a, **k))
    scene = port_box(32, 32, 2)
    img, rays = tpath.render_soa_wavefront(scene, 2, seed=5, return_stats=True,
                                           k_iters=2, compact=compact)
    assert (shrinks == [1024]) == compact and (compact or not shrinks)
    if "banded32" not in _CACHE:
        _CACHE["banded32"] = tpath.render_soa(scene, seed=5, return_stats=True, wavefront=False)
    ref, ref_rays = _CACHE["banded32"]
    assert rays == ref_rays
    np.testing.assert_allclose(img, ref, rtol=0, atol=2e-6)
    assert tpath.render_soa_wavefront.last_iters % 2 == 0
    assert 0.0 < tpath.render_soa_wavefront.last_occupancy <= 1.0


@pytest.mark.parametrize("pool,k_iters", [(1024, 1), (4096, 3)])
def test_pool_width_and_chunking_do_not_change_the_image(pool, k_iters):
    scene = port_box(16, 16, 2)
    img, rays = tpath.render_soa_wavefront(scene, 2, seed=SEED, return_stats=True,
                                           pool=pool, k_iters=k_iters)
    ref, ref_rays = _port("wavefront")
    assert rays == ref_rays
    np.testing.assert_allclose(img, ref, rtol=0, atol=2e-6)


def test_scene_tables_are_built_once_per_scene(monkeypatch):
    """Repeated renders of one scene reuse its copy on the device and its
    packet table; another scene, or the same one with other options, is
    not served a stale entry."""
    from gdpt_tpu_torch.accel import traverse_soa as ttrs
    from gdpt_tpu_torch.scene.build import scene_to

    builds = []
    real = ttrs.geom_soa_from_aos
    monkeypatch.setattr(ttrs, "geom_soa_from_aos", lambda g, **k: builds.append(1) or real(g, **k))
    scene = port_box(16, 16, 1)
    a = trender.render(scene, seed=SEED, device="cpu")
    b = trender.render(scene, seed=SEED, device="cpu")
    assert builds == [1]
    np.testing.assert_array_equal(a, b)
    moved = scene_to(scene, "cpu")
    assert moved.device is scene_to(scene, torch.device("cpu")).device
    assert tpath.scene_soa_from_aos(moved) is tpath.scene_soa_from_aos(scene_to(scene, "cpu"))
    two = scene._replace(static=dataclasses.replace(scene.static, width=8, height=8))
    assert scene_to(two, "cpu").static.width == 8 and builds == [1]
    assert trender.render(two, seed=SEED, device="cpu").shape == (8, 8, 3)
    other = port_box(16, 16, 1)
    trender.render(other, seed=SEED, device="cpu")
    assert builds == [1, 1]


def test_work_queue_limit(monkeypatch):
    """n_pix * spp >= 2^32 does not fit the uint32 work queue: the
    wavefront raises, and render_soa routes such a render to the banded
    loop instead."""
    scene = port_box(16, 16, 1)
    with pytest.raises(ValueError, match="2\\^32"):
        tpath.render_soa_wavefront(scene, 2 ** 24)

    class Banded(Exception):
        pass

    def banded_pass(*args):
        raise Banded

    monkeypatch.setattr(tpath, "_soa_pass", banded_pass)
    with pytest.raises(Banded):
        tpath.render_soa(scene, spp=2 ** 24)


@pytest.mark.parametrize("n_alive,cur_pool,lane_q", [
    (0, 262144, 1024), (1, 2048, 1024), (1000, 2048, 1024), (1025, 4096, 1024),
    (1025, 2048, 1024), (70000, 262144, 1024), (131073, 262144, 1024), (5, 1024, 1024),
    (3000, 262144, 1024), (300, 8192, 128)])
def test_tail_bucket_equals_reference(n_alive, cur_pool, lane_q):
    from gdpt_tpu.integrators import path_soa as jpath

    assert tpath._tail_bucket(n_alive, cur_pool, lane_q) == \
        jpath._tail_bucket(n_alive, cur_pool, lane_q)


def test_shrink_keeps_live_lanes_in_order():
    st = tpath._wavefront_state(16, 2048, 32, 0, torch.device("cpu"))
    st["alive"][[3, 700, 1500, 2047]] = 1.0
    st["pixel"] = torch.arange(2048)
    st["org"] = st["org"]._replace(x=torch.arange(2048, dtype=torch.float32))
    out = tpath._shrink_pool_state(st, 1024)
    assert out["alive"].shape == (1024,) and int(out["alive"].sum()) == 4
    assert out["pixel"][:4].tolist() == [3, 700, 1500, 2047]
    assert out["org"].x[:4].tolist() == [3.0, 700.0, 1500.0, 2047.0]
    assert out["acc_x"] is st["acc_x"] and out["tp"].y.shape == (1024,)
    assert tpath._pool_width(2 ** 30) == 1 << 18 and tpath._pool_width(1500) == 2048
    assert tpath._pool_width(10 ** 6, pool=3000) == 3072
