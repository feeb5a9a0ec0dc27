"""The pool-sorted wavefronts (pool_sort=True) against gdpt_tpu's
(GDPT_POOL_SORT=1), on the CPU.

The three pool sorts (path_soa._pool_sort, gdpt_soa._gdpt_pool_sort,
volpath_soa._vol_pool_sort) morton-permute a lane pool, dead lanes to
the back: on one seeded state, each permutes every leaf as the
reference's does, leaf for leaf (a stable sort on both sides).

The renders: the force_bvh Cornell box of tests/test_soa.py:474 (path)
and tests/test_gdpt.py:231 (gradpath) at 16x16, and a small medium box
(volpath), each through the port's wavefront with pool_sort=True and the
reference's with GDPT_PACKET=1 (its Pallas walk in interpret mode, the
pool sort needs a packet table) and GDPT_POOL_SORT=1; the path render
also with packet_sort=False against the reference's GDPT_PACKET_SORT=0.
Port against reference at the path gate: at least 99% of values within
rtol 1e-3 / atol 1e-4 and the mean within 0.1% (f32 transcendental ulps
can flip a rare test). Within the port, the sorted pool against the unsorted one:
equal ray counts and images within 2e-6 absolute (the same samples,
summed in f32 in another lane order); the volpath ray counts also equal
the reference's.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.integrators import gdpt_soa as tgdpt
from gdpt_tpu_torch.integrators import path_soa as tpath
from gdpt_tpu_torch.integrators import volpath_soa as tvol
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import _tables, one_thread  # noqa: F401 (autouse fixture)
from test_torch_volpath import gate

SEED = 5
POOL = 2048
_CACHE = {}


class _Vertex(NamedTuple):
    position: object
    material_id: object


def _pool_state(kind, n=3000, seed=0):
    """A seeded lane pool as numpy leaves: positions from a coarse grid
    (so many lanes share a morton key and the sort's stability shows),
    directions of every octant, a third of the lanes dead, and the
    entries each pool sort must carry along or leave alone."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(-6, 7, (3, n)).astype(np.float32) * 2.0
    d = rng.normal(size=(3, n)).astype(np.float32)
    live = (rng.random(n) > 0.33).astype(np.float32)
    tag = np.arange(n, dtype=np.int64)
    f = rng.random((4, n)).astype(np.float32)
    if kind == "path":
        st = {k: f[0] + i for i, k in enumerate(("pdf_prev", "eta_scale", "rr_prev", "cont",
                                                  "radius", "spread"))}
        st.update(org=tuple(pos), d=tuple(d), tp=tuple(f[:3]), pixel=tag, sample=tag * 7,
                  bounce=(tag % 5).astype(np.int32), alive=live,
                  acc_x=f[3], rays=np.float32(17.0))
        return st
    if kind == "gdpt":
        lane = dict(base_v=_Vertex(tuple(pos), (tag % 3).astype(np.int32)), base_d=tuple(d),
                    active=live, pixel=tag, offs=tuple(dict(prob=f[i], d=tuple(f[:3]))
                                                       for i in range(4)),
                    rays=np.float32(17.0))
    else:
        lane = dict(org=tuple(pos), d=tuple(d), active=live > 0, pixel=tag,
                    throughput=tuple(f[:3]), rays=np.float32(17.0))
    return dict(lane=lane, pending=(f[3] > 0.5).astype(np.float32 if kind == "gdpt" else bool),
                acc=f[:2].T.copy(), next_item=5)


def _to(st, lib):
    """The numpy state as the port's (torch, V3) or the reference's (jax) tree."""
    if lib == "torch":
        from gdpt_tpu_torch.core.soa import V3 as Vec
        arr = torch.as_tensor
    else:
        import jax.numpy as jnp
        from gdpt_tpu.core.soa import V3 as Vec
        arr = jnp.asarray

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, _Vertex):
            return _Vertex(conv(x.position), conv(x.material_id))
        if isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], np.ndarray):
            return Vec(*(arr(c) for c in x))
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        if isinstance(x, (np.ndarray, np.floating)):
            return arr(x)
        return x
    return conv(st)


def _leaves(tree, out=None, path=""):
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _leaves(v, out, f"{path}/{k}")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            _leaves(v, out, f"{path}/{i}")
    else:
        out[path] = np.asarray(tree)
    return out


@pytest.mark.parametrize("kind", ["path", "gdpt", "vol"])
def test_pool_sort_permutes_as_the_reference(kind):
    from gdpt_tpu.integrators import gdpt_soa as jgdpt
    from gdpt_tpu.integrators import path_soa as jpath
    from gdpt_tpu.integrators import volpath_soa as jvol

    jtab, tab, _, _ = _tables("triangles", 32)
    st = _pool_state(kind)
    port = {"path": tpath._pool_sort, "gdpt": tgdpt._gdpt_pool_sort,
            "vol": tvol._vol_pool_sort}[kind]
    ref = {"path": jpath._pool_sort, "gdpt": jgdpt._gdpt_pool_sort,
           "vol": jvol._vol_pool_sort}[kind]
    got = _leaves(port(_to(st, "torch"), tab))
    want = _leaves(ref(_to(st, "jax"), jtab))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    before = _leaves(st)
    alive = "/alive" if kind == "path" else "/lane/active"
    tag = "/pixel" if kind == "path" else "/lane/pixel"
    perm = got[tag]
    assert not np.array_equal(perm, before[tag])         # it did permute
    n_live = int((before[alive] > 0).sum())
    assert (got[alive][:n_live] > 0).all() and not (got[alive][n_live:] > 0).any()
    for k in ("/rays", "/lane/rays", "/acc", "/acc_x", "/next_item"):
        if k in before:  # what is not per lane stays put
            np.testing.assert_array_equal(got[k], before[k])


def _cbox(presets, integrator):
    if integrator == "path":
        return presets.cornell_box(width=16, height=16, spp=3, max_depth=4, force_bvh=True)
    return presets.cornell_box(width=16, height=16, spp=2, max_depth=3, integrator="gradpath",
                               force_bvh=True)


def _medium_box(M, build, xf):
    return tpresets.build_medium_box(
        M, build, xf, 12, 12, 4, balls=[(1, (368.0, 100.0, 351.0), 100.0)], grid_res=16,
        max_depth=6)


def _reference(kind, monkeypatch, variant="pool_sort"):
    """(image, rays) of gdpt_tpu's pool-sorted wavefront render, or with
    variant="packet_sort" of the one whose casts do not sort
    (GDPT_PACKET_SORT=0)."""
    key = ("ref", kind, variant)
    if key not in _CACHE:
        monkeypatch.setenv("GDPT_PACKET", "1")
        if variant == "pool_sort":
            monkeypatch.setenv("GDPT_POOL_SORT", "1")
        else:
            monkeypatch.setenv("GDPT_PACKET_SORT", "0")
        if kind == "path":
            from gdpt_tpu.integrators import path_soa as jpath
            from gdpt_tpu.scene import presets as jpresets

            out = jpath.render_soa(_cbox(jpresets, "path"), spp=3, seed=SEED, return_stats=True)
        elif kind == "gradpath":
            from gdpt_tpu.integrators import gdpt_soa as jgdpt
            from gdpt_tpu.scene import presets as jpresets

            out = jgdpt.render_gradpath_soa(_cbox(jpresets, "gradpath"), spp=3, seed=SEED,
                                            return_stats=True)
        else:
            from gdpt_tpu.core import transform as xf
            from gdpt_tpu.integrators import volpath_soa as jvol
            from gdpt_tpu.scene import build
            from gdpt_tpu.scene import model as M

            monkeypatch.setenv("GDPT_VOL_POOL", str(POOL))
            out = jvol.render_volpath_soa(_medium_box(M, build, xf), seed=SEED,
                                          return_stats=True)
        _CACHE[key] = (np.asarray(out[0]), out[1])
    return _CACHE[key]


def _port(kind, pool_sort, packet_sort=True):
    key = ("port", kind, pool_sort, packet_sort)
    if key not in _CACHE:
        if kind == "volpath":
            from gdpt_tpu_torch.core import transform as xf
            from gdpt_tpu_torch.scene import build
            from gdpt_tpu_torch.scene import model as M

            _CACHE[key] = tvol.render_volpath_soa(_medium_box(M, build, xf), seed=SEED,
                                                  return_stats=True, pool=POOL,
                                                  pool_sort=pool_sort, packet_sort=packet_sort)
        else:
            render = tpath.render_soa if kind == "path" else tgdpt.render_gradpath_soa
            _CACHE[key] = render(_cbox(tpresets, kind), spp=3, seed=SEED, return_stats=True,
                                 pool_sort=pool_sort, packet_sort=packet_sort)
    return _CACHE[key]


@pytest.mark.parametrize("kind", ["path", "gradpath", "volpath"])
def test_pool_sorted_render_matches_reference(kind, monkeypatch):
    ref, ref_rays = _reference(kind, monkeypatch)
    img, rays = _port(kind, True)
    gate(img, ref, float(ref.mean()))
    if kind == "gradpath":  # shadow rays graze the light (ROADMAP.md C): 0.1%
        assert abs(rays - ref_rays) <= 1e-3 * ref_rays
    else:
        assert rays == ref_rays


@pytest.mark.parametrize("kind", ["path", "gradpath", "volpath"])
def test_pool_sort_changes_no_estimate(kind, monkeypatch):
    """The sorted pool traces the same samples as the unsorted one: equal
    ray counts, images within f32 summation order; and it did sort (the
    extension casts ran unsorted, the pool sort was taken)."""
    calls = []
    sorts = {"path": (tpath, "_pool_sort"), "gradpath": (tgdpt, "_gdpt_pool_sort"),
             "volpath": (tvol, "_vol_pool_sort")}[kind]
    real = getattr(*sorts)
    monkeypatch.setattr(*sorts, lambda st, tab: calls.append(1) or real(st, tab))
    _CACHE.pop(("port", kind, True, True), None)
    a, ra = _port(kind, True)
    b, rb = _port(kind, False)
    assert calls and ra == rb
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)


def test_unsorted_casts_match_reference(monkeypatch):
    """packet_sort=False (the reference's GDPT_PACKET_SORT=0): no cast
    sorts its rays, so no morton key is computed in the whole render;
    the image is the reference's unsorted render's at the path gate with
    its ray count, and the sorted render's within f32 summation order
    with its ray count. The reference reads the variable when it traces,
    and its jit caches do not key on it: they are cleared around its
    render."""
    import jax
    from gdpt_tpu_torch.accel import packet_trace as tpt

    jax.clear_caches()
    try:
        ref, ref_rays = _reference("path", monkeypatch, variant="packet_sort")
    finally:
        jax.clear_caches()
    keys = []
    real = tpt._morton_keys
    monkeypatch.setattr(tpt, "_morton_keys", lambda *a, **kw: keys.append(1) or real(*a, **kw))
    img, rays = _port("path", False, packet_sort=False)
    assert not keys
    gate(img, ref, float(ref.mean()))
    assert rays == ref_rays
    _CACHE.pop(("port", "path", False, True), None)
    sorted_img, sorted_rays = _port("path", False)
    assert keys and sorted_rays == rays
    np.testing.assert_allclose(img, sorted_img, rtol=0, atol=2e-6)
