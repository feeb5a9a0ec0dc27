"""The port's two-phase entry traversal and the packet table's switches
against gdpt_tpu's.

packet_trace.trace_two_phase (phase 1: the dense (n, K) slab test
against the entry boxes; phase 2: one dispatch per entry, nearest first,
from a start ref per ray; a root walk for the lanes that crossed more
than entry_iters boxes) runs here on the plain walk. It is held against
gdpt_tpu.accel.packet_trace.trace_two_phase(interpret=True) on the
reference test's soup (tests/test_packet.py: 1,500 triangles, 1,024
rays, seeds 11 and 12) and its dead and non-finite lanes, and against
the port's own single-phase walk: t within 1 ulp (2 ulp for spheres,
whose CPU sqrt is not correctly rounded), prim equal where the closest
t is unique, any-hit masks equal. The switches that replace the
reference's environment variables (GDPT_TWO_PHASE, GDPT_EXPAND_PREMERGE,
GDPT_ENTRY_K and _morton_keys' hint) give the reference's routes,
tables and keys.

The gpu-marked test holds K3 and K4 under the two-phase walk against
the plain walk under it on the card, bit for bit:
    python -m pytest --noconftest -m gpu tests/test_torch_two_phase.py
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.accel import packet_kernels as pk
from gdpt_tpu_torch.accel import packet_trace as tpt
from gdpt_tpu_torch.core.soa import V3

from test_torch_packet import (_arrays, _brute, _carry, _jv3, _reference_table, _table_case,
                               _v3, one_thread)  # noqa: F401 (autouse fixture)

_CACHE = {}


def _soup(nt, seed):
    """tests/test_super16.py's soup (the reference's two-phase tests)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(nt, 3))
    return tuple(centers + rng.normal(0, 0.3, (nt, 3)) for _ in range(3))


def _rays(nr, seed):
    """tests/test_super16.py's rays."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-15, 15, (nr, 3)).astype(np.float32)
    d = rng.uniform(-10, 10, (nr, 3)).astype(np.float32) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _clustered(n_clusters, seed, max_size):
    """Clusters of 1 to max_size triangles: fat leaves small enough for
    sibling leaves to share a row, where premerge counts slots apart."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_size + 1, n_clusters)
    cen = (np.repeat(rng.uniform(-50, 50, (n_clusters, 3)), sizes, 0)
           + rng.normal(0, 0.5, (sizes.sum(), 3)))
    return tuple(cen + rng.normal(0, 0.3, cen.shape) for _ in range(3))


def _tables(nt, seed, wide=32):
    """(reference table, the port's table carried from it, geo9)."""
    if (nt, seed, wide) not in _CACHE:
        ref = _reference_table(_arrays(*_soup(nt, seed)), wide=wide)
        _CACHE[nt, seed, wide] = (ref, _carry(ref), np.asarray(ref.geo9))
    return _CACHE[nt, seed, wide]


def _max_ulp(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    both = np.isfinite(a) & np.isfinite(b)
    assert (np.isfinite(a) == np.isfinite(b)).all()
    ia, ib = a[both].view(np.int32).astype(np.int64), b[both].view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max(initial=0))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_two_phase_matches_reference_and_single_phase(any_hit):
    from gdpt_tpu.accel import packet_trace as jpt

    jtab, tab, geo9 = _tables(1500, 11)
    assert tab.entry_ref.shape[0] > 2
    org, d = _rays(1024, seed=12)
    got = tpt.trace_two_phase(tab, _v3(org), _v3(d), 1e-4, 1e9, any_hit=any_hit)
    ref = jpt.trace_two_phase(jtab, _jv3(org), _jv3(d), 1e-4, 1e9, any_hit=any_hit,
                              interpret=True)
    one = tpt.trace_packet_soa(tab, _v3(org), _v3(d), 1e-4, 1e9, any_hit=any_hit)
    bt, bp, unique = _brute(geo9, org, d)
    assert 0.15 < (bp >= 0).mean() < 1.0 and unique.mean() > 0.99
    prim, jprim = got[1].numpy(), np.asarray(ref[1])
    np.testing.assert_array_equal(prim >= 0, bp >= 0)
    np.testing.assert_array_equal(prim >= 0, jprim >= 0)
    np.testing.assert_array_equal(prim >= 0, one[1].numpy() >= 0)
    if any_hit:
        # t is the input tfar and the attributes are the miss's, as in the reference.
        np.testing.assert_array_equal(got[0].numpy(), np.full(1024, 1e9, np.float32))
        np.testing.assert_array_equal(np.asarray(ref[0]), got[0].numpy())
        assert not got[2].any() and not got[3].any() and bool((got[4].z == 1).all())
        return
    assert _max_ulp(got[0], ref[0]) <= 1 and _max_ulp(got[0], one[0]) <= 1
    np.testing.assert_array_equal(prim[unique], jprim[unique])
    np.testing.assert_array_equal(prim[unique], bp[unique])
    np.testing.assert_array_equal(prim, one[1].numpy())
    same = prim == jprim
    for a, b in zip((got[2], got[3], *got[4]), (ref[2], ref[3], *ref[4])):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=1e-4, atol=1e-5)


def test_two_phase_dead_and_nonfinite_lanes():
    """tests/test_packet.py's set: 400 triangles, 640 rays, every fourth
    origin inf, every seventh lane dead (tfar = -1)."""
    import jax.numpy as jnp
    from gdpt_tpu.accel import packet_trace as jpt

    jtab, tab, geo9 = _tables(400, 13)
    org, d = _rays(640, seed=14)
    orgb = org.copy()
    bad = np.arange(640) % 4 == 0
    orgb[bad] = np.inf
    tfar = np.full(640, 1e9, np.float32)
    dead = np.arange(640) % 7 == 0
    tfar[dead] = -1.0
    out = bad | dead
    _, bp, unique = _brute(geo9, org, d)
    for any_hit in (False, True):
        got = tpt.trace_two_phase(tab, _v3(orgb), _v3(d), 1e-4, torch.from_numpy(tfar),
                                  any_hit=any_hit)
        one = tpt.trace_packet_soa(tab, _v3(orgb), _v3(d), 1e-4, torch.from_numpy(tfar),
                                   any_hit=any_hit)
        prim = got[1].numpy()
        assert (prim[out] == -1).all()
        np.testing.assert_array_equal(prim[~out] >= 0, bp[~out] >= 0)
        np.testing.assert_array_equal(prim >= 0, one[1].numpy() >= 0)
        if not any_hit:
            np.testing.assert_array_equal(prim[~out & unique], bp[~out & unique])
            assert _max_ulp(got[0], one[0]) <= 1
            jt, jp, _, _, _ = jpt.trace_two_phase(jtab, _jv3(orgb), _jv3(d), 1e-4,
                                                  jnp.asarray(tfar), interpret=True)
            np.testing.assert_array_equal(np.asarray(jp)[unique], prim[unique])
            assert _max_ulp(got[0], jt) <= 1


def test_two_phase_with_in_table_spheres():
    """A table holding 11 spheres (n_tris given), half the rays aimed at
    sphere centres: the two-phase walk gives the single-phase result."""
    args, kw = _table_case("spheres_in_table", 32)
    tab = tpt.build_packet_table(*args, **kw)
    geo9 = tab.geo9.numpy()
    n_tris = args[6].shape[0]
    org, d = _rays(1024, seed=2)
    c = geo9[-11:, 0:3][np.arange(512) % 11]
    d[:512] = c - org[:512]
    d[:512] /= np.linalg.norm(d[:512], axis=1, keepdims=True)
    bt, bp, unique = _brute(geo9, org, d, n_tris=n_tris)
    assert (bp >= n_tris).mean() > 0.1
    got = tpt.trace_two_phase(tab, _v3(org), _v3(d), 1e-4, 1e9, n_tris=n_tris)
    one = tpt.trace_packet_soa(tab, _v3(org), _v3(d), 1e-4, 1e9, n_tris=n_tris)
    assert _max_ulp(got[0], one[0]) <= 2
    np.testing.assert_array_equal(got[1].numpy()[unique], bp[unique])
    np.testing.assert_array_equal(got[1].numpy()[unique], one[1].numpy()[unique])
    for a, b in zip(got[4], one[4]):  # sphere normals follow t
        np.testing.assert_allclose(a.numpy()[unique], b.numpy()[unique], rtol=1e-4, atol=1e-3)
    occ = tpt.trace_two_phase(tab, _v3(org), _v3(d), 1e-4, 1e9, n_tris=n_tris, any_hit=True)
    np.testing.assert_array_equal(occ[1].numpy() >= 0, bp >= 0)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_two_phase_dual_on_a_16_wide_table(any_hit):
    """dual=True (K4's contract) under the two-phase walk equals the solo
    walk under it bit for bit, and the single-phase walk."""
    _, tab, geo9 = _tables(1500, 11, wide=16)
    assert tab.width == 16
    org, d = _rays(1024, seed=12)
    solo = tpt.trace_two_phase(tab, _v3(org), _v3(d), 1e-4, 1e9, any_hit=any_hit)
    dual = tpt.trace_two_phase(tab, _v3(org), _v3(d), 1e-4, 1e9, any_hit=any_hit, dual=True)
    one = tpt.trace_packet_soa(tab, _v3(org), _v3(d), 1e-4, 1e9, any_hit=any_hit, dual=True)
    assert torch.equal(dual[0], solo[0]) and torch.equal(dual[1], solo[1])
    np.testing.assert_array_equal(dual[1].numpy() >= 0, one[1].numpy() >= 0)
    if not any_hit:
        _, _, unique = _brute(geo9, org, d)
        assert _max_ulp(dual[0], one[0]) <= 1
        np.testing.assert_array_equal(dual[1].numpy()[unique], one[1].numpy()[unique])
    _, tab32, _ = _tables(1500, 11)
    with pytest.raises(ValueError, match="16-wide"):
        tpt.trace_two_phase(tab32, _v3(org), _v3(d), 1e-4, 1e9, any_hit=any_hit, dual=True)


def test_two_phase_threshold(monkeypatch):
    """two_phase=True takes the two-phase walk for casts of 4,096 rays or
    more and the single-phase walk below, as the reference's
    _two_phase_on; two_phase=False never takes it. A GeomSoA built with
    two_phase=True routes both of traverse_soa's casts there."""
    from gdpt_tpu_torch.accel import traverse_soa as ttrs
    from gdpt_tpu_torch.scene import presets

    assert tpt.TWO_PHASE_MIN_RAYS == 4096
    seen = []
    real = tpt.trace_two_phase

    def spy(*a, **kw):
        seen.append((a[1].x.shape[0], bool(kw.get("any_hit"))))
        return real(*a, **kw)

    monkeypatch.setattr(tpt, "trace_two_phase", spy)
    _, tab, _ = _tables(400, 13)
    for n in (4095, 4096):
        org, d = _rays(n, seed=3)
        for two_phase in (False, True):
            tpt.intersect_packet(tab, _v3(org), _v3(d), 1e-4, 1e9, two_phase=two_phase)
            tpt.occluded_packet(tab, _v3(org), _v3(d), 1e-4, 1e9, two_phase=two_phase)
    assert seen == [(4096, False), (4096, True)]
    seen.clear()
    scene = presets.cornell_box(8, 8, spp=1, force_bvh=True)
    for flag in (False, True):
        g = ttrs.geom_soa_from_aos(scene.device.geom, two_phase=flag)
        assert g.two_phase == flag
        org, d = _rays(4096, seed=4)
        org = org * 10 + 278.0
        ttrs.intersect_soa_gn(scene.static, g, _v3(org), _v3(d), 1e-3, 1e9)
        ttrs.occluded_soa(scene.static, g, _v3(org), _v3(d), 1e-3, 1e9)
    assert seen == [(4096, False), (4096, True)]
    brute = ttrs.geom_soa_from_aos(presets.cornell_box(8, 8, spp=1).device.geom, two_phase=True)
    assert brute.packet is None and not brute.two_phase


@pytest.mark.parametrize("n_spheres", [3, 12])
def test_traverse_casts_with_spheres_under_two_phase(n_spheres, monkeypatch):
    """traverse_soa's casts on a view built with two_phase=True: 3 spheres
    ride outside the table and are merged after the two-phase walk, 12
    ride in it (n_tris given); the hits and the occlusion equal the
    single-phase view's (t within 2 ulp: CPU sphere roots)."""
    from gdpt_tpu_torch.accel import traverse_soa as ttrs
    from gdpt_tpu_torch.core import transform as txf
    from gdpt_tpu_torch.scene import build as tbuild
    from gdpt_tpu_torch.scene import model as tmodel

    from test_torch_packet import _soup_scene

    scene, org, d = _soup_scene(tmodel, tbuild, txf, n_spheres)
    org, d = np.tile(org, (6, 1)), np.tile(d, (6, 1))    # 4,608 rays: two-phase
    seen = []
    real = tpt.trace_two_phase
    monkeypatch.setattr(tpt, "trace_two_phase", lambda *a, **kw: seen.append(1) or real(*a, **kw))
    out = {}
    for flag in (False, True):
        g = ttrs.geom_soa_from_aos(scene.device.geom, two_phase=flag)
        hit, gn = ttrs.intersect_soa_gn(scene.static, g, _v3(org), _v3(d), 1e-4, 1e9)
        occ = ttrs.occluded_soa(scene.static, g, _v3(org), _v3(d), 1e-4, 1e9)
        out[flag] = (hit, gn, occ)
    assert len(seen) == 2 and bool((out[True][0].prim_id >= scene.static.n_tris).any())
    (h1, g1, o1), (h0, g0, o0) = out[True], out[False]
    assert torch.equal(h1.prim_id, h0.prim_id) and torch.equal(o1, o0)
    assert _max_ulp(h1.t, h0.t) <= 2
    for a, b in zip((h1.u, h1.v, *g1), (h0.u, h0.v, *g0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hint", [None, "depth"])
def test_morton_keys_equal_reference(hint):
    from gdpt_tpu.accel import packet_trace as jpt

    jtab, tab, _ = _tables(1500, 11)
    org, d = _rays(4096, seed=5)
    org[::9] = org[::9] * 3.0  # outside the scene box: clipped
    d[::5, 1] = -0.0
    h = None if hint is None else np.random.default_rng(6).integers(-5, 80, 4096)
    got = tpt._morton_keys(tab, _v3(org), _v3(d),
                           hint=None if h is None else torch.from_numpy(h))
    ref = jpt._morton_keys(jtab, _jv3(org), _jv3(d),
                           hint=None if h is None else np.asarray(h, np.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if hint is not None:
        np.testing.assert_array_equal(got.numpy() >> 21, np.clip(h, 0, 63))


@pytest.mark.parametrize("entry", ["trace_packet_soa", "intersect_soa_gn"])
def test_sort_hint_reaches_the_keys(entry, monkeypatch):
    """sort_hint reaches _morton_keys through the cast that takes it, and
    changes no ray's result: trace_packet_soa with a hint equals the
    reference's trace_packet_soa(sort_hint=) (interpret mode; t within 1
    ulp, prim where t is unique) and, bit for bit, the port's cast
    without one; so does traverse_soa.intersect_soa_gn on a BVH box."""
    from gdpt_tpu_torch.accel import traverse_soa as ttrs
    from gdpt_tpu_torch.scene import presets

    hints = []
    real = tpt._morton_keys
    monkeypatch.setattr(tpt, "_morton_keys",
                        lambda *a, hint=None: hints.append(hint) or real(*a, hint=hint))
    n = 1024
    hint = torch.from_numpy(np.random.default_rng(8).integers(0, 64, n).astype(np.int32))
    if entry == "trace_packet_soa":
        from gdpt_tpu.accel import packet_trace as jpt

        jtab, tab, geo9 = _tables(1500, 11)
        org, d = _rays(n, seed=12)

        def cast(h):
            return tpt.trace_packet_soa(tab, _v3(org), _v3(d), 1e-4, 1e9, sort_hint=h)[:2]

        got = cast(hint)
        ref = jpt.trace_packet_soa(jtab, _jv3(org), _jv3(d), 1e-4, 1e9, interpret=True,
                                   sort_hint=np.asarray(hint))
        _, _, unique = _brute(geo9, org, d)
        assert _max_ulp(got[0], ref[0]) <= 1
        np.testing.assert_array_equal(got[1].numpy()[unique], np.asarray(ref[1])[unique])
    else:
        scene = presets.cornell_box(8, 8, spp=1, force_bvh=True)
        g = ttrs.geom_soa_from_aos(scene.device.geom)
        org, d = _rays(n, seed=4)
        org = org * 10 + 278.0

        def cast(h):
            hit, _ = ttrs.intersect_soa_gn(scene.static, g, _v3(org), _v3(d), 1e-3, 1e9,
                                           sort_hint=h)
            return hit.t, hit.prim_id

        got = cast(hint)
        assert bool((got[1] >= 0).any())
    assert len(hints) == 1 and hints[0] is hint
    plain = cast(None)
    assert hints[1] is None
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


@pytest.mark.parametrize("wide", [16, 32])
@pytest.mark.parametrize("switch", ["premerge", "entry_k16"])
def test_table_switches_equal_reference(switch, wide, monkeypatch):
    """premerge=True is GDPT_EXPAND_PREMERGE=1 and entry_k=16 is
    GDPT_ENTRY_K=16: the tables are the reference's leaf for leaf, and
    each switch changes what it should."""
    args, kw = _table_case("triangles", wide)
    if switch == "premerge":
        args = _arrays(*(_clustered(120, 0, 29) if wide == 16 else _clustered(300, 1, 3)))
        mine = dict(premerge=True)
        monkeypatch.setenv("GDPT_EXPAND_PREMERGE", "1")
    else:
        mine = dict(entry_k=16)
        monkeypatch.setenv("GDPT_ENTRY_K", "16")
    got = tpt.build_packet_table(*args, **kw, **mine)
    ref = _reference_table(args, **kw)
    for name in ("table", "bbox", "geo9", "entry_ref", "entry_bbox"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.stack_n == ref.stack_dummy.shape[0] and got.width == wide
    plain = tpt.build_packet_table(*args, **kw)
    if switch == "premerge":
        assert got.table.shape != plain.table.shape or not torch.equal(got.table, plain.table)
    else:
        assert torch.equal(got.table, plain.table)
        assert 16 <= got.entry_ref.shape[0] - 1 < plain.entry_ref.shape[0] - 1
    # The walk over either table finds the same hits.
    org, d = _rays(1024, seed=7)
    for tab_ in (got, plain):
        t, prim = tpt.trace_two_phase(tab_, _v3(org), _v3(d), 1e-4, 1e9)[:2]
        if tab_ is got:
            first = (t, prim)
    np.testing.assert_array_equal(first[1].numpy() >= 0, prim.numpy() >= 0)


@pytest.mark.parametrize("switch", ["premerge", "entry_k16"])
def test_scene_view_memo_keys_the_table_build(switch):
    """path_soa.scene_soa_from_aos memoises a scene's view per table
    build: with premerge=True or entry_k=16 it returns that build's
    table, not the default one memoised before it, and a default call
    after it the default table again (the scene: 612 triangles in
    clusters, whose table both switches change)."""
    from gdpt_tpu_torch.accel import traverse_soa as ttrs
    from gdpt_tpu_torch.core import transform as txf
    from gdpt_tpu_torch.integrators import path_soa as tps
    from gdpt_tpu_torch.scene import build as tbuild
    from gdpt_tpu_torch.scene import model as tmodel

    v0, v1, v2 = _clustered(300, 1, 3)
    nt = len(v0)
    mesh = tmodel.TriangleMesh(
        positions=np.concatenate([v0, v1, v2]).astype(np.float32),
        indices=np.stack([np.arange(nt), np.arange(nt) + nt, np.arange(nt) + 2 * nt],
                         -1).astype(np.int32),
        material_id=0)
    cam = tmodel.Camera(txf.look_at([0, 0, 120], [0, 0, 0], [0, 1, 0]), 45.0, 8, 8)
    scene = tbuild.build_scene(cam, [tmodel.Lambertian(0.5)], [mesh],
                               [tmodel.DiffuseAreaLight(shape_id=0, intensity=np.ones(3))],
                               options=tmodel.RenderOptions(integrator="path"))
    mine = dict(premerge=True) if switch == "premerge" else dict(entry_k=16)
    default = tps.scene_soa_from_aos(scene).geom.packet
    got = tps.scene_soa_from_aos(scene, **mine).geom.packet
    want = ttrs.geom_soa_from_aos(scene.device.geom, **mine).packet
    for name in ("table", "entry_ref", "entry_bbox"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    changed = "table" if switch == "premerge" else "entry_ref"
    assert getattr(got, changed).shape != getattr(default, changed).shape
    assert tps.scene_soa_from_aos(scene).geom.packet is default


def test_per_ray_oracle_is_unchanged_by_two_phase(monkeypatch):
    """The per-ray path oracle casts through traverse_soa, so a view
    built with two_phase=True reaches it too (the reference's per-ray
    programs cast through XLA walks that never read GDPT_TWO_PHASE): its
    4,096-lane passes then take the two-phase walk, with the same image
    and ray count."""
    from gdpt_tpu_torch.integrators import path, render

    from test_torch_bvh import port_box

    scene = port_box(16, 16, 16, max_depth=3)
    assert not scene.static.use_brute_force
    launches = dict(pk.LAUNCHES)
    seen = []
    real = tpt.trace_two_phase
    monkeypatch.setattr(tpt, "trace_two_phase", lambda *a, **kw: seen.append(1) or real(*a, **kw))
    img, rays = render.render_samples(scene, path.trace_path, seed=5, return_stats=True,
                                      two_phase=True)
    assert seen
    seen.clear()
    ref, ref_rays = render.render_samples(scene, path.trace_path, seed=5, return_stats=True)
    assert not seen and pk.LAUNCHES == launches  # the CPU walks count no launch
    assert rays == ref_rays and img.mean() > 0
    np.testing.assert_array_equal(img, ref)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("walker", ["K3 32-wide", "K3 16-wide", "K4 16-wide"])
def test_cuda_two_phase_matches_plain(walker, monkeypatch):
    """The two-phase walk with K3 or K4 against the same walk with their
    plain versions in their place, on the card: t and prim bit for bit,
    closest and any hit, on a soup of 20,000 triangles and 65,536 rays
    (dead lanes among them), and the share of lanes the root walk takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wide, dual = (32, False) if walker == "K3 32-wide" else (16, walker.startswith("K4"))
    tab = tpt.packet_table_to(tpt.build_packet_table(*_arrays(*_soup(20_000, 31)), wide=wide),
                              "cuda")
    org, d = _rays(65_536, seed=32)
    o = V3(*(torch.from_numpy(np.ascontiguousarray(org[:, i])).cuda() for i in range(3)))
    dd = V3(*(torch.from_numpy(np.ascontiguousarray(d[:, i])).cuda() for i in range(3)))
    tf = torch.from_numpy(np.random.default_rng(3).uniform(-1, 40, 65_536).astype(np.float32))
    kernel = pk.trace_packets

    def plain(tab_, *rays, dual=False, **kw):
        return (pk.trace_packets_dual_plain if dual else pk.trace_packets_plain)(tab_, *rays,
                                                                                  **kw)

    for any_hit in (False, True):
        key = "packet_dual_" if dual else "packet_"
        key += "occluded" if any_hit else "intersect"
        before = pk.LAUNCHES[key]
        got = tpt.trace_two_phase(tab, o, dd, 1e-4, tf.cuda(), any_hit=any_hit, dual=dual)
        assert pk.LAUNCHES[key] - before >= 2
        monkeypatch.setattr(pk, "trace_packets", plain)
        ref = tpt.trace_two_phase(tab, o, dd, 1e-4, tf.cuda(), any_hit=any_hit, dual=dual)
        monkeypatch.setattr(pk, "trace_packets", kernel)
        torch.cuda.synchronize()
        assert 0.05 < float((ref[1] >= 0).float().mean()) < 0.95
        assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
        assert torch.equal(got[1], ref[1])
        one = tpt.trace_packet_soa(tab, o, dd, 1e-4, tf.cuda(), any_hit=any_hit, dual=dual)
        assert torch.equal(got[1] >= 0, one[1] >= 0)
        if not any_hit:
            assert torch.equal(got[0], one[0])
