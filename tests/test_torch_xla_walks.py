"""The reference's XLA BVH walks in the port (accel/traverse_soa.py):
_pack_bvh, intersect_bvh_packed, intersect_bvh_soa and occluded_bvh_soa,
the views built for them, and the filled geometric normal.

The packed table is held bit for bit equal to the reference's
bvh_nodes48. The walks run on tests/test_soa.py's scene (the 8x8 Cornell
box with a BVH built over its triangles) and on a BVH that holds spheres
(tests/test_packet.py's soup with 12 spheres), with its rays and with
dead (tfar < tnear) and non-finite lanes (tests/test_packet.py's set),
against the reference's walks on the same arrays. Tolerances: t of a
triangle hit bit-equal to numpy brute force (sphere hits to 2 ulp:
torch's CPU sqrt is not correctly rounded) and within rtol 1e-5 of the
reference, whose XLA CPU code fuses multiply-adds; prim equal where the
closest t is unique; any-hit masks equal.

The reference's shading rebuilds the geometric normal after its per-lane
walk (gn_raw None); the port fills it in traverse_soa instead, and the
shaded vertex is held to the reference's.

The gpu-marked tests hold the walks on the card against themselves on
the CPU and against K3; they import jax nowhere:
    python -m pytest --noconftest -m gpu tests/test_torch_xla_walks.py
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.accel import bvh as tbvh
from gdpt_tpu_torch.accel import traverse as ttr
from gdpt_tpu_torch.accel import traverse_soa as ttrs
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.integrators import path_soa as tpath
from gdpt_tpu_torch.integrators import render as trender
from gdpt_tpu_torch.scene import presets as tpresets

from test_torch_packet import _brute, one_thread  # noqa: F401

BIG = 1e30
_CACHE = {}


def _cbox_geom():
    """tests/test_soa.py:72's geometry as numpy leaves: the 8x8 Cornell
    box's triangles with a BVH over them (the numpy builder, the
    reference's algorithm), and that test's 400 rays."""
    if "cbox" not in _CACHE:
        sc = tpresets.cornell_box(width=8, height=8, spp=1)
        g = sc.device.geom
        v0, e1, e2 = (a.numpy() for a in (g.tri_v0, g.tri_e1, g.tri_e2))
        b = tbvh.build_bvh(v0, v0 + e1, v0 + e2, builder="numpy")
        leaves = [a.numpy() for a in g[:7]] + [np.asarray(b.bbox_min, np.float32),
                                               np.asarray(b.bbox_max, np.float32)] + [
            np.asarray(a, np.int32) for a in (b.first, b.count, b.miss, b.prim_order)]
        rng = np.random.RandomState(1)
        org = (rng.rand(400, 3) * 500).astype(np.float32)
        d = rng.randn(400, 3)
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        _CACHE["cbox"] = (leaves, org, d)
    return _CACHE["cbox"]


def _sphere_geom():
    """220 soup triangles and 12 spheres in one BVH (tests/test_packet.py's
    mixed scene), and 768 rays aimed at the spheres."""
    if "spheres" not in _CACHE:
        from test_torch_packet import _soup_scene
        from gdpt_tpu_torch.core import transform as xf
        from gdpt_tpu_torch.scene import build
        from gdpt_tpu_torch.scene import model as M

        scene, org, d = _soup_scene(M, build, xf, 12)
        _CACHE["spheres"] = ([a.numpy() for a in scene.device.geom], org, d)
    return _CACHE["spheres"]


def _geoms(leaves, **view):
    """(reference GeomSoA, port GeomSoA of `view`, static) of numpy leaves."""
    import jax.numpy as jnp
    from gdpt_tpu.accel import traverse as jtr
    from gdpt_tpu.accel import traverse_soa as jtrs

    jg = jtrs.geom_soa_from_aos(jtr.Geometry(*(jnp.asarray(a) for a in leaves)))
    tg = ttrs.geom_soa_from_aos(ttr.Geometry(*(torch.from_numpy(a) for a in leaves)), **view)
    static = SimpleNamespace(n_tris=leaves[0].shape[0], n_spheres=leaves[4].shape[0],
                             use_brute_force=False)
    return jg, tg, static


def _rays_with_dead(org, d):
    """Every fourth lane's origin non-finite, every seventh lane dead
    (tfar = -1), as tests/test_packet.py:132."""
    n = org.shape[0]
    orgb = org.copy()
    bad = np.arange(n) % 4 == 0
    orgb[bad] = np.inf
    tfar = np.full(n, 1e9, np.float32)
    dead = np.arange(n) % 7 == 0
    tfar[dead] = -1.0
    return orgb, tfar, bad | dead


def _v3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _jv3(a):
    import jax.numpy as jnp
    from gdpt_tpu.core.soa import V3 as JV3

    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _geo9(leaves):
    v0, e1, e2, _, c, r = leaves[:6]
    sph = np.concatenate([c, r[:, None], np.zeros((len(r), 5), np.float32)], 1)
    return np.concatenate([np.concatenate([v0, e1, e2], 1), sph]).astype(np.float32)


def test_packed_table_equals_reference():
    from gdpt_tpu.accel import traverse_soa as jtrs

    leaves = _cbox_geom()[0]
    jg, tg, _ = _geoms(leaves, packet=False)
    assert tg.bvh_nodes48.dtype == torch.float32 and tg.bvh_nodes48.shape[1] == 48
    np.testing.assert_array_equal(tg.bvh_nodes48.numpy().view(np.int32),
                                  np.asarray(jg.bvh_nodes48).view(np.int32))
    # A BVH that holds spheres has no packed table, on either side.
    sleaves = _sphere_geom()[0]
    assert ttrs._pack_bvh(ttr.Geometry(*(torch.from_numpy(a) for a in sleaves))) is None
    import jax.numpy as jnp
    from gdpt_tpu.accel import traverse as jtr

    assert jtrs._pack_bvh(jtr.Geometry(*(jnp.asarray(a) for a in sleaves))) is None


@pytest.mark.parametrize("lanes", ["live", "dead_and_nonfinite"])
@pytest.mark.parametrize("walk", ["packed", "per_lane_cbox", "per_lane_spheres"])
def test_walk_matches_reference(walk, lanes):
    import jax.numpy as jnp
    from gdpt_tpu.accel import traverse_soa as jtrs

    leaves, org, d = _sphere_geom() if walk == "per_lane_spheres" else _cbox_geom()
    jg, tg, static = _geoms(leaves, packet=False)
    tfar, out = np.full(org.shape[0], 1e9, np.float32), np.zeros(org.shape[0], bool)
    o = org
    if lanes != "live":
        o, tfar, out = _rays_with_dead(org, d)
    args = (_v3(o), _v3(d), 1e-3, torch.from_numpy(tfar))
    jargs = (_jv3(o), _jv3(d), 1e-3, jnp.asarray(tfar))
    if walk == "packed":
        hit, gn = ttrs.intersect_bvh_packed(static, tg, *args)
        jhit, jgn = jtrs.intersect_bvh_packed(static, jg, *jargs)
    else:
        assert (tg.bvh_nodes48 is None) == (walk == "per_lane_spheres")
        hit = ttrs.intersect_bvh_soa(static, tg, *args)
        jhit = jtrs.intersect_bvh_soa(static, jg, *jargs)
    occ = ttrs.occluded_bvh_soa(static, tg, *args)
    jocc = jtrs.occluded_bvh_soa(static, jg, *jargs)
    t, prim = hit.t.numpy(), hit.prim_id.numpy()
    n_tris = static.n_tris
    bt, bp, unique = _brute(_geo9(leaves), org, d, tnear=1e-3, n_tris=n_tris)
    bp = np.where(out, -1, bp)
    unique |= out
    hits = bp >= 0
    assert 0.05 < hits.mean() < 0.95
    sph = hits & (bp >= n_tris)
    np.testing.assert_array_equal(prim >= 0, hits)
    np.testing.assert_array_equal(t[hits & ~sph], bt[hits & ~sph])
    np.testing.assert_allclose(t[sph], bt[sph], rtol=3e-7)
    np.testing.assert_array_equal(t[~hits], tfar[~hits])  # a miss keeps tfar
    np.testing.assert_array_equal(prim[unique], bp[unique])
    np.testing.assert_allclose(t, np.asarray(jhit.t), rtol=1e-5)
    np.testing.assert_array_equal(prim[unique], np.asarray(jhit.prim_id)[unique])
    same = prim == np.asarray(jhit.prim_id)
    for a, b in ((hit.u, jhit.u), (hit.v, jhit.v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=1e-4, atol=1e-4)
    if walk == "packed":
        # e1 x e2 of the hit triangle, bit for bit as numpy's, within an
        # ulp of its largest component of the reference's (its multiply-
        # adds round a * b - c * d once); (0, 0, 1) on a miss.
        g9 = _geo9(leaves)[np.clip(prim, 0, None)]
        e1, e2 = g9[:, 3:6], g9[:, 6:9]
        want = [e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]]
        scale = np.abs(np.stack(want, 1)).max(1)
        for a, w, b in zip(gn, want, jgn):
            np.testing.assert_array_equal(a.numpy()[hits], w[hits])
            assert (np.abs(a.numpy() - np.asarray(b))[same & hits]
                    <= 2 ** -22 * scale[same & hits]).all()
        np.testing.assert_array_equal(np.stack([c.numpy() for c in gn], 1)[~hits],
                                      np.tile([0.0, 0.0, 1.0], (int((~hits).sum()), 1)))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(occ.numpy(), hits)


def test_filled_normal_shades_the_reference_vertex():
    """On the material box's BVH (nine spheres in it: the per-lane walk),
    intersect_soa_gn's filled normal shades the vertex the reference's
    shade_hit builds from gn_raw = None, lane for lane on every hit."""
    import jax
    import jax.numpy as jnp
    from gdpt_tpu.accel import traverse_soa as jtrs
    from gdpt_tpu.integrators import path_soa as jpath
    from gdpt_tpu_torch import convert

    from test_torch_materials_render import reference_box

    js = reference_box(True)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(js.device)]
    ts = convert.scene_from_numpy(leaves, dataclasses.asdict(js.static), device="cpu")
    jsc, tsc = jpath.scene_soa_from_aos(js), tpath.scene_soa_from_aos(ts, packet=False)
    assert tsc.geom.bvh_nodes48 is None and tsc.geom.bvh_first is not None
    rng = np.random.default_rng(12)
    org = rng.uniform([20, 20, 20], [530, 530, 540], (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    hit, gn = ttrs.intersect_soa_gn(ts.static, tsc.geom, _v3(org), _v3(d), 1e-3, BIG)
    prim = hit.prim_id.numpy()
    assert (prim >= ts.static.n_tris).mean() > 0.02 and ((prim >= 0) & (prim < 30)).any()
    # The reference walks the same BVH to the same closest hits.
    jhit = jtrs.intersect_bvh_soa(js.static, jsc.geom, _jv3(org), _jv3(d), 1e-3, BIG)
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(jhit.t), rtol=1e-5)
    same = hit.prim_id.numpy() == np.asarray(jhit.prim_id)
    assert same.mean() > 0.99
    np.testing.assert_array_equal(np.stack([c.numpy() for c in gn], 1)[prim < 0],
                                  np.tile([0.0, 0.0, 1.0], (int((prim < 0).sum()), 1)))
    # The port's hit shaded both ways.
    jh = jtrs.HitSoA(*(jnp.asarray(a.numpy()) for a in hit))
    tv = tpath.shade_hit(ts.static, tsc, _v3(org), _v3(d), hit, gn)
    jv = jpath.shade_hit(js.static, jsc, _jv3(org), _jv3(d), jh, None)
    valid = prim >= 0
    for name in tv._fields:
        ours, ref = _leaves(getattr(tv, name)), jax.tree_util.tree_leaves(getattr(jv, name))
        assert len(ours) == len(ref), name
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy()[valid], np.asarray(b)[valid], rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def _bvh_scene(kind):
    """A small BVH scene of the port: the force_bvh Cornell box (triangles
    only) or the material box with its nine spheres in the BVH."""
    if kind == "cbox":
        return tpresets.cornell_box(8, 8, spp=1, force_bvh=True, max_depth=2)
    from test_torch_materials_render import port_box

    return port_box(True, width=8, height=8)


@pytest.mark.parametrize("kind", ["cbox", "material"])
def test_views_build_only_what_their_route_reads(kind):
    scene = _bvh_scene(kind)
    walk = ("bvh_bmin", "bvh_bmax", "bvh_first", "bvh_count", "bvh_miss", "bvh_prim_order")
    g = tpath.scene_soa_from_aos(scene).geom
    assert g.packet is not None and g.sup16 is None and g.bvh_nodes48 is None
    assert all(getattr(g, f) is None for f in walk)
    g = tpath.scene_soa_from_aos(scene, packet=False).geom
    assert g.packet is None and g.sup16 is None
    assert (g.bvh_nodes48 is not None) == (kind == "cbox")
    assert all(getattr(g, f) is not None for f in walk)
    g = tpath.scene_soa_from_aos(scene, max_table_mb=0).geom
    assert g.packet is None and g.sup16 is not None and g.bvh_nodes48 is None
    assert g.sup16.table.dtype == torch.int32
    g = tpath.scene_soa_from_aos(scene, max_table_mb=1024).geom
    assert g.packet is not None and g.sup16 is None


def test_memo_keeps_a_view_per_switch():
    scene = _bvh_scene("cbox")
    views = [tpath.scene_soa_from_aos(scene, **kw) for kw in (
        {}, dict(packet=False), dict(max_table_mb=0), dict(max_table_mb=1024))]
    assert len({id(v) for v in views}) == 4
    assert tpath.scene_soa_from_aos(scene, packet=False) is views[1]
    assert tpath.scene_soa_from_aos(scene, max_table_mb=0) is views[2]


@pytest.mark.parametrize("switch", [dict(two_phase=True), dict(packet_sort=False),
                                    dict(packet_wide=16, packet_dual=True),
                                    dict(pool_sort=True)])
@pytest.mark.parametrize("route", [dict(packet=False), dict(max_table_mb=0)])
@pytest.mark.parametrize("integrator", ["path", "gradpath"])
def test_table_switches_raise_without_a_table(integrator, route, switch):
    scene = tpresets.cornell_box(4, 4, spp=1, force_bvh=True, max_depth=2,
                                 integrator=integrator)
    with pytest.raises(ValueError, match="packet table"):
        trender.render(scene, device="cpu", **route, **switch)


def test_table_switches_leave_a_brute_force_scene_alone():
    """A brute-force scene has no table on any route; its casts ignore the
    table's switches as before."""
    scene = tpresets.cornell_box(4, 4, spp=1, max_depth=2)
    ref = trender.render(scene, device="cpu", seed=1)
    got = trender.render(scene, device="cpu", seed=1, packet=False, two_phase=True,
                         pool_sort=True)
    np.testing.assert_array_equal(got, ref)


def test_geom_soa_raises_for_switches_without_a_table():
    leaves = _cbox_geom()[0]
    geom = ttr.Geometry(*(torch.from_numpy(a) for a in leaves))
    with pytest.raises(ValueError, match="two_phase"):
        ttrs.geom_soa_from_aos(geom, two_phase=True, packet=False)
    with pytest.raises(ValueError, match="packet_dual"):
        ttrs.geom_soa_from_aos(geom, wide=16, dual=True, max_table_mb=0)
    assert ttrs.geom_soa_from_aos(geom, two_phase=True).two_phase


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("walk", ["packed", "per_lane"])
def test_cuda_walks_match_cpu_and_k3(walk):
    """The packed and per-lane walks on the card equal themselves on the
    CPU bit for bit (t, prim, u, v, the normal, the steps; sphere t within
    2 ulp), and K3 over a packet table of the same BVH: t of triangle hits
    bit for bit, prim where t is unique, the any-hit masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import packet_trace as tpt

    leaves, org, d = _sphere_geom() if walk == "per_lane" else _cbox_geom()
    o, tfar, _ = _rays_with_dead(org, d)
    n_tris, n = leaves[0].shape[0], org.shape[0]
    out = {}
    for dev in ("cpu", "cuda"):
        geom = ttr.Geometry(*(torch.from_numpy(a).to(dev) for a in leaves))
        g = ttrs.geom_soa_from_aos(geom, packet=False)
        static = SimpleNamespace(n_tris=n_tris, n_spheres=leaves[4].shape[0],
                                 use_brute_force=False)
        args = (V3(*(c.to(dev) for c in _v3(o))), V3(*(c.to(dev) for c in _v3(d))), 1e-3,
                torch.from_numpy(tfar).to(dev))
        if walk == "packed":
            hit, gn, steps = ttrs.intersect_bvh_packed(static, g, *args, count_steps=True)
        else:
            hit, steps = ttrs.intersect_bvh_soa(static, g, *args, count_steps=True)
            gn = ttrs._hit_normal(static, g, args[0], args[1], hit)
        out[dev] = (hit, gn, steps, ttrs.occluded_bvh_soa(static, g, *args), args)
    (a, agn, asteps, aocc, _), (b, bgn, bsteps, bocc, args) = out["cpu"], out["cuda"]
    sph = a.prim_id >= n_tris
    assert torch.equal(b.prim_id.cpu(), a.prim_id) and torch.equal(bsteps.cpu(), asteps)
    assert torch.equal(b.t.cpu()[~sph], a.t[~sph])
    torch.testing.assert_close(b.t.cpu()[sph], a.t[sph], rtol=3e-7, atol=0)
    for x, y in ((b.u, a.u), (b.v, a.v), *zip(bgn, agn)):
        torch.testing.assert_close(x.cpu()[~sph], y[~sph], rtol=0, atol=0)
    assert torch.equal(bocc.cpu(), aocc)
    arrs = [leaves[k] for k in (7, 8, 9, 10, 11, 12, 0, 1, 2, 4, 5)]
    tab = tpt.packet_table_to(tpt.build_packet_table(*arrs, wide=32), "cuda")
    rays = (*args[0], *args[1], torch.full((n,), 1e-3, device="cuda"), args[3])
    nt = n_tris if leaves[4].shape[0] else None
    kt, kprim = pk.trace_packets(tab, *rays, n_tris=nt)
    unique = torch.from_numpy(_brute(_geo9(leaves), org, d, tnear=1e-3, n_tris=n_tris)[2])
    hit = kprim >= 0
    assert torch.equal(hit, b.prim_id >= 0)
    tri = hit & (kprim < n_tris)
    assert torch.equal(kt[tri], b.t[tri])
    assert torch.equal(kprim[unique.cuda() & hit], b.prim_id[unique.cuda() & hit])
    assert torch.equal(pk.trace_packets(tab, *rays, n_tris=nt, any_hit=True)[1] >= 0, bocc)
