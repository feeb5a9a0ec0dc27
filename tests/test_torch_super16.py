"""The port's super16 table and walk (accel/super16.py) against gdpt_tpu's.

Table: build_super16 is held element for element equal to the
reference's on the same BVH arrays (tests/test_super16.py's 3,000-
triangle soup, its 40 spheres, a cap that forces the adapted leaf size,
leaf_skip_from), with the same leaf size L and stack depth.

Walk: intersect_super16, occluded_super16 and traversal_steps against
the reference's jitted calls on the same rays. Tolerances: t of a
triangle hit bit-equal to numpy brute force (the same operation order,
no fused multiply-add on either side), of a sphere hit to 2 ulp (torch's
CPU sqrt is not correctly rounded); t within rtol 1e-5 of the reference,
whose XLA CPU code fuses multiply-adds; prim equal wherever the closest
t is unique (ties may flip with the visit order); any-hit masks and the
steps of every lane equal. Both sides also run with _UNROLL = 1.

The gpu-marked tests hold the walk on the card against itself on the
CPU and against K3 on the same rays; they import jax nowhere:
    python -m pytest --noconftest -m gpu tests/test_torch_super16.py
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.accel import bvh as tbvh
from gdpt_tpu_torch.accel import super16 as ts16
from gdpt_tpu_torch.core.soa import V3

from test_torch_packet import _brute, _rays, _soup, one_thread  # noqa: F401

_CASES = {}


def _case(name):
    """(build_super16 positional args, keyword args, n_tris argument of the
    walk, the rows of every primitive as geo9) of a named case."""
    if name not in _CASES:
        rng = np.random.default_rng(3)
        if name == "spheres":
            v0, v1, v2 = _soup(500, seed=3)
            sc, sr = rng.uniform(-10, 10, (40, 3)), rng.uniform(0.3, 1.2, 40)
        elif name == "skip":
            v0, v1, v2 = _soup(600, seed=11)
            sc, sr = rng.uniform(-10, 10, (3, 3)), rng.uniform(0.3, 1.2, 3)
        else:
            v0, v1, v2 = _soup(3000 if name == "soup" else 2500, seed=0 if name == "soup" else 7)
            sc = sr = None
        e1, e2 = v1 - v0, v2 - v0
        sph = {} if sc is None else dict(sph_center=sc, sph_radius=sr)
        arr = tbvh.build_bvh(v0, v1, v2, builder="numpy", **sph)
        args = tuple(arr[:6]) + tuple(a.astype(np.float32) for a in (v0, e1, e2))
        kw = dict(sph)
        if name == "skip":
            kw["leaf_skip_from"] = 600
        n_tris = 500 if name == "spheres" else None
        geo9 = np.concatenate([v0, e1, e2], 1).astype(np.float32)
        if sc is not None:
            geo9 = np.concatenate([geo9, np.concatenate(
                [sc, sr[:, None], np.zeros((len(sr), 5))], 1).astype(np.float32)])
        _CASES[name] = (args, kw, n_tris, geo9)
    return _CASES[name]


def _cap(monkeypatch, name):
    """The adapted case: a supernode cap of 20 rows on both sides."""
    if name == "adapted":
        from gdpt_tpu.accel import super16 as js16

        monkeypatch.setattr(js16, "MAX_SUPER_ROWS", 20)
        monkeypatch.setattr(ts16, "MAX_SUPER_ROWS", 20)


def _tables(name, monkeypatch):
    from gdpt_tpu.accel import super16 as js16

    _cap(monkeypatch, name)
    args, kw, n_tris, geo9 = _case(name)
    return js16.build_super16(*args, **kw), ts16.build_super16(*args, **kw), n_tris, geo9


def _v3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _jv3(a):
    import jax.numpy as jnp
    from gdpt_tpu.core.soa import V3 as JV3

    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


CASES = ["soup", "spheres", "adapted", "skip"]


@pytest.mark.parametrize("name", CASES)
def test_table_equals_reference(name, monkeypatch):
    jsup, tsup, _, _ = _tables(name, monkeypatch)
    assert tsup is not None
    np.testing.assert_array_equal(tsup.table.numpy(), np.asarray(jsup.table))
    assert tsup.table.dtype == torch.int32
    assert (tsup.leaf, tsup.stack_n) == (jsup.leaf_dummy.shape[0], jsup.depth_dummy.shape[0])
    assert (tsup.leaf > 12) == (name == "adapted")


def test_table_refuses_spheres_it_is_not_given():
    args, _, _, _ = _case("spheres")
    assert ts16.build_super16(*args) is None


def _rays_for(name, geo9, n_tris):
    org, d = _rays(768 if name == "spheres" else 1024, seed=5)
    if n_tris is not None:  # aim half the rays at sphere centers
        c = geo9[n_tris:, 0:3][np.arange(384) % (geo9.shape[0] - n_tris)]
        d[:384] = c - org[:384]
        d[:384] /= np.linalg.norm(d[:384], axis=1, keepdims=True)
    return org, d


def _attribs(geo9, org, d, prim, t, n_tris):
    """u, v and the unnormalized normal of each ray's hit primitive in
    numpy f32, in the walk's operation order (e1 x e2 of a triangle,
    (org + d t) - center of a sphere)."""
    g = geo9[np.clip(prim, 0, None)]
    v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]

    def dot(a, b):
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

    def cross(a, b):
        return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)

    with np.errstate(all="ignore"):
        pvec = cross(d, e2)
        det = dot(e1, pvec)
        inv = np.where(det != 0, np.float32(1) / np.where(det != 0, det, np.float32(1)),
                       np.float32(0))
        tvec = org - v0
        u = dot(tvec, pvec) * inv
        v = dot(d, cross(tvec, e1)) * inv
        gn = cross(e1, e2)
        if n_tris is not None:
            sph = prim >= n_tris
            u, v = np.where(sph, 0, u), np.where(sph, 0, v)
            gn = np.where(sph[:, None], (org + d * t[:, None]) - v0, gn)
    return u, v, gn


# (case, _UNROLL on both sides): the reference's 2, and 1 on two cases.
WALKS = [(name, 2) for name in CASES] + [("soup", 1), ("spheres", 1)]


@pytest.mark.parametrize("name,unroll", WALKS)
def test_walk_matches_reference_and_brute_force(name, unroll, monkeypatch):
    import jax

    from gdpt_tpu.accel import super16 as js16

    monkeypatch.setattr(js16, "_UNROLL", unroll)
    monkeypatch.setattr(ts16, "_UNROLL", unroll)
    jsup, tsup, n_tris, geo9 = _tables(name, monkeypatch)
    org, d = _rays_for(name, geo9, n_tris)
    t, prim, u, v, gn = ts16.intersect_super16(tsup, _v3(org), _v3(d), 1e-4, 1e9, n_tris=n_tris)
    occ = ts16.occluded_super16(tsup, _v3(org), _v3(d), 1e-4, 1e9, n_tris=n_tris)
    steps = ts16.traversal_steps(tsup, _v3(org), _v3(d), 1e-4, 1e9, n_tris=n_tris)
    kw = dict(static_argnames=("n_tris",))
    jt, jprim, ju, jv, jgn = jax.jit(js16.intersect_super16, **kw)(
        jsup, _jv3(org), _jv3(d), 1e-4, 1e9, n_tris=n_tris)
    jocc = jax.jit(js16.occluded_super16, **kw)(jsup, _jv3(org), _jv3(d), 1e-4, 1e9,
                                               n_tris=n_tris)
    jsteps = jax.jit(js16.traversal_steps, **kw)(jsup, _jv3(org), _jv3(d), 1e-4, 1e9,
                                                n_tris=n_tris)
    t, prim = t.numpy(), prim.numpy()
    # Against brute force over every primitive the leaves hold.
    rows = geo9[:600] if name == "skip" else geo9
    bt, bp, unique = _brute(rows, org, d, n_tris=n_tris)
    hit = bp >= 0
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(prim >= 0, hit)
    sph = bp >= (n_tris if n_tris is not None else 2 ** 31)
    np.testing.assert_array_equal(t[hit & ~sph], bt[hit & ~sph])
    np.testing.assert_allclose(t[sph], bt[sph], rtol=3e-7)
    np.testing.assert_array_equal(t[~hit], np.float32(1e9))
    np.testing.assert_array_equal(prim[unique], bp[unique])
    # u, v and the normal of the hit primitive: bit-equal to numpy but
    # for sphere normals, which take sphere t.
    au, av, agn = _attribs(rows, org, d, prim, t, n_tris)
    np.testing.assert_array_equal(u.numpy()[hit], au[hit])
    np.testing.assert_array_equal(v.numpy()[hit], av[hit])
    got_gn = np.stack([c.numpy() for c in gn], 1)
    np.testing.assert_array_equal(got_gn[hit & ~sph], agn[hit & ~sph])
    np.testing.assert_allclose(got_gn[sph], agn[sph], rtol=1e-5, atol=1e-5)
    # Against the reference's walk, t, u and v with its multiply-adds.
    np.testing.assert_allclose(t, np.asarray(jt), rtol=1e-5)
    np.testing.assert_array_equal(prim[unique], np.asarray(jprim)[unique])
    same = prim == np.asarray(jprim)
    for a, b in ((u, ju), (v, jv), *zip(gn, jgn)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=1e-4, atol=1e-4)
    miss_gn = np.stack([c.numpy()[~hit] for c in gn], 1)
    np.testing.assert_array_equal(miss_gn, np.tile([0.0, 0.0, 1.0], (int((~hit).sum()), 1)))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(occ.numpy(), hit)
    np.testing.assert_array_equal(steps.numpy(), np.asarray(jsteps))
    assert steps.dtype == torch.int32 and int(steps.max()) < 4 * tsup.table.shape[0] + 256


def test_any_hit_steps_and_per_ray_extents(monkeypatch):
    """Per-ray tnear and tfar, dead lanes (tfar < tnear) and any-hit steps,
    against the reference."""
    import jax
    import jax.numpy as jnp

    from gdpt_tpu.accel import super16 as js16

    jsup, tsup, _, _ = _tables("soup", monkeypatch)
    org, d = _rays(640, seed=9)
    rng = np.random.default_rng(4)
    tn = rng.uniform(0, 2, 640).astype(np.float32)
    tf = rng.uniform(-1, 30, 640).astype(np.float32)
    got = ts16.traversal_steps(tsup, _v3(org), _v3(d), torch.from_numpy(tn),
                               torch.from_numpy(tf), any_hit=True)
    ref = jax.jit(js16.traversal_steps, static_argnames=("n_tris", "any_hit"))(
        jsup, _jv3(org), _jv3(d), jnp.asarray(tn), jnp.asarray(tf), any_hit=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    occ = ts16.occluded_super16(tsup, _v3(org), _v3(d), torch.from_numpy(tn),
                                torch.from_numpy(tf))
    jocc = jax.jit(js16.occluded_super16)(jsup, _jv3(org), _jv3(d), jnp.asarray(tn),
                                          jnp.asarray(tf))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert not occ.numpy()[tf < tn].any()


def test_ceiling_raises_on_a_cyclic_table(monkeypatch):
    """A supernode whose child is itself never finishes: the walk stops at
    4 * rows + 256 iterations and raises, where a sane scene never gets
    near the ceiling (test_walk_matches_reference_and_brute_force)."""
    _, tsup, _, _ = _tables("soup", monkeypatch)
    table = tsup.table.clone()
    table[0, 96] = 0  # the root's first child is the root
    table[0, :6] = torch.tensor([-1e9, -1e9, -1e9, 1e9, 1e9, 1e9]).view(torch.int32)
    cyclic = tsup._replace(table=table)
    org, d = _rays(64, seed=1)
    with pytest.raises(RuntimeError, match="ceiling"):
        ts16.intersect_super16(cyclic, _v3(org), _v3(d), 1e-4, 1e9)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["soup", "spheres"])
def test_cuda_walk_matches_cpu_and_k3(name, monkeypatch):
    """The walk on the card equals itself on the CPU (t, prim, u, v, the
    normal and the steps bit for bit, but for sphere t within 2 ulp: the
    CPU's sqrt is not correctly rounded), and K3 on a packet table of the
    same BVH: t of triangle hits bit for bit, prim where t is unique, the
    any-hit masks equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import packet_trace as tpt

    args, kw, n_tris, geo9 = _case(name)
    sup = ts16.build_super16(*args, **kw)
    org, d = _rays_for(name, geo9, n_tris)
    cpu = ts16.intersect_super16(sup, _v3(org), _v3(d), 1e-4, 1e9, n_tris=n_tris)
    sup_c = ts16.super16_to(sup, "cuda")
    oc, dc = (V3(*(c.cuda() for c in _v3(a))) for a in (org, d))
    got = ts16.intersect_super16(sup_c, oc, dc, 1e-4, 1e9, n_tris=n_tris)
    sph = cpu[1] >= (n_tris if n_tris is not None else 2 ** 31)
    assert torch.equal(got[1].cpu(), cpu[1])
    assert torch.equal(got[0].cpu()[~sph], cpu[0][~sph])
    torch.testing.assert_close(got[0].cpu()[sph], cpu[0][sph], rtol=3e-7, atol=0)
    assert torch.equal(ts16.traversal_steps(sup_c, oc, dc, 1e-4, 1e9, n_tris=n_tris).cpu(),
                       ts16.traversal_steps(sup, _v3(org), _v3(d), 1e-4, 1e9, n_tris=n_tris))
    tab = tpt.packet_table_to(tpt.build_packet_table(*args, **kw), "cuda")
    n = org.shape[0]
    rays = (*oc, *dc, torch.full((n,), 1e-4, device="cuda"), torch.full((n,), 1e9, device="cuda"))
    kt, kprim = pk.trace_packets(tab, *rays, n_tris=n_tris)
    _, _, unique = _brute(geo9, org, d, n_tris=n_tris)
    unique = torch.from_numpy(unique).cuda()
    hit = kprim >= 0
    assert torch.equal(hit, got[1] >= 0)
    tri = hit & (kprim < (n_tris if n_tris is not None else 2 ** 31))
    assert torch.equal(kt[tri], got[0][tri])
    assert torch.equal(kprim[unique], got[1][unique])
    occ = ts16.occluded_super16(sup_c, oc, dc, 1e-4, 1e9, n_tris=n_tris)
    assert torch.equal(occ, pk.trace_packets(tab, *rays, n_tris=n_tris, any_hit=True)[1] >= 0)
