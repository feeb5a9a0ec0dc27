"""The port's packet table and BVH walk (K3) against gdpt_tpu's.

Table: gdpt_tpu_torch.accel.packet_trace.build_packet_table is held
bit-identical to gdpt_tpu.accel.packet_trace.build_packet_table on the
same BVH arrays (numpy soups, seeded), for both widths and every option.

Walk: the plain PyTorch version of K3 (what the wrapper runs for CPU
tensors) is held against the Pallas kernel in interpret mode on the very
same table (carried across by convert.packet_table_from_numpy) and
against brute force in numpy. Tolerances: t of a triangle hit equal to
numpy brute force bit for bit (same operation order, no fused
multiply-add on either side), of a sphere hit to 2 ulp (torch's CPU
sqrt is not correctly rounded); t within rtol 1e-5 of the Pallas kernel, whose XLA CPU code may
fuse a multiply-add and then differs by an ulp; prim equal wherever the
closest t is unique (ties may flip with the visit order, ROADMAP.md C);
any-hit masks equal.

The gpu-marked tests hold the CUDA kernel against its plain version on
the card. They import jax nowhere:
    python -m pytest --noconftest -m gpu tests/test_torch_packet.py
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch import convert
from gdpt_tpu_torch.accel import bvh as tbvh
from gdpt_tpu_torch.accel import packet_kernels as pk
from gdpt_tpu_torch.accel import packet_trace as tpt
from gdpt_tpu_torch.core.soa import V3

EMPTY = np.int32(2 ** 31 - 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests work on small tensors: one torch thread per test
    process is faster than many processes contending for every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _soup(nt, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(nt, 3))
    return tuple(centers + rng.normal(0, 0.3, (nt, 3)) for _ in range(3))


def _rays(nr, seed=1):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-15, 15, (nr, 3)).astype(np.float32)
    d = rng.uniform(-10, 10, (nr, 3)).astype(np.float32) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _brute(geo9, org, d, tnear=1e-4, n_tris=None):
    """Closest (t, prim) of every ray over the rows of geo9 in numpy f32,
    in the walk's operation order; spheres (rows >= n_tris) by their
    roots. A miss gives (inf, -1). Third: whether no other row ties."""
    g = geo9[None].astype(np.float32)
    o, dd = org[:, None, :], d[:, None, :]
    v0, e1, e2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]

    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    def cross(a, b):
        return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                         a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)

    with np.errstate(all="ignore"):
        pvec = cross(dd, e2)
        det = dot(e1, pvec)
        inv = np.where(det != 0, np.float32(1) / np.where(det != 0, det, np.float32(1)),
                       np.float32(0))
        tvec = o - v0
        uu = dot(tvec, pvec) * inv
        qvec = cross(tvec, e1)
        vv = dot(dd, qvec) * inv
        tt = dot(e2, qvec) * inv
        hit = (det != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt >= np.float32(tnear))
        if n_tris is not None:
            r = e1[..., 0]
            a2 = dot(dd, dd)
            inv_a = np.float32(1) / np.where(a2 != 0, a2, np.float32(1))
            tm = -dot(dd, tvec) * inv_a
            m = tvec + dd * tm[..., None]
            disc = r * r - dot(m, m)
            dtq = np.sqrt(np.maximum(disc, np.float32(0)) * inv_a)
            s0, s1 = tm - dtq, tm + dtq
            lo, hi = s0 >= np.float32(tnear), s1 >= np.float32(tnear)
            is_sph = (np.arange(geo9.shape[0]) >= n_tris)[None]
            tt = np.where(is_sph, np.where(lo, s0, s1), tt)
            hit = np.where(is_sph, (disc >= 0) & (a2 != 0) & (lo | hi), hit)
    tt = np.where(hit, tt, np.float32(np.inf))
    i = np.argmin(tt, 1)
    t = tt[np.arange(org.shape[0]), i]
    unique = ((tt == t[:, None]).sum(1) <= 1) | ~np.isfinite(t)
    return t, np.where(np.isfinite(t), i, -1), unique


def _arrays(v0, v1, v2, **bvh_kw):
    e1, e2 = v1 - v0, v2 - v0
    arr = tbvh.build_bvh(v0, v1, v2, builder="numpy", **bvh_kw)
    return arr[:6] + tuple(a.astype(np.float32) for a in (v0, e1, e2))


def _reference_table(args, **kw):
    from gdpt_tpu.accel import packet_trace as jpt

    wide = kw.pop("wide", 32)
    return jpt.build_packet_table(*args, wide=wide == 32, **kw)


def _carry(jtab):
    """The reference's table as the port's, leaf for leaf."""
    return convert.packet_table_from_numpy(
        *(np.asarray(a) for a in (jtab.table, jtab.bbox, jtab.geo9, jtab.entry_ref,
                                  jtab.entry_bbox)),
        stack_n=jtab.stack_dummy.shape[0], width=32 if jtab.wide_dummy is not None else 16,
        device="cpu")


def _table_case(case, wide):
    """(positional args, keyword args) of build_packet_table for a case."""
    rng = np.random.default_rng(17)
    sc = rng.uniform(-8, 8, (11, 3)).astype(np.float32)
    sr = rng.uniform(0.3, 1.2, 11).astype(np.float32)
    if case == "triangles":
        return _arrays(*_soup(900, seed=5)), dict(wide=wide)
    if case == "spheres_in_table":
        args = _arrays(*_soup(200, seed=3), sph_center=sc, sph_radius=sr)
        return args, dict(sph_center=sc, sph_radius=sr, wide=wide)
    if case == "leaf_skip_from":
        args = _arrays(*_soup(220, seed=11), sph_center=sc[:3], sph_radius=sr[:3])
        return args, dict(sph_center=sc[:3], sph_radius=sr[:3], leaf_skip_from=220, wide=wide)
    if case == "single_leaf":
        return _arrays(*_soup(3, seed=2)), dict(wide=wide)
    v0, v1, v2 = _soup(400, seed=13)
    rp, rbmin, rbmax = tbvh.presplit_refs(v0, v1, v2, budget_factor=1.0)
    arr = tbvh.build_bvh_over_refs(rbmin, rbmax, builder="numpy")
    args = arr[:6] + tuple(a.astype(np.float32) for a in (v0, v1 - v0, v2 - v0))
    return args, dict(prim_of_ref=rp, ref_bbox_min=rbmin, ref_bbox_max=rbmax, wide=wide)


CASES = ["triangles", "spheres_in_table", "leaf_skip_from", "presplit", "single_leaf"]


@pytest.mark.parametrize("wide", [16, 32])
@pytest.mark.parametrize("case", CASES)
def test_table_bit_identical_to_reference(case, wide):
    args, kw = _table_case(case, wide)
    got = tpt.build_packet_table(*args, **kw)
    ref = _reference_table(args, **kw)
    assert got.width == wide == (32 if ref.wide_dummy is not None else 16)
    assert got.stack_n == ref.stack_dummy.shape[0]
    for name in ("table", "bbox", "geo9", "entry_ref", "entry_bbox"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    carried = _carry(ref)
    assert carried.width == got.width and carried.stack_n == got.stack_n
    assert torch.equal(carried.table, got.table)


def _walk_table(tab):
    """Leaf groups reachable from the root, reading the width from the
    table: [(box row, slot, first leaf row)], and the supernode depth."""
    t = tab.table.numpy()
    n_kids, s_leaf = tab.width, tab.width // 16
    seen, stack, leaves, depth = set(), [(0, 1)], [], 0
    while stack:
        r, dep = stack.pop()
        if r in seen:
            continue
        seen.add(r)
        depth = max(depth, dep)
        mask = int(np.uint32(t[r, 120]))
        assert 0 <= t[r, 121] <= 2
        for k in range(n_kids):
            br = r + (k >> 4)
            ref = int(t[br, 96 + (k & 15)])
            if not (mask >> k) & 1:
                assert ref == EMPTY
                continue
            if ref >= 0:
                stack.append((ref, dep + 1))
            else:
                inv = int(np.uint32(~np.int32(ref)))
                assert inv >> tpt._CHAIN_SHIFT == s_leaf
                leaves.append((br, k & 15, inv & ((1 << tpt._CHAIN_SHIFT) - 1)))
    return leaves, depth


@pytest.mark.parametrize("wide", [16, 32])
@pytest.mark.parametrize("case", ["triangles", "spheres_in_table"])
def test_table_structure(case, wide):
    """Every primitive sits in exactly one reachable leaf group, groups
    respect the leaf cap, each child box holds its group's primitives
    (spheres as center +- r on all axes), and stack_n bounds the depth."""
    args, kw = _table_case(case, wide)
    tab = tpt.build_packet_table(*args, **kw)
    t = tab.table.numpy()
    geo9 = tab.geo9.numpy()
    n_tris = args[6].shape[0]
    leaves, depth = _walk_table(tab)
    s_leaf = wide // 16
    assert tab.stack_n == max(64, wide * (depth + 1))
    prims = []
    for br, slot, lr in leaves:
        ids = np.concatenate([t[lr + r, 108:120] for r in range(s_leaf)])
        ids = ids[ids >= 0]
        assert 0 < ids.shape[0] <= tpt.LEAF_TRIS * s_leaf
        prims.extend(ids.tolist())
        blo = t[br, slot * 6: slot * 6 + 3].view(np.float32)
        bhi = t[br, slot * 6 + 3: slot * 6 + 6].view(np.float32)
        for pid in ids:
            g = geo9[pid]
            if pid < n_tris:
                pts = np.stack([g[0:3], g[0:3] + g[3:6], g[0:3] + g[6:9]])
            else:
                pts = np.stack([g[0:3] - g[3], g[0:3] + g[3]])
            assert (pts.min(0) >= blo - 1e-4).all() and (pts.max(0) <= bhi + 1e-4).all()
    assert sorted(prims) == list(range(geo9.shape[0]))


@pytest.mark.parametrize("bad", ["width", "spheres_without_arrays", "empty"])
def test_table_builder_rejects_bad_arguments(bad):
    args, kw = _table_case("triangles", 32)
    if bad == "width":
        kw["wide"] = 8
    elif bad == "spheres_without_arrays":
        sc = np.zeros((1, 3), np.float32)
        args = _arrays(*_soup(50, seed=1), sph_center=sc, sph_radius=np.ones(1, np.float32))
    else:
        z3, zi = np.zeros((0, 3), np.float32), np.zeros(0, np.int32)
        args = (z3, z3, zi, zi, zi, zi) + args[6:]
    with pytest.raises(ValueError):
        tpt.build_packet_table(*args, **kw)


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


def _v3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _jv3(a):
    import jax.numpy as jnp
    from gdpt_tpu.core.soa import V3 as JV3

    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


_TABLES = {}


def _tables(case, wide):
    """(reference table, the same table carried to the port, geo9, n_tris
    argument of the walk), built once per case."""
    if (case, wide) not in _TABLES:
        args, kw = _table_case(case, wide)
        ref = _reference_table(args, **kw)
        n_tris = args[6].shape[0] if case == "spheres_in_table" else None
        _TABLES[case, wide] = (ref, _carry(ref), np.asarray(ref.geo9), n_tris)
    return _TABLES[case, wide]


def _assert_closest(t, prim, bt, bp, unique, n_tris=None):
    """Triangle hits bit-equal to numpy; sphere hits to 2 ulp, because
    torch's CPU sqrt is not correctly rounded (the card's is)."""
    miss = bp < 0
    sph = bp >= (n_tris if n_tris is not None else 2 ** 31)
    np.testing.assert_array_equal(prim[miss], -1)
    np.testing.assert_array_equal(t[~miss & ~sph], bt[~miss & ~sph])
    np.testing.assert_allclose(t[sph], bt[sph], rtol=3e-7)
    assert unique.mean() > 0.99
    np.testing.assert_array_equal(prim[unique], bp[unique])


@pytest.mark.parametrize("wide", [16, 32])
@pytest.mark.parametrize("case", ["triangles", "spheres_in_table", "presplit"])
def test_plain_walk_matches_pallas_and_brute_force(case, wide):
    from gdpt_tpu.accel import packet_trace as jpt

    jtab, tab, geo9, n_tris = _tables(case, wide)
    org, d = _rays(1024, seed=2)
    if case == "spheres_in_table":  # aim half the rays at sphere centers
        c = geo9[-11:, 0:3][np.arange(512) % 11]
        d[:512] = c - org[:512]
        d[:512] /= np.linalg.norm(d[:512], axis=1, keepdims=True)
    t, prim, u, v, gn = tpt.intersect_packet(tab, _v3(org), _v3(d), 1e-4, 1e9, n_tris=n_tris)
    bt, bp, unique = _brute(geo9, org, d, n_tris=n_tris)
    assert 0.05 < (bp >= 0).mean() < 1.0
    if n_tris is not None:
        assert (bp >= n_tris).mean() > 0.1  # spheres are hit
    _assert_closest(t.numpy(), prim.numpy(), bt, bp, unique, n_tris)
    assert (t.numpy()[bp < 0] == np.float32(1e9)).all()  # a miss returns tfar
    jt, jp, ju, jv, jgn = jpt.intersect_packet(jtab, _jv3(org), _jv3(d), 1e-4, 1e9,
                                               n_tris=n_tris, interpret=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5)
    np.testing.assert_array_equal(prim.numpy()[unique], np.asarray(jp)[unique])
    same = prim.numpy() == np.asarray(jp)
    for a, b in ((u, ju), (v, jv), (gn.x, jgn.x), (gn.y, jgn.y), (gn.z, jgn.z)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=1e-4, atol=1e-5)
    occ = tpt.occluded_packet(tab, _v3(org), _v3(d), 1e-4, 1e9, n_tris=n_tris)
    jocc = jpt.occluded_packet(jtab, _jv3(org), _jv3(d), 1e-4, 1e9, n_tris=n_tris,
                               interpret=True)
    assert occ.dtype == torch.bool
    np.testing.assert_array_equal(occ.numpy(), bp >= 0)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


@pytest.mark.parametrize("sort_rays", [True, False])
def test_dead_padding_nonfinite_lanes_and_per_ray_tfar(sort_rays):
    """777 rays (a ragged count), every third origin NaN, every fifth
    direction inf, every seventh lane dead, tfar per ray: poisoned and
    dead lanes come back as misses without disturbing live lanes."""
    from gdpt_tpu.accel import packet_trace as jpt

    jtab, tab, geo9, _ = _tables("triangles", 32)
    n = 777
    org, d = _rays(n, seed=6)
    bt, bp, unique = _brute(geo9, org, d)
    lane = np.arange(n)
    tfar = np.random.default_rng(8).uniform(2.0, 40.0, n).astype(np.float32)
    tfar[lane % 7 == 0] = -1.0
    orgb, db = org.copy(), d.copy()
    orgb[lane % 3 == 0] = np.nan
    db[lane % 5 == 0] = np.inf
    out = (lane % 3 == 0) | (lane % 5 == 0) | (lane % 7 == 0)
    t, prim, _, _, _ = tpt.intersect_packet(tab, _v3(orgb), _v3(db), 1e-4,
                                            torch.from_numpy(tfar), sort_rays=sort_rays)
    t, prim = t.numpy(), prim.numpy()
    hit = (bp >= 0) & (bt < tfar) & ~out
    assert hit.sum() > 15 and ((bp >= 0) & ~hit & ~out).sum() > 15
    assert (prim[~hit] == -1).all()
    np.testing.assert_array_equal(t[hit], bt[hit])
    np.testing.assert_array_equal(prim[hit & unique], bp[hit & unique])
    np.testing.assert_array_equal(t[~hit & ~out], tfar[~hit & ~out])
    occ = tpt.occluded_packet(tab, _v3(orgb), _v3(db), 1e-4, torch.from_numpy(tfar),
                              sort_rays=sort_rays).numpy()
    np.testing.assert_array_equal(occ, hit)
    import jax.numpy as jnp

    jt, jp, _, _, _ = jpt.intersect_packet(jtab, _jv3(orgb), _jv3(db), 1e-4,
                                           jnp.asarray(tfar), interpret=True,
                                           sort_rays=sort_rays)
    np.testing.assert_array_equal(np.asarray(jp) >= 0, hit)
    np.testing.assert_allclose(t, np.asarray(jt), rtol=1e-5)


@pytest.mark.parametrize("any_hit", [False, True])
def test_start_ref_other_than_root(any_hit):
    """A walk started at an entry subtree (the TPU kernel's rref) sees
    that subtree only, in the port as in the reference."""
    import jax.numpy as jnp
    from gdpt_tpu.accel import packet_trace as jpt

    jtab, tab, geo9, _ = _tables("triangles", 16)
    refs = tab.entry_ref.numpy()
    assert refs.shape[0] > 3 and refs[-1] == 0
    n = 1024
    org, d = _rays(n, seed=4)
    rays = [torch.from_numpy(np.ascontiguousarray(a[:, i])) for a in (org, d) for i in range(3)]
    tn, tf = torch.full((n,), 1e-4), torch.full((n,), 1e9)
    root = pk.trace_packets(tab, *rays, tn, tf, any_hit=any_hit)
    some_differ = False
    for ref in (refs[0], refs[len(refs) // 2]):  # a supernode or leaf-group ref
        rref = torch.full((n,), int(ref), dtype=torch.int32)
        t, prim = pk.trace_packets(tab, *rays, tn, tf, rref=rref, any_hit=any_hit)
        shape = lambda a: jnp.asarray(a.numpy().reshape(-1, 128))  # noqa: E731
        jt, jp = jpt._trace_packets(jtab, *map(shape, rays), shape(tn), shape(tf),
                                    shape(rref), any_hit=any_hit, interpret=True)
        jt, jp = np.asarray(jt).reshape(-1), np.asarray(jp).reshape(-1)
        np.testing.assert_array_equal(prim.numpy() >= 0, jp >= 0)
        if not any_hit:
            np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5)
            assert (prim.numpy() == jp).mean() > 0.99
            # A subtree's hit is no closer than the whole tree's.
            assert (t.numpy() >= root[0].numpy()).all()
        some_differ |= bool(((prim >= 0) != (root[1] >= 0)).any())
    assert some_differ  # the subtrees are proper subtrees


def test_visit_counts_and_stack_depth():
    """The counts output: a ray's stack never runs deeper than
    stack_n // width entries; a table whose stack_n understates its depth
    raises instead of dropping pushes."""
    _, tab, _, _ = _tables("triangles", 16)
    org, d = _rays(512, seed=3)
    rays = [torch.from_numpy(np.ascontiguousarray(a[:, i])) for a in (org, d) for i in range(3)]
    tn, tf = torch.full((512,), 1e-4), torch.full((512,), 1e9)
    t, prim, cnt = pk.trace_packets(tab, *rays, tn, tf, counts=True)
    t2, prim2 = pk.trace_packets(tab, *rays, tn, tf)
    assert torch.equal(t, t2) and torch.equal(prim, prim2)
    assert cnt.shape == (512, 4) and cnt.dtype == torch.int32
    depth = _walk_table(tab)[1]
    assert 1 < int(cnt[:, 3].max()) <= depth <= tab.stack_n // tab.width
    assert (cnt[:, 0] >= 1).all()                      # every live ray visits the root
    assert (cnt[:, 2] <= cnt[:, 1] * tpt.LEAF_TRIS).all()
    tf_dead = tf.clone()
    tf_dead[::2] = -1.0
    cnt_dead = pk.trace_packets(tab, *rays, tn, tf_dead, counts=True)[2]
    assert int(cnt_dead[::2].sum()) == 0               # dead lanes do no work
    shallow = tab._replace(stack_n=tab.width)          # one stack entry per ray
    with pytest.raises(RuntimeError, match="stack"):
        pk.trace_packets(shallow, *rays, tn, tf)
    # rows_read marks the table rows these rays' visits read: the root,
    # at most one row per visit of this 16-wide table, fewer for two rays.
    read, read_half = (torch.zeros(tab.table.shape[0], dtype=torch.bool) for _ in range(2))
    pk.trace_packets_plain(tab, *rays, tn, tf, rows_read=read)
    tf_few = torch.full_like(tf, -1.0)
    tf_few[:2] = 1e9
    pk.trace_packets_plain(tab, *rays, tn, tf_few, rows_read=read_half)
    assert bool(read[0]) and 1 < int(read.sum()) <= int(cnt[:, :2].sum())
    assert bool((read | ~read_half).all()) and int(read_half.sum()) < int(read.sum())
    # The iteration ceiling ends a walk early (here after the root visit).
    t3, prim3, cnt3 = pk.trace_packets_plain(tab, *rays, tn, tf, counts=True, ceiling=1)
    assert int(cnt3[:, :2].sum(1).max()) == 1 and (prim3 == -1).all()


def _tie_case(wide, spheres=False):
    """A leaf group built to stress the leaf reduction: T in z = 0 and its
    reversed twin (a ray from a point of T with tnear = 0 hits both at
    t = 0, one +0.0 and one -0.0), five coplanar copies of D in z = 5,
    E and its twin in z = 9; with `spheres` two equal in-table spheres
    below D's level. (positional args, keyword args, n_tris)."""
    corner = lambda x, y, z, s: [np.array(p, np.float32) for p in  # noqa: E731
                                 ((x, y, z), (x + s, y, z), (x, y + s, z))]
    t, d, e = corner(-4, -4, 0, 10), corner(-3, -3, 5, 8), corner(-2, -2, 9, 6)
    tris = [t, [t[0], t[2], t[1]]] + [d] * 5 + [e, [e[0], e[2], e[1]]]
    v0, v1, v2 = (np.stack([tri[k] for tri in tris]) for k in range(3))
    kw = dict(wide=wide)
    if spheres:
        kw.update(sph_center=np.array([[-1.0, -1.0, 6.2]] * 2, np.float32),
                  sph_radius=np.array([0.5, 0.5], np.float32))
    return _arrays(v0, v1, v2, **{k: v for k, v in kw.items() if k != "wide"}), kw, \
        (len(tris) if spheres else None)


def _tie_rays(seed=0):
    """Rays at the _tie_case leaf, 128 of them: 48 from z = 7 straight
    down onto the copies of D (tfar 1e9), 40 from points of T with
    tnear = 0 (up and down), 40 from z = 7 down with tfar = 3 (only the
    copies of D block them)."""
    rng = np.random.default_rng(seed)
    org = np.zeros((128, 3), np.float32)
    d = np.zeros((128, 3), np.float32)
    org[:, :2] = rng.uniform(-2.5, 0.5, (128, 2))
    org[:48, 2] = org[88:, 2] = 7.0
    org[48:88, :2] = rng.uniform(-3.5, -0.5, (40, 2))
    d[:, :2] = rng.uniform(-0.05, 0.05, (128, 2))
    d[:, 2] = -1.0
    d[48:88, 2] = np.where(np.arange(40) % 2 == 0, 1.0, -1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tnear = np.full(128, 1e-4, np.float32)
    tnear[48:88] = 0.0
    tfar = np.full(128, 1e9, np.float32)
    tfar[88:] = 3.0
    return [np.ascontiguousarray(a) for a in (*org.T, *d.T, tnear, tfar)]


@pytest.mark.parametrize("wide", [16, 32])
def test_leaf_tie_rules_match_pallas(wide):
    """The tie rules the kernel's group reduction must match, held on the
    plain walk against the Pallas kernel in interpret mode: closest hit
    takes the first slot among equal t, -0.0 and +0.0 included (the
    reference's sequential strict t < best scan); any hit takes the lowest
    blocking slot, with the valid slots up to it tested."""
    import jax.numpy as jnp
    from gdpt_tpu.accel import packet_trace as jpt

    args, kw, _ = _tie_case(wide)
    jtab = _reference_table(args, **kw)
    tab = _carry(jtab)
    (leaf,), _ = _walk_table(tab)
    ids = np.concatenate([tab.table.numpy()[leaf[2] + r, 108:120] for r in range(wide // 16)])
    np.testing.assert_array_equal(ids[ids >= 0], np.arange(9))   # slot s holds prim s
    rays = [torch.from_numpy(a) for a in _tie_rays()]
    # The two zero-distance hits from T's points have opposite signs.
    geo = tab.geo9[:2][None].expand(40, 2, 9)
    tz, hz = pk._prim_hits(geo, torch.tensor([[0, 1]] * 40),
                           tuple(c[48:88, None] for c in rays[:3]),
                           tuple(c[48:88, None] for c in rays[3:6]),
                           rays[6][48:88, None], rays[7][48:88, None], None)
    assert bool(hz.all()) and bool((tz == 0).all())
    assert bool((torch.signbit(tz[:, 0]) != torch.signbit(tz[:, 1])).all())
    # The Pallas walk takes whole packets (PACKET_ROWS x 128 lanes): the
    # 128 rays eight times over.
    shape = lambda a: jnp.asarray(np.tile(a.numpy(), 8).reshape(-1, 128))  # noqa: E731
    jrays = [shape(a) for a in (*rays, torch.zeros(128, dtype=torch.int32))]
    t, prim, cnt = pk.trace_packets_plain(tab, *rays, counts=True)
    jt, jp = (np.asarray(a).reshape(8, 128)[0]
              for a in jpt._trace_packets(jtab, *jrays, any_hit=False, interpret=True))
    want = np.r_[np.full(48, 2), np.zeros(40, int), np.full(40, 2)]
    np.testing.assert_array_equal(prim.numpy(), want)        # first copy of D; T, not its twin
    np.testing.assert_array_equal(jp, want)
    np.testing.assert_array_equal(t.numpy()[48:88], 0.0)
    assert torch.equal(torch.signbit(t[48:88]), torch.signbit(tz[:, 0]))  # T's own zero
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-6)
    np.testing.assert_array_equal(cnt[:, 2].numpy(), 9)      # every valid slot tested
    t, prim, cnt = pk.trace_packets_plain(tab, *rays, any_hit=True, counts=True)
    _, jp = jpt._trace_packets(jtab, *jrays, any_hit=True, interpret=True)
    np.testing.assert_array_equal(prim.numpy() >= 0, np.asarray(jp).reshape(8, 128)[0] >= 0)
    want = np.r_[np.zeros(88, int), np.full(40, 2)]          # T blocks first; else D's first copy
    np.testing.assert_array_equal(prim.numpy(), want)
    np.testing.assert_array_equal(cnt[:, 2].numpy(), want + 1)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    _, tab, _, _ = _tables("triangles", 32)
    org, d = _rays(256, seed=5)
    rays = [torch.from_numpy(np.ascontiguousarray(a[:, i])) for a in (org, d) for i in range(3)]
    tn, tf = torch.full((256,), 1e-4), torch.full((256,), 1e9)
    before = dict(pk.LAUNCHES)
    for any_hit in (False, True):
        a = pk.trace_packets(tab, *rays, tn, tf, any_hit=any_hit)
        b = pk.trace_packets_plain(tab, *rays, tn, tf, any_hit=any_hit)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert pk.LAUNCHES == before


@pytest.mark.parametrize("bad", ["float64", "strided", "rref_dtype", "table_dtype",
                                 "table_shape", "width", "stack_too_deep", "length"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, tab, _, _ = _tables("triangles", 32)
    org, d = _rays(256, seed=5)
    rays = [torch.from_numpy(np.ascontiguousarray(a[:, i])) for a in (org, d) for i in range(3)]
    rays += [torch.full((256,), 1e-4), torch.full((256,), 1e9)]
    rref = None
    if bad == "float64":
        rays[0] = rays[0].double()
    elif bad == "strided":
        rays[3] = torch.zeros(512)[::2]
    elif bad == "rref_dtype":
        rref = torch.zeros(256, dtype=torch.int64)
    elif bad == "table_dtype":
        tab = tab._replace(table=tab.table.float())
    elif bad == "table_shape":
        tab = tab._replace(table=tab.table[:, :64].contiguous())
    elif bad == "width":
        tab = tab._replace(width=24)
    elif bad == "stack_too_deep":
        tab = tab._replace(stack_n=32 * (pk.MAX_DEPTH + 1))
    else:
        rays[7] = rays[7][:100].contiguous()
    with pytest.raises(ValueError):
        pk.trace_packets(tab, *rays, rref=rref)


# ---------------------------------------------------------------------------
# traverse_soa dispatch on whole scenes
# ---------------------------------------------------------------------------


def _soup_scene(M, build, xf, n_spheres):
    """220 soup triangles plus n_spheres spheres under a camera at z = 40
    (the scenes of tests/test_packet.py), with one package's modules."""
    ntris = 220
    rng = np.random.RandomState(7)
    v0, v1, v2 = _soup(ntris, seed=7)
    mesh = M.TriangleMesh(
        positions=np.concatenate([v0, v1, v2]).astype(np.float32),
        indices=np.stack([np.arange(ntris), np.arange(ntris) + ntris,
                          np.arange(ntris) + 2 * ntris], -1).astype(np.int32),
        material_id=0)
    centers = rng.randn(n_spheres, 3).astype(np.float32) * 4
    centers[:, 2] = np.linspace(4.0, 26.0, n_spheres)
    spheres = [M.Sphere(center=centers[i], radius=0.8 + 0.1 * i, material_id=0)
               for i in range(n_spheres)]
    cam = M.Camera(xf.look_at([0, 0, 40], [0, 0, 0], [0, 1, 0]), 45.0, 16, 16)
    lights = [M.DiffuseAreaLight(shape_id=1, intensity=np.ones(3))]
    opts = M.RenderOptions(integrator="path", samples_per_pixel=1, max_depth=2)
    scene = build.build_scene(cam, [M.Lambertian(0.5)], [mesh] + spheres, lights, options=opts)
    nr = 768
    org = rng.randn(nr, 3).astype(np.float32) * 3
    org[:, 2] = 45.0
    d = -org + centers[rng.randint(0, n_spheres, nr)] + rng.randn(nr, 3).astype(np.float32) * 1.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return scene, org, d


@pytest.mark.parametrize("n_spheres", [3, 12])
def test_traverse_dispatch_matches_reference(n_spheres, monkeypatch):
    """3 spheres ride outside the table and are brute-merged; 12 ride in
    it (n_tris given to the walk). intersect_soa_gn and occluded_soa
    agree with the reference's packet dispatch and its brute force."""
    monkeypatch.setenv("GDPT_PACKET", "1")
    import jax.numpy as jnp
    from gdpt_tpu.accel import traverse_soa as jtrs
    from gdpt_tpu.core import transform as jxf
    from gdpt_tpu.integrators import path_soa as jps
    from gdpt_tpu.scene import build as jbuild
    from gdpt_tpu.scene import model as jM
    from gdpt_tpu_torch.accel import traverse_soa as ttrs
    from gdpt_tpu_torch.core import transform as txf
    from gdpt_tpu_torch.scene import build as tbuild
    from gdpt_tpu_torch.scene import model as tM

    js, org, d = _soup_scene(jM, jbuild, jxf, n_spheres)
    ts, _, _ = _soup_scene(tM, tbuild, txf, n_spheres)
    assert not ts.static.use_brute_force and ts.static.n_spheres == n_spheres
    jg = jps.scene_soa_from_aos(js).geom
    tg = ttrs.geom_soa_from_aos(ts.device.geom)
    assert jg.packet is not None and tg.packet.width == 32
    assert (ttrs._table_n_tris(ts.static) is None) == (n_spheres <= ttrs.SPH_BRUTE_MAX)
    hit, gn = ttrs.intersect_soa_gn(ts.static, tg, _v3(org), _v3(d), 1e-4, 1e9)
    jhit, jgn = jtrs.intersect_soa_gn(js.static, jg, _jv3(org), _jv3(d), 1e-4, 1e9)
    bhit = jtrs.intersect_brute_soa(js.static, jg, _jv3(org), _jv3(d), 1e-4,
                                    jnp.full(org.shape[0], 1e9))
    prim, bprim = hit.prim_id.numpy(), np.asarray(bhit.prim_id)
    np.testing.assert_array_equal(prim, bprim)
    np.testing.assert_array_equal(prim, np.asarray(jhit.prim_id))
    assert (bprim >= ts.static.n_tris).mean() > 0.1 and (bprim < 0).any()
    assert ((bprim >= 0) & (bprim < ts.static.n_tris)).any()
    for a, b in ((hit.t, jhit.t), (hit.u, jhit.u), (hit.v, jhit.v),
                 (gn.x, jgn.x), (gn.y, jgn.y), (gn.z, jgn.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(bhit.t), rtol=1e-4, atol=1e-5)
    tfar = np.where(np.arange(org.shape[0]) % 4 == 0, 30.0, 1e9).astype(np.float32)
    occ = ttrs.occluded_soa(ts.static, tg, _v3(org), _v3(d), 1e-4, torch.from_numpy(tfar))
    jocc = jtrs.occluded_soa(js.static, jg, _jv3(org), _jv3(d), 1e-4, jnp.asarray(tfar))
    assert occ.dtype == torch.float32
    np.testing.assert_array_equal(occ.numpy() > 0, np.asarray(jocc))
    np.testing.assert_array_equal(occ.numpy() > 0, (bprim >= 0) & (np.asarray(bhit.t) < tfar))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["closest", "any_hit"])
def test_cuda_kernel_matches_plain(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for case, wide in (("triangles", 32), ("spheres_in_table", 16)):
        args, kw = _table_case(case, wide)
        tab = tpt.packet_table_to(tpt.build_packet_table(*args, **kw), "cuda")
        n_tris = args[6].shape[0] if case == "spheres_in_table" else None
        n = 262_144 + 77  # ragged last block
        org, d = _rays(n, seed=5)
        rays = [torch.from_numpy(np.ascontiguousarray(a[:, i])).cuda()
                for a in (org, d) for i in range(3)]
        tn = torch.full((n,), 1e-4, device="cuda")
        tf = torch.from_numpy(np.random.default_rng(1).uniform(-1, 60, n).astype(np.float32)).cuda()
        key = "packet_occluded" if mode == "any_hit" else "packet_intersect"
        before = pk.LAUNCHES[key]
        got = pk.trace_packets(tab, *rays, tn, tf, n_tris=n_tris, any_hit=mode == "any_hit",
                               counts=True)
        ref = pk.trace_packets_plain(tab, *rays, tn, tf, n_tris=n_tris,
                                     any_hit=mode == "any_hit", counts=True)
        torch.cuda.synchronize()
        assert pk.LAUNCHES[key] == before + 1
        assert 0.05 < float((ref[1] >= 0).float().mean()) < 0.95
        for a, b in zip(got, ref):  # t, prim and the visit counts, bit for bit
            assert torch.equal(a, b)
    # Hand-built leaves that stress the group's reduction (_tie_case: equal
    # t in one leaf, hits at t = tnear = 0 of both signs, several blocking
    # slots, equal in-table spheres), on both widths: 0, 1, W + 1 and
    # 3W + 1 rays and all 128, from the root and from a leaf-group ref,
    # and a batch of dead rays.
    for wide in (16, 32):
        for spheres in (False, True):
            args, kw, n_tris = _tie_case(wide, spheres)
            tab = tpt.packet_table_to(tpt.build_packet_table(*args, **kw), "cuda")
            rays = [torch.from_numpy(a).cuda() for a in _tie_rays(seed=wide)]
            leaf_ref = int(tab.table[0, 96])
            assert leaf_ref < 0
            dead = rays[:7] + [torch.full_like(rays[7], -1.0)]
            for n in (0, 1, wide + 1, 3 * wide + 1, 128):
                for rref in (None, torch.full((n,), leaf_ref, dtype=torch.int32, device="cuda")):
                    for rr in (rays, dead):
                        cut = [c[:n].contiguous() for c in rr]
                        got = pk.trace_packets(tab, *cut, rref=rref, n_tris=n_tris,
                                               any_hit=mode == "any_hit", counts=True)
                        ref = pk.trace_packets_plain(tab, *cut, rref=rref, n_tris=n_tris,
                                                     any_hit=mode == "any_hit", counts=True)
                        torch.cuda.synchronize()
                        for a, b in zip(got, ref):
                            assert torch.equal(a, b), (wide, spheres, n, rref is None)
            if spheres:  # the two equal spheres are hit
                hit = pk.trace_packets_plain(tab, *rays, n_tris=n_tris)[1]
                assert bool((hit >= n_tris).any())


@pytest.mark.gpu
def test_cuda_kernel_reports_stack_overflow():
    """A table whose stack_n understates its depth: the kernel never drops
    a push silently. The overflowing rays' deepest count reads past the
    depth and the wrapper raises, as the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, kw = _table_case("triangles", 16)
    tab = tpt.packet_table_to(tpt.build_packet_table(*args, **kw), "cuda")
    org, d = _rays(4096, seed=3)
    rays = [torch.from_numpy(np.ascontiguousarray(a[:, i])).cuda()
            for a in (org, d) for i in range(3)]
    tn, tf = torch.full((4096,), 1e-4, device="cuda"), torch.full((4096,), 1e9, device="cuda")
    pk.trace_packets(tab, *rays, tn, tf, counts=True)   # deep enough: no error
    shallow = tab._replace(stack_n=tab.width)          # one stack entry per ray
    with pytest.raises(RuntimeError, match="stack"):
        pk.trace_packets(shallow, *rays, tn, tf, counts=True)
    pk.trace_packets(shallow, *rays, tn, tf)
    with pytest.raises(RuntimeError, match="stack"):
        pk.check_overflow()
    pk.check_overflow()                                 # the flag was cleared
    with pytest.raises(RuntimeError, match="stack"):
        pk.trace_packets_plain(shallow, *rays, tn, tf)
