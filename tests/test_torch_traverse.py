"""The port's per-ray casts (accel/traverse.py) against gdpt_tpu's.

The reference writes each query for one ray and vmaps it; the port's
are lane-batched, the BVH walks masked loops. On tests/test_accel.py's
geometry and rays (700 soup triangles and 9 spheres, one BVH from the
port's numpy builder, the reference's algorithm, given to both): intersect_bvh, occluded_bvh,
intersect_brute and occluded_brute against the reference's vmapped
calls; the single-triangle and sphere-root cases; sphere_uv.
Tolerances: t within rtol 1e-5 of the reference (its XLA CPU code fuses
multiply-adds), and of a triangle hit bit-equal to numpy brute force,
of a sphere hit to 2 ulp (torch's CPU sqrt is not correctly rounded);
prim equal where the closest t is unique; any-hit masks equal.

The per-ray walks are the oracle of the port's casts: K1's and K3's
plain versions on the same rays give the walk's t (bit for bit on
triangles) and prim where t is unique.

The gpu-marked tests hold the walks on the card against themselves on
the CPU and against K1 and K3 there; they import jax nowhere:
    python -m pytest --noconftest -m gpu tests/test_torch_traverse.py
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.accel import bvh as tbvh
from gdpt_tpu_torch.accel import traverse as ttr

from test_torch_packet import _brute, one_thread  # noqa: F401

BIG = 1e30
_CACHE = {}


def _soup(n, seed=0, spread=10.0):
    rng = np.random.RandomState(seed)
    base = rng.randn(n, 3) * spread
    return base, base + rng.randn(n, 3), base + rng.randn(n, 3)


def _arrays(v0, v1, v2, centers=None, radii=None):
    """(v0, e1, e2, centers, radii, BVH arrays) in f32/int32, the BVH from
    the port's numpy builder (the reference's algorithm) over all of them."""
    centers = np.zeros((0, 3)) if centers is None else np.asarray(centers)
    radii = np.zeros((0,)) if radii is None else np.asarray(radii)
    b = tbvh.build_bvh(v0, v1, v2, centers if len(centers) else None,
                       radii if len(radii) else None, builder="numpy")
    f32 = [np.asarray(a, np.float32) for a in (v0, v1 - v0, v2 - v0, centers, radii)]
    return f32 + [np.asarray(b.bbox_min, np.float32), np.asarray(b.bbox_max, np.float32)] + [
        np.asarray(a, np.int32) for a in (b.first, b.count, b.miss, b.prim_order)]


def _port_geom(arrs, device="cpu"):
    v0, e1, e2, c, r, *bvh = (torch.from_numpy(a).to(device) for a in arrs)
    z = torch.zeros(v0.shape[0], dtype=torch.int32, device=device)
    return ttr.Geometry(v0, e1, e2, z, c, r, torch.zeros(c.shape[0], dtype=torch.int32,
                                                         device=device), *bvh)


def _ref_geom(arrs):
    import jax.numpy as jnp
    from gdpt_tpu.accel import traverse as jtr

    v0, e1, e2, c, r, *bvh = (jnp.asarray(a) for a in arrs)
    return jtr.Geometry(v0, e1, e2, jnp.zeros(v0.shape[0], jnp.int32), c, r,
                        jnp.zeros(c.shape[0], jnp.int32), *bvh)


def _scene():
    """test_accel.py's geometry and rays (test_bvh_matches_brute_force)."""
    if "scene" not in _CACHE:
        v0, v1, v2 = _soup(700, seed=1)
        centers = np.random.RandomState(2).randn(9, 3) * 8
        radii = np.abs(np.random.RandomState(3).randn(9)) + 0.5
        rng = np.random.RandomState(4)
        org = (rng.randn(2000, 3) * 15).astype(np.float32)
        d = rng.randn(2000, 3)
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        _CACHE["scene"] = (_arrays(v0, v1, v2, centers, radii), org, d)
    return _CACHE["scene"]


def _small():
    """At most 128 primitives for K1: 100 soup triangles and 8 spheres."""
    if "small" not in _CACHE:
        v0, v1, v2 = _soup(100, seed=5, spread=6.0)
        rng = np.random.RandomState(6)
        centers, radii = rng.randn(8, 3) * 6, np.abs(rng.randn(8)) + 0.5
        org = (rng.randn(1024, 3) * 15).astype(np.float32)
        d = v0[rng.randint(0, 100, 1024)] + rng.randn(1024, 3) * 3 - org
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        _CACHE["small"] = (_arrays(v0, v1, v2, centers, radii), org, d)
    return _CACHE["small"]


def _soups(arrs, device="cpu"):
    """K1's (9, T) and (4, S) soups."""
    tri = np.concatenate([arrs[0], arrs[1], arrs[2]], 1).T.copy()
    sph = np.concatenate([arrs[3], arrs[4][:, None]], 1).T.copy()
    return torch.from_numpy(tri).to(device), torch.from_numpy(sph).to(device)


def _geo9(arrs):
    v0, e1, e2, c, r = arrs[:5]
    sph = np.concatenate([c, r[:, None], np.zeros((len(r), 5), np.float32)], 1)
    return np.concatenate([np.concatenate([v0, e1, e2], 1), sph]).astype(np.float32)


def _reference(fn_name, arrs, org, d, tnear, tfar):
    """The reference's per-ray `fn_name`, vmapped over the rays (and over
    tfar when it is an array) and jitted."""
    import jax
    import jax.numpy as jnp
    from gdpt_tpu.accel import traverse as jtr

    geom = _ref_geom(arrs)
    fn = getattr(jtr, fn_name)
    tf = jnp.broadcast_to(jnp.asarray(tfar, jnp.float32), (org.shape[0],))
    return jax.jit(jax.vmap(lambda o, dd, f: fn(geom, o, dd, tnear, f)))(
        jnp.asarray(org), jnp.asarray(d), tf)


def _assert_closest(t, prim, ref_t, ref_prim, arrs, org, d, tnear):
    n_tris = arrs[0].shape[0]
    bt, bp, unique = _brute(_geo9(arrs), org, d, tnear=tnear, n_tris=n_tris)
    hit = bp >= 0
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(prim >= 0, hit)
    sph = bp >= n_tris
    np.testing.assert_array_equal(t[hit & ~sph], bt[hit & ~sph])
    np.testing.assert_allclose(t[sph], bt[sph], rtol=3e-7)
    np.testing.assert_array_equal(prim[unique], bp[unique])
    np.testing.assert_allclose(t, np.asarray(ref_t), rtol=1e-5)
    np.testing.assert_array_equal(prim[unique], np.asarray(ref_prim)[unique])


@pytest.mark.parametrize("walk", ["bvh", "brute"])
def test_intersect_matches_reference(walk):
    arrs, org, d = _scene()
    geom = _port_geom(arrs)
    fn = getattr(ttr, f"intersect_{walk}")
    hit = fn(geom, torch.from_numpy(org), torch.from_numpy(d), 1e-3, BIG)
    ref = _reference(f"intersect_{walk}", arrs, org, d, 1e-3, BIG)
    _assert_closest(hit.t.numpy(), hit.prim_id.numpy(), ref.t, ref.prim_id, arrs, org, d, 1e-3)
    same = hit.prim_id.numpy() == np.asarray(ref.prim_id)
    for a, b in ((hit.u, ref.u), (hit.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=1e-4, atol=1e-4)
    miss = hit.prim_id.numpy() < 0
    np.testing.assert_array_equal(hit.t.numpy()[miss], np.float32(BIG))


@pytest.mark.parametrize("walk", ["bvh", "brute"])
def test_occluded_matches_reference(walk):
    arrs, org, d = _scene()
    geom = _port_geom(arrs)
    tfar = np.random.default_rng(6).uniform(-1.0, 40.0, org.shape[0]).astype(np.float32)
    occ = getattr(ttr, f"occluded_{walk}")(geom, torch.from_numpy(org), torch.from_numpy(d),
                                           1e-3, torch.from_numpy(tfar))
    ref = _reference(f"occluded_{walk}", arrs, org, d, 1e-3, tfar)
    assert occ.dtype == torch.bool and 0.05 < occ.float().mean() < 0.95
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
    # The any-hit walk agrees with the closest hit inside the window.
    hit = ttr.intersect_bvh(geom, torch.from_numpy(org), torch.from_numpy(d), 1e-3,
                            torch.from_numpy(tfar))
    np.testing.assert_array_equal(occ.numpy(), hit.prim_id.numpy() >= 0)


def test_single_triangle_hit_position():
    arrs = _arrays(np.array([[0.0, 0.0, 1.0]]), np.array([[1.0, 0.0, 1.0]]),
                   np.array([[0.0, 1.0, 1.0]]))
    geom = _port_geom(arrs)
    hit = ttr.intersect_bvh(geom, torch.tensor([[0.2, 0.3, 0.0]]),
                            torch.tensor([[0.0, 0.0, 1.0]]), 0.0, BIG)
    assert int(hit.prim_id[0]) == 0
    np.testing.assert_allclose(float(hit.t[0]), 1.0, atol=1e-6)
    np.testing.assert_allclose([float(hit.u[0]), float(hit.v[0])], [0.2, 0.3], atol=1e-6)


def test_sphere_roots():
    import jax.numpy as jnp
    from gdpt_tpu.accel import traverse as jtr

    z = np.zeros((0, 3))
    arrs = _arrays(z, z, z, centers=[[0.0, 0.0, 5.0]], radii=[1.0])
    geom, jgeom = _port_geom(arrs), _ref_geom(arrs)
    org = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 5.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    hit = ttr.intersect_brute(geom, torch.from_numpy(org), torch.from_numpy(d),
                              torch.tensor([0.0, 1e-4]), BIG)
    np.testing.assert_allclose(hit.t.numpy(), [4.0, 1.0], atol=1e-5)  # the far root inside
    for i, tn in enumerate((0.0, 1e-4)):
        ref = jtr.intersect_brute(jgeom, jnp.asarray(org[i]), jnp.asarray(d[i]), tn, BIG)
        assert float(ref.t) == float(hit.t[i]) and int(ref.prim_id) == int(hit.prim_id[i])


def test_sphere_uv_matches_reference():
    import jax.numpy as jnp
    from gdpt_tpu.accel import traverse as jtr

    rng = np.random.default_rng(8)
    c = rng.normal(size=(500, 3)).astype(np.float32)
    r = rng.uniform(0.5, 2.0, 500).astype(np.float32)
    n = rng.normal(size=(500, 3))
    p = (c + n / np.linalg.norm(n, axis=1, keepdims=True) * r[:, None]).astype(np.float32)
    u, v = ttr.sphere_uv(torch.from_numpy(c), torch.from_numpy(r), torch.from_numpy(p))
    ju, jv = jtr.sphere_uv(jnp.asarray(c), jnp.asarray(r)[:, None], jnp.asarray(p))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_masked_loop_keeps_a_finished_lane():
    """A lane that leaves the tree at its first step keeps its state while
    the others walk on: its hit, and every other lane's, is what it gets
    cast alone, and its step count is 1."""
    arrs, org, d = _scene()
    geom = _port_geom(arrs)
    away_o = np.array([[1e4, 1e4, 1e4]], np.float32)
    away_d = np.array([[1.0, 0.0, 0.0]], np.float32)
    o = torch.from_numpy(np.concatenate([away_o, org[:64]]))
    dd = torch.from_numpy(np.concatenate([away_d, d[:64]]))
    hit, steps = ttr.intersect_bvh(geom, o, dd, 1e-3, BIG, count_steps=True)
    assert int(steps[0]) == 1 and int(steps.max()) > 10
    assert int(hit.prim_id[0]) == -1 and float(hit.t[0]) == np.float32(BIG)
    for i in (0, 1, 17, 64):
        alone = ttr.intersect_bvh(geom, o[i:i + 1], dd[i:i + 1], 1e-3, BIG)
        for a, b in zip(alone, hit):
            assert torch.equal(a[0], b[i])
    blocked, steps = ttr.occluded_bvh(geom, o, dd, 1e-3, BIG, count_steps=True)
    assert int(steps[0]) == 1 and not bool(blocked[0])
    for i in (1, 17, 64):
        assert bool(ttr.occluded_bvh(geom, o[i:i + 1], dd[i:i + 1], 1e-3, BIG)[0]) == \
            bool(blocked[i])


def _assert_kernel_matches_walk(t, prim, walk, n_tris, unique):
    """A kernel's (t, prim) against the walk's on the same rays: the same
    hits, t of triangle hits bit for bit and of sphere hits to 2 ulp, prim
    where t is unique."""
    hit = prim >= 0
    sph = walk.prim_id >= n_tris
    assert torch.equal(hit, walk.prim_id >= 0)
    assert torch.equal(t[hit & ~sph], walk.t[hit & ~sph])
    torch.testing.assert_close(t[sph], walk.t[sph], rtol=3e-7, atol=0)
    assert torch.equal(prim[unique], walk.prim_id[unique])


def _kernel_casts(arrs, org, d, device):
    """K1 (for at most 128 primitives) or K3 (on a packet table of the same
    BVH) closest hits, the per-ray walk's, and the brute-force uniqueness
    of each ray's t."""
    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import packet_trace as tpt

    n_tris, n_sph, n = arrs[0].shape[0], arrs[3].shape[0], org.shape[0]
    o, dd = torch.from_numpy(org).to(device), torch.from_numpy(d).to(device)
    walk = ttr.intersect_bvh(_port_geom(arrs, device), o, dd, 1e-3, BIG)
    rays = [c.contiguous() for c in (*o.unbind(1), *dd.unbind(1))]
    far = torch.full((n,), BIG, device=device)
    if n_tris + n_sph <= 128:
        got = bk.intersect_brute(*_soups(arrs, device), n_tris, n_sph, *rays, far, 1e-3)[:2]
    else:
        tab = tpt.packet_table_to(tpt.build_packet_table(*arrs[5:], *arrs[:5], wide=32), device)
        got = pk.trace_packets(tab, *rays, torch.full((n,), 1e-3, device=device), far,
                               n_tris=n_tris)
    unique = _brute(_geo9(arrs), org, d, tnear=1e-3, n_tris=n_tris)[2]
    return got, walk, torch.from_numpy(unique).to(device)


@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_kernels_plain_versions_match_the_walk(kernel):
    """K1's plain version over the soups of a small scene and K3's over a
    packet table of the same BVH give the per-ray walk's t (triangle hits
    bit for bit, spheres to 2 ulp) and prim where t is unique."""
    arrs, org, d = _small() if kernel == "K1" else _scene()
    (t, prim), walk, unique = _kernel_casts(arrs, org, d, "cpu")
    assert 0.05 < float((prim >= 0).float().mean()) < 0.95
    _assert_kernel_matches_walk(t, prim, walk, arrs[0].shape[0], unique)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_walks_match_cpu_and_kernels():
    """The four casts on the card equal themselves on the CPU (sphere t
    within 2 ulp: the CPU's sqrt is not correctly rounded), and K1 (brute
    force) and K3 on a packet table of the same BVH give the walk's t on
    triangle hits bit for bit, prim where t is unique, and its any-hit
    masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrs, org, d = _scene()
    n_tris, n = arrs[0].shape[0], org.shape[0]
    cpu, gpu = _port_geom(arrs), _port_geom(arrs, "cuda")
    o, dd = torch.from_numpy(org), torch.from_numpy(d)
    oc, dc = o.cuda(), dd.cuda()
    tfar = torch.from_numpy(np.random.default_rng(6).uniform(-1.0, 40.0, n).astype(np.float32))
    for walk in ("bvh", "brute"):
        a = getattr(ttr, f"intersect_{walk}")(cpu, o, dd, 1e-3, BIG)
        b = getattr(ttr, f"intersect_{walk}")(gpu, oc, dc, 1e-3, BIG)
        sph = a.prim_id >= n_tris
        assert torch.equal(b.prim_id.cpu(), a.prim_id)
        assert torch.equal(b.t.cpu()[~sph], a.t[~sph])
        torch.testing.assert_close(b.t.cpu()[sph], a.t[sph], rtol=3e-7, atol=0)
        occ_a = getattr(ttr, f"occluded_{walk}")(cpu, o, dd, 1e-3, tfar)
        occ_b = getattr(ttr, f"occluded_{walk}")(gpu, oc, dc, 1e-3, tfar.cuda())
        assert torch.equal(occ_b.cpu(), occ_a)
    for small in (True, False):  # K1, then K3
        arrs_k, org_k, d_k = _small() if small else (arrs, org, d)
        (t, prim), walk, uniq = _kernel_casts(arrs_k, org_k, d_k, "cuda")
        _assert_kernel_matches_walk(t, prim, walk, arrs_k[0].shape[0], uniq)
    from gdpt_tpu_torch.accel import brute_kernels as bk

    arrs_k, org_k, d_k = _small()
    oc, dc = torch.from_numpy(org_k).cuda(), torch.from_numpy(d_k).cuda()
    tf = tfar[:org_k.shape[0]].cuda()
    rays = [c.contiguous() for c in (*oc.unbind(1), *dc.unbind(1))]
    k2 = bk.occluded_brute(*_soups(arrs_k, "cuda"), arrs_k[0].shape[0], arrs_k[3].shape[0],
                           *rays, tf, 1e-3)
    geom = _port_geom(arrs_k, "cuda")
    assert torch.equal(k2 > 0, ttr.occluded_brute(geom, oc, dc, 1e-3, tf))
    assert torch.equal(k2 > 0, ttr.occluded_bvh(geom, oc, dc, 1e-3, tf))
