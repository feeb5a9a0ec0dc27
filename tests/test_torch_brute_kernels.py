"""K1/K2 of the port against the reference's Pallas brute kernels.

The plain PyTorch versions (what the wrappers run for CPU tensors) are
held against gdpt_tpu.accel.pallas_intersect in interpret mode on the
same soups (cbox plus one sphere) and rays (numpy, seeded). Tolerance:
rtol 1e-5 / atol 1e-5 on t, u, v and gn, for XLA-vs-torch CPU float
differences (the conftest disables XLA optimizations, ~1e-6); prim must
be equal wherever the closest t is unique (ties may flip, ROADMAP.md C).
The Pallas K1 takes no tfar and casts over [tnear, BIG); the port's K1
with tfar = BIG is that kernel, and with a per-ray tfar it keeps the
Pallas hit where t < tfar and gives the miss record elsewhere.

The gpu-marked test holds each CUDA kernel against its plain version on
the card bit for bit (t, u, v, normal bits, prim, blocked) over soups of
1 to 128 triangles with and without spheres, with duplicate and coplanar
triangles and rays that hit at t = -0.0 and +0.0, dead shares 0 to 1
scattered and in whole warps, a scalar and a per-ray tnear, and 0, 1 and
262,221 rays. This file
imports jax only inside the reference helpers, so the gpu test also runs
where jax is absent:
    python -m pytest --noconftest -m gpu tests/test_torch_brute_kernels.py
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.accel import brute_kernels as bk
from gdpt_tpu_torch.scene import presets as tpresets

N = 8192
SPHERE = np.array([[278.0], [120.0], [300.0], [80.0]], np.float32)
MISS = (bk.BIG, -1, 0.0, 0.0, 0.0, 0.0, 1.0)  # t, prim, u, v, gx, gy, gz


def _soups():
    """cbox triangle soup from the port's own build, plus one sphere."""
    from gdpt_tpu_torch.accel.traverse_soa import geom_soa_from_aos

    scene = tpresets.cornell_box(16, 16)
    g = geom_soa_from_aos(scene.device.geom)
    return g.tri_soup.numpy(), SPHERE.copy(), scene.static


def _rays(seed, n=N):
    """Origins inside and in front of the box, random unit directions,
    and per-ray tfar with every seventh lane dead (-1)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([20, 20, -600], [540, 530, 540], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tfar = rng.uniform(-1, 1500, n).astype(np.float32)
    tfar[::7] = -1.0
    return [o[:, i].copy() for i in range(3)], [d[:, i].copy() for i in range(3)], tfar


def _pallas():
    pytest.importorskip("jax")
    from gdpt_tpu.accel import pallas_intersect

    return pallas_intersect


def _t(arrs, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrs]


def _big(n, device="cpu"):
    return torch.full((n,), bk.BIG, dtype=torch.float32, device=device)


def _pallas_k1(tri, sph, o, d, tn):
    pli = _pallas()
    return [np.array(x) for x in pli.pallas_intersect_brute(
        tri, sph, *o, *d, n_tris=tri.shape[1], n_sph=1, tnear_static=float(tn))]


@pytest.mark.parametrize("tnear", ["zero", "eps"])
def test_intersect_plain_matches_pallas(tnear):
    tri, sph, static = _soups()
    tn = 0.0 if tnear == "zero" else static.intersection_epsilon
    o, d, _ = _rays(1)
    ref = _pallas_k1(tri, sph, o, d, tn)
    got = [x.numpy() for x in bk.intersect_brute_plain(
        *_t([tri, sph])[:2], tri.shape[1], 1, *_t(o), *_t(d), _big(N), tn)]
    t_ref, prim_ref = ref[0], ref[1]
    assert 0.3 < (prim_ref >= 0).mean() < 1.0  # both hits and misses
    assert (prim_ref >= tri.shape[1]).any()    # the sphere is hit
    for k in (0, 2, 3, 4, 5, 6):  # t, u, v, gx, gy, gz
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5)
    # prim must agree on lanes whose closest t no other primitive shares.
    o_t, d_t, t_ref_t = _t(o), _t(d), torch.from_numpy(t_ref)
    t_rows, _, _, h_rows = bk._tri_test_rows(torch.from_numpy(tri), tri.shape[1],
                                             o_t, d_t, tn, bk.BIG)
    t_s, h_s = bk._sphere_test_rows(torch.from_numpy(sph), 1, o_t, d_t, tn, bk.BIG)
    ties = (h_rows & (t_rows == t_ref_t)).sum(0) + (h_s & (t_s == t_ref_t)).sum(0)
    unique = (ties <= 1).numpy()
    assert unique.mean() > 0.99
    np.testing.assert_array_equal(got[1][unique], prim_ref[unique])


@pytest.mark.parametrize("window", ["mixed", "finite", "at_hit"])
def test_intersect_plain_window_matches_pallas(window):
    """K1 with a per-ray tfar against the Pallas kernel, which casts over
    [tnear, BIG). mixed: lanes with tfar = BIG or a dead tfar (-1, 0 =
    tnear, NaN); finite: random tfar, some below the Pallas hit, some
    above; at_hit: tfar equal to the hit's t, which the window [tnear,
    tfar) leaves out. A lane keeps the Pallas hit where it lies
    inside its window (t and prim as in the first test; u, v and the
    normal bit for bit those of the port's own cast with tfar = BIG), else
    it gets the miss record. Where a sphere wins, u and v belong to the
    closest triangle inside the window, so a triangle beyond tfar leaves
    them 0."""
    tri, sph, static = _soups()
    n_tris = tri.shape[1]
    tn = static.intersection_epsilon
    o, d, _ = _rays(6)
    ref = _pallas_k1(tri, sph, o, d, tn)
    args = (*_t([tri, sph]), n_tris, 1, *_t(o), *_t(d))
    base = [x.numpy() for x in bk.intersect_brute_plain(*args, _big(N), tn)]
    rng = np.random.default_rng(7)
    if window == "mixed":
        tfar = np.where(rng.uniform(size=N) < 0.5, np.float32(bk.BIG), np.float32(-1.0))
        tfar[1::9] = np.float32(tn)
        tfar[2::13] = np.nan
    elif window == "finite":
        tfar = rng.uniform(0.0, 1200.0, N)
    else:
        tfar = np.where(base[1] >= 0, base[0], np.float32(500.0))
    tfar = tfar.astype(np.float32)
    got = [x.numpy() for x in bk.intersect_brute_plain(*args, torch.from_numpy(tfar), tn)]
    keep = (base[1] >= 0) & (base[0] < tfar)
    assert 0.1 < keep.mean() < 0.9 or (window == "at_hit" and not keep.any())
    lost = ~keep
    assert lost.mean() > 0.1
    np.testing.assert_allclose(got[0][keep], ref[0][keep], rtol=1e-5, atol=1e-5)
    assert window == "at_hit" or (got[1][keep] == ref[1][keep]).mean() > 0.99  # ties may flip
    tri_hit = keep & (base[1] < n_tris)
    for k in range(7):
        np.testing.assert_array_equal(got[k][lost], np.asarray(MISS[k], got[k].dtype))
        rows = keep if k not in (2, 3) else tri_hit
        np.testing.assert_array_equal(got[k][rows], base[k][rows])
    for k in (2, 3):
        sph_hit = keep & ~tri_hit
        assert ((got[k][sph_hit] == base[k][sph_hit]) | (got[k][sph_hit] == 0)).all()


@pytest.mark.parametrize("tnear", ["zero", "eps"])
def test_occluded_plain_matches_pallas(tnear):
    pli = _pallas()
    tri, sph, static = _soups()
    tn = 0.0 if tnear == "zero" else static.shadow_epsilon
    o, d, tfar = _rays(2)
    ref = np.asarray(pli.pallas_occluded_brute(
        tri, sph, *o, *d, tfar, n_tris=tri.shape[1], n_sph=1, tnear_static=float(tn)))
    got = bk.occluded_brute_plain(*_t([tri, sph]), tri.shape[1], 1,
                                  *_t(o), *_t(d), torch.from_numpy(tfar), tn)
    assert got.dtype == torch.float32
    assert 0.05 < ref.mean() < 0.95
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numpy()[::7] == 0).all()  # dead lanes never block


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    tri, sph, _ = _soups()
    o, d, tfar = _rays(3, 1024)
    before = dict(bk.LAUNCHES)
    args = (*_t([tri, sph]), tri.shape[1], 1, *_t(o), *_t(d), torch.from_numpy(tfar))
    for a, b in zip(bk.intersect_brute(*args, 0.5), bk.intersect_brute_plain(*args, 0.5)):
        assert torch.equal(a, b)
    assert torch.equal(bk.occluded_brute(*args, 0.5), bk.occluded_brute_plain(*args, 0.5))
    assert bk.LAUNCHES == before


def test_a_captured_launch_counts_once_per_replay(monkeypatch):
    """A launch counts in LAUNCHES when it runs: one made while a stream
    is captured goes into the capture's tally instead (none outside a
    tally), and count_replays adds the tally once per replay; an empty
    batch counts nowhere."""
    capturing = [False]
    monkeypatch.setattr(bk.torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    for k in bk.LAUNCHES:
        monkeypatch.setitem(bk.LAUNCHES, k, 0)
    bk._count("intersect", 4)
    bk._count("occluded", 0)
    assert bk.LAUNCHES == {"intersect": 1, "occluded": 0}
    capturing[0] = True
    with bk.capture_tally() as tally:
        bk._count("intersect", 4)
        bk._count("occluded", 4)
        bk._count("occluded", 4)
        bk._count("occluded", 0)
    bk._count("intersect", 4)
    assert tally == {"intersect": 1, "occluded": 2}
    assert bk.LAUNCHES == {"intersect": 1, "occluded": 0}
    bk.count_replays(tally, 3)
    assert bk.LAUNCHES == {"intersect": 4, "occluded": 6}


def test_a_capture_tallies_each_counter_group_apart(monkeypatch):
    """Another kernel's counter group (path_fused's stages) keeps a tally
    of its own in one capture beside K1's and K2's: a launch counts in its
    own group's tally, nested tallies of one group give the outer one
    back, and a group with no tally open counts nothing while captured."""
    capturing = [True]
    monkeypatch.setattr(bk.torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    for k in bk.LAUNCHES:
        monkeypatch.setitem(bk.LAUNCHES, k, 0)
    stages, other = {"primary": 0, "after_hit": 0}, {"x": 0}
    with bk.capture_tally() as casts, bk.capture_tally(stages) as tally:
        bk._count("intersect", 8)
        bk.count_launch("after_hit", stages)
        bk.count_launch("x", other)
        with bk.capture_tally(stages) as inner:
            bk.count_launch("primary", stages)
        bk.count_launch("after_hit", stages)
    assert casts == {"intersect": 1, "occluded": 0}
    assert tally == {"primary": 0, "after_hit": 2} and inner == {"primary": 1, "after_hit": 0}
    assert stages == {"primary": 0, "after_hit": 0} and other == {"x": 0}
    bk.count_launch("primary", stages)
    assert stages["primary"] == 0
    capturing[0] = False
    bk.count_launch("primary", stages)
    bk.count_replays(tally, 4, stages)
    assert stages == {"primary": 1, "after_hit": 8} and bk.LAUNCHES["intersect"] == 0


@pytest.mark.parametrize("kernel", ["intersect", "occluded"])
def test_wrappers_take_a_per_ray_tnear(kernel):
    """A per-ray tnear (the wavefront casts primary rays from 0 and bounce
    rays from the epsilon in one launch) gives every lane the cast of its
    own scalar tnear, bit for bit; here 0 or 200 by lane, so that the two
    casts differ on many lanes."""
    tri, sph, _ = _soups()
    o, d, tfar = _rays(5)
    args = (*_t([tri, sph]), tri.shape[1], 1, *_t(o), *_t(d), torch.from_numpy(tfar))
    lane = torch.from_numpy(np.random.default_rng(5).uniform(size=N) < 0.5)
    fn = bk.intersect_brute if kernel == "intersect" else bk.occluded_brute
    got, near, far = fn(*args, torch.where(lane, 0.0, 200.0)), fn(*args, 0.0), fn(*args, 200.0)
    if kernel == "occluded":
        got, near, far = [got], [near], [far]
    assert int((near[0] != far[0]).sum()) > N // 50
    for g, a, b in zip(got, near, far):
        assert torch.equal(_bits(g), _bits(torch.where(lane, a, b)))


@pytest.mark.parametrize("bad", ["float64", "strided", "too_many_prims", "soup_shape",
                                 "tnear_shape"])
def test_wrappers_reject_what_kernels_do_not_take(bad):
    tri, sph, _ = _soups()
    o, d, _ = _rays(4, 256)
    tri_t, sph_t = _t([tri, sph])
    o_t, d_t = _t(o), _t(d)
    n_tris = tri.shape[1]
    if bad == "float64":
        o_t[0] = o_t[0].double()
    elif bad == "strided":
        o_t[0] = torch.zeros(512)[::2]
    elif bad == "too_many_prims":
        tri_t, n_tris = torch.zeros((9, 129)), 129
    elif bad == "soup_shape":
        tri_t = tri_t[:, :4].contiguous()
    tnear = torch.zeros(255) if bad == "tnear_shape" else 0.0
    with pytest.raises(ValueError):
        bk.intersect_brute(tri_t, sph_t, n_tris, 1, *o_t, *d_t, _big(256), tnear)


def _gpu_soup(n_tris, n_sph, seed):
    """(9, T) triangles in a 100-unit box with ties built in: triangle 1
    repeats triangle 0, triangle 3 repeats 2 with its edges swapped (so
    its t comes out with the other sign of zero), and triangles 0-3 lie in
    the plane z = 0; (4, S) spheres inside the box."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(0, 100, (n_tris, 3))
    e1 = rng.uniform(-40, 40, (n_tris, 3))
    e2 = rng.uniform(-40, 40, (n_tris, 3))
    if n_tris >= 4:
        v0[:4] = [[10, 10, 0], [10, 10, 0], [0, 0, 0], [0, 0, 0]]
        e1[:4] = [[60, 0, 0], [60, 0, 0], [80, 5, 0], [5, 80, 0]]
        e2[:4] = [[0, 60, 0], [0, 60, 0], [5, 80, 0], [80, 5, 0]]
    tri = np.concatenate([v0.T, e1.T, e2.T]).astype(np.float32)
    sph = np.zeros((4, max(n_sph, 1)), np.float32)
    if n_sph:
        sph[:3] = rng.uniform(20, 80, (3, n_sph))
        sph[3] = rng.uniform(2, 15, n_sph)
    return np.ascontiguousarray(tri), sph


def _gpu_rays(n, seed):
    """Half the rays start in the plane z = 0 over triangles 0-3 (t = +0.0
    or -0.0 there, ties at tnear = 0), half anywhere in the box; random
    directions, every tenth one with a zero component."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-20, 120, (n, 3))
    plane = rng.uniform(size=n) < 0.5
    o[plane] = np.c_[rng.uniform(12, 60, (plane.sum(), 2)), np.zeros(plane.sum())]
    d = rng.normal(size=(n, 3))
    d[::10, 0] = 0.0
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return [np.ascontiguousarray(a[:, i], np.float32) for a in (o, d) for i in range(3)]


def _dead_mask(n, share, layout, seed):
    rng = np.random.default_rng(seed)
    if layout == "warps":
        return np.repeat(rng.uniform(size=(n + 31) // 32) < share, 32)[:n]
    return rng.uniform(size=n) < share


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


@pytest.mark.gpu
@pytest.mark.parametrize("n_tris", [1, 31, 32, 33, 128])
@pytest.mark.parametrize("n_sph", [0, 5])
@pytest.mark.parametrize("kernel", ["intersect", "occluded"])
def test_cuda_kernel_matches_plain(kernel, n_sph, n_tris):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tri, sph = _gpu_soup(n_tris, n_sph, seed=n_tris + n_sph)
    soups = (*_t([tri, sph], "cuda"), n_tris, n_sph)
    fn, plain = ((bk.intersect_brute, bk.intersect_brute_plain) if kernel == "intersect"
                 else (bk.occluded_brute, bk.occluded_brute_plain))
    cases = [(n, 0.0, "lanes") for n in (0, 1)]
    cases += [(262_144 + 77, share, layout) for share in (0.0, 0.5, 0.93, 1.0)
              for layout in ("lanes", "warps")]
    for j, (n, share, layout) in enumerate(cases):
        rays = _t(_gpu_rays(n, seed=j), "cuda")
        tfar = np.random.default_rng(j).uniform(1.0, 300.0, n).astype(np.float32)
        tfar[::3] = bk.BIG
        tfar[_dead_mask(n, share, layout, j)] = -1.0
        # Every third case a per-ray tnear, 0 or 1e-4 by lane.
        lane_tn = np.where(np.random.default_rng(j + 1).uniform(size=n) < 0.5, 0.0,
                           1e-4).astype(np.float32)
        tnear = (torch.from_numpy(lane_tn).cuda() if j % 3 == 0 else 0.0 if j % 2 else 1e-4)
        args = (*soups, *rays, torch.from_numpy(tfar).cuda(), tnear)
        before = bk.LAUNCHES[kernel]
        got = fn(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        assert bk.LAUNCHES[kernel] == before + (n > 0)
        label = f"{n} rays, dead share {share} by {layout}"
        for a, b in zip(got if kernel == "intersect" else [got],
                        ref if kernel == "intersect" else [ref]):
            assert torch.equal(_bits(a), _bits(b)), label
        if kernel == "intersect" and n > 1:
            dead = torch.from_numpy(tfar <= (lane_tn if j % 3 == 0 else tnear)).cuda()
            assert bool((got[1][dead] == -1).all()) and bool((got[0][dead] == bk.BIG).all())
            if n_tris >= 4 and share < 1.0 and j % 3 and tnear == 0.0:
                # The plane rays' ties at t = +-0.0 go to the lowest index.
                zero = (got[0] == 0.0) & (got[1] < 4)
                assert bool(zero.any()) and bool((got[1][zero] % 2 == 0).all()), label
