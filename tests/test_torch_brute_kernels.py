"""K1/K2 of the port against the reference's Pallas brute kernels.

The plain PyTorch versions (what the wrappers run for CPU tensors) are
held against gdpt_tpu.accel.pallas_intersect in interpret mode on the
same soups (cbox plus one sphere) and rays (numpy, seeded). Tolerance:
rtol 1e-5 / atol 1e-5 on t, u, v and gn, for XLA-vs-torch CPU float
differences (the conftest disables XLA optimizations, ~1e-6); prim must
be equal wherever the closest t is unique (ties may flip, ROADMAP.md C).

The gpu-marked test holds each CUDA kernel against its plain version on
the card. This file imports jax only inside the reference helpers, so
the gpu test also runs where jax is absent:
    python -m pytest --noconftest -m gpu tests/test_torch_brute_kernels.py
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.accel import brute_kernels as bk
from gdpt_tpu_torch.scene import presets as tpresets

N = 8192
SPHERE = np.array([[278.0], [120.0], [300.0], [80.0]], np.float32)


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


@pytest.mark.parametrize("tnear", ["zero", "eps"])
def test_intersect_plain_matches_pallas(tnear):
    pli = _pallas()
    tri, sph, static = _soups()
    tn = 0.0 if tnear == "zero" else static.intersection_epsilon
    o, d, _ = _rays(1)
    ref = [np.array(x) for x in pli.pallas_intersect_brute(
        tri, sph, *o, *d, n_tris=tri.shape[1], n_sph=1, tnear_static=float(tn))]
    got = [x.numpy() for x in bk.intersect_brute_plain(
        *_t([tri, sph])[:2], tri.shape[1], 1, *_t(o), *_t(d), tn)]
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
    args = (*_t([tri, sph]), tri.shape[1], 1, *_t(o), *_t(d))
    for a, b in zip(bk.intersect_brute(*args, 0.5), bk.intersect_brute_plain(*args, 0.5)):
        assert torch.equal(a, b)
    assert torch.equal(bk.occluded_brute(*args, torch.from_numpy(tfar), 0.5),
                       bk.occluded_brute_plain(*args, torch.from_numpy(tfar), 0.5))
    assert bk.LAUNCHES == before


@pytest.mark.parametrize("bad", ["float64", "strided", "too_many_prims", "soup_shape"])
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
    else:
        tri_t = tri_t[:, :4].contiguous()
    with pytest.raises(ValueError):
        bk.intersect_brute(tri_t, sph_t, n_tris, 1, *o_t, *d_t, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["intersect", "occluded"])
def test_cuda_kernel_matches_plain(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tri, sph, static = _soups()
    o, d, tfar = _rays(5, 262_144 + 77)  # ragged last block
    args = (*_t([tri, sph], "cuda"), tri.shape[1], 1, *_t(o, "cuda"), *_t(d, "cuda"))
    before = bk.LAUNCHES[kernel]
    if kernel == "intersect":
        eps = static.intersection_epsilon
        got = bk.intersect_brute(*args, eps)
        ref = bk.intersect_brute_plain(*args, eps)
        torch.cuda.synchronize()
        same = got[1] == ref[1]
        assert int((~same).sum()) <= 26  # ties only
        for a, b in zip(got[:1] + got[2:], ref[:1] + ref[2:]):
            torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-5)
    else:
        tf = torch.from_numpy(tfar).cuda()
        eps = static.shadow_epsilon
        got = bk.occluded_brute(*args, tf, eps)
        ref = bk.occluded_brute_plain(*args, tf, eps)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    assert bk.LAUNCHES[kernel] == before + 1
