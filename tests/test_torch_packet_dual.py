"""The port's dual BVH walk (K4) against its solo walk (K3) and gdpt_tpu's
dual Pallas kernel.

On the CPU `trace_packets(dual=True)` runs K4's plain version
(`trace_packets_dual_plain`: the width check and the plain solo walk).
The two rays of a pair never interact, so dual and solo results are held
equal bit for bit, for even and odd ray counts, closest and any hit,
with start refs and with in-table spheres.
Against `gdpt_tpu.accel.packet_trace._trace_packets(..., interpret=True,
dual=True)` on the same table: prim equal where the closest t is unique,
t within rtol 1e-5 (XLA's CPU code may differ from torch by an ulp), any-hit
masks equal. A 32-wide table raises ValueError: the port does not give
way to the solo kernel quietly as the reference does.

The gpu-marked tests hold the CUDA kernel against its plain version and
against K3 on the card, bit for bit, among them hand-built leaves that
stress the group's leaf reduction and pairs whose rays share every row:
    python -m pytest --noconftest -m gpu tests/test_torch_packet_dual.py
"""

import numpy as np
import pytest
import torch

from gdpt_tpu_torch.accel import packet_kernels as pk
from gdpt_tpu_torch.accel import packet_trace as tpt
from gdpt_tpu_torch.accel import traverse_soa as ttrs

from test_torch_packet import (_arrays, _brute, _carry, _rays, _reference_table, _soup,
                               _table_case, _tie_case, _tie_rays,
                               one_thread)  # noqa: F401 (autouse fixture)

_TABS = {}


def _tab(case):
    """(reference table, port table, geo9, n_tris) of a 16-wide table:
    the 1,200-triangle soup of tests/test_packet.py's dual test, or a
    soup with 11 in-table spheres."""
    if case not in _TABS:
        if case == "soup1200":
            args, kw = _arrays(*_soup(1200, seed=21)), dict(wide=16)
        else:
            args, kw = _table_case("spheres_in_table", 16)
        ref = _reference_table(args, **kw)
        n_tris = args[6].shape[0] if case == "spheres" else None
        _TABS[case] = (ref, _carry(ref), np.asarray(ref.geo9), n_tris)
    return _TABS[case]


def _flat(n, seed, device="cpu"):
    org, d = _rays(n, seed=seed)
    rays = [torch.from_numpy(np.ascontiguousarray(a[:, i])).to(device)
            for a in (org, d) for i in range(3)]
    tf = np.random.default_rng(seed).uniform(5.0, 60.0, n).astype(np.float32)
    tf[::11] = -1.0  # dead lanes
    return org, d, rays + [torch.full((n,), 1e-4, device=device),
                           torch.from_numpy(tf).to(device)]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("n", [2048, 2047, 300, 1])
@pytest.mark.parametrize("case", ["soup1200", "spheres"])
def test_dual_equals_solo_bit_for_bit(case, n, any_hit):
    _, tab, _, n_tris = _tab(case)
    _, _, rays = _flat(n, seed=22)
    solo = pk.trace_packets(tab, *rays, n_tris=n_tris, any_hit=any_hit, counts=True)
    dual = pk.trace_packets(tab, *rays, n_tris=n_tris, any_hit=any_hit, counts=True, dual=True)
    assert n == 1 or bool((solo[1] >= 0).any())
    for a, b in zip(dual, solo):  # t, prim and the visit counts
        assert a.shape == b.shape and torch.equal(a, b)
    two = pk.trace_packets(tab, *rays, n_tris=n_tris, any_hit=any_hit, dual=True)
    assert len(two) == 2 and torch.equal(two[0], solo[0]) and torch.equal(two[1], solo[1])


def test_dual_with_start_refs_equals_solo():
    _, tab, _, _ = _tab("soup1200")
    _, _, rays = _flat(777, seed=4)
    refs = tab.entry_ref
    rref = refs[torch.arange(777) % refs.shape[0]].contiguous()
    solo = pk.trace_packets(tab, *rays, rref=rref)
    dual = pk.trace_packets(tab, *rays, rref=rref, dual=True)
    root = pk.trace_packets(tab, *rays)
    assert torch.equal(dual[0], solo[0]) and torch.equal(dual[1], solo[1])
    assert not torch.equal(solo[1], root[1])  # the start refs were honoured


@pytest.mark.parametrize("n_pack,any_hit", [(2, False), (3, False), (3, True)])
def test_dual_plain_matches_pallas_dual_kernel(n_pack, any_hit):
    import jax.numpy as jnp
    from gdpt_tpu.accel import packet_trace as jpt

    jtab, tab, geo9, _ = _tab("soup1200")
    n = jpt.PACKET_ROWS * 128 * n_pack
    org, d = _rays(n, seed=22)
    rays = [torch.from_numpy(np.ascontiguousarray(a[:, i])) for a in (org, d) for i in range(3)]
    rays += [torch.full((n,), 1e-4), torch.full((n,), 1e9)]
    t, prim = pk.trace_packets(tab, *rays, any_hit=any_hit, dual=True)
    jt, jp = jpt._trace_packets(jtab, *(jnp.asarray(a.numpy().reshape(-1, 128)) for a in rays),
                                any_hit=any_hit, interpret=True, dual=True)
    jt, jp = np.asarray(jt).reshape(-1), np.asarray(jp).reshape(-1)
    np.testing.assert_array_equal(prim.numpy() >= 0, jp >= 0)
    if not any_hit:
        _, _, unique = _brute(geo9, org, d)
        assert unique.mean() > 0.99
        np.testing.assert_array_equal(prim.numpy()[unique], jp[unique])
        np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5)


@pytest.mark.parametrize("where", ["trace_packets", "plain", "geom", "scene_soa", "render_soa",
                                   "render_gradpath_soa", "render"])
def test_dual_on_a_32_wide_table_raises(where):
    from gdpt_tpu_torch.integrators import gdpt_soa, path_soa, render
    from gdpt_tpu_torch.scene import presets

    args, kw = _table_case("triangles", 32)
    tab = tpt.build_packet_table(*args, **kw)
    _, _, rays = _flat(256, seed=3)
    scene = presets.cornell_box(8, 8, spp=1, max_depth=2, force_bvh=True)
    with pytest.raises(ValueError, match="16"):
        if where == "trace_packets":
            pk.trace_packets(tab, *rays, dual=True)
        elif where == "plain":
            pk.trace_packets_dual_plain(tab, *rays)
        elif where == "geom":
            ttrs.geom_soa_from_aos(scene.device.geom, wide=32, dual=True)
        elif where == "scene_soa":
            path_soa.scene_soa_from_aos(scene, 32, True)
        elif where == "render_soa":
            path_soa.render_soa(scene, packet_dual=True)
        elif where == "render_gradpath_soa":
            gdpt_soa.render_gradpath_soa(scene, packet_dual=True)
        else:
            render.render(scene, device="cpu", packet_wide=32, packet_dual=True)


def test_dual_flag_rides_on_the_scene_view_and_reaches_the_walk(monkeypatch):
    """scene_soa_from_aos memoises per table width; the dual view is the
    16-wide view with its static flag set (the same tables, no second
    build), and the flag reaches trace_packets through intersect_soa_gn
    and occluded_soa; CPU tensors count no launch."""
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.scene import presets

    scene = presets.cornell_box(8, 8, spp=1, max_depth=2, force_bvh=True)
    solo = path_soa.scene_soa_from_aos(scene, 16)
    dual = path_soa.scene_soa_from_aos(scene, 16, True)
    assert solo is path_soa.scene_soa_from_aos(scene, wide=16, dual=False)
    assert dual is not solo and dual.geom.dual and not solo.geom.dual
    assert dual.geom.packet.width == 16 and path_soa.scene_soa_from_aos(scene).geom.packet.width == 32
    assert dual.geom.packet.table is solo.geom.packet.table
    seen = []
    real = pk.trace_packets
    monkeypatch.setattr(pk, "trace_packets",
                        lambda *a, **k: seen.append((k["any_hit"], k["dual"])) or real(*a, **k))
    before = dict(pk.LAUNCHES)
    org, d, _ = _flat(64, seed=9)
    from test_torch_packet import _v3
    o3, d3 = _v3(org * 20 + 278), _v3(d)
    for view in (solo, dual):
        ttrs.intersect_soa_gn(scene.static, view.geom, o3, d3, 1e-4, 1e9)
        ttrs.occluded_soa(scene.static, view.geom, o3, d3, 1e-4, torch.full((64,), 1e9))
    assert seen == [(False, False), (True, False), (False, True), (True, True)]
    assert pk.LAUNCHES == before and set(before) >= {"packet_dual_intersect",
                                                      "packet_dual_occluded"}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["closest", "any_hit"])
def test_cuda_dual_kernel_matches_plain_and_solo(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    any_hit = mode == "any_hit"
    for case in ("soup1200", "spheres"):
        if case == "soup1200":
            args, kw = _arrays(*_soup(1200, seed=21)), dict(wide=16)
        else:
            args, kw = _table_case("spheres_in_table", 16)
        tab = tpt.packet_table_to(tpt.build_packet_table(*args, **kw), "cuda")
        n_tris = args[6].shape[0] if case == "spheres" else None
        for n in (262_144, 262_143 + 130, 5):
            _, _, rays = _flat(n, seed=5, device="cuda")
            key = "packet_dual_occluded" if any_hit else "packet_dual_intersect"
            before = dict(pk.LAUNCHES)
            got = pk.trace_packets(tab, *rays, n_tris=n_tris, any_hit=any_hit, counts=True,
                                   dual=True)
            assert pk.LAUNCHES[key] == before[key] + 1
            assert pk.LAUNCHES["packet_intersect"] == before["packet_intersect"]
            ref = pk.trace_packets_dual_plain(tab, *rays, n_tris=n_tris, any_hit=any_hit,
                                              counts=True)
            solo = pk.trace_packets(tab, *rays, n_tris=n_tris, any_hit=any_hit, counts=True)
            torch.cuda.synchronize()
            for a, b, c in zip(got, ref, solo):  # t, prim and the visit counts, bit for bit
                assert torch.equal(a, b) and torch.equal(a, c)


def _dual_plain_solo(tab, rays, **kw):
    """K4, its plain version and K3 on the same rays, with the counts; K4
    must be launched once and K3's counters left alone by it."""
    key = "packet_dual_occluded" if kw.get("any_hit") else "packet_dual_intersect"
    before = dict(pk.LAUNCHES)
    got = pk.trace_packets(tab, *rays, counts=True, dual=True, **kw)
    assert pk.LAUNCHES[key] == before[key] + (rays[0].shape[0] > 0)
    assert pk.LAUNCHES["packet_intersect"] == before["packet_intersect"]
    assert pk.LAUNCHES["packet_occluded"] == before["packet_occluded"]
    ref = pk.trace_packets_dual_plain(tab, *rays, counts=True, **kw)
    solo = pk.trace_packets(tab, *rays, counts=True, **kw)
    torch.cuda.synchronize()
    return got, ref, solo


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["closest", "any_hit"])
def test_cuda_dual_kernel_lane_reductions(mode):
    """Hand-built leaves that stress the group's leaf reduction (_tie_case:
    equal t in one leaf, hits at t = tnear = 0 of both signs, several
    blocking slots, equal in-table spheres): 0, 1, 17, 49 and 128 rays,
    from the root and from a leaf-group ref, a batch of dead rays, pairs
    of identical rays (every row shared) and pairs with one ray dead. K4
    equals its plain version and K3 in t bits, prim and the four counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    any_hit = mode == "any_hit"
    for spheres in (False, True):
        args, kw, n_tris = _tie_case(16, spheres)
        tab = tpt.packet_table_to(tpt.build_packet_table(*args, **kw), "cuda")
        rays = [torch.from_numpy(a).cuda() for a in _tie_rays(seed=16)]
        leaf_ref = int(tab.table[0, 96])
        assert leaf_ref < 0
        dead = rays[:7] + [torch.full_like(rays[7], -1.0)]
        twins = [c[torch.arange(128, device="cuda") // 2].contiguous() for c in rays]
        one_dead = [c.clone() for c in rays]
        one_dead[7][::2] = -1.0
        other_dead = [c.clone() for c in rays]
        other_dead[7][1::2] = -1.0
        for n in (0, 1, 17, 49, 128):
            for rref in (None, torch.full((n,), leaf_ref, dtype=torch.int32, device="cuda")):
                for label, rr in (("live", rays), ("dead", dead), ("twins", twins),
                                  ("first dead", one_dead), ("second dead", other_dead)):
                    cut = [c[:n].contiguous() for c in rr]
                    got, ref, solo = _dual_plain_solo(tab, cut, rref=rref, n_tris=n_tris,
                                                      any_hit=any_hit)
                    for a, b, c in zip(got, ref, solo):
                        a, b, c = (x.view(torch.int32) for x in (a, b, c))
                        assert torch.equal(a, b) and torch.equal(a, c), \
                            (spheres, n, rref is None, label)
        hit = pk.trace_packets_plain(tab, *rays, n_tris=n_tris, any_hit=any_hit)[1]
        assert bool((hit >= 0).all())
        if spheres and not any_hit:  # the two equal spheres are hit
            assert bool((hit >= n_tris).any())


@pytest.mark.gpu
def test_cuda_dual_kernel_reports_stack_overflow():
    """A table whose stack_n understates its depth: K4 never drops a push
    silently. The wrapper raises with counts, check_overflow without, as
    for K3 and the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, kw = _table_case("triangles", 16)
    tab = tpt.packet_table_to(tpt.build_packet_table(*args, **kw), "cuda")
    _, _, rays = _flat(4096, seed=3, device="cuda")
    rays[7] = torch.full((4096,), 1e9, device="cuda")
    pk.trace_packets(tab, *rays, counts=True, dual=True)   # deep enough: no error
    shallow = tab._replace(stack_n=tab.width)               # one stack entry per ray
    for any_hit in (False, True):
        with pytest.raises(RuntimeError, match="stack"):
            pk.trace_packets(shallow, *rays, counts=True, any_hit=any_hit, dual=True)
        pk.trace_packets(shallow, *rays, any_hit=any_hit, dual=True)
        with pytest.raises(RuntimeError, match="stack"):
            pk.check_overflow()
        pk.check_overflow()                                  # the flag was cleared
    with pytest.raises(RuntimeError, match="stack"):
        pk.trace_packets_dual_plain(shallow, *rays)
