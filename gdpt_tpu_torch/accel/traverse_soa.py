"""Batched (SoA) ray casting dispatch — replaces Embree's
rtcIntersect1/rtcOccluded1 (reference: src/intersection.cpp:32,83).

Counterpart of gdpt_tpu/accel/traverse_soa.py. All ray state lives in
(N,) component tensors. Backends, chosen per scene at build time:

- brute force (at most 128 primitives): the K1/K2 wrappers of
  accel/brute_kernels.py;
- packet table (every larger scene): the BVH walk of
  accel/packet_kernels.py over the table of accel/packet_trace.py: K3,
  or K4 (the dual walk) when the scene's view was built 16-wide with
  dual=True; with two_phase=True casts of 4,096 rays or more take the
  two-phase entry traversal (packet_trace.trace_two_phase) over the same
  kernels, and packet_sort=False turns off every cast's ray sort.

Each wrapper launches its hand-written CUDA kernel for CUDA tensors and
takes its plain PyTorch version for CPU tensors. A BVH scene always has
a packet table here: the table lives in device memory, with no size cap
and no per-lane fallback walk.

Few-sphere scenes (<= SPH_BRUTE_MAX) keep spheres out of the table
entirely and brute-merge them after the walk.
"""

from typing import NamedTuple

import torch

from gdpt_tpu_torch.accel import brute_kernels as bk
from gdpt_tpu_torch.accel import packet_trace
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL
from gdpt_tpu_torch.core.soa import V3

# Scenes with at most this many spheres keep them OUT of the packet
# table and brute-test them per lane instead (see geom_soa_from_aos /
# _sph_outside): an in-table sphere forces the walk's sphere branch into
# every leaf visit scene-wide.
SPH_BRUTE_MAX = 8


class GeomSoA(NamedTuple):
    """Component-transposed geometry view (built once per render), with
    the kernels' packed primitive soups."""

    tri_v0: V3
    tri_e1: V3
    tri_e2: V3
    sph_center: V3
    sph_radius: torch.Tensor
    tri_soup: torch.Tensor  # (9, T) v0.xyz e1.xyz e2.xyz
    sph_soup: torch.Tensor  # (4, S) center.xyz radius
    # Packet table (accel/packet_trace.PacketTable) of a BVH scene, on
    # the geometry's device; None for brute-force scenes.
    packet: object = None
    # Walk the table with the dual kernel (K4) instead of the solo one
    # (K3); static, and only ever set beside a 16-wide table.
    dual: bool = False
    # Every cast of 4,096 rays or more takes the two-phase entry
    # traversal (the reference's GDPT_TWO_PHASE=1); static.
    two_phase: bool = False
    # False: no cast sorts its rays (the reference's GDPT_PACKET_SORT=0);
    # static.
    packet_sort: bool = True


def geom_soa_from_aos(geom, wide=32, dual=False, two_phase=False, packet_sort=True,
                      premerge=False, entry_k=packet_trace.ENTRY_K) -> GeomSoA:
    """wide: supernode width of the packet table, 16 or 32. dual: walk
    the table with the dual kernel (K4), which takes 16-wide tables only.
    two_phase, packet_sort: the casts' walk (see GeomSoA); premerge,
    entry_k: the table's build (packet_trace.build_packet_table). All
    four leave a brute-force scene as it is."""
    if dual and wide != 16:
        raise ValueError(f"dual=True needs a 16-wide packet table (wide=16), got wide={wide!r}")
    n_tris = geom.tri_v0.shape[0]
    n_sph = geom.sph_center.shape[0]
    dev = geom.tri_v0.device
    packet = None
    if geom.bvh_count.shape[0]:
        # Few-sphere scenes (typically a lone sphere light in a mesh
        # scene) test spheres OUTSIDE the walk with the brute row tester.
        skip = n_tris if 0 < n_sph <= SPH_BRUTE_MAX else None
        host = [a.cpu().numpy() for a in (
            geom.bvh_bbox_min, geom.bvh_bbox_max, geom.bvh_first, geom.bvh_count,
            geom.bvh_miss, geom.bvh_prim_order, geom.tri_v0, geom.tri_e1,
            geom.tri_e2, geom.sph_center, geom.sph_radius)]
        packet = packet_trace.packet_table_to(
            packet_trace.build_packet_table(*host, leaf_skip_from=skip, wide=wide,
                                            premerge=premerge, entry_k=entry_k), dev)
    z1 = torch.zeros(1, dtype=geom.tri_v0.dtype, device=dev)
    v0 = soa.from_rows(geom.tri_v0)
    e1 = soa.from_rows(geom.tri_e1)
    e2 = soa.from_rows(geom.tri_e2)
    center = soa.from_rows(geom.sph_center) if n_sph else V3(z1, z1.clone(), z1.clone())
    radius = geom.sph_radius if n_sph else torch.ones_like(z1)
    tri, sph = bk.pack_soups(v0, e1, e2, center, radius, n_tris, n_sph)
    table = packet is not None
    return GeomSoA(v0, e1, e2, center, radius, tri, sph, packet, dual=bool(dual) and table,
                   two_phase=bool(two_phase) and table, packet_sort=bool(packet_sort) or not table)


class HitSoA(NamedTuple):
    t: torch.Tensor
    prim_id: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor

    @property
    def valid(self):
        return self.prim_id >= 0


def _per_ray(tfar, n, dev):
    """tfar as an (N,) float32 tensor (the kernels take one per ray)."""
    if isinstance(tfar, torch.Tensor) and tfar.dim():
        return tfar.to(REAL).contiguous()
    return torch.full((n,), float(tfar), dtype=REAL, device=dev)


def intersect_brute_soa(static, g: GeomSoA, org: V3, d: V3, tnear, tfar):
    """Closest hit within [tnear, tfar) over every primitive (K1) and the
    unnormalized geometric normal of the hit primitive. tfar is a scalar
    or an (N,) tensor; a lane with tfar <= tnear runs no test and gets a
    miss (t = BIG, prim -1, normal (0, 0, 1))."""
    tfar = _per_ray(tfar, org.x.shape[0], org.x.device)
    t, prim, u, v, gx, gy, gz = bk.intersect_brute(
        g.tri_soup, g.sph_soup, static.n_tris, static.n_spheres,
        org.x, org.y, org.z, d.x, d.y, d.z, tfar, tnear)
    return HitSoA(t, prim, u, v), V3(gx, gy, gz)


def occluded_brute_soa(static, g: GeomSoA, org: V3, d: V3, tnear, tfar):
    """Any hit within [tnear, tfar) per ray (K2); f32 0/1 mask. tfar is a
    scalar or an (N,) tensor; a lane with tfar <= tnear gives 0."""
    return bk.occluded_brute(
        g.tri_soup, g.sph_soup, static.n_tris, static.n_spheres,
        org.x, org.y, org.z, d.x, d.y, d.z, _per_ray(tfar, org.x.shape[0], org.x.device),
        tnear)


def _sph_outside(static):
    """Few-sphere scenes: spheres ride outside the packet table
    (geom_soa_from_aos built it with leaf_skip_from) and are tested
    brute-force here."""
    return 0 < static.n_spheres <= SPH_BRUTE_MAX


def _merge_spheres_closest(static, g, org, d, tnear, hit: HitSoA, gn):
    """Min-combine the brute sphere tests into a table-walk result.
    hit.t carries tfar on miss, so bounding the sphere window by it
    keeps only strictly closer sphere hits."""
    n = org.x.shape[0]
    ts, sh = bk._sphere_test_rows(g.sph_soup, static.n_spheres, org, d, tnear, hit.t)
    ts = torch.where(sh, ts, BIG)
    i = torch.argmin(ts, dim=0)
    ti = ts[i, torch.arange(n, device=ts.device)]
    closer = ti < hit.t
    c = soa.gather(g.sph_center, i)
    gn_s = (org + d * ti) - c
    return HitSoA(
        torch.where(closer, ti, hit.t),
        torch.where(closer, (static.n_tris + i).to(INT), hit.prim_id),
        torch.where(closer, 0.0, hit.u),
        torch.where(closer, 0.0, hit.v),
    ), soa.where(closer, gn_s, gn)


def _table_n_tris(static):
    """The walk's n_tris argument: the triangle count when spheres ride
    in the table, else None (no sphere branch)."""
    return static.n_tris if static.n_spheres and not _sph_outside(static) else None


def intersect_soa_gn(static, g: GeomSoA, org: V3, d: V3, tnear, tfar=BIG,
                     sort_rays=True, sort_hint=None):
    """Closest hit within [tnear, tfar): (HitSoA, unnormalized geometric
    normal V3), both backends. tfar is a scalar or an (N,) tensor; a lane
    with tfar <= tnear (a retired one) runs no test and comes back a
    miss. A miss has prim -1 (t is BIG from the brute-force kernel, tfar
    from the walk). sort_rays=False skips the packet backend's
    per-dispatch morton/octant sort (callers whose lanes are sorted
    already: the pool-sorted wavefront); sort_hint is _morton_keys'
    hint. The brute-force backend reads neither."""
    if static.use_brute_force:
        return intersect_brute_soa(static, g, org, d, tnear, tfar)
    t, prim, u, v, gn = packet_trace.intersect_packet(
        g.packet, org, d, tnear, tfar, n_tris=_table_n_tris(static),
        sort_rays=sort_rays and g.packet_sort, dual=g.dual, two_phase=g.two_phase,
        sort_hint=sort_hint)
    hit = HitSoA(t, prim, u, v)
    if _sph_outside(static):
        hit, gn = _merge_spheres_closest(static, g, org, d, tnear, hit, gn)
    return hit, gn


def occluded_soa(static, g: GeomSoA, org: V3, d: V3, tnear, tfar):
    """Any hit within [tnear, tfar) per ray; f32 0/1 mask."""
    if static.use_brute_force:
        return occluded_brute_soa(static, g, org, d, tnear, tfar)
    occ = packet_trace.occluded_packet(
        g.packet, org, d, tnear, tfar, n_tris=_table_n_tris(static), sort_rays=g.packet_sort,
        dual=g.dual, two_phase=g.two_phase)
    if _sph_outside(static):
        _, sh = bk._sphere_test_rows(g.sph_soup, static.n_spheres, org, d, tnear, tfar)
        occ = occ | sh.any(dim=0)
    return occ.to(REAL)
