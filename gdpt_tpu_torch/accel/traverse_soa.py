"""Batched (SoA) ray casting dispatch — replaces Embree's
rtcIntersect1/rtcOccluded1 (reference: src/intersection.cpp:32,83).

Counterpart of gdpt_tpu/accel/traverse_soa.py. All ray state lives in
(N,) component tensors. Backends, chosen per scene at build time:

- brute force (at most 128 primitives): the K1/K2 wrappers of
  accel/brute_kernels.py;
- packet table (every larger scene, by default): the BVH walk of
  accel/packet_kernels.py over the table of accel/packet_trace.py: K3,
  or K4 (the dual walk) when the scene's view was built 16-wide with
  dual=True; with two_phase=True casts of 4,096 rays or more take the
  two-phase entry traversal (packet_trace.trace_two_phase) over the same
  kernels, and packet_sort=False turns off every cast's ray sort.
- the reference's XLA walks, in plain PyTorch, each taken only when the
  view is built for it: super16 (accel/super16.py) when max_table_mb=
  is set and the packet table is over it; without a table
  (packet=False, or super16 over its own cap) the packed walk
  (intersect_bvh_packed over bvh_nodes48, one row gather a step) on a
  BVH of triangles only, else the per-lane walk (intersect_bvh_soa).

Each kernel wrapper launches its hand-written CUDA kernel for CUDA
tensors and takes its plain PyTorch version for CPU tensors. The packet
table lives in device memory, with no size cap unless max_table_mb=
sets the reference's.

Few-sphere scenes (<= SPH_BRUTE_MAX) keep spheres out of the packet and
super16 tables and brute-merge them after the walk; the other walks
test them in the BVH.
"""

from typing import NamedTuple

import torch

import numpy as np

from gdpt_tpu_torch.accel import brute_kernels as bk
from gdpt_tpu_torch.accel import packet_trace
from gdpt_tpu_torch.accel import super16 as s16
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.utils import profiling

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
    # The XLA walks' tables, each built only for the view whose casts
    # read it, None otherwise: the BVH arrays (the per-lane walk), the
    # packed (n_nodes, 48) table (a BVH of triangles only: bmin.xyz,
    # bmax.xyz, miss and is_leaf as bits, 4 x (v0, e1, e2) inline leaf
    # triangles and 4 prim ids as bits; one row gather a step) and the
    # super16 table (accel/super16.Super16).
    bvh_bmin: V3 = None
    bvh_bmax: V3 = None
    bvh_first: torch.Tensor = None
    bvh_count: torch.Tensor = None
    bvh_miss: torch.Tensor = None
    bvh_prim_order: torch.Tensor = None
    bvh_nodes48: torch.Tensor = None
    sup16: object = None


_LEAF_W = 4  # prims per packed leaf row (== the BVH build's leaf size)


def _pack_bvh(geom):
    """Host-side packing of the miss-link BVH into one row-gatherable
    float32 table (numpy in, a CPU tensor out), bit for bit the
    reference's bvh_nodes48; None when the BVH holds a sphere."""
    n_nodes = geom.bvh_count.shape[0]
    n_tris = geom.tri_v0.shape[0]
    if n_nodes == 0:
        return None
    order = geom.bvh_prim_order.cpu().numpy()
    if order.size and order.max(initial=0) >= n_tris:
        return None  # spheres in the BVH: the per-lane walk tests them
    count = geom.bvh_count.cpu().numpy()
    first = geom.bvh_first.cpu().numpy()
    miss = geom.bvh_miss.cpu().numpy().astype(np.int32)
    bmin = geom.bvh_bbox_min.cpu().numpy().astype(np.float32)
    bmax = geom.bvh_bbox_max.cpu().numpy().astype(np.float32)

    leaf_mask = count > 0
    is_leaf = leaf_mask.astype(np.int32)
    j = np.arange(_LEAF_W)[None, :]
    valid = (j < count[:, None]) & leaf_mask[:, None]
    slots = np.clip(first[:, None] + j, 0, max(order.size - 1, 0))
    prim = np.where(valid, order[slots] if order.size else 0, -1).astype(np.int32)
    pv = np.clip(prim, 0, max(n_tris - 1, 0))
    # A degenerate triangle in padded and inner slots: det == 0, no hit.
    z = (~valid)[..., None]
    v0, e1, e2 = (np.where(z, 0.0, a.cpu().numpy().astype(np.float32)[pv])
                  for a in (geom.tri_v0, geom.tri_e1, geom.tri_e2))
    tri36 = np.concatenate([v0, e1, e2], axis=2).reshape(n_nodes, _LEAF_W * 9)
    nodes48 = np.concatenate(
        [bmin, bmax, miss.view(np.float32)[:, None], is_leaf.view(np.float32)[:, None],
         tri36, prim.view(np.float32)], axis=1).astype(np.float32)
    return torch.from_numpy(nodes48)


def refuse_without_table(**switches):
    """ValueError if a switch that acts on the packet table is on (given
    as name=on; packet_sort=True means packet_sort=False was asked for)
    for a BVH scene whose view has no table: packet=False, or the table
    over max_table_mb. The port ignores no switch quietly."""
    on = [k + ("=False" if k == "packet_sort" else "") for k, v in switches.items() if v]
    if on:
        raise ValueError(f"{', '.join(on)} act on the packet table, which this view does not "
                         f"have (packet=False, or a table over max_table_mb)")


def geom_soa_from_aos(geom, wide=32, dual=False, two_phase=False, packet_sort=True,
                      premerge=False, entry_k=packet_trace.ENTRY_K, packet=True,
                      max_table_mb=None) -> GeomSoA:
    """wide: supernode width of the packet table, 16 or 32. dual: walk
    the table with the dual kernel (K4), which takes 16-wide tables only.
    two_phase, packet_sort: the casts' walk (see GeomSoA); premerge,
    entry_k: the table's build (packet_trace.build_packet_table). All
    four leave a brute-force scene as it is.

    packet=False (the reference's GDPT_PACKET=0) builds no packet table:
    the casts take the packed walk, or the per-lane walk where the BVH
    holds spheres. max_table_mb (GDPT_MAX_TABLE_MB): a packet table of
    more MiB is not built and the casts walk super16 instead (None: no
    cap). On a BVH scene left without a packet table, dual, two_phase
    and packet_sort=False raise ValueError (refuse_without_table)."""
    if dual and wide != 16:
        raise ValueError(f"dual=True needs a 16-wide packet table (wide=16), got wide={wide!r}")
    n_tris = geom.tri_v0.shape[0]
    n_sph = geom.sph_center.shape[0]
    dev = geom.tri_v0.device
    table = sup = None
    walks = {}
    if geom.bvh_count.shape[0]:
        # Few-sphere scenes (typically a lone sphere light in a mesh
        # scene) test spheres OUTSIDE the tables with the brute row tester.
        skip = n_tris if 0 < n_sph <= SPH_BRUTE_MAX else None
        host = [a.cpu().numpy() for a in (
            geom.bvh_bbox_min, geom.bvh_bbox_max, geom.bvh_first, geom.bvh_count,
            geom.bvh_miss, geom.bvh_prim_order, geom.tri_v0, geom.tri_e1,
            geom.tri_e2, geom.sph_center, geom.sph_radius)]
        if packet:
            table = packet_trace.build_packet_table(
                *host, leaf_skip_from=skip, wide=wide, premerge=premerge, entry_k=entry_k,
                max_bytes=None if max_table_mb is None else int(max_table_mb) << 20)
            if table is None:
                sup = s16.build_super16(*host, leaf_skip_from=skip)
        if table is None and sup is None:
            nodes48 = _pack_bvh(geom)
            walks = dict(
                bvh_bmin=soa.from_rows(geom.bvh_bbox_min),
                bvh_bmax=soa.from_rows(geom.bvh_bbox_max), bvh_first=geom.bvh_first,
                bvh_count=geom.bvh_count, bvh_miss=geom.bvh_miss,
                bvh_prim_order=geom.bvh_prim_order,
                bvh_nodes48=None if nodes48 is None else nodes48.to(dev))
        if table is None:
            refuse_without_table(packet_dual=dual, two_phase=two_phase,
                                 packet_sort=not packet_sort)
    z1 = torch.zeros(1, dtype=geom.tri_v0.dtype, device=dev)
    v0 = soa.from_rows(geom.tri_v0)
    e1 = soa.from_rows(geom.tri_e1)
    e2 = soa.from_rows(geom.tri_e2)
    center = soa.from_rows(geom.sph_center) if n_sph else V3(z1, z1.clone(), z1.clone())
    radius = geom.sph_radius if n_sph else torch.ones_like(z1)
    tri, sph = bk.pack_soups(v0, e1, e2, center, radius, n_tris, n_sph)
    if table is not None:
        table = packet_trace.packet_table_to(table, dev)
    has = table is not None
    return GeomSoA(v0, e1, e2, center, radius, tri, sph, table, dual=bool(dual) and has,
                   two_phase=bool(two_phase) and has, packet_sort=bool(packet_sort) or not has,
                   sup16=None if sup is None else s16.super16_to(sup, dev), **walks)


class HitSoA(NamedTuple):
    t: torch.Tensor
    prim_id: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor

    @property
    def valid(self):
        return self.prim_id >= 0


# ---------------------------------------------------------------------------
# The reference's XLA BVH walks, in plain PyTorch
# ---------------------------------------------------------------------------

# Host reads of the walks' loop conditions, by walk.
HOST_READS = profiling.counter_group("traverse_soa.host_reads",
                                     {"intersect_bvh_soa": 0, "intersect_bvh_packed": 0})


def _lanes(x, n, dev):
    """A scalar or (N,) extent as an (N,) float32 tensor."""
    return torch.as_tensor(x, dtype=REAL, device=dev).expand(n)


def _test_prim_soa(static, g: GeomSoA, prim, org: V3, d: V3, tnear, tfar):
    """Each lane against its (N, K) primitive ids: (t, u, v, hit)."""
    n_tri, n_sph = static.n_tris, static.n_spheres
    o, dd = V3(*(c[:, None] for c in org)), V3(*(c[:, None] for c in d))
    tn, tf = tnear[:, None], tfar[:, None]
    zero = torch.zeros_like(prim, dtype=REAL)

    def tri():
        tid = prim.clamp(0, max(n_tri - 1, 0))
        return s16.tri_slots(soa.gather(g.tri_v0, tid), soa.gather(g.tri_e1, tid),
                             soa.gather(g.tri_e2, tid), o, dd, tn, tf)

    def sph():
        sid = (prim - n_tri).clamp(0, max(n_sph - 1, 0))
        return s16.sphere_slots(soa.gather(g.sph_center, sid), soa.take(g.sph_radius, sid),
                                o, dd, tn, tf)

    if n_tri and n_sph:
        tt, u, v, th = tri()
        ts, sh = sph()
        is_tri = prim < n_tri
        return (torch.where(is_tri, tt, ts), torch.where(is_tri, u, zero),
                torch.where(is_tri, v, zero), torch.where(is_tri, th, sh))
    if n_tri:
        return tri()
    t, hit = sph()
    return t, zero, zero, hit


def intersect_bvh_soa(static, g: GeomSoA, org: V3, d: V3, tnear, tfar, count_steps=False):
    """The per-lane miss-link walk over the BVH arrays, every lane one
    node a step in lockstep, the loop condition read every step; serves
    BVHs that hold spheres. A miss keeps t = tfar and prim -1. With
    count_steps=True also each lane's steps (int32)."""
    n, dev = org.x.shape[0], org.x.device
    n_nodes = g.bvh_count.shape[0]
    inv = s16.inv_dir(d)
    tnear = _lanes(tnear, n, dev)
    node = torch.zeros(n, dtype=INT, device=dev)
    best_t = _lanes(tfar, n, dev).clone()
    best_prim = torch.full((n,), -1, dtype=INT, device=dev)
    best_u = torch.zeros(n, dtype=REAL, device=dev)
    best_v = torch.zeros_like(best_u)
    steps = torch.zeros(n, dtype=INT, device=dev)
    order_max = g.bvh_prim_order.shape[0] - 1
    lanes_j = torch.arange(_LEAF_W, dtype=INT, device=dev)
    while True:
        active = node < n_nodes
        HOST_READS["intersect_bvh_soa"] += 1
        if not bool(active.any()):
            break
        nd = torch.clamp_max(node, n_nodes - 1)
        bmin, bmax = soa.gather(g.bvh_bmin, nd), soa.gather(g.bvh_bmax, nd)
        hit_box = s16.slab(bmin, bmax, org, inv, tnear, best_t)[1]
        count = soa.take(g.bvh_count, nd)
        is_leaf = count > 0
        test_leaf = active & hit_box & is_leaf
        slots = (soa.take(g.bvh_first, nd)[:, None] + lanes_j).clamp(0, order_max)
        prim = soa.take(g.bvh_prim_order, slots)
        t, u, v, hit = _test_prim_soa(static, g, prim, org, d, tnear, best_t)
        take, j, tj = s16.first_least(
            t, hit & test_leaf[:, None] & (lanes_j < count[:, None]), best_t)
        best_t = torch.where(take, tj, best_t)
        best_prim = torch.where(take, s16.pick(prim, j), best_prim)
        best_u = torch.where(take, s16.pick(u, j), best_u)
        best_v = torch.where(take, s16.pick(v, j), best_v)
        nxt = torch.where(hit_box & ~is_leaf, nd + 1, soa.take(g.bvh_miss, nd))
        node = torch.where(active, nxt, node)
        steps += active.to(INT)
    hit = HitSoA(best_t, best_prim, best_u, best_v)
    return (hit, steps) if count_steps else hit


_UNROLL_PACKED = 4  # steps of the packed walk per host read


def intersect_bvh_packed(static, g: GeomSoA, org: V3, d: V3, tnear, tfar, count_steps=False):
    """The packed stackless walk: ONE (N, 48) row gather a step (node box,
    links and the leaf's 4 triangles inline), 4 steps per read of the loop
    condition. Returns (HitSoA, unnormalized geometric normal V3); a miss
    keeps t = tfar, prim -1 and the normal (0, 0, 1). With
    count_steps=True also each lane's steps (int32)."""
    n, dev = org.x.shape[0], org.x.device
    n_nodes = g.bvh_nodes48.shape[0]
    inv = s16.inv_dir(d)
    tnear = _lanes(tnear, n, dev)
    zero = torch.zeros(n, dtype=REAL, device=dev)
    node = torch.zeros(n, dtype=INT, device=dev)
    best_t = _lanes(tfar, n, dev).clone()
    best_prim = torch.full((n,), -1, dtype=INT, device=dev)
    best_u, best_v, gnx, gny, gnz = zero, zero, zero, zero, zero + 1.0
    steps = torch.zeros(n, dtype=INT, device=dev)
    o, dd = V3(*(c[:, None] for c in org)), V3(*(c[:, None] for c in d))
    while True:
        HOST_READS["intersect_bvh_packed"] += 1
        if not bool((node < n_nodes).any()):
            break
        for _ in range(_UNROLL_PACKED):
            active = node < n_nodes
            nd = torch.clamp_max(node, n_nodes - 1).long()
            row = g.bvh_nodes48[nd]
            bits = row.view(INT)
            hit_box = s16.slab(row[:, 0:3].unbind(1), row[:, 3:6].unbind(1), org, inv,
                               tnear, best_t)[1]
            miss_link = bits[:, 6]
            is_leaf = bits[:, 7] != 0
            test_leaf = active & hit_box & is_leaf
            tri = row[:, 8:8 + _LEAF_W * 9].reshape(n, _LEAF_W, 9)
            v0, e1, e2 = (V3(tri[:, :, k], tri[:, :, k + 1], tri[:, :, k + 2])
                          for k in (0, 3, 6))
            prim = bits[:, 8 + _LEAF_W * 9:]
            t, u, v, hit = s16.tri_slots(v0, e1, e2, o, dd, tnear[:, None], best_t[:, None])
            take, j, tj = s16.first_least(t, hit & (prim >= 0) & test_leaf[:, None], best_t)
            gn = soa.cross(e1, e2)
            best_prim = torch.where(take, s16.pick(prim, j), best_prim)
            best_u = torch.where(take, s16.pick(u, j), best_u)
            best_v = torch.where(take, s16.pick(v, j), best_v)
            gnx = torch.where(take, s16.pick(gn.x, j), gnx)
            gny = torch.where(take, s16.pick(gn.y, j), gny)
            gnz = torch.where(take, s16.pick(gn.z, j), gnz)
            best_t = torch.where(take, tj, best_t)
            nxt = torch.where(hit_box & ~is_leaf, nd.to(INT) + 1, miss_link)
            node = torch.where(active, nxt, node)
            steps += active.to(INT)
    out = HitSoA(best_t, best_prim, best_u, best_v), V3(gnx, gny, gnz)
    return (*out, steps) if count_steps else out


def occluded_bvh_soa(static, g: GeomSoA, org: V3, d: V3, tnear, tfar):
    """Any hit within [tnear, tfar) per lane (bool): the closest-hit walk
    of the view's table, as the reference's."""
    if g.bvh_nodes48 is not None:
        hit, _ = intersect_bvh_packed(static, g, org, d, tnear, tfar)
    else:
        hit = intersect_bvh_soa(static, g, org, d, tnear, tfar)
    return hit.prim_id >= 0


def _hit_normal(static, g: GeomSoA, org: V3, d: V3, hit: HitSoA) -> V3:
    """The unnormalized geometric normal of each lane's hit primitive,
    where the reference's shading rebuilds it after the per-lane walk
    (gn_raw None): e1 x e2 of a triangle, (org + d t) - center of a
    sphere, (0, 0, 1) on a miss."""
    prim = hit.prim_id
    gn = None
    if static.n_tris:
        tid = prim.clamp(0, static.n_tris - 1)
        gn = soa.cross(soa.gather(g.tri_e1, tid), soa.gather(g.tri_e2, tid))
    if static.n_spheres:
        sid = (prim - static.n_tris).clamp(0, static.n_spheres - 1)
        gs = (org + d * hit.t) - soa.gather(g.sph_center, sid)
        gn = gs if gn is None else soa.where(prim >= static.n_tris, gs, gn)
    zero = torch.zeros_like(hit.t)
    return soa.where(prim >= 0, gn, V3(zero, zero, zero + 1.0))


def _per_ray(tfar, n, dev):
    """tfar as an (N,) float32 tensor (the kernels take one per ray)."""
    if isinstance(tfar, torch.Tensor) and tfar.dim():
        return tfar.to(REAL).contiguous()
    return torch.full((n,), float(tfar), dtype=REAL, device=dev)


def intersect_brute_soa(static, g: GeomSoA, org: V3, d: V3, tnear, tfar):
    """Closest hit within [tnear, tfar) over every primitive (K1) and the
    unnormalized geometric normal of the hit primitive. tnear and tfar
    are scalars or (N,) tensors; a lane with tfar <= tnear runs no test
    and gets a miss (t = BIG, prim -1, normal (0, 0, 1))."""
    tfar = _per_ray(tfar, org.x.shape[0], org.x.device)
    t, prim, u, v, gx, gy, gz = bk.intersect_brute(
        g.tri_soup, g.sph_soup, static.n_tris, static.n_spheres,
        org.x, org.y, org.z, d.x, d.y, d.z, tfar, tnear)
    return HitSoA(t, prim, u, v), V3(gx, gy, gz)


def occluded_brute_soa(static, g: GeomSoA, org: V3, d: V3, tnear, tfar):
    """Any hit within [tnear, tfar) per ray (K2); f32 0/1 mask. tnear and
    tfar are scalars or (N,) tensors; a lane with tfar <= tnear gives 0."""
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


@profiling.span("cast.closest")
def intersect_soa_gn(static, g: GeomSoA, org: V3, d: V3, tnear, tfar=BIG,
                     sort_rays=True, sort_hint=None):
    """Closest hit within [tnear, tfar): (HitSoA, unnormalized geometric
    normal V3), every backend. tfar is a scalar or an (N,) tensor; a lane
    with tfar <= tnear (a retired one) comes back a miss. A miss has prim
    -1 (t is BIG from the brute-force kernel, tfar from the walks) and
    the normal (0, 0, 1). sort_rays=False skips the packet backend's
    per-dispatch morton/octant sort (callers whose lanes are sorted
    already: the pool-sorted wavefront); sort_hint is _morton_keys'
    hint. The brute-force backend reads neither. Every call is the
    program span cast.closest (utils/profiling)."""
    if static.use_brute_force:
        return intersect_brute_soa(static, g, org, d, tnear, tfar)
    if g.packet is not None:
        t, prim, u, v, gn = packet_trace.intersect_packet(
            g.packet, org, d, tnear, tfar, n_tris=_table_n_tris(static),
            sort_rays=sort_rays and g.packet_sort, dual=g.dual, two_phase=g.two_phase,
            sort_hint=sort_hint)
    elif g.sup16 is not None:
        t, prim, u, v, gn = s16.intersect_super16(g.sup16, org, d, tnear, tfar,
                                                  n_tris=_table_n_tris(static))
    elif g.bvh_nodes48 is not None:
        return intersect_bvh_packed(static, g, org, d, tnear, tfar)
    else:
        hit = intersect_bvh_soa(static, g, org, d, tnear, tfar)
        return hit, _hit_normal(static, g, org, d, hit)
    hit = HitSoA(t, prim, u, v)
    if _sph_outside(static):
        hit, gn = _merge_spheres_closest(static, g, org, d, tnear, hit, gn)
    return hit, gn


@profiling.span("cast.shadow")
def occluded_soa(static, g: GeomSoA, org: V3, d: V3, tnear, tfar):
    """Any hit within [tnear, tfar) per ray; f32 0/1 mask. Every call is
    the program span cast.shadow (utils/profiling)."""
    if static.use_brute_force:
        return occluded_brute_soa(static, g, org, d, tnear, tfar)
    if g.packet is not None:
        occ = packet_trace.occluded_packet(
            g.packet, org, d, tnear, tfar, n_tris=_table_n_tris(static),
            sort_rays=g.packet_sort, dual=g.dual, two_phase=g.two_phase)
    elif g.sup16 is not None:
        occ = s16.occluded_super16(g.sup16, org, d, tnear, tfar, n_tris=_table_n_tris(static))
    else:
        return occluded_bvh_soa(static, g, org, d, tnear, tfar).to(REAL)
    if _sph_outside(static):
        _, sh = bk._sphere_test_rows(g.sph_soup, static.n_spheres, org, d, tnear, tfar)
        occ = occ | sh.any(dim=0)
    return occ.to(REAL)
