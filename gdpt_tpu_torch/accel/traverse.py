"""Per-ray ray casting: closest-hit and any-hit queries, lane-batched.

Counterpart of gdpt_tpu/accel/traverse.py (replaces Embree's
rtcIntersect1 / rtcOccluded1, reference: src/intersection.cpp:32,83).
The reference writes each query for one ray and vmaps it; here the lane
axis leads: org and d are (N, 3), tnear and tfar scalars or (N,). Two
backends:

- ``*_brute``: every primitive against every lane, (N, T) intermediates;
- ``*_bvh``: the stackless miss-link walk of the flat BVH of accel/bvh.py,
  leaves tested 4-wide. The reference's ``lax.while_loop`` under vmap is
  a masked loop here: every live lane takes the body, and a lane keeps
  its new state only while its own condition holds; the loop ends when
  no lane's holds, one read on the host per iteration (HOST_READS).

The port's integrators cast through accel/traverse_soa.py (the kernels
K1-K4); these walks are their oracle. The scene's Geometry, the hit
record and the brute-force threshold live here, as in the reference.
"""

import math
from typing import NamedTuple

import torch

from gdpt_tpu_torch.core.dtypes import BIG, INT, REAL
from gdpt_tpu_torch.utils import profiling

# Host reads of the BVH walks' loop conditions, by walk.
HOST_READS = profiling.counter_group("traverse.host_reads",
                                     {"intersect_bvh": 0, "occluded_bvh": 0})


class Geometry(NamedTuple):
    """Flattened scene geometry (triangle soup + spheres + BVH). The BVH
    fields (accel/bvh.BVHArrays) stay empty in the brute-force regime."""

    tri_v0: torch.Tensor        # (T, 3)
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_shape_id: torch.Tensor  # (T,)
    sph_center: torch.Tensor    # (S, 3)
    sph_radius: torch.Tensor    # (S,)
    sph_shape_id: torch.Tensor  # (S,)
    bvh_bbox_min: torch.Tensor
    bvh_bbox_max: torch.Tensor
    bvh_first: torch.Tensor
    bvh_count: torch.Tensor
    bvh_miss: torch.Tensor
    bvh_prim_order: torch.Tensor


class Hit(NamedTuple):
    t: torch.Tensor        # distance; tfar when missed
    prim_id: torch.Tensor  # global primitive id; -1 when missed
    u: torch.Tensor        # triangle barycentric u (0 for a sphere)
    v: torch.Tensor        # triangle barycentric v

    @property
    def valid(self):
        return self.prim_id >= 0


def _cross(a, b):
    """jnp.cross's component order on (..., 3) tensors."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _sum3(p):
    """A sum over the last axis of 3, left to right."""
    return p[..., 0] + p[..., 1] + p[..., 2]


def intersect_tri(v0, e1, e2, org, d, tnear, tfar):
    """Moeller-Trumbore over broadcast (..., 3) operands. Returns (t, u,
    v, hit)."""
    pvec = _cross(d, e2)
    det = _sum3(e1 * pvec)
    inv_det = torch.where(det != 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    tvec = org - v0
    u = _sum3(tvec * pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _sum3(d * qvec) * inv_det
    t = _sum3(e2 * qvec) * inv_det
    hit = ((det != 0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= tnear) & (t < tfar))
    return t, u, v, hit


def intersect_sphere(center, radius, org, d, tnear, tfar):
    """Sphere intersection in the closest-approach (impact parameter)
    form, robust in f32 for huge wall spheres. Returns (t, hit)."""
    v = org - center
    a = _sum3(d * d)
    inv_a = 1.0 / torch.where(a != 0, a, 1.0)
    tm = -_sum3(v * d) * inv_a
    m = v + tm[..., None] * d
    disc = radius * radius - _sum3(m * m)
    ok = (disc >= 0.0) & (a != 0)
    dt = torch.sqrt(torch.clamp_min(disc, 0.0) * inv_a)
    t0 = tm - dt
    t1 = tm + dt
    use_lo = (t0 >= tnear) & (t0 < tfar)
    use_hi = (t1 >= tnear) & (t1 < tfar)
    t = torch.where(use_lo, t0, t1)
    return t, ok & (use_lo | use_hi)


def sphere_uv(center, radius, p):
    """Spherical coordinates as uv (reference: src/shapes/sphere.inl:94-101):
    u = azimuth / 2pi, v = elevation / pi, y up. p and center are
    (..., 3), radius has p's leading shape."""
    n = (p - center) / torch.as_tensor(radius)[..., None]
    elevation = torch.arccos(torch.clamp(n[..., 1], -1.0, 1.0))
    azimuth = torch.atan2(n[..., 2], n[..., 0])
    return azimuth / (2.0 * math.pi), elevation / math.pi


def _lanes(x, n, dev):
    """A scalar or (N,) extent as an (N,) float32 tensor."""
    return torch.as_tensor(x, dtype=REAL, device=dev).expand(n)


# --------------------------------------------------------------------------
# Brute force backend
# --------------------------------------------------------------------------

def intersect_brute(geom: Geometry, org, d, tnear, tfar) -> Hit:
    n, dev = org.shape[0], org.device
    tnear = _lanes(tnear, n, dev)
    best_t = _lanes(tfar, n, dev).clone()
    best_prim = torch.full((n,), -1, dtype=INT, device=dev)
    best_u = torch.zeros(n, dtype=REAL, device=dev)
    best_v = torch.zeros(n, dtype=REAL, device=dev)
    lane = torch.arange(n, device=dev)
    n_tri = geom.tri_v0.shape[0]
    o, dd = org[:, None, :], d[:, None, :]
    if n_tri:
        t, u, v, hit = intersect_tri(geom.tri_v0, geom.tri_e1, geom.tri_e2, o, dd,
                                     tnear[:, None], best_t[:, None])
        t = torch.where(hit, t, BIG)
        i = torch.argmin(t, dim=1)
        ti = t[lane, i]
        closer = ti < best_t
        best_t = torch.where(closer, ti, best_t)
        best_prim = torch.where(closer, i.to(INT), best_prim)
        best_u = torch.where(closer, u[lane, i], best_u)
        best_v = torch.where(closer, v[lane, i], best_v)
    if geom.sph_center.shape[0]:
        t, hit = intersect_sphere(geom.sph_center, geom.sph_radius, o, dd, tnear[:, None],
                                  best_t[:, None])
        t = torch.where(hit, t, BIG)
        i = torch.argmin(t, dim=1)
        ti = t[lane, i]
        closer = ti < best_t
        best_t = torch.where(closer, ti, best_t)
        best_prim = torch.where(closer, (n_tri + i).to(INT), best_prim)
    return Hit(best_t, best_prim, best_u, best_v)


def occluded_brute(geom: Geometry, org, d, tnear, tfar):
    """Any hit within [tnear, tfar) per lane (bool)."""
    n, dev = org.shape[0], org.device
    tnear = _lanes(tnear, n, dev)[:, None]
    tfar = _lanes(tfar, n, dev)[:, None]
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    o, dd = org[:, None, :], d[:, None, :]
    if geom.tri_v0.shape[0]:
        hit = intersect_tri(geom.tri_v0, geom.tri_e1, geom.tri_e2, o, dd, tnear, tfar)[3]
        blocked |= hit.any(dim=1)
    if geom.sph_center.shape[0]:
        blocked |= intersect_sphere(geom.sph_center, geom.sph_radius, o, dd, tnear,
                                    tfar)[1].any(dim=1)
    return blocked


# --------------------------------------------------------------------------
# BVH backend
# --------------------------------------------------------------------------

_LEAF_SIZE = 4


def _aabb_hit(bbox_min, bbox_max, org, inv_d, tnear, tfar):
    t0 = (bbox_min - org) * inv_d
    t1 = (bbox_max - org) * inv_d
    t_in = torch.maximum(torch.minimum(t0, t1).amax(dim=-1), tnear)
    t_out = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), tfar)
    return t_in <= t_out


def _test_prim(geom: Geometry, prim, org, d, tnear, tfar):
    """Test one primitive id per lane; returns (t, u, v, hit)."""
    n_tri = geom.tri_v0.shape[0]
    n_sph = geom.sph_center.shape[0]

    def tri():
        tid = torch.clamp(prim, 0, n_tri - 1).long()
        return intersect_tri(geom.tri_v0[tid], geom.tri_e1[tid], geom.tri_e2[tid], org, d,
                             tnear, tfar)

    def sph():
        sid = torch.clamp(prim - n_tri, 0, n_sph - 1).long()
        return intersect_sphere(geom.sph_center[sid], geom.sph_radius[sid], org, d, tnear,
                                tfar)

    if n_tri and n_sph:
        tt, u, v, th = tri()
        ts, sh = sph()
        is_tri = prim < n_tri
        return (torch.where(is_tri, tt, ts), torch.where(is_tri, u, 0.0),
                torch.where(is_tri, v, 0.0), torch.where(is_tri, th, sh))
    if n_tri:
        return tri()
    t, hit = sph()
    return t, torch.zeros_like(t), torch.zeros_like(t), hit


def _masked_loop(cond, body, state, walk, steps=None):
    """lax.while_loop under vmap: body(state) on every lane, the new
    state kept where the lane's cond held; ends when no lane's holds.
    steps: a per-lane count of the bodies each lane kept, or None."""
    while True:
        live = cond(state)
        HOST_READS[walk] += 1
        if not bool(live.any()):
            return state
        new = body(state)
        state = tuple(torch.where(live, a, b) for a, b in zip(new, state))
        if steps is not None:
            steps += live.to(steps.dtype)


def _leaf_prims(geom: Geometry, node):
    """Each lane's leaf primitive slots [first, first + 4), clipped: (N, 4)."""
    slots = geom.bvh_first[node][:, None] + torch.arange(_LEAF_SIZE, dtype=INT,
                                                        device=node.device)
    slots = torch.clamp(slots, 0, geom.bvh_prim_order.shape[0] - 1).long()
    return geom.bvh_prim_order[slots]


def _inv_dir(d):
    return 1.0 / torch.where(d == 0.0, 1e-20, d)


def intersect_bvh(geom: Geometry, org, d, tnear, tfar, count_steps=False):
    """Closest hit of each lane over the BVH; with count_steps=True also
    each lane's steps (int32)."""
    n_nodes = geom.bvh_bbox_min.shape[0]
    n, dev = org.shape[0], org.device
    inv_d = _inv_dir(d)
    tnear = _lanes(tnear, n, dev)

    def cond(state):
        return state[0] < n_nodes

    def body(state):
        node, best_t, best_prim, best_u, best_v = state
        nd = torch.clamp(node, 0, n_nodes - 1).long()
        hit_box = _aabb_hit(geom.bvh_bbox_min[nd], geom.bvh_bbox_max[nd], org, inv_d, tnear,
                            best_t)
        count = geom.bvh_count[nd]
        is_leaf = count > 0
        test_leaf = hit_box & is_leaf
        prims = _leaf_prims(geom, nd)
        for j in range(_LEAF_SIZE):
            t, u, v, hit = _test_prim(geom, prims[:, j], org, d, tnear, best_t)
            take = test_leaf & (j < count) & hit & (t < best_t)
            best_t = torch.where(take, t, best_t)
            best_prim = torch.where(take, prims[:, j], best_prim)
            best_u = torch.where(take, u, best_u)
            best_v = torch.where(take, v, best_v)
        nxt = torch.where(hit_box & ~is_leaf, node + 1, geom.bvh_miss[nd])
        return nxt, best_t, best_prim, best_u, best_v

    zero = torch.zeros(n, dtype=REAL, device=dev)
    state = (torch.zeros(n, dtype=INT, device=dev), _lanes(tfar, n, dev).clone(),
             torch.full((n,), -1, dtype=INT, device=dev), zero, zero)
    steps = torch.zeros(n, dtype=INT, device=dev) if count_steps else None
    _, t, prim, u, v = _masked_loop(cond, body, state, "intersect_bvh", steps)
    hit = Hit(t, prim, u, v)
    return (hit, steps) if count_steps else hit


def occluded_bvh(geom: Geometry, org, d, tnear, tfar, count_steps=False):
    """Any hit of each lane within [tnear, tfar) over the BVH (bool); a
    lane stops at its first blocking primitive. With count_steps=True
    also each lane's steps."""
    n_nodes = geom.bvh_bbox_min.shape[0]
    n, dev = org.shape[0], org.device
    inv_d = _inv_dir(d)
    tnear = _lanes(tnear, n, dev)
    tfar = _lanes(tfar, n, dev)

    def cond(state):
        return (state[0] < n_nodes) & ~state[1]

    def body(state):
        node, blocked = state
        nd = torch.clamp(node, 0, n_nodes - 1).long()
        hit_box = _aabb_hit(geom.bvh_bbox_min[nd], geom.bvh_bbox_max[nd], org, inv_d, tnear,
                            tfar)
        count = geom.bvh_count[nd]
        is_leaf = count > 0
        test_leaf = hit_box & is_leaf
        prims = _leaf_prims(geom, nd)
        for j in range(_LEAF_SIZE):
            hit = _test_prim(geom, prims[:, j], org, d, tnear, tfar)[3]
            blocked = blocked | (test_leaf & (j < count) & hit)
        nxt = torch.where(hit_box & ~is_leaf, node + 1, geom.bvh_miss[nd])
        return nxt, blocked

    state = (torch.zeros(n, dtype=INT, device=dev),
             torch.zeros(n, dtype=torch.bool, device=dev))
    steps = torch.zeros(n, dtype=INT, device=dev) if count_steps else None
    blocked = _masked_loop(cond, body, state, "occluded_bvh", steps)[1]
    return (blocked, steps) if count_steps else blocked


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

# Scenes of at most this many primitives are ray cast by brute force.
BRUTE_FORCE_THRESHOLD = 128


def use_brute_force(n_prims: int) -> bool:
    return n_prims <= BRUTE_FORCE_THRESHOLD


def make_intersect(n_prims: int):
    return intersect_brute if use_brute_force(n_prims) else intersect_bvh


def make_occluded(n_prims: int):
    return occluded_brute if use_brute_force(n_prims) else occluded_bvh
