"""16-wide supernode BVH and its per-lane walk.

Counterpart of gdpt_tpu/accel/super16.py, the reference's ray casting
when its packet table is over its size cap (GDPT_MAX_TABLE_MB); here a
BVH scene's view takes it when the caller sets max_table_mb= and the
packet table is over it (accel/traverse_soa.geom_soa_from_aos).

- ONE unified int32 row table: supernode rows (16 child AABBs + 16 child
  refs) and fat-leaf rows (up to L inline primitives + L prim ids) share
  a single (R, W) table, so every step of the walk is one row gather
  whatever state a lane is in. Geometry rides in it as f32 bits, read
  with a bit view (never a value cast).
- The supernode region is capped at MAX_SUPER_ROWS rows; the leaf size L
  adapts upward (12, 16, 24, 32, 48, 64) until the cap holds.

The walk is a per-lane (node, pending-mask) state machine in lockstep
over the whole ray batch, in plain PyTorch: one row gather per step, 16
box tests, nearest-child-first descent, (node << 16 | pending mask)
pushed on a short per-lane stack (int64 holding the reference's uint32
bits); pops re-gather the node row and re-cull the pending mask against
the updated best t. The loop condition is read on the host every
_UNROLL steps (HOST_READS), and the walk raises RuntimeError if a lane
is still walking at the ceiling of 4 * rows + 256 iterations.
"""

from typing import NamedTuple

import numpy as np
import torch

from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import INT, REAL
from gdpt_tpu_torch.core.soa import V3
from gdpt_tpu_torch.utils import profiling

MAX_SUPER_ROWS = 16384
_EMPTY = np.int32(2**31 - 1)
_DONE = 2**31 - 2
_UNROLL = 2  # steps per host read of the loop condition

# Host reads of the walk's loop condition.
HOST_READS = profiling.counter_group("super16.host_reads", {"super16": 0})
_BITS = torch.tensor([1 << k for k in range(16)], dtype=INT)  # child k's bit


class Super16(NamedTuple):
    # (R, W) int32 unified supernode + leaf rows; geometry as f32 bits.
    table: torch.Tensor
    stack_n: int  # per-lane stack entries: supernode depth + 1
    leaf: int     # L, primitives per leaf row


def super16_to(sup: Super16, device) -> Super16:
    """The same table on `device`."""
    return sup._replace(table=sup.table.to(device))


def build_super16(bvh_bbox_min, bvh_bbox_max, first, count, miss, prim_order,
                  tri_v0, tri_e1, tri_e2, sph_center=None, sph_radius=None,
                  leaf_tris=12, leaf_skip_from=None):
    """Host-side collapse of the binary miss-link BVH into a Super16
    table (numpy in, a CPU tensor out), element for element the
    reference's for the same inputs.

    Spheres (prim ids past the triangle range) occupy a leaf slot as
    [center.xyz, radius, 0...]; the prim id discriminates at test time.
    leaf_skip_from drops primitives with ids from it on out of the leaves
    (few-sphere scenes test their spheres outside the walk). Returns None
    when the supernode cap cannot be met, or when the BVH holds spheres
    and none are given.
    """
    n_nodes = count.shape[0]
    n_tris = tri_v0.shape[0]
    if n_nodes == 0:
        return None
    order = np.asarray(prim_order)
    count = np.asarray(count)
    first = np.asarray(first)
    miss = np.asarray(miss).astype(np.int64)
    bmin = np.asarray(bvh_bbox_min, np.float32)
    bmax = np.asarray(bvh_bbox_max, np.float32)
    v0a = np.asarray(tri_v0, np.float32)
    e1a = np.asarray(tri_e1, np.float32)
    e2a = np.asarray(tri_e2, np.float32)
    if sph_center is not None and np.asarray(sph_center).size:
        sc = np.asarray(sph_center, np.float32).reshape(-1, 3)
        sr = np.asarray(sph_radius, np.float32).reshape(-1)
        sph9 = np.concatenate([sc, sr[:, None], np.zeros((sc.shape[0], 5), np.float32)], axis=1)
        geo9 = np.concatenate([np.concatenate([v0a, e1a, e2a], axis=1), sph9], axis=0)
    else:
        if order.size and order.max(initial=0) >= n_tris:
            return None
        geo9 = np.concatenate([v0a, e1a, e2a], axis=1)
    is_leaf_b = count > 0
    n_prims = order.size

    # Subtree prim ranges: the DFS layout makes each subtree's prims
    # contiguous. pstart[i] = first[first leaf at or after i].
    leaf_first = np.where(is_leaf_b, first.astype(np.int64), np.iinfo(np.int64).max)
    pstart = np.minimum.accumulate(leaf_first[::-1])[::-1]
    pstart = np.append(pstart, n_prims)  # sentinel for miss == n_nodes
    pend = pstart[np.minimum(miss, n_nodes)]
    cnt_sub = pend - pstart[:-1]

    for L in [leaf_tris] + [16, 24, 32, 48, 64]:
        packed = _try_build(bmin, bmax, miss, is_leaf_b, cnt_sub, pstart[:-1], order, geo9,
                            n_nodes, L, leaf_skip_from)
        if packed is not None:
            return packed
    return None


def _try_build(bmin, bmax, miss, is_leaf_b, cnt_sub, pstart, order, geo9, n_nodes, L,
               leaf_skip_from=None):
    # Fat-leaf roots: maximal subtrees with <= L prims, in DFS order.
    fat_of = {}
    fat_ranges = []
    i = 0
    while i < n_nodes:
        if cnt_sub[i] <= L:
            fat_of[i] = len(fat_ranges)
            fat_ranges.append((int(pstart[i]), int(cnt_sub[i])))
            i = int(miss[i])
        else:
            i += 1
    n_fat = len(fat_ranges)

    def children2(b):
        left = b + 1
        return left, int(miss[left])

    def expand16(b):
        """Split the largest internal subtree first until 16 subtrees."""
        frontier = [b]
        while len(frontier) < 16:
            pick, pick_cnt = None, -1
            for idx, x in enumerate(frontier):
                if x not in fat_of and cnt_sub[x] > pick_cnt:
                    pick, pick_cnt = idx, cnt_sub[x]
            if pick is None:
                break
            x = frontier.pop(pick)
            left, right = children2(x)
            frontier[pick:pick] = [left, right]
        return frontier

    if 0 in fat_of:
        # The whole scene fits one fat leaf: one supernode with one child.
        kids_of = [[0]]
        order_q = [None]
        super_of = {}
        max_depth = 1
    else:
        super_of = {}
        order_q = []
        kids_of = []
        queue = [(0, 1)]
        max_depth = 1
        while queue:
            b, depth = queue.pop()
            if b in super_of:
                continue
            super_of[b] = len(order_q)
            order_q.append(b)
            max_depth = max(max_depth, depth)
            ch = expand16(b)
            kids_of.append(ch)
            for c in ch:
                if c not in fat_of:
                    queue.append((c, depth + 1))
        if len(order_q) > MAX_SUPER_ROWS:
            return None

    n_super = len(order_q)
    # The reference pads rows to whole 128-lane registers; so does the port.
    width = max(112, 10 * L)
    width = (width + 127) // 128 * 128
    table = np.zeros((n_super + n_fat, width), np.float32)
    refs = np.full((n_super, 16), _EMPTY, np.int32)
    for si in range(n_super):
        for k, c in enumerate(kids_of[si]):
            table[si, k * 6 + 0: k * 6 + 3] = bmin[c]
            table[si, k * 6 + 3: k * 6 + 6] = bmax[c]
            if c in fat_of:
                # Leaf ref: ~row index into the unified table.
                refs[si, k] = np.int32(~np.int32(n_super + fat_of[c]))
            else:
                refs[si, k] = np.int32(super_of[c])
    table.view(np.int32)[:n_super, 96:112] = refs

    # Fat leaf rows: L inline primitives + prim ids (degenerate padding).
    prim_pad = np.full((n_fat, L), -1, np.int32)
    for fi, (lo, cnt) in enumerate(fat_ranges):
        prims = order[lo: lo + cnt].astype(np.int32)
        if leaf_skip_from is not None:
            # Spheres tested outside the walk (traverse_soa's brute
            # merge): dropped from the leaves, their geo9 rows kept.
            prims = prims[prims < leaf_skip_from]
            cnt = prims.shape[0]
        table[n_super + fi, : cnt * 9] = geo9[prims].reshape(-1)
        prim_pad[fi, :cnt] = prims
    table.view(np.int32)[n_super:, 9 * L: 10 * L] = prim_pad
    return Super16(torch.from_numpy(table.view(np.int32).copy()), max_depth + 1, L)


def inv_dir(d: V3) -> V3:
    """The walks' inverse direction: a zero component becomes 1e-20."""
    return V3(*(1.0 / torch.where(c == 0, 1e-20, c) for c in d))


def slab(bmin, bmax, org, inv, tnear, best_t):
    """The walks' box test, the reference's order of min and max; bmin
    and bmax are per-axis tensors broadcasting against the rays'."""
    t0x = (bmin[0] - org[0]) * inv[0]
    t1x = (bmax[0] - org[0]) * inv[0]
    t0y = (bmin[1] - org[1]) * inv[1]
    t1y = (bmax[1] - org[1]) * inv[1]
    t0z = (bmin[2] - org[2]) * inv[2]
    t1z = (bmax[2] - org[2]) * inv[2]
    t_in = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                         torch.maximum(torch.minimum(t0z, t1z), tnear))
    t_out = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                          torch.minimum(torch.maximum(t0z, t1z), best_t))
    return t_in, t_in <= t_out


def tri_slots(v0: V3, e1: V3, e2: V3, org: V3, d: V3, tnear, tfar):
    """Moeller-Trumbore of each lane against its (N, K) leaf slots; org,
    d, tnear and tfar are (N, 1). Returns (t, u, v, hit)."""
    pvec = soa.cross(d, e2)
    det = soa.dot(e1, pvec)
    inv = torch.where(det != 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    tvec = org - v0
    u = soa.dot(tvec, pvec) * inv
    qvec = soa.cross(tvec, e1)
    v = soa.dot(d, qvec) * inv
    t = soa.dot(e2, qvec) * inv
    hit = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= tnear) & (t < tfar)
    return t, u, v, hit


def sphere_slots(c: V3, r, org: V3, d: V3, tnear, tfar):
    """The stable closest-approach roots of each lane's sphere slots:
    (t, hit)."""
    vv = org - c
    a = soa.dot(d, d)
    inv_a = 1.0 / torch.where(a != 0, a, 1.0)
    tm = -soa.dot(d, vv) * inv_a
    mm = vv + d * tm
    disc = r * r - soa.dot(mm, mm)
    dtq = torch.sqrt(torch.clamp_min(disc, 0.0) * inv_a)
    t0 = tm - dtq
    t1 = tm + dtq
    use_lo = (t0 >= tnear) & (t0 < tfar)
    use_hi = (t1 >= tnear) & (t1 < tfar)
    return torch.where(use_lo, t0, t1), (disc >= 0) & (a != 0) & (use_lo | use_hi)


def first_least(t, hit, best_t):
    """The winner of a leaf's (N, K) slots. The reference tests them one
    after another, each against the best t so far; the winner is the
    first slot of the least t below the best t on entry, as a slot's t
    does not depend on the best t and the strict < keeps the first of
    equal minima. Returns (take (N,), slot (N, 1), its t)."""
    cand = torch.where(hit, t, float("inf"))
    j = torch.argmin(cand, dim=1, keepdim=True)
    tj = torch.gather(cand, 1, j)[:, 0]
    return tj < best_t, j, tj


def pick(x, j):
    """Each lane's slot j of x (N, K)."""
    return torch.gather(x, 1, j)[:, 0]


def _box_hits(rowf, row, org, inv, tnear, best_t):
    """The 16 slab tests of each lane's row: (hit bits int32, t_in (N, 16)
    with inf where the child is not hit)."""
    box = rowf[:, :96].reshape(-1, 16, 6)
    t_in, hit = slab(box[:, :, 0:3].unbind(2), box[:, :, 3:6].unbind(2),
                     [c[:, None] for c in org], [c[:, None] for c in inv], tnear[:, None],
                     best_t[:, None])
    ok = hit & (row[:, 96:112] != int(_EMPTY))
    bits = (ok.to(INT) * _BITS.to(row.device)).sum(dim=1, dtype=INT)
    return bits, torch.where(ok, t_in, float("inf"))


def _leaf_tests(rowf, row, L, org, d, tnear, s, is_leaf, n_tris):
    """Test each lane's row as up to L inline primitives (all at once,
    first_least) and update its best hit in s. A slot holds a triangle
    (v0, e1, e2) unless its prim id is past the triangle range, when it
    holds a sphere (center, radius)."""
    geo = rowf[:, :9 * L].reshape(-1, L, 9)
    v0 = V3(geo[:, :, 0], geo[:, :, 1], geo[:, :, 2])
    e1 = V3(geo[:, :, 3], geo[:, :, 4], geo[:, :, 5])
    e2 = V3(geo[:, :, 6], geo[:, :, 7], geo[:, :, 8])
    prim = row[:, 9 * L: 10 * L]
    o = V3(*(c[:, None] for c in org))
    dd = V3(*(c[:, None] for c in d))
    tn, bt = tnear[:, None], s["t"][:, None]
    live = (prim >= 0) & is_leaf[:, None]
    t, u, v, hit = tri_slots(v0, e1, e2, o, dd, tn, bt)
    hit = hit & live
    gn = soa.cross(e1, e2)
    if n_tris is not None:
        is_sph = prim >= n_tris
        ts, hit_s = sphere_slots(v0, e1.x, o, dd, tn, bt)  # center in v0, radius in e1.x
        gns = (o + dd * ts) - v0
        t = torch.where(is_sph, ts, t)
        hit = torch.where(is_sph, hit_s & live, hit)
        u = torch.where(is_sph, 0.0, u)
        v = torch.where(is_sph, 0.0, v)
        gn = soa.where(is_sph, gns, gn)
    take, j, tj = first_least(t, hit, s["t"])
    s["t"] = torch.where(take, tj, s["t"])
    s["prim"] = torch.where(take, pick(prim, j), s["prim"])
    s["u"] = torch.where(take, pick(u, j), s["u"])
    s["v"] = torch.where(take, pick(v, j), s["v"])
    for k, c in zip(("gnx", "gny", "gnz"), gn):
        s[k] = torch.where(take, pick(c, j), s[k])


def _step(sup: Super16, org, d, inv, tnear, any_hit, n_tris, s):
    """One step of every lane (s updated in place)."""
    cur = s["cur"]
    done = cur == _DONE
    is_super = (cur >= 0) & ~done
    is_leaf = cur < 0
    row_idx = torch.where(is_super, cur, torch.where(is_leaf, ~cur, 0))
    row = sup.table[row_idx.clamp(0, sup.table.shape[0] - 1).long()]
    rowf = row.view(torch.float32)

    fresh_bits, t_ins = _box_hits(rowf, row, org, inv, tnear, s["t"])
    # pend == 0 is a fresh visit (every child allowed); a pop carries the
    # stored pending mask, re-culled by the fresh test (best t has
    # tightened since the push).
    pend = s["pend"]
    allowed = torch.where(pend != 0, pend, 0xFFFF)
    eff = torch.where(is_super, fresh_bits & allowed, 0)

    _leaf_tests(rowf, row, sup.leaf, org, d, tnear, s, is_leaf, n_tris)

    # Nearest first: the lowest t_in among the effective children, ties
    # to the lowest bit.
    on = (eff[:, None] & _BITS.to(eff.device)) != 0
    t_on = torch.where(on, t_ins, float("inf"))
    tmin = t_on.amin(dim=1, keepdim=True)
    first = on & (t_ins == tmin)
    k = torch.argmax(first.to(torch.uint8), dim=1, keepdim=True)
    chosen = torch.where(first.any(dim=1), torch.bitwise_left_shift(
        torch.ones_like(eff), k[:, 0].to(INT)), 0)
    child_ref = torch.where(chosen != 0, torch.gather(row[:, 96:112], 1, k)[:, 0],
                            int(_EMPTY))
    rest = eff ^ chosen

    descend = is_super & (eff != 0)
    do_push = descend & (rest != 0)
    do_pop = ~done & ~descend
    if any_hit:
        # A shadow query: the first accepted hit finishes the lane.
        finish = (s["prim"] >= 0) & ~done
        descend = descend & ~finish
        do_push = do_push & ~finish
        do_pop = do_pop & ~finish
    sp = s["sp"]
    stack = s["stack"]
    stack_n = stack.shape[0]
    pushed = ((cur.to(torch.int64) << 16) | rest.to(torch.int64)) & 0xFFFFFFFF
    slot = sp.clamp(0, stack_n - 1).long()[None]
    write = do_push & (sp < stack_n)
    stack.scatter_(0, slot, torch.where(write, pushed, stack.gather(0, slot)[0])[None])
    sp = sp + do_push.to(INT)
    top = (sp - 1).clamp(0, stack_n - 1).long()[None]
    popped = torch.where(do_pop & (sp >= 1) & (sp <= stack_n), stack.gather(0, top)[0], 0)
    can_pop = do_pop & (sp > 0)
    sp = sp - can_pop.to(INT)
    pop_node = (popped >> 16).to(INT)
    pop_mask = (popped & 0xFFFF).to(INT)

    new_cur = torch.where(descend, child_ref,
                          torch.where(can_pop, pop_node, torch.where(done, cur, _DONE)))
    new_pend = torch.where(descend, 0, torch.where(can_pop, pop_mask, 0))
    if any_hit:
        new_cur = torch.where(finish, _DONE, new_cur)
        new_pend = torch.where(finish, 0, new_pend)
    s.update(cur=new_cur.to(INT), pend=new_pend.to(INT), sp=sp)
    if "steps" in s:
        s["steps"] = s["steps"] + (~done).to(INT)


def _traverse(sup: Super16, org: V3, d: V3, tnear, tfar, any_hit, n_tris=None,
              count_steps=False):
    n, dev = org.x.shape[0], org.x.device
    inv = inv_dir(d)
    tnear = torch.as_tensor(tnear, dtype=REAL, device=dev).expand(n)
    zero = torch.zeros(n, dtype=REAL, device=dev)
    s = dict(
        cur=torch.zeros(n, dtype=INT, device=dev),
        pend=torch.zeros(n, dtype=INT, device=dev),
        sp=torch.zeros(n, dtype=INT, device=dev),
        stack=torch.zeros((sup.stack_n, n), dtype=torch.int64, device=dev),
        t=torch.as_tensor(tfar, dtype=REAL, device=dev).expand(n).clone(),
        prim=torch.full((n,), -1, dtype=INT, device=dev),
        u=zero, v=zero, gnx=zero, gny=zero, gnz=zero + 1.0,
    )
    if count_steps:
        s["steps"] = torch.zeros(n, dtype=INT, device=dev)
    # The iteration ceiling: a correct walk visits O(table rows) rows; a
    # lane still walking there is an error, not a miss.
    ceiling = 4 * int(sup.table.shape[0]) + 256
    it = 0
    while it < ceiling:
        HOST_READS["super16"] += 1
        if not bool((s["cur"] != _DONE).any()):
            break
        for _ in range(_UNROLL):
            _step(sup, org, d, inv, tnear, any_hit, n_tris, s)
        it += _UNROLL
    stuck = int((s["cur"] != _DONE).sum())
    if stuck:
        raise RuntimeError(f"super16 walk: {stuck} of {n} lanes still walking after the "
                           f"ceiling of {ceiling} iterations")
    return s


def intersect_super16(sup: Super16, org: V3, d: V3, tnear, tfar, n_tris=None):
    """Closest hit. Returns (t, prim, u, v, gn V3); a miss keeps t = tfar,
    prim -1 and gn (0, 0, 1). n_tris enables sphere slots when the scene
    mixes spheres into the table."""
    s = _traverse(sup, org, d, tnear, tfar, any_hit=False, n_tris=n_tris)
    return s["t"], s["prim"], s["u"], s["v"], V3(s["gnx"], s["gny"], s["gnz"])


def occluded_super16(sup: Super16, org: V3, d: V3, tnear, tfar, n_tris=None):
    """Any hit within [tnear, tfar) per lane (bool)."""
    return _traverse(sup, org, d, tnear, tfar, any_hit=True, n_tris=n_tris)["prim"] >= 0


def traversal_steps(sup: Super16, org: V3, d: V3, tnear, tfar, n_tris=None, any_hit=False):
    """Each lane's steps (int32) until it is done."""
    return _traverse(sup, org, d, tnear, tfar, any_hit=any_hit, n_tris=n_tris,
                     count_steps=True)["steps"]
