"""Packet BVH table and ray casting over it.

Counterpart of gdpt_tpu/accel/packet_trace.py (replaces Embree's
rtcIntersect1/rtcOccluded1, reference: src/intersection.cpp:32,83) for
scenes above the brute-force limit. This module holds the host half:
the collapse of the binary miss-link BVH (accel/bvh.py) into the wide
table, the ray sort, the dead-lane and non-finite conventions, the hit
attributes, and the reference's opt-in two-phase entry traversal
(trace_two_phase: the table's entry subtrees walked one at a time from a
start ref per ray). The walk itself is kernel K3, or on a 16-wide table
and on request the dual kernel K4, in accel/packet_kernels.py
(hand-written CUDA for CUDA tensors, the plain PyTorch versions for CPU
tensors).

The table lives in device memory and is read through the cache; there
is no size cap unless the caller sets one (max_bytes, the reference's
GDPT_MAX_TABLE_MB). Its width (16 or 32 children per supernode) is a build
argument, recorded in ``PacketTable.width`` and read from there by
everything downstream.

Table layout (int32, width 128; f32 payloads ride as bit patterns):

- Supernode row: 16 children; cols k*6..k*6+5 = child AABB
  (min.xyz, max.xyz as f32 bits), cols 96..111 = child refs, col 120 =
  child-validity bits, col 121 = the axis the children are sorted along.
  Empty slots carry an inverted AABB (never hit) and ref _EMPTY. A
  32-wide supernode spans two rows: children 0-15 in row A, 16-31 in row
  B, all 32 validity bits in row A col 120.
- Leaf rows: 12 primitives per row, one row per leaf group (16-wide) or
  two (32-wide, 24 prims): cols 0..107 = 12x(v0,e1,e2) f32 bits, cols
  108..119 = prim ids (-1 pads). Spheres ride in a slot as (center,
  radius, 0...) with prim id >= n_tris discriminating.
- Child ref encoding: >= 0 -> supernode row index; < 0 -> leaf group,
  ~ref = start_row | (n_rows << 22); _EMPTY -> no child.
"""

from typing import NamedTuple

import numpy as np
import torch

from gdpt_tpu_torch.accel import packet_kernels as pk
from gdpt_tpu_torch.core import soa
from gdpt_tpu_torch.core.dtypes import INT, REAL
from gdpt_tpu_torch.core.soa import V3

_EMPTY = np.int32(2**31 - 1)
LEAF_TRIS = 12           # per leaf row: 12*9 geometry + 12 prim ids = 120
_CHAIN_SHIFT = 22        # leaf ref: start | (n_rows << 22)
ENTRY_K = 64             # target size of the entry frontier
# Casts of at least this many rays take the two-phase walk when it is
# asked for: four of the reference's 1024-ray packets.
TWO_PHASE_MIN_RAYS = 4 * 8 * 128
BIG_KEY = 3e38           # phase 1's key of an entry box the ray misses


class PacketTable(NamedTuple):
    table: torch.Tensor        # (R, 128) int32 unified rows
    bbox: torch.Tensor         # (6,) scene AABB (morton ray-sort domain)
    # (n_prims, 9) f32 primitive geometry (tri v0/e1/e2 or sphere
    # center/radius/pad): the kernel reports only (t, prim); u/v and the
    # geometric normal are recomputed outside from one gather of the hit
    # primitive (_hit_attribs).
    geo9: torch.Tensor
    # Entry frontier of the two-phase traversal (trace_two_phase): about
    # entry_k disjoint subtrees covering the scene. entry_ref (K+1,)
    # int32 kernel refs (last = whole-table root); entry_bbox (K+1, 6) f32.
    entry_ref: torch.Tensor
    entry_bbox: torch.Tensor
    # Bound on the walk's stack: max(64, width * (supernode depth + 1)).
    stack_n: int
    # Children per supernode, 16 or 32 (the table's width marker).
    width: int


def packet_table_to(tab: PacketTable, device) -> PacketTable:
    """The same table with every tensor on `device`."""
    return soa.tree_map(lambda t: t.to(device), tab)


def build_packet_table(bvh_bbox_min, bvh_bbox_max, first, count, miss,
                       prim_order, tri_v0, tri_e1, tri_e2,
                       sph_center=None, sph_radius=None,
                       leaf_skip_from=None,
                       prim_of_ref=None, ref_bbox_min=None,
                       ref_bbox_max=None, wide=32, premerge=False, entry_k=ENTRY_K,
                       max_bytes=None):
    """Host-side collapse of the binary miss-link BVH into the packet
    table (numpy; the result holds CPU tensors). wide: supernode width,
    32 (two rows per supernode, 24-prim leaf groups) or 16 (one row,
    12-prim groups). Bit-identical to the reference's table for the
    same BVH arrays and switches.

    premerge: a supernode's expansion stops at W children counted
    before sibling leaves share rows (the reference's
    GDPT_EXPAND_PREMERGE=1), not at W slots after it. entry_k: the
    target size of the two-phase entry frontier (GDPT_ENTRY_K).
    max_bytes: the reference's cap (GDPT_MAX_TABLE_MB << 20); a table
    of more bytes is not built and None comes back. None: no cap.

    Mirrors super16.build_super16's collapse (maximal 16-subtree
    frontier expansion over the DFS/miss-link layout) but with fixed
    12-prim leaf rows chained per fat leaf, so leaf fatness never
    widens the row.

    prim_of_ref / ref_bbox_min / ref_bbox_max support pre-split
    references (early split clipping): prim_order then indexes split
    REFERENCES, prim_of_ref maps each reference to its original
    primitive id (emitted in leaf rows, so hit attributes and sphere
    detection see original ids), and the ref bboxes (clipped to the
    split region) drive the stored leaf-group bounds — the whole point
    of splitting. Duplicate refs of one primitive inside a single leaf
    group are deduped (one geometry row, union of the refs' boxes).
    """
    n_nodes = count.shape[0]
    n_tris = tri_v0.shape[0]
    if n_nodes == 0:
        raise ValueError("build_packet_table: empty BVH")
    if wide not in (16, 32):
        raise ValueError(f"wide must be 16 or 32, got {wide!r}")
    # Supernode width: 16 children in one row or 32 across two rows.
    # S = rows per supernode.
    W = wide
    S = W // 16
    order = np.asarray(prim_order)
    # pid[ref] -> original primitive id (identity without pre-splits).
    pid = (np.asarray(prim_of_ref, np.int64) if prim_of_ref is not None
           else None)
    rbmin = (np.asarray(ref_bbox_min, np.float32)
             if ref_bbox_min is not None else None)
    rbmax = (np.asarray(ref_bbox_max, np.float32)
             if ref_bbox_max is not None else None)

    def to_pid(p):
        return pid[p] if pid is not None else p
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
        sph9 = np.concatenate(
            [sc, sr[:, None], np.zeros((sc.shape[0], 5), np.float32)], axis=1)
        geo9 = np.concatenate(
            [np.concatenate([v0a, e1a, e2a], axis=1), sph9], axis=0)
    else:
        if order.size and to_pid(order).max(initial=0) >= n_tris:
            raise ValueError("build_packet_table: the BVH holds sphere ids "
                             "but no sphere arrays were given")
        geo9 = np.concatenate([v0a, e1a, e2a], axis=1)

    is_leaf_b = count > 0
    n_prims = order.size
    leaf_first = np.where(is_leaf_b, first.astype(np.int64),
                          np.iinfo(np.int64).max)
    pstart = np.minimum.accumulate(leaf_first[::-1])[::-1]
    pstart = np.append(pstart, n_prims)
    pend = pstart[np.minimum(miss, n_nodes)]
    cnt_sub = pend - pstart[:-1]

    # Fat-leaf roots: maximal subtrees with <= LEAF_CAP prims — a fixed
    # S_LEAF rows per leaf group, so the kernel needs no dynamic chain
    # loop and every stack entry is a fixed-size visit. 32-wide tables double the leaf bin to 24 prims
    # across two rows: the flatter 32-wide tree touches ~10% MORE leaf
    # groups (coarser hierarchical culling), so the leaf side amortizes
    # its per-visit fixed cost the same way the super side does.
    LEAF_CAP = LEAF_TRIS * S
    S_LEAF = S
    FAT_CAP = LEAF_CAP
    fat_of = {}
    fat_ranges = []
    i = 0
    while i < n_nodes:
        if cnt_sub[i] <= FAT_CAP:
            fat_of[i] = len(fat_ranges)
            fat_ranges.append((int(pstart[i]), int(cnt_sub[i])))
            i = int(miss[i])
        else:
            i += 1

    def children2(b):
        left = b + 1
        return left, int(miss[left])

    def eff_count(c):
        """A fat node's prim count minus outside-tested spheres."""
        lo, cnt = fat_ranges[fat_of[c]]
        if leaf_skip_from is None:
            return cnt
        p = order[lo: lo + cnt]
        return int((to_pid(p) < leaf_skip_from).sum())

    def binpack(leaf_kids):
        """First-fit-descending pack of leaf nodes into <= LEAF_CAP
        prim bins; returns a list of member-node lists."""
        bins = []
        for c in sorted(leaf_kids, key=lambda c: -eff_count(c)):
            k = eff_count(c)
            for b_ in bins:
                if b_[1] + k <= LEAF_CAP:
                    b_[0].append(c)
                    b_[1] += k
                    break
            else:
                bins.append([[c], k])
        return [m for m, _ in bins]

    def expand16(b):
        """Split largest-first until W POST-MERGE child slots: leaf
        siblings that bin-pack into shared rows occupy one slot, so the
        freed slots take more subtree splits — a flatter tree with
        fewer supernode visits on the walk."""
        frontier = [b]
        while True:
            sups = [x for x in frontier if x not in fat_of]
            leaves = [x for x in frontier if x in fat_of]
            bins = binpack(leaves)
            full = len(frontier) >= W if premerge else len(sups) + len(bins) >= W
            if full or not sups:
                return sups, bins
            big = max(sups, key=lambda x: cnt_sub[x])
            i = frontier.index(big)
            left, right = children2(big)
            frontier[i:i + 1] = [left, right]

    if 0 in fat_of:
        kid_plan = [([], binpack([0]))]
        kids_of = [[0]]
        super_of = {}
        max_depth = 1
        order_q = [None]
    else:
        super_of = {}
        order_q = []
        kid_plan = []  # per super: (super children, leaf bins)
        kids_of = []   # flat node lists (two-phase frontier splitter)
        queue = [(0, 1)]
        max_depth = 1
        while queue:
            b, depth = queue.pop()
            if b in super_of:
                continue
            super_of[b] = len(order_q)
            order_q.append(b)
            max_depth = max(max_depth, depth)
            sups, bins = expand16(b)
            kid_plan.append((sups, bins))
            kids_of.append(sups + [c for m in bins for c in m])
            for c in sups:
                queue.append((c, depth + 1))

    n_super = len(order_q)

    def eff_prims(c):
        """A fat node's ref ids, minus any outside-tested spheres."""
        lo, cnt = fat_ranges[fat_of[c]]
        p = order[lo: lo + cnt].astype(np.int32)
        if leaf_skip_from is not None:
            p = p[to_pid(p) < leaf_skip_from]
        return p

    # Sibling-leaf bin packing (bins precomputed in expand16): SAH
    # leaves average ~8 of the row's 12 slots, so sibling leaf children
    # of a supernode share rows — fewer leaf rows means fewer leaf
    # visits, the bulk of incoherent packet cost — and the freed child
    # slots took extra subtree splits (flatter tree, fewer super
    # visits). Each group gets a tight bbox recomputed from its
    # triangles (also sheds the slack a skipped sphere left in the
    # node bbox).
    leaf_groups = []   # np.int32 prim-id arrays, each <= LEAF_TRIS
    group_bbox = []    # (bmin3, bmax3) per group
    node_group = {}    # fat node -> group index
    kid_entries = []   # per super: [("s", node) | ("l", group_index)]
    for si in range(n_super):
        sups, bins = kid_plan[si]
        entries = [("s", c) for c in sups]
        for members in bins:
            refs = (np.concatenate([eff_prims(c) for c in members])
                    if members else np.zeros(0, np.int32))
            if refs.shape[0] == 0:
                continue  # only skipped spheres lived here: drop child
            gi = len(leaf_groups)
            if rbmin is not None:
                # Pre-split refs: group bbox = union of the refs'
                # CLIPPED boxes (the splitting win); geometry rows are
                # deduped per original primitive — the kept full-
                # triangle test covers every ref's region.
                group_bbox.append((rbmin[refs].min(axis=0),
                                   rbmax[refs].max(axis=0)))
                _, keep = np.unique(to_pid(refs), return_index=True)
                prims = refs[np.sort(keep)]
            else:
                prims = refs
                # Tight bbox from primitive geometry. Triangle rows are
                # (v0, e1, e2); sphere rows (prim id >= n_tris, present
                # in leaves only when leaf_skip_from is None) are
                # (center, (r,0,0,..)) and must contribute center +- r
                # on ALL axes, not the degenerate tri-style corners.
                pidp = to_pid(prims)
                tri_p = pidp[pidp < n_tris]
                sph_p = pidp[pidp >= n_tris]
                parts = []
                if tri_p.size:
                    parts += [geo9[tri_p, 0:3],
                              geo9[tri_p, 0:3] + geo9[tri_p, 3:6],
                              geo9[tri_p, 0:3] + geo9[tri_p, 6:9]]
                if sph_p.size:
                    cen = geo9[sph_p, 0:3]
                    rad = geo9[sph_p, 3:4]
                    parts += [cen - rad, cen + rad]
                vs = np.concatenate(parts)
                group_bbox.append((vs.min(axis=0), vs.max(axis=0)))
            leaf_groups.append(prims)
            for c in members:
                node_group[c] = gi
            entries.append(("l", gi))
        kid_entries.append(entries)
    # Shared all-dead leaf row: target for fat nodes whose prims were
    # all skipped (two-phase entry refs can still name them).
    empty_gi = None
    if leaf_skip_from is not None:
        empty_gi = len(leaf_groups)
        leaf_groups.append(np.zeros(0, np.int32))
        group_bbox.append((np.full(3, 3e38, np.float32),
                           np.full(3, -3e38, np.float32)))
    n_rows = n_super * S + len(leaf_groups) * S_LEAF
    if max_bytes is not None and n_rows * 128 * 4 > max_bytes:
        return None
    if n_rows >= 1 << _CHAIN_SHIFT:
        raise ValueError(f"build_packet_table: {n_rows} rows do not fit the "
                         f"{_CHAIN_SHIFT}-bit row field of a child ref")

    table = np.zeros((n_rows, 128), np.float32)
    ti = table.view(np.int32)
    # Empty child slots: inverted boxes that no slab test can enter.
    for si in range(n_super):
        for r in range(S):
            for k in range(16):
                table[si * S + r, k * 6 + 0: k * 6 + 3] = np.float32(3e38)
                table[si * S + r, k * 6 + 3: k * 6 + 6] = np.float32(-3e38)
            ti[si * S + r, 96:112] = _EMPTY

    def group_ref(gi):
        return np.int32(~np.int32((n_super * S + gi * S_LEAF)
                                  | (S_LEAF << _CHAIN_SHIFT)))

    for si in range(n_super):
        ents = kid_entries[si]
        boxes = [(bmin[x], bmax[x]) if kind == "s" else group_bbox[x]
                 for kind, x in ents]
        # Children are stored sorted by centroid (ascending) along the
        # axis of greatest centroid spread; the kernel pushes slots
        # forward or backward depending on the packet's direction sign
        # along that axis, so pops come nearest-first and best-t
        # shrinks as early as possible (ordered traversal).
        axis = 0
        if ents:
            cen = np.array([(lo + hi) * 0.5 for lo, hi in boxes])
            axis = int(np.argmax(cen.max(axis=0) - cen.min(axis=0)))
            sort = np.argsort(cen[:, axis], kind="stable")
            ents = [ents[j] for j in sort]
            boxes = [boxes[j] for j in sort]
        valid = 0
        for k, ((kind, x), (blo, bhi)) in enumerate(zip(ents, boxes)):
            r = si * S + (k >> 4)
            kk = k & 15
            table[r, kk * 6 + 0: kk * 6 + 3] = blo
            table[r, kk * 6 + 3: kk * 6 + 6] = bhi
            valid |= 1 << k
            ti[r, 96 + kk] = (np.int32(super_of[x] * S) if kind == "s"
                              else group_ref(x))
        # Col 120 (row A): child-validity bits — the slab test cannot
        # reject an unused slot by geometry alone (inverted boxes still
        # pass once min/max mix the +-inf slabs), so the scalar mask
        # ANDs this in. 32-wide masks use all 32 bits of the int32.
        ti[si * S, 120] = np.int32(np.uint32(valid & 0xFFFFFFFF))
        ti[si * S, 121] = axis  # sort axis for the ordered push

    for gi, prims in enumerate(leaf_groups):
        pids_all = to_pid(prims)
        for r in range(S_LEAF):
            row = n_super * S + gi * S_LEAF + r
            pids = pids_all[r * LEAF_TRIS: (r + 1) * LEAF_TRIS]
            cnt = pids.shape[0]
            if cnt:
                table[row, : cnt * 9] = geo9[pids].reshape(-1)
            ids = np.full(LEAF_TRIS, -1, np.int32)
            ids[:cnt] = pids
            ti[row, 108:120] = ids

    stack_n = max(64, W * (max_depth + 1))
    root_lo = bmin[0] if n_nodes else np.zeros(3, np.float32)
    root_hi = bmax[0] if n_nodes else np.ones(3, np.float32)

    # Entry frontier for two-phase traversal: greedily split the
    # largest-population supernode root until ~K disjoint subtrees.
    def ref_of(c):
        if c in super_of:
            return int(super_of[c] * S)
        gi = node_group.get(c, empty_gi)
        return int(group_ref(gi))

    k_target = int(entry_k)
    frontier = [0]
    while len(frontier) < k_target:
        pick, pick_cnt = None, -1
        for i, c in enumerate(frontier):
            if c in super_of and cnt_sub[c] > pick_cnt:
                pick, pick_cnt = i, cnt_sub[c]
        if pick is None:
            break
        c = frontier.pop(pick)
        ch = [x for x in kids_of[super_of[c]] if x is not None]
        frontier[pick:pick] = ch
    entry_ref = np.asarray([ref_of(c) for c in frontier] + [0], np.int32)
    entry_bbox = np.concatenate(
        [np.concatenate([bmin[frontier], bmax[frontier]], axis=1),
         np.concatenate([root_lo, root_hi])[None, :]], axis=0)

    return PacketTable(
        torch.from_numpy(ti),
        torch.from_numpy(np.concatenate([root_lo, root_hi]).astype(np.float32)),
        torch.from_numpy(geo9),
        torch.from_numpy(entry_ref),
        torch.from_numpy(entry_bbox.astype(np.float32)),
        int(stack_n),
        W,
    )


def _morton_keys(tab, org: V3, d: V3, hint=None):
    """Ray-coherence sort key: direction octant (3 high bits) then a
    6-bit-per-axis interleaved morton code of the origin in scene-bbox
    space. Bounce batches arrive shuffled; grouping rays that start
    near each other and head the same way keeps a warp's rays in one
    subtree.

    hint: an optional per-lane integer, clipped to [0, 63] and placed
    above the octant bits (a wavefront pool's bounce depth, say), so
    that rays sort by it first."""
    lo = tab.bbox[:3]
    ext = torch.clamp_min(tab.bbox[3:] - lo, 1e-6)

    def q6(x, i):
        v = torch.clamp((x - lo[i]) / ext[i], 0.0, 0.999) * 64.0
        return v.to(INT)

    def spread(v):
        v = (v | (v << 8)) & 0x0300F
        v = (v | (v << 4)) & 0x030C3
        v = (v | (v << 2)) & 0x09249
        return v

    mort = (spread(q6(org.x, 0)) | (spread(q6(org.y, 1)) << 1)
            | (spread(q6(org.z, 2)) << 2))
    octant = ((d.x < 0).to(INT)
              | ((d.y < 0).to(INT) << 1)
              | ((d.z < 0).to(INT) << 2))
    key = (octant << 18) | mort
    if hint is not None:
        key = key | (torch.clamp(hint.to(INT), 0, 63) << 21)
    return key


def _scrub(org: V3, d: V3, tnear, tfar):
    """Rays as the walks take them: (n,) tnear and tfar, and every lane
    with a non-finite datum dead (tfar = -1 < tnear). Integrators pass
    masked-off lanes with garbage origins and directions, and non-finite
    values must never steer a walk. Returns org, d, tnear, tfar, alive."""
    n = org.x.shape[0]
    dev = org.x.device

    def full(v):
        if isinstance(v, torch.Tensor):
            return v.to(REAL).expand(n)
        return torch.full((n,), v, dtype=REAL, device=dev)

    tnear = full(tnear)
    tfar = full(tfar)
    fin = (torch.isfinite(org.x) & torch.isfinite(org.y) & torch.isfinite(org.z)
           & torch.isfinite(d.x) & torch.isfinite(d.y) & torch.isfinite(d.z)
           & torch.isfinite(tnear))

    def _fin(v, alt):
        return torch.where(torch.isfinite(v), v, alt)

    org = V3(_fin(org.x, 0.0), _fin(org.y, 0.0), _fin(org.z, 0.0))
    d = V3(_fin(d.x, 1.0), _fin(d.y, 0.0), _fin(d.z, 0.0))
    tnear = _fin(tnear, 0.0)
    tfar = torch.where(fin, torch.clamp(_fin(tfar, 3e37), -1.0, 3e37), -1.0)
    return org, d, tnear, tfar, tfar >= tnear


def _any_hit_result(t, prim):
    zero = torch.zeros_like(t)
    return t, prim, zero, zero, V3(zero, zero, 1.0 + zero)


def trace_packet_soa(tab: PacketTable, org: V3, d: V3, tnear, tfar,
                     n_tris=None, any_hit=False, sort_rays=True, dual=False, sort_hint=None):
    """Flat-ray entry: (t, prim, u, v, gn V3) over n rays.

    tnear and tfar are scalars or (n,) tensors. A lane with tfar < tnear
    is dead: it does no work and comes back as a miss. A lane with any
    non-finite ray datum becomes a dead lane. When sort_rays is set,
    rays are morton/octant-sorted before the walk (sort_hint: see
    _morton_keys) and results unsorted on the way out. dual=True walks a
    16-wide table with the dual kernel (K4) in place of the solo one
    (K3): the same result per ray.
    """
    n = org.x.shape[0]
    org, d, tnear, tfar, alive = _scrub(org, d, tnear, tfar)
    org0, d0 = org, d  # original order, for the hit-attribute recompute
    perm = None
    if sort_rays and n > 128:
        keys = _morton_keys(tab, org, d, hint=sort_hint)
        # Dead lanes sort to the back, where whole warps of them exit
        # at once.
        keys = torch.where(alive, keys, 2**30)
        perm = torch.argsort(keys, stable=True)
        org = V3(org.x[perm], org.y[perm], org.z[perm])
        d = V3(d.x[perm], d.y[perm], d.z[perm])
        tnear = tnear[perm]
        tfar = tfar[perm]
    rays = [c.contiguous() for c in (*org, *d, tnear, tfar)]
    t, prim = pk.trace_packets(tab, *rays, n_tris=n_tris, any_hit=any_hit, dual=dual)
    if perm is not None:
        # Invert by scatter (O(n)), not by a second sort.
        t = torch.empty_like(t).index_copy_(0, perm, t)
        prim = torch.empty_like(prim).index_copy_(0, perm, prim)
    prim = torch.where(alive, prim, -1)
    if any_hit:
        return _any_hit_result(t, prim)
    return (t, prim) + _hit_attribs(tab, org0, d0, t, prim, n_tris)


def _entry_dispatch(tab: PacketTable, org: V3, d: V3, tnear, tfar, entry_id, mort, n_tris,
                    any_hit, dual):
    """One dispatch of the two-phase traversal: every lane with work
    walks the one subtree it was given.

    entry_id (n,): an index into tab.entry_ref, or K1 (the entry count)
    for no work this round. Only the lanes with work are cast, each with
    its own start ref (K3 and K4 take one per ray), ordered by (entry,
    morton key) so that a warp's rays walk one subtree; the reference
    scatters them into groups padded to whole 1024-ray TPU packets
    instead, which changes no ray's result. Returns (t, prim) in the
    input order, prim = -1 (t = 0) where a lane had no dispatch."""
    n = org.x.shape[0]
    k1 = tab.entry_ref.shape[0]
    t_out = torch.zeros(n, dtype=REAL, device=org.x.device)
    p_out = torch.full((n,), -1, dtype=INT, device=org.x.device)
    lanes = torch.nonzero(entry_id < k1).squeeze(1)
    if lanes.numel() == 0:
        return t_out, p_out
    eid = entry_id[lanes].to(torch.int64)
    key = (eid << _CHAIN_SHIFT) | (mort[lanes].to(torch.int64) & ((1 << _CHAIN_SHIFT) - 1))
    order = torch.argsort(key, stable=True)
    lanes = lanes[order]
    rays = [c[lanes].contiguous() for c in (*org, *d, tnear, tfar)]
    rref = tab.entry_ref[eid[order]].contiguous()
    t, prim = pk.trace_packets(tab, *rays, rref=rref, n_tris=n_tris, any_hit=any_hit,
                               dual=dual)
    t_out[lanes] = t
    p_out[lanes] = prim
    return t_out, p_out


def trace_two_phase(tab: PacketTable, org: V3, d: V3, tnear, tfar, n_tris=None,
                    any_hit=False, entry_iters=3, dual=False):
    """Two-phase entry-point traversal: trace_packet_soa's contract.

    Phase 1 slab-tests every ray against the K entry-subtree boxes
    (tab.entry_bbox[:K]) as one dense (n, K) tensor pass and ranks the
    boxes hit by their entry distance. Phase 2 runs tk = min(entry_iters,
    K) dispatches (_entry_dispatch), the nearest box first, each lane
    walking the one subtree it enters with tfar tightened to its running
    best; in any-hit mode a lane is done at its first blocker. A last
    dispatch walks the whole table (the root ref) for the lanes that
    crossed more than tk boxes and are not done, with the tightened
    tfar. Any hit returns the (scrubbed) input tfar as t, as the
    reference does."""
    n = org.x.shape[0]
    org, d, tnear, tfar, alive = _scrub(org, d, tnear, tfar)
    k1 = tab.entry_ref.shape[0]
    k = k1 - 1                                 # real entries (the last is the root)

    # ---- phase 1: dense (n, K) entry culling, the reference's operation order ----
    eb = tab.entry_bbox
    inv = V3(*(1.0 / torch.where(c == 0, 1e-20, c) for c in d))

    def slab(lo_c, hi_c, o_c, i_c):
        a = (lo_c[None, :] - o_c[:, None]) * i_c[:, None]
        b = (hi_c[None, :] - o_c[:, None]) * i_c[:, None]
        return torch.minimum(a, b), torch.maximum(a, b)

    ax, bx = slab(eb[:k, 0], eb[:k, 3], org.x, inv.x)
    ay, by = slab(eb[:k, 1], eb[:k, 4], org.y, inv.y)
    az, bz = slab(eb[:k, 2], eb[:k, 5], org.z, inv.z)
    t_in = torch.maximum(torch.maximum(ax, ay), torch.maximum(az, tnear[:, None]))
    t_out = torch.minimum(torch.minimum(bx, by), torch.minimum(bz, tfar[:, None]))
    hitk = t_in <= t_out
    keyk = torch.where(hitk, t_in, BIG_KEY)
    tk = min(entry_iters, k)
    # Nearest first; equal entry distances (rays starting inside several
    # boxes) keep the lower entry first, as the reference's top_k does.
    tins, idx = torch.sort(keyk, dim=1, stable=True)
    tins, idx = tins[:, :tk], idx[:, :tk].to(INT)
    overflow = hitk.sum(dim=1) > tk
    # Free phase 1's (n, K) tensors before the dispatches.
    del ax, bx, ay, by, az, bz, t_in, t_out, hitk, keyk
    mort = _morton_keys(tab, org, d)

    dead = torch.full((n,), k1, dtype=INT, device=org.x.device)
    best_t = tfar
    best_p = torch.full((n,), -1, dtype=INT, device=org.x.device)
    done = ~alive
    for e in range(tk):
        ok = (~done) & (tins[:, e] < best_t) & (tins[:, e] < BIG_KEY)
        t_e, p_e = _entry_dispatch(tab, org, d, tnear, best_t, torch.where(ok, idx[:, e], dead),
                                   mort, n_tris, any_hit, dual)
        imp = (p_e >= 0) & ok
        if not any_hit:
            imp = imp & (t_e < best_t)
            best_t = torch.where(imp, t_e, best_t)
        best_p = torch.where(imp, p_e, best_p)
        if any_hit:
            done = done | imp

    # ---- cleanup: lanes that crossed more than tk entries walk the
    # whole table with the tightened tfar ----
    pend = (~done) & overflow
    t_e, p_e = _entry_dispatch(tab, org, d, tnear, best_t, torch.where(pend, k, dead), mort,
                               n_tris, any_hit, dual)
    imp = (p_e >= 0) & pend
    if not any_hit:
        imp = imp & (t_e < best_t)
        best_t = torch.where(imp, t_e, best_t)
    best_p = torch.where(imp, p_e, best_p)

    prim = torch.where(alive, best_p, -1)
    if any_hit:
        return _any_hit_result(best_t, prim)
    return (best_t, prim) + _hit_attribs(tab, org, d, best_t, prim, n_tris)


def _hit_attribs(tab: PacketTable, org: V3, d: V3, t, prim, n_tris):
    """(u, v, unnormalized geometric normal) of the winning primitive,
    recomputed from one gather of its geometry row: one gather per *ray*
    instead of five more outputs carried through every leaf visit."""
    pr = torch.clamp_min(prim, 0)
    row = soa.take(tab.geo9, pr)
    v0 = V3(row[:, 0], row[:, 1], row[:, 2])
    e1 = V3(row[:, 3], row[:, 4], row[:, 5])
    e2 = V3(row[:, 6], row[:, 7], row[:, 8])
    pvec = soa.cross(d, e2)
    det = soa.dot(e1, pvec)
    inv_det = torch.where(det != 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    tvec = org - v0
    u = soa.dot(tvec, pvec) * inv_det
    qvec = soa.cross(tvec, e1)
    v = soa.dot(d, qvec) * inv_det
    gn = soa.cross(e1, e2)
    zero = torch.zeros_like(u)
    if n_tris is not None:
        is_sph = pr >= n_tris
        gns = (org + d * t) - v0  # v0 = sphere center
        u = torch.where(is_sph, 0.0, u)
        v = torch.where(is_sph, 0.0, v)
        gn = soa.where(is_sph, gns, gn)
    miss = prim < 0
    u = torch.where(miss, 0.0, u)
    v = torch.where(miss, 0.0, v)
    gn = soa.where(miss, V3(zero, zero, 1.0 + zero), gn)
    return u, v, gn


def intersect_packet(tab: PacketTable, org: V3, d: V3, tnear, tfar,
                     n_tris=None, sort_rays=True, dual=False, two_phase=False, sort_hint=None):
    """Closest hit within [tnear, tfar): (t, prim, u, v, gn V3); a miss
    gives t = tfar, prim = -1. n_tris: the triangle count when the table
    holds spheres (prim id >= n_tris), else None. two_phase=True takes
    trace_two_phase for casts of TWO_PHASE_MIN_RAYS rays or more (its
    dispatches sort within themselves: sort_rays and sort_hint are not
    read there)."""
    if two_phase and org.x.shape[0] >= TWO_PHASE_MIN_RAYS:
        return trace_two_phase(tab, org, d, tnear, tfar, n_tris=n_tris, dual=dual)
    return trace_packet_soa(tab, org, d, tnear, tfar, n_tris=n_tris, any_hit=False,
                            sort_rays=sort_rays, dual=dual, sort_hint=sort_hint)


def occluded_packet(tab: PacketTable, org: V3, d: V3, tnear, tfar,
                    n_tris=None, sort_rays=True, dual=False, two_phase=False):
    """Whether any primitive blocks each ray within [tnear, tfar): bool."""
    if two_phase and org.x.shape[0] >= TWO_PHASE_MIN_RAYS:
        prim = trace_two_phase(tab, org, d, tnear, tfar, n_tris=n_tris, any_hit=True,
                               dual=dual)[1]
    else:
        prim = trace_packet_soa(tab, org, d, tnear, tfar, n_tris=n_tris, any_hit=True,
                                sort_rays=sort_rays, dual=dual)[1]
    return prim >= 0
