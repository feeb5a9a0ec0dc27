"""The BVH walk over the packet table: closest hit or any hit, solo
(K3) or dual (K4).

Counterpart of gdpt_tpu/accel/packet_trace.py `_make_kernel`,
`_make_kernel_dual` and `_trace_packets`. The hand-written Hopper
kernels live in csrc/packet_trace.cu (K3: a group of as many lanes as
the table is wide walks one ray, lane k testing child k of a supernode
and slot k of a leaf, the stack in the lanes' registers) and
csrc/packet_trace_dual.cu (K4, 16-wide tables only: a group of 16 lanes
walks rays 2q and 2q + 1 one after the other, its lanes checking both
for a dead ray at once; both kernels are instances of the one walk in
csrc/packet_group.cuh); this module builds them at first use
(accel/native_build.py), binds them with ctypes and launches them on
PyTorch's current stream. `trace_packets` takes a plain PyTorch
version only for tensors on the CPU. For CUDA tensors it launches the
kernel or raises: there is no fallback. LAUNCHES counts kernel launches.
A ray whose stack runs full (a table whose stack_n understates its
depth) raises in the plain version; the kernel stops that ray and sets a
flag on the card, which `check_overflow` turns into the same error.

Contract (flat (N,) float32 ray arrays, a table of accel/packet_trace):
for each ray the closest primitive of the table within [tnear, tfar)
(t, prim; a miss gives t = tfar, prim = -1), or in any-hit mode some
primitive that blocks it (prim >= 0, t its distance). A lane with
tfar < tnear is dead: no work, a miss. `rref` is an optional per-ray
start ref (0 = the root). Ray data must be finite
(packet_trace.trace_packet_soa scrubs it).

The walk is per ray, where the TPU kernel walks a 1024-ray packet over
one shared stack: each ray visits only the nodes its own box tests
admit, nearest child first by its own direction sign along the row's
sort axis. The tests and their operation order are the reference's
(`super_mask`, `visit_leaf`). The stack holds one (row, pending child
mask) entry per supernode on the path, so its depth is the tree's,
stack_n // width at most, not width times that.

Kernel and plain version do the same visits in the same order with the
same separately rounded operations (the kernels are built with
--fmad=false), so they agree bit for bit, ties included: among equal t
in a leaf the lowest slot wins (closest hit), and any hit stops at the
lowest blocking slot, with the visit counts' primitive tests up to it.
"""

import ctypes

import torch

from gdpt_tpu_torch.accel import native_build
from gdpt_tpu_torch.core.dtypes import INT, REAL

LAUNCHES = {"packet_intersect": 0, "packet_occluded": 0,
            "packet_dual_intersect": 0, "packet_dual_occluded": 0}

SOURCE = "packet_trace.cu"
SOURCE_DUAL = "packet_trace_dual.cu"
MAX_DEPTH = 32           # stack entries per ray compiled into the kernel
_ROW_MASK = (1 << 22) - 1
_LEAF_TRIS = 12

_lib = None
_lib_dual = None
_overflow = {}           # cuda device index -> (1,) int32 flag the kernel sets
_OVERFLOW_MSG = ("packet walk: a ray needs more than stack_n // width stack "
                 "entries; the table's stack_n does not bound its depth")


def build(verbose=False):
    """Compile csrc/packet_trace.cu (see native_build.build)."""
    return native_build.build(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdpt_trace_packets.argtypes = [p, i, i, i, p, p, p, p, p, p, p, p, p,
                                           i, i, i, i, p, p, p, p, p]
        lib.gdpt_trace_packets.restype = i
        _lib = lib
    return _lib


def _load_dual():
    global _lib_dual
    if _lib_dual is None:
        lib = ctypes.CDLL(str(native_build.build(SOURCE_DUAL)))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdpt_trace_packets_dual.argtypes = [p, i, i, p, p, p, p, p, p, p, p, p,
                                                i, i, i, i, p, p, p, p, p]
        lib.gdpt_trace_packets_dual.restype = i
        _lib_dual = lib
    return _lib_dual


def _check_dual(tab):
    if tab.width != 16:
        raise ValueError(f"the dual walk takes 16-wide packet tables only, got width "
                         f"{tab.width!r}: build the table with wide=16 or walk it solo")


def _check(tab, rays, rref):
    n = rays[0].shape[0]
    dev = rays[0].device
    table = tab.table
    if tab.width not in (16, 32):
        raise ValueError(f"packet table width must be 16 or 32, got {tab.width!r}")
    if (table.dim() != 2 or table.shape[1] != 128 or table.dtype != INT
            or not table.is_contiguous() or table.device != dev):
        raise ValueError("the packet table must be a contiguous (R, 128) int32 "
                         "tensor on the rays' device")
    rows = table.shape[0]
    if not tab.width // 16 <= rows <= _ROW_MASK:
        raise ValueError(f"packet table of {rows} rows (width {tab.width}) is out of range")
    depth = tab.stack_n // tab.width
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(
            f"packet table stack_n = {tab.stack_n} at width {tab.width} asks for "
            f"{depth} stack entries per ray; the walk takes 1 to {MAX_DEPTH}")
    for a in rays:
        if a.dtype != REAL or a.device != dev or not a.is_contiguous() or a.shape != (n,):
            raise ValueError("ray components must be contiguous (N,) float32 "
                             "tensors on one device")
    if rref is not None and (rref.dtype != INT or rref.device != dev
                             or not rref.is_contiguous() or rref.shape != (n,)):
        raise ValueError("rref must be a contiguous (N,) int32 tensor on the rays' device")
    if n >= 2 ** 31:
        raise ValueError("the packet walk takes fewer than 2^31 rays")
    return n, dev, rows, depth


def _inv_dir(c):
    """1 / c with the reference's guard: |c| < 1e-18 (zero and
    subnormal components) becomes +-1e-20, which caps |inv| at 1e20."""
    tiny = c.abs() < 1e-18
    return 1.0 / torch.where(tiny, torch.where(c < 0, -1e-20, 1e-20), c)


def _bit_index(m):
    """Index of the highest set bit of positive int64 values (exact: the
    binary exponent of the value as a double)."""
    return torch.frexp(m.to(torch.float64))[1].to(torch.int64) - 1


def _slab_hits(rf, inv, oinv, tn, best):
    """The supernode visit's slab tests. rf: (M, K, 6) child boxes
    (min.xyz, max.xyz); inv, oinv: per-axis (M, 1) inverse direction and
    origin * inverse direction; tn, best: (M, 1). Returns (M, K) bool:
    the ray enters the box within [tn, best]."""
    lo_hi = []
    for a in range(3):
        t0 = rf[:, :, a] * inv[a] - oinv[a]
        t1 = rf[:, :, a + 3] * inv[a] - oinv[a]
        lo_hi.append((torch.minimum(t0, t1), torch.maximum(t0, t1)))
    t_in = torch.maximum(torch.maximum(lo_hi[0][0], lo_hi[1][0]),
                         torch.maximum(lo_hi[2][0], tn))
    t_out = torch.minimum(torch.minimum(lo_hi[0][1], lo_hi[1][1]),
                          torch.minimum(lo_hi[2][1], best))
    return t_in <= t_out


def _prim_hits(geo, pid, r_o, r_d, tn, best, n_tris):
    """The leaf visit's primitive tests. geo: (M, K, 9) slots of
    (v0, e1, e2), or (center, radius, 0...) for a sphere; pid: (M, K)
    prim ids (-1 pads); r_o, r_d: per-axis (M, 1) origin and direction;
    tn, best: (M, 1); n_tris: the triangle count when ids >= n_tris are
    spheres, else None. Returns (t, hit), both (M, K): each slot's
    distance and whether it is a hit within [tn, best)."""
    v0 = tuple(geo[:, :, k] for k in (0, 1, 2))
    e1 = tuple(geo[:, :, k] for k in (3, 4, 5))
    e2 = tuple(geo[:, :, k] for k in (6, 7, 8))
    px = r_d[1] * e2[2] - r_d[2] * e2[1]
    py = r_d[2] * e2[0] - r_d[0] * e2[2]
    pz = r_d[0] * e2[1] - r_d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    inv_det = torch.where(det != 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    tx, ty, tz = r_o[0] - v0[0], r_o[1] - v0[1], r_o[2] - v0[2]
    uu = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    vv = (r_d[0] * qx + r_d[1] * qy + r_d[2] * qz) * inv_det
    tt = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    hit = ((det != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1)
           & (tt >= tn) & (tt < best) & (pid >= 0))
    if n_tris is not None:
        # In-table spheres: (center, radius, 0...) in the slot.
        is_sph = pid >= n_tris
        r = e1[0]
        a2 = r_d[0] * r_d[0] + r_d[1] * r_d[1] + r_d[2] * r_d[2]
        inv_a = 1.0 / torch.where(a2 != 0, a2, 1.0)
        tm = -(r_d[0] * tx + r_d[1] * ty + r_d[2] * tz) * inv_a
        mx, my, mz = tx + r_d[0] * tm, ty + r_d[1] * tm, tz + r_d[2] * tm
        disc = r * r - (mx * mx + my * my + mz * mz)
        dtq = torch.sqrt(torch.clamp_min(disc, 0.0) * inv_a)
        s0, s1 = tm - dtq, tm + dtq
        use_lo = (s0 >= tn) & (s0 < best)
        use_hi = (s1 >= tn) & (s1 < best)
        ts = torch.where(use_lo, s0, s1)
        hs = (disc >= 0) & (a2 != 0) & (use_lo | use_hi) & (pid >= 0)
        tt = torch.where(is_sph, ts, tt)
        hit = torch.where(is_sph, hs, hit)
    return tt, hit


def trace_packets_plain(tab, ox, oy, oz, dx, dy, dz, tnear, tfar, rref=None,
                        n_tris=None, any_hit=False, counts=False, ceiling=None,
                        rows_read=None):
    """K3's contract in plain PyTorch: one visit per loop iteration for
    every ray that still has a node to visit. Returns (t, prim), and with
    counts an (N, 4) int32 tensor of per-ray super visits, leaf visits,
    primitive tests and the deepest stack use. rows_read: an optional
    (R,) bool tensor in which every table row these rays' visits read is
    set (a leaf group's second row only where it holds a primitive)."""
    n, dev, rows, depth = _check(tab, (ox, oy, oz, dx, dy, dz, tnear, tfar), rref)
    table = tab.table
    tablef = table.view(REAL)
    width = tab.width
    s_rows = width // 16
    last = rows - s_rows      # row clamp that leaves room for row B
    if ceiling is None:
        ceiling = 4 * rows + 64
    i64 = torch.int64
    o = (ox, oy, oz)
    dd = (dx, dy, dz)
    inv = tuple(_inv_dir(c) for c in dd)
    oinv = tuple(a * b for a, b in zip(o, inv))
    best = tfar.clone()
    prim = torch.full((n,), -1, dtype=INT, device=dev)
    node = torch.zeros(n, dtype=i64, device=dev) if rref is None else rref.to(i64)
    has_node = tfar >= tnear
    stk_row = torch.zeros((n, depth), dtype=i64, device=dev)
    stk_mask = torch.zeros((n, depth), dtype=i64, device=dev)
    sp = torch.zeros(n, dtype=i64, device=dev)
    cnt = torch.zeros((n, 4), dtype=i64, device=dev)
    bit = torch.arange(width, dtype=i64, device=dev)
    it = 0
    while it < ceiling:
        idx = torch.nonzero(has_node).squeeze(1)
        if idx.numel() == 0:
            break
        it += 1
        nd = node[idx]
        is_sup = nd >= 0
        si, li = idx[is_sup], idx[~is_sup]

        # ---- supernode visit: W slab tests -> child mask -> one push ----
        if si.numel():
            srow = nd[is_sup].clamp(0, last)
            rf = tablef[srow][:, :96].reshape(-1, 16, 6)
            if s_rows == 2:
                rf = torch.cat([rf, tablef[srow + 1][:, :96].reshape(-1, 16, 6)], dim=1)
            if rows_read is not None:
                for r in range(s_rows):
                    rows_read[srow + r] = True
            enters = _slab_hits(rf, tuple(c[si][:, None] for c in inv),
                                tuple(c[si][:, None] for c in oinv),
                                tnear[si][:, None], best[si][:, None])
            mask = (enters.to(i64) << bit).sum(dim=1)
            mask = mask & (table[srow, 120].to(i64) & 0xFFFFFFFF)
            # Children sit sorted ascending by centroid along the row's
            # axis; a ray heading the other way takes them from the top.
            axis = table[srow, 121]
            sgn = torch.where(axis == 0, dx[si], torch.where(axis == 1, dy[si], dz[si]))
            rev = (sgn <= 0).to(i64)
            push = mask != 0
            pi = si[push]
            at = sp[pi]
            if bool((at >= depth).any()):
                raise RuntimeError(_OVERFLOW_MSG)
            stk_row[pi, at] = srow[push] | (rev[push] << 30)
            stk_mask[pi, at] = mask[push]
            sp[pi] = at + 1
            cnt[si, 0] += 1
            cnt[pi, 3] = torch.maximum(cnt[pi, 3], at + 1)

        # ---- leaf visit: 12 or 24 primitive tests ----
        if li.numel():
            lrow = ((~nd[~is_sup]) & _ROW_MASK).clamp(0, last)
            geo = tablef[lrow][:, :108].reshape(-1, _LEAF_TRIS, 9)
            pid = table[lrow][:, 108:120]
            if s_rows == 2:
                geo = torch.cat([geo, tablef[lrow + 1][:, :108].reshape(-1, _LEAF_TRIS, 9)], dim=1)
                pid = torch.cat([pid, table[lrow + 1][:, 108:120]], dim=1)
            if rows_read is not None:
                rows_read[lrow] = True
                if s_rows == 2:
                    rows_read[(lrow + 1)[pid[:, _LEAF_TRIS] >= 0]] = True
            tt, hit = _prim_hits(geo, pid, tuple(c[li][:, None] for c in o),
                                 tuple(c[li][:, None] for c in dd),
                                 tnear[li][:, None], best[li][:, None], n_tris)
            got = hit.any(dim=1)
            n_valid = (pid >= 0).sum(dim=1)
            if any_hit:
                # The kernel stops at the first blocking primitive: the
                # valid slots up to it are tested.
                j = hit.to(torch.int8).argmax(dim=1)
                upto = torch.arange(pid.shape[1], device=dev) <= j[:, None]
                tested = torch.where(got, ((pid >= 0) & upto).sum(dim=1), n_valid)
            else:
                # Strict t < best in slot order: the minimum wins, the
                # first slot among equals (argmin takes the first).
                j = torch.where(hit, tt, float("inf")).argmin(dim=1)
                tested = n_valid
            tj = tt.gather(1, j[:, None]).squeeze(1)
            pj = pid.gather(1, j[:, None]).squeeze(1)
            best[li] = torch.where(got, tj, best[li])
            prim[li] = torch.where(got, pj, prim[li])
            cnt[li, 1] += 1
            cnt[li, 2] += tested
            if any_hit:
                sp[li[got]] = 0   # a blocked ray is done

        # ---- next node: peel the nearest pending child off the stack ----
        more = sp[idx] > 0
        has_node[idx] = more
        j = idx[more]
        if j.numel():
            top = sp[j] - 1
            e = stk_row[j, top]
            m = stk_mask[j, top]
            k = torch.where((e >> 30) == 1, _bit_index(m), _bit_index(m & -m))
            m2 = m & ~(1 << k)
            stk_mask[j, top] = m2
            sp[j] = torch.where(m2 == 0, top, top + 1)
            prow = (e & _ROW_MASK) + (k >> 4)
            node[j] = table[prow, 96 + (k & 15)].to(i64)
    if counts:
        return best, prim, cnt.to(INT)
    return best, prim


def check_overflow():
    """Raise RuntimeError if a ray of any kernel launch since the last
    check ran its stack full (its result is then not a full walk). Reads
    the kernel's flag from the card, which waits for the launches queued
    there: callers check where they read results back anyway."""
    for flag in _overflow.values():
        if int(flag):
            flag.zero_()
            raise RuntimeError(_OVERFLOW_MSG)


def trace_packets_dual_plain(tab, ox, oy, oz, dx, dy, dz, tnear, tfar, rref=None,
                             n_tris=None, any_hit=False, counts=False):
    """K4's contract in plain PyTorch: K3's on a 16-wide table. The two
    rays a group walks never interact, so the pairing changes no result:
    the width check, then the plain solo walk."""
    _check_dual(tab)
    return trace_packets_plain(tab, ox, oy, oz, dx, dy, dz, tnear, tfar, rref=rref,
                               n_tris=n_tris, any_hit=any_hit, counts=counts)


def trace_packets(tab, ox, oy, oz, dx, dy, dz, tnear, tfar, rref=None,
                  n_tris=None, any_hit=False, counts=False, dual=False):
    """Walk the packet table `tab` for every ray: K3, or with dual=True
    K4 (a 16-wide table; any other width raises ValueError). Returns
    (t, prim); with counts also the (N, 4) int32 per-ray visit counts
    (see trace_packets_plain). With counts the call also runs
    check_overflow; without, the caller does once its results are due."""
    rays = (ox, oy, oz, dx, dy, dz, tnear, tfar)
    n, dev, rows, depth = _check(tab, rays, rref)
    if dual:
        _check_dual(tab)
    if dev.type == "cpu":
        plain = trace_packets_dual_plain if dual else trace_packets_plain
        return plain(tab, *rays, rref=rref, n_tris=n_tris, any_hit=any_hit, counts=counts)
    if dev.type != "cuda":
        raise ValueError(f"the packet walk runs on cuda or cpu tensors, not {dev}")
    lib = _load_dual() if dual else _load()
    if dev.index not in _overflow:
        _overflow[dev.index] = torch.zeros(1, dtype=INT, device=dev)
    t = torch.empty(n, dtype=REAL, device=dev)
    prim = torch.empty(n, dtype=INT, device=dev)
    cnt = torch.empty((n, 4), dtype=INT, device=dev) if counts else None
    ptr = lambda a: ctypes.c_void_p(a.data_ptr() if a is not None else None)  # noqa: E731
    args = (*map(ptr, rays), ptr(rref), n, -1 if n_tris is None else int(n_tris),
            int(bool(any_hit)), 4 * rows + 64, ptr(t), ptr(prim), ptr(cnt),
            ptr(_overflow[dev.index]))
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if dual:
            err = lib.gdpt_trace_packets_dual(ptr(tab.table), rows, depth, *args, stream)
        else:
            err = lib.gdpt_trace_packets(ptr(tab.table), rows, tab.width, depth, *args, stream)
    mode = "occluded" if any_hit else "intersect"
    LAUNCHES[f"packet_dual_{mode}" if dual else f"packet_{mode}"] += n > 0
    if err != 0:
        raise RuntimeError(f"packet walk kernel launch failed: CUDA error {err}")
    if counts:
        check_overflow()
        return t, prim, cnt
    return t, prim
