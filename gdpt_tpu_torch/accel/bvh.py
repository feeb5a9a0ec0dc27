"""Host-side BVH construction (numpy and C++, no tensors).

Counterpart of gdpt_tpu/accel/bvh.py and gdpt_tpu/accel/native (replaces
Embree's BVH build, reference: src/scene.cpp:19-27, ``rtcCommitScene``).
The tree is emitted in depth-first order as flat arrays with *miss
links* (escape pointers): a node's children directly follow it, and
``miss[node]`` is the first node past its subtree.
accel/packet_trace.build_packet_table collapses this layout into the
wide table that the ray-casting kernel walks.

Primitive ids: ``p < n_triangles`` is a triangle, otherwise sphere
``p - n_triangles`` (spheres are first-class primitives here instead of
Embree user geometry, reference: src/shapes/sphere.inl:1-162).

Build strategy: binned SAH (16 bins, largest extent axis, leaf size <= 4)
with a median-split fallback. Two builders: "native", the C++ source
csrc/bvh_builder.cpp compiled with g++ at first use and loaded with
ctypes, and "numpy", a recursive Python builder that is array-for-array
equal to the reference's. ``builder=None`` tries native and takes numpy
only when no C++ compiler is present; the builder that ran is recorded
on the result (``BVHArrays.builder``), never hidden.
"""

import ctypes
import shutil
from typing import NamedTuple

import numpy as np

from gdpt_tpu_torch.accel import native_build

LEAF_SIZE = 4
N_BINS = 16

SOURCE = "bvh_builder.cpp"


class BVHArrays(NamedTuple):
    bbox_min: np.ndarray   # (n_nodes, 3) f32
    bbox_max: np.ndarray   # (n_nodes, 3) f32
    first: np.ndarray      # (n_nodes,) i32: first prim slot (leaves)
    count: np.ndarray      # (n_nodes,) i32: 0 for inner nodes
    miss: np.ndarray       # (n_nodes,) i32: escape pointer (n_nodes = done)
    prim_order: np.ndarray  # (n_prims,) i32: reordered primitive ids
    builder: str = ""      # "native" or "numpy": which builder made it


_lib = None


def _native_lib():
    global _lib
    if _lib is None:
        lib = native_build.load(SOURCE)
        pd = ctypes.POINTER(ctypes.c_double)
        pf = ctypes.POINTER(ctypes.c_float)
        pi = ctypes.POINTER(ctypes.c_int32)
        lib.gdpt_build_bvh.restype = ctypes.c_int64
        lib.gdpt_build_bvh.argtypes = [ctypes.c_int64, pd, pd, pd, ctypes.c_int,
                                       ctypes.c_int, pf, pf, pi, pi, pi, pi]
        _lib = lib
    return _lib


def _build_bvh_native(bmin, bmax, cent):
    lib = _native_lib()
    n = bmin.shape[0]
    max_nodes = max(2 * n, 1)
    bmin = np.ascontiguousarray(bmin, np.float64)
    bmax = np.ascontiguousarray(bmax, np.float64)
    cent = np.ascontiguousarray(cent, np.float64)
    node_bmin = np.empty((max_nodes, 3), np.float32)
    node_bmax = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    prim_order = np.empty(n, np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n_nodes = lib.gdpt_build_bvh(
        n, ptr(bmin, ctypes.c_double), ptr(bmax, ctypes.c_double),
        ptr(cent, ctypes.c_double), LEAF_SIZE, N_BINS,
        ptr(node_bmin, ctypes.c_float), ptr(node_bmax, ctypes.c_float),
        ptr(first, ctypes.c_int32), ptr(count, ctypes.c_int32),
        ptr(miss, ctypes.c_int32), ptr(prim_order, ctypes.c_int32))
    if n_nodes <= 0:
        raise RuntimeError(f"native BVH builder failed on {n} primitives ({n_nodes})")
    return BVHArrays(
        node_bmin[:n_nodes].copy(), node_bmax[:n_nodes].copy(),
        first[:n_nodes].copy(), count[:n_nodes].copy(), miss[:n_nodes].copy(),
        prim_order, "native")


def _build(bmin, bmax, cent, builder):
    if builder not in (None, "native", "numpy"):
        raise ValueError(f"builder must be 'native', 'numpy' or None, got {builder!r}")
    if builder is None:
        # The default takes numpy only where there is no C++ compiler;
        # a compiler that is present and fails raises.
        builder = "native" if shutil.which(native_build.cxx_name()) else "numpy"
    if builder == "native":
        return _build_bvh_native(bmin, bmax, cent)
    return _build_bvh_numpy(bmin, bmax, cent)


def _centroids_bounds(tri_v0, tri_v1, tri_v2, sph_center, sph_radius):
    n_tri = tri_v0.shape[0]
    n_sph = sph_center.shape[0]
    n = n_tri + n_sph
    bmin = np.empty((n, 3), np.float64)
    bmax = np.empty((n, 3), np.float64)
    if n_tri:
        bmin[:n_tri] = np.minimum(np.minimum(tri_v0, tri_v1), tri_v2)
        bmax[:n_tri] = np.maximum(np.maximum(tri_v0, tri_v1), tri_v2)
    if n_sph:
        bmin[n_tri:] = sph_center - sph_radius[:, None]
        bmax[n_tri:] = sph_center + sph_radius[:, None]
    centroid = 0.5 * (bmin + bmax)
    return bmin, bmax, centroid


def build_bvh(tri_v0, tri_v1, tri_v2, sph_center=None, sph_radius=None,
              builder=None):
    tri_v0 = np.asarray(tri_v0, np.float64).reshape(-1, 3)
    tri_v1 = np.asarray(tri_v1, np.float64).reshape(-1, 3)
    tri_v2 = np.asarray(tri_v2, np.float64).reshape(-1, 3)
    sph_center = (
        np.zeros((0, 3)) if sph_center is None else np.asarray(sph_center, np.float64).reshape(-1, 3)
    )
    sph_radius = (
        np.zeros((0,)) if sph_radius is None else np.asarray(sph_radius, np.float64).reshape(-1)
    )
    bmin, bmax, cent = _centroids_bounds(tri_v0, tri_v1, tri_v2, sph_center, sph_radius)
    if bmin.shape[0] == 0:
        raise ValueError("build_bvh: empty scene")
    return _build(bmin, bmax, cent, builder)


def _build_bvh_numpy(bmin, bmax, cent):
    n = bmin.shape[0]
    order = np.arange(n)

    # Nodes are appended in DFS order; children of a node directly follow
    # it, so the hit-link is implicit (node + 1) and only miss links are
    # stored.
    node_bmin, node_bmax, node_first, node_count = [], [], [], []
    node_end = []  # one past the last DFS index of each node's subtree
    prim_out = np.empty(n, np.int64)

    def emit(prims_lo, prims_hi):
        """Recursively emit the subtree over order[prims_lo:prims_hi].
        Returns the node index."""
        idx = len(node_bmin)
        sel = order[prims_lo:prims_hi]
        lo = bmin[sel].min(axis=0)
        hi = bmax[sel].max(axis=0)
        node_bmin.append(lo)
        node_bmax.append(hi)
        node_end.append(0)
        count = prims_hi - prims_lo
        if count <= LEAF_SIZE:
            node_first.append(prims_lo)
            node_count.append(count)
            prim_out[prims_lo:prims_hi] = sel
            node_end[idx] = idx + 1
            return idx
        node_first.append(-1)
        node_count.append(0)

        c = cent[sel]
        clo, chi = c.min(axis=0), c.max(axis=0)
        axis = int(np.argmax(chi - clo))
        extent = chi[axis] - clo[axis]
        split = None
        if extent > 0:
            # Binned SAH over the largest-extent centroid axis.
            bins = np.minimum(
                ((c[:, axis] - clo[axis]) / extent * N_BINS).astype(np.int64),
                N_BINS - 1,
            )
            counts = np.bincount(bins, minlength=N_BINS)
            bin_lo = np.full((N_BINS, 3), np.inf)
            bin_hi = np.full((N_BINS, 3), -np.inf)
            for a in range(3):
                np.minimum.at(bin_lo[:, a], bins, bmin[sel][:, a])
                np.maximum.at(bin_hi[:, a], bins, bmax[sel][:, a])
            # Prefix/suffix surface areas.
            def sa(lo_, hi_):
                d = np.maximum(hi_ - lo_, 0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            pre_lo = np.minimum.accumulate(bin_lo, axis=0)
            pre_hi = np.maximum.accumulate(bin_hi, axis=0)
            suf_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
            suf_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
            n_left = np.cumsum(counts)[:-1]
            n_right = count - n_left
            cost = sa(pre_lo[:-1], pre_hi[:-1]) * n_left + sa(suf_lo[1:], suf_hi[1:]) * n_right
            cost = np.where((n_left == 0) | (n_right == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                left_mask = bins <= best
                n_left_best = int(left_mask.sum())
                part = np.concatenate([sel[left_mask], sel[~left_mask]])
                order[prims_lo:prims_hi] = part
                split = prims_lo + n_left_best
        if split is None:
            # Median fallback (degenerate centroids).
            key = c[:, axis]
            perm = np.argsort(key, kind="stable")
            order[prims_lo:prims_hi] = sel[perm]
            split = prims_lo + count // 2

        emit(prims_lo, split)
        emit(split, prims_hi)
        node_end[idx] = len(node_bmin)
        return idx

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        emit(0, n)
    finally:
        sys.setrecursionlimit(old_limit)

    first = np.asarray(node_first, np.int32)
    count = np.asarray(node_count, np.int32)
    # Miss link of node i = first DFS node past i's subtree.
    miss = np.asarray(node_end, np.int32)
    return BVHArrays(
        np.asarray(node_bmin, np.float32),
        np.asarray(node_bmax, np.float32),
        first,
        count,
        miss,
        prim_out.astype(np.int32),
        "numpy",
    )


def _clip_poly(poly, ax, t, below):
    """Sutherland-Hodgman clip of a convex polygon against an axis
    plane; returns None when the kept side is (near) empty."""
    res = []
    k = poly.shape[0]
    for i in range(k):
        a, b = poly[i], poly[(i + 1) % k]
        da, db = a[ax] - t, b[ax] - t
        ina = (da <= 0.0) if below else (da >= 0.0)
        inb = (db <= 0.0) if below else (db >= 0.0)
        if ina:
            res.append(a)
        if ina != inb:
            f = da / (da - db)
            res.append(a + f * (b - a))
    if len(res) < 3:
        return None
    return np.asarray(res)


def presplit_refs(tri_v0, tri_v1, tri_v2, sph_center=None, sph_radius=None,
                  budget_factor=1.0):
    """Early split clipping (Ernst & Greiner 2007): split the largest
    triangle AABBs at their longest-axis midplane into clipped
    sub-references until the extra-reference budget is spent.

    Big-scene packet unions are driven by leaf/node bbox overlap; long
    thin architectural triangles (sponza's arches, beams) bound huge
    empty boxes that every nearby packet must visit. Splitting the
    BOUNDS (intersection still tests the full triangle — a duplicate
    hit is a real hit, so closest/any-hit stay exact) tightens the tree
    without touching traversal.

    Returns (ref_prim i32, ref_bmin f32 (R,3), ref_bmax f32 (R,3))
    covering all triangles AND spheres (sphere refs are never split),
    ordered with every triangle/sphere appearing at least once.
    """
    import heapq

    v0 = np.asarray(tri_v0, np.float64).reshape(-1, 3)
    v1 = np.asarray(tri_v1, np.float64).reshape(-1, 3)
    v2 = np.asarray(tri_v2, np.float64).reshape(-1, 3)
    n = v0.shape[0]
    budget = int(n * budget_factor)

    def half_area(lo, hi):
        d = hi - lo
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    heap = []
    serial = 0
    for i in range(n):
        poly = np.stack([v0[i], v1[i], v2[i]])
        lo, hi = poly.min(0), poly.max(0)
        heap.append((-half_area(lo, hi), serial, i, poly))
        serial += 1
    heapq.heapify(heap)
    done = []
    # Never split below this fraction of the mean box diagonal: tiny
    # refs cost table rows without shrinking unions further.
    if heap:
        mean_diag = float(np.mean([np.linalg.norm(
            e[3].max(0) - e[3].min(0)) for e in heap[: min(len(heap), 4096)]]))
    while heap and budget > 0:
        negA, _, prim, poly = heapq.heappop(heap)
        lo, hi = poly.min(0), poly.max(0)
        ax = int(np.argmax(hi - lo))
        if (hi[ax] - lo[ax]) < 0.25 * mean_diag:
            done.append((prim, lo, hi))
            continue
        mid = 0.5 * (lo[ax] + hi[ax])
        left = _clip_poly(poly, ax, mid, True)
        right = _clip_poly(poly, ax, mid, False)
        if left is None or right is None:
            done.append((prim, lo, hi))
            continue
        for piece in (left, right):
            heapq.heappush(heap, (-half_area(piece.min(0), piece.max(0)),
                                  serial, prim, piece))
            serial += 1
        budget -= 1
    for negA, _, prim, poly in heap:
        done.append((prim, poly.min(0), poly.max(0)))

    ref_prim = np.asarray([d[0] for d in done], np.int32)
    ref_bmin = np.asarray([d[1] for d in done], np.float32).reshape(-1, 3)
    ref_bmax = np.asarray([d[2] for d in done], np.float32).reshape(-1, 3)
    if sph_center is not None and np.asarray(sph_center).size:
        c = np.asarray(sph_center, np.float64).reshape(-1, 3)
        r = np.asarray(sph_radius, np.float64).reshape(-1, 1)
        ref_prim = np.concatenate(
            [ref_prim, n + np.arange(c.shape[0], dtype=np.int32)])
        ref_bmin = np.concatenate([ref_bmin, (c - r).astype(np.float32)])
        ref_bmax = np.concatenate([ref_bmax, (c + r).astype(np.float32)])
    return ref_prim, ref_bmin, ref_bmax


def build_bvh_over_refs(ref_bmin, ref_bmax, builder=None):
    """Binned-SAH BVH over arbitrary reference boxes (pre-split refs);
    prim_order in the result indexes REFS, not primitives."""
    bmin = np.asarray(ref_bmin, np.float64)
    bmax = np.asarray(ref_bmax, np.float64)
    cent = 0.5 * (bmin + bmax)
    return _build(bmin, bmax, cent, builder)
