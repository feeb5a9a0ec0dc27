// The lane-group BVH walk over the packet table, shared by the solo walk
// (packet_trace.cu, K3) and the dual walk (packet_trace_dual.cu, K4): one
// walk, one slab test, one primitive test and one set of tie rules. The
// two kernels differ only in how many rays a group walks in turn (K3: one
// on a 16-wide table, two on a 32-wide one; K4: two on a 16-wide table).
//
// A group is G lanes of one warp (G = 16 or 32, the table's width); its
// ballots and shuffles name its own lanes only. Lane k of a group tests
// child k of a supernode row (box_hit) or slot k of a leaf row
// (prim_hit); leaf_reduce folds the slots' hits into the ray's (best,
// prim) as a sequential strict t < best scan over the slots would. The
// tests are the reference's, operation for operation
// (gdpt_tpu/accel/packet_trace.py `super_mask`, `visit_leaf`), in the
// order of visit_microbench.cu's slab and tri (K5); every source that
// includes this file is built with --fmad=false. packet_trace.cu's
// top comment describes the walk and its stack.

#pragma once

#include <cuda_runtime.h>

#include "packet_visit.cuh"

// The G lanes of one warp that walk together (G = the table's width).
template <int G>
struct Lanes {
  unsigned mask;  // the group's lanes in the warp
  int base;       // the group's first lane in the warp
  int lane;       // this lane in the group
  __device__ __forceinline__ Lanes() {
    const int w = threadIdx.x & 31;
    base = G == 32 ? 0 : w & ~(G - 1);
    lane = G == 32 ? w : w & (G - 1);
    mask = G == 32 ? 0xffffffffu : (0xffffffffu >> (32 - G)) << base;
  }
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return __ballot_sync(mask, p) >> base;
  }
  template <class T>
  __device__ __forceinline__ T shfl(T v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
};

// One box of the slab test in the reference's operation order; the
// box is (min.x, min.y), (min.z, max.x), (max.y, max.z).
__device__ __forceinline__ bool box_hit(float2 a, float2 b, float2 c, const Ray& r,
                                        float best) {
  const float t0x = a.x * r.ix - r.oix, t1x = b.y * r.ix - r.oix;
  const float t0y = a.y * r.iy - r.oiy, t1y = c.x * r.iy - r.oiy;
  const float t0z = b.x * r.iz - r.oiz, t1z = c.y * r.iz - r.oiz;
  const float t_in = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), r.tnear));
  const float t_o = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fminf(fmaxf(t0z, t1z), best));
  return t_in <= t_o;
}

// One slot of the primitive test in the reference's operation order: a
// hit within [tnear, best), its distance in tt.
__device__ __forceinline__ bool prim_hit(const float* g, int pid, const Ray& r, int n_tris,
                                         float best, float& tt) {
  const float v0x = g[0], v0y = g[1], v0z = g[2];
  const float e1x = g[3], e1y = g[4], e1z = g[5];
  const float e2x = g[6], e2y = g[7], e2z = g[8];
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  if (n_tris >= 0 && pid >= n_tris) {
    const float r_s = e1x;
    const float a2 = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    const float inv_a = 1.0f / (a2 != 0.0f ? a2 : 1.0f);
    const float tm = -(r.dx * tx + r.dy * ty + r.dz * tz) * inv_a;
    const float mx = tx + r.dx * tm, my = ty + r.dy * tm, mz = tz + r.dz * tm;
    const float disc = r_s * r_s - (mx * mx + my * my + mz * mz);
    const float dtq = sqrtf(fmaxf(disc, 0.0f) * inv_a);
    const float s0 = tm - dtq, s1 = tm + dtq;
    const bool use_lo = s0 >= r.tnear && s0 < best;
    const bool use_hi = s1 >= r.tnear && s1 < best;
    tt = use_lo ? s0 : s1;
    return disc >= 0.0f && a2 != 0.0f && (use_lo || use_hi);
  }
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
  const float uu = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return det != 0.0f && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt >= r.tnear &&
         tt < best;
}

// An int that orders like the float t, with one key for -0.0 and +0.0.
__device__ __forceinline__ int t_key(float t) {
  const int b = __float_as_int(t);
  return t == 0.0f ? 0 : (b >= 0 ? b : b ^ 0x7fffffff);
}

// The child a pop peels off entry (e, m): the nearest pending one.
__device__ __forceinline__ int nearest(int e, unsigned m) {
  return (e >> 30) ? 31 - __clz(m) : __ffs(m) - 1;
}

// The end of a leaf visit of the group: each lane has tested its slot
// (pid -1: no primitive; hit, tt: prim_hit's result). Folds the group's
// hit into (best, prim) and the valid slots tested into n_tests; true
// when any hit and a slot blocks the ray. Closest hit takes the smallest
// t and among equal t the lowest slot: one reduction over keys that
// order like the floats, with -0.0 and +0.0 one key (they compare equal),
// as a sequential strict t < best scan treats them (that scan's result is
// this minimum); any hit takes the lowest blocking slot.
template <int W, bool ANY>
__device__ __forceinline__ bool leaf_reduce(bool hit, float tt, int pid, float& best, int& prim,
                                            int& n_tests, const Lanes<W>& g) {
  const unsigned valid = g.ballot(pid >= 0);
  unsigned hits = g.ballot(hit);
  if (hits == 0u) {
    n_tests += __popc(valid);
    return false;
  }
  if (!ANY) {
    const int kmin = __reduce_min_sync(g.mask, hit ? t_key(tt) : 0x7fffffff);
    hits = g.ballot(hit && t_key(tt) == kmin);
  }
  // The lowest slot in hits: the first among equal t, or the first
  // blocking slot.
  const int w = __ffs(hits) - 1;
  best = g.shfl(tt, w);
  prim = g.shfl(pid, w);
  n_tests += __popc(ANY ? valid & (0xffffffffu >> (31 - w)) : valid);
  return ANY;
}

struct WalkArgs {
  const int* table;
  int last;  // row clamp that leaves room for row B
  int depth;
  RayArrays rays;
  int n, n_tris, ceiling;
  float* t;
  int* prim;
  int* counts;
  int* overflow;
};

__device__ __forceinline__ void store(const WalkArgs& w, int i, float t, int prim, int n_super,
                                      int n_leaf, int n_tests, int deepest) {
  w.t[i] = t;
  w.prim[i] = prim;
  if (w.counts) {
    w.counts[4 * i + 0] = n_super;
    w.counts[4 * i + 1] = n_leaf;
    w.counts[4 * i + 2] = n_tests;
    w.counts[4 * i + 3] = deepest;
  }
}

#define WALK_BLOCK 128  // threads per block of either walk

// A ray as the walk keeps it: Ray without origin * inverse direction,
// which full() recomputes where a slab test needs it (three registers
// fewer under the walk's 48-register bound; the same products as
// make_ray's).
struct RayS {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tnear;
};

__device__ __forceinline__ Ray full(const RayS& s) {
  Ray r;
  r.ox = s.ox; r.oy = s.oy; r.oz = s.oz;
  r.dx = s.dx; r.dy = s.dy; r.dz = s.dz;
  r.ix = s.ix; r.iy = s.iy; r.iz = s.iz;
  r.oix = s.ox * s.ix; r.oiy = s.oy * s.iy; r.oiz = s.oz * s.iz;
  r.tnear = s.tnear;
  return r;
}

// A leaf visit of the group of W lanes: lane s tests slot s of rows lrow
// (slots 0..11) and lrow + 1 (12..23, W = 32); leaf_reduce folds the hit
// into (best, prim) and the valid slots tested into n_tests. True when any
// hit and a slot blocks the ray.
template <int W, bool ANY>
__device__ __forceinline__ bool leaf_visit_group(const int* __restrict__ table, int lrow,
                                                 const Ray& r, int n_tris, float& best,
                                                 int& prim, int& n_tests, const Lanes<W>& g) {
  const int s = g.lane;
  int pid = -1;
  bool hit = false;
  float tt = 0.0f;
  if (s < LEAF_TRIS * (W / 16)) {
    const int j = s % LEAF_TRIS;
    const int* row = table + (size_t)(lrow + s / LEAF_TRIS) * 128;
    float geo[9];
#pragma unroll
    for (int m = 0; m < 9; ++m) geo[m] = __ldg(reinterpret_cast<const float*>(row) + 9 * j + m);
    pid = __ldg(row + 108 + j);
    if (pid >= 0) hit = prim_hit(geo, pid, r, n_tris, best, tt);
  }
  return leaf_reduce<W, ANY>(hit, tt, pid, best, prim, n_tests, g);
}

// Live ray i's walk by the group of W lanes; lane 0 stores its results,
// and its visit counts only where COUNTS (the kernels built without keep
// no counters).
template <int W, bool ANY, bool COUNTS>
__device__ __forceinline__ void walk_ray(const WalkArgs& w, int i, const Lanes<W>& g) {
  constexpr int D = MAX_DEPTH / W;  // stack entries per lane
  const int* __restrict__ table = w.table;
  const RayArrays& a = w.rays;
  const Ray r0 = make_ray(a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i], a.tnear[i]);
  const RayS r = {r0.ox, r0.oy, r0.oz, r0.dx, r0.dy, r0.dz, r0.ix, r0.iy, r0.iz, r0.tnear};
  float best = a.tfar[i];
  int prim = -1;
  int n_super = 0, n_leaf = 0, n_tests = 0, deepest = 0;
  int node = a.rref ? a.rref[i] : 0;
  int sp = 0;            // stack entries, the top one included
  int top_e = 0;         // the top entry: row | reversed << 30,
  unsigned top_m = 0u;   // and its pending children
  int low_e[D];          // entry j < sp - 1: lane j % W, slot j / W
  unsigned low_m[D];
  int kid = 0;           // the ref of this lane's child at the last supernode visit
  bool fresh = false;    // the top entry is that visit's
#pragma unroll
  for (int d = 0; d < D; ++d) low_e[d] = 0, low_m[d] = 0u;
  for (int it = 0; it < w.ceiling; ++it) {
    // The ref the next pop reads if this visit pushes nothing.
    int next_old = 0;
    if (sp > 0) {
      const int k = nearest(top_e, top_m);
      next_old = __ldg(table + (size_t)((top_e & ROW_MASK) + (k >> 4)) * 128 + 96 + (k & 15));
    }
    if (node >= 0) {
      const int srow = min(node, w.last);
      const int* row0 = table + (size_t)srow * 128;
      const int k = g.lane;
      const int* row = W == 32 ? row0 + (k >> 4) * 128 : row0;
      const float2* bx = reinterpret_cast<const float2*>(row) + 3 * (k & 15);
      const float2 p = __ldg(bx), q = __ldg(bx + 1), u = __ldg(bx + 2);
      kid = __ldg(row + 96 + (k & 15));
      const unsigned mask =
          g.ballot(box_hit(p, q, u, full(r), best)) & (unsigned)__ldg(row0 + 120);
      const int axis = __ldg(row0 + 121);
      ++n_super;
      fresh = mask != 0u;
      if (fresh) {
        if (sp >= w.depth) {  // the table is deeper than its stack_n says
          deepest = w.depth + 1;
          if (g.lane == 0) atomicOr(w.overflow, 1);
          break;
        }
        const float sgn = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
        if (sp > 0) {  // the old top goes below
          const int j = sp - 1;
#pragma unroll
          for (int d = 0; d < D; ++d)
            if (d == j / W && g.lane == j % W) low_e[d] = top_e, low_m[d] = top_m;
        }
        top_e = srow | ((sgn <= 0.0f ? 1 : 0) << 30);
        top_m = mask;
        ++sp;
        deepest = max(deepest, sp);
      }
    } else {
      ++n_leaf;
      fresh = false;
      const int lrow = min((~node) & ROW_MASK, w.last);
      if (leaf_visit_group<W, ANY>(table, lrow, full(r), w.n_tris, best, prim, n_tests, g))
        break;
    }
    if (sp == 0) break;
    const int k = nearest(top_e, top_m);
    top_m &= ~(1u << k);
    node = fresh ? g.shfl(kid, k) : next_old;
    if (top_m == 0u) {
      --sp;
      if (sp > 0) {  // the entry below comes up
        const int j = sp - 1;
        int e = low_e[0];
        unsigned m = low_m[0];
#pragma unroll
        for (int d = 1; d < D; ++d)
          if (j / W == d) e = low_e[d], m = low_m[d];
        top_e = g.shfl(e, j % W);
        top_m = g.shfl(m, j % W);
      }
    }
  }
  if (g.lane == 0) {
    if (COUNTS)
      store(w, i, best, prim, n_super, n_leaf, n_tests, deepest);
    else
      store(w, i, best, prim, 0, 0, 0, 0);
  }
}

// The walk of one group of W lanes of a grid of WALK_BLOCK-thread blocks:
// group q takes rays K * q .. K * q + K - 1 (K <= W). Each of its first K
// lanes looks at one and settles it if it is dead (tfar < tnear: a miss,
// no work), so the dead lanes the wrapper's caller sorts to the back cost
// a lane, not a walk; the group walks the live ones in turn.
template <int W, int K, bool ANY, bool COUNTS>
__device__ __forceinline__ void walk_group(const WalkArgs& w) {
  static_assert(K >= 1 && K <= W, "a group settles its rays one lane each");
  const Lanes<W> g;
  const long long first = ((long long)blockIdx.x * (WALK_BLOCK / W) + threadIdx.x / W) * K;
  const long long i = first + g.lane;
  bool live = false;
  if (g.lane < K && i < w.n) {
    const float tf = w.rays.tfar[i];
    live = tf >= w.rays.tnear[i];
    if (!live) store(w, (int)i, tf, -1, 0, 0, 0, 0);
  }
  for (unsigned todo = g.ballot(live); todo != 0u; todo &= todo - 1u)
    walk_ray<W, ANY, COUNTS>(w, (int)first + __ffs(todo) - 1, g);
}

// Blocks for n > 0 rays at K rays per group of W lanes.
inline int walk_blocks(int n, int W, int K) { return (n - 1) / (WALK_BLOCK / W * K) + 1; }
