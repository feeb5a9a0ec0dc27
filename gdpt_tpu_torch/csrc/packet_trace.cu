// BVH walk over the packet table, closest hit or any hit, Hopper (K3).
//
// Replaces the Pallas TPU kernel of gdpt_tpu/accel/packet_trace.py:
//   packet_trace_kernel <- _make_kernel (pallas_call at :1185, launched
//   by _trace_packets): the walk over the collapsed BVH table built by
//   build_packet_table, returning only (t, prim) per ray.
//
// Contract (as the TPU kernel's): the table is (R, 128) int32 rows with
// f32 payloads as bit patterns. A supernode is one row (16 children) or
// two (32): cols k*6..k*6+5 child AABB, cols 96..111 child refs, row A
// col 120 the validity bits, col 121 the axis the children are sorted
// along. A leaf group is one row (12 primitives) or two (24): cols
// 0..107 12 x (v0, e1, e2), cols 108..119 prim ids (-1 pads); a sphere
// rides as (center, radius, 0...) with prim id >= n_tris. A child ref
// >= 0 is a supernode row, < 0 a leaf group at (~ref) & (2^22 - 1).
// Rays are eight (N,) arrays (origin, direction, tnear, tfar) and an
// optional per-ray start ref (null = the root, row 0). Closest hit:
// t, prim of the nearest primitive within [tnear, tfar), else t = tfar,
// prim = -1. Any hit: prim >= 0 (and its t) of some blocking primitive.
// A lane with tfar < tnear is dead: no work, a miss. The tests are the
// reference's, operation for operation: the slab test bound*inv - org*inv
// with the |c| < 1e-18 direction guard, t_in <= t_out with tnear and the
// running best folded in; Moeller-Trumbore with strict t < best; the
// sphere roots.
//
// Walk: a group of G = W lanes of one warp walks one ray, where the TPU
// walks a 1024-ray packet over one shared stack. (A 32-wide table takes a
// whole warp per ray, a 16-wide one half a warp.) Every lane of a group
// follows the ray's one control flow, so nothing diverges inside a group;
// the group's ballots and shuffles name its own lanes only. The node's
// row lies across the lanes:
//   - supernode visit: lane k loads child k's box (three 8-byte loads; a
//     box is 24 B, so the group's loads cover the row's boxes contiguously)
//     and its ref, and runs the slab test; a group ballot cut to the
//     row's validity bits is the child mask;
//   - leaf visit: lane s loads slot s (nine words and its id) and tests
//     it. Closest hit takes the smallest t and among equal t the lowest
//     slot: one warp min reduction over ints that order like the floats,
//     with -0.0 and +0.0 one key, as a sequential strict t < best scan
//     treats them (that scan's result is this minimum); any hit takes the
//     lowest blocking slot.
// The walk per ray is the one the reference's tests imply and the plain
// version runs: a supernode visit pushes ONE entry (row | reversed << 30,
// child mask); each later step peels the nearest pending child, the
// lowest set bit, or the highest when the ray runs against the row's sort
// axis. The stack is group-uniform and lives in registers: the top entry
// in every lane, entry j below it in lane j % G. A pop right after a push
// reads the child's ref from its lane by shuffle; any other pop reads it
// from the table, a load issued before the visit that precedes it, so it
// overlaps that visit's own loads. The stack is as deep as the tree (at
// most stack_n / W entries, 32 compiled in). An iteration ceiling (4R + 64
// visits, as the reference's) ends a walk over a malformed table. A push
// that finds the stack full is never dropped silently: the ray stops, its
// deepest count reads depth + 1 and the kernel sets *overflow, which the
// wrapper turns into an error.
//
// Scheduling: a warp takes two consecutive rays (a 32-wide group walks
// both in turn, each 16-wide group one); each is first checked by one
// lane, and a dead ray is settled there (a miss, no work), so the dead
// lanes the wrapper's caller sorts to the back cost a lane, not a walk.
// Registers are held to 48 per thread (__launch_bounds__(128, 10)), which
// buys 40 resident warps per SM for a few bytes of spill. PERF.md has the
// designs this was measured against (one ray per group, a group of W / 2
// lanes, persistent and resident grids, leaf rows staged in shared
// memory) and their times.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32): the work depends on the
// rays. Bytes: 40 per ray in and out (44 with start refs), plus each table
// row the rays visit, once. Operations: a supernode visit is W slab tests
// of 25 operations (6 mul, 6 sub, 12 min/max, 1 compare), a primitive
// test 52 (Moeller-Trumbore). On a 409,612-triangle scene (24.4 MB of
// table, under the 50 MB L2) a bounce ray makes about 2 supernode and 2
// leaf visits with 16 primitive tests: 0.67 Gop and 31 MB per 262,144
// rays, about 10 us either way. The kernel is bound instead by the chain
// of each visit (the row loads, the tests, a ballot, the pop and its
// shuffle) over the 40 warps an SM holds: its time per visit stays the
// same when the rows hit L1, so coherent rays, which the
// one-thread-per-ray walk of packet_visit.cuh's bodies runs at a
// fraction of the cost, gain nothing here (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC. --fmad=false keeps every multiply and add
// separately rounded, as the plain PyTorch version does.

#include <cuda_runtime.h>

// From packet_visit.cuh the walk takes the ray set-up (Ray, make_ray,
// RayArrays) and the table constants; its visit bodies, which the dual
// walk K4 and the microbenchmark K5 run, are not used here.
#include "packet_visit.cuh"

#define K3_BLOCK 128  // threads per block

// The G lanes of one warp that walk one ray (G = the table's width).
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

// One box of test_boxes2 (packet_visit.cuh) in its operation order; the
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

// One slot of test_prims4 (packet_visit.cuh) in its operation order: a
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

// A leaf visit of the group of W lanes: lane s tests slot s of rows lrow
// (slots 0..11) and lrow + 1 (12..23, W = 32). Folds the hit into (best,
// prim) and the valid slots tested into n_tests; true when any hit and a
// slot blocks the ray.
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
  const unsigned valid = g.ballot(pid >= 0);
  unsigned hits = g.ballot(hit);
  if (hits == 0u) {
    n_tests += __popc(valid);
    return false;
  }
  if (!ANY) {
    // The group's smallest t: one reduction over keys that order like the
    // floats, with -0.0 and +0.0 one key (they compare equal).
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

// Live ray i's walk by the group of W lanes; lane 0 stores its results.
template <int W, bool ANY>
__device__ __forceinline__ void walk_ray(const WalkArgs& w, int i, const Lanes<W>& g) {
  constexpr int D = MAX_DEPTH / W;  // stack entries per lane
  const int* __restrict__ table = w.table;
  const RayArrays& a = w.rays;
  const Ray r = make_ray(a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i], a.tnear[i]);
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
      const unsigned mask = g.ballot(box_hit(p, q, u, r, best)) & (unsigned)__ldg(row0 + 120);
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
      if (leaf_visit_group<W, ANY>(table, lrow, r, w.n_tris, best, prim, n_tests, g)) break;
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
  if (g.lane == 0) store(w, i, best, prim, n_super, n_leaf, n_tests, deepest);
}

// A warp's two consecutive rays: K = W / 16 per group, rays K * q ..
// K * q + K - 1 for group q. Each of the group's first K lanes looks at
// one and settles it if it is dead (a miss, no work); the group walks the
// live ones in turn.
template <int W, bool ANY>
__global__ void __launch_bounds__(K3_BLOCK, 10) packet_trace_kernel(WalkArgs w) {
  constexpr int K = W / 16;
  const Lanes<W> g;
  const long long first = ((long long)blockIdx.x * (K3_BLOCK / W) + threadIdx.x / W) * K;
  const long long i = first + g.lane;
  bool live = false;
  if (g.lane < K && i < w.n) {
    const float tf = w.rays.tfar[i];
    live = tf >= w.rays.tnear[i];
    if (!live) store(w, (int)i, tf, -1, 0, 0, 0, 0);
  }
  for (unsigned todo = g.ballot(live); todo != 0u; todo &= todo - 1u)
    walk_ray<W, ANY>(w, (int)first + __ffs(todo) - 1, g);
}

template <int W, bool ANY>
static void launch(const WalkArgs& w, cudaStream_t s) {
  const int per_block = 2 * K3_BLOCK / 32;  // two rays per warp
  packet_trace_kernel<W, ANY><<<(w.n - 1) / per_block + 1, K3_BLOCK, 0, s>>>(w);
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a width or depth the kernel does not take.
// overflow: one int the kernel ORs 1 into when a ray's stack ran full.
int gdpt_trace_packets(const int* table, int n_rows, int width, int depth,
                       const float* ox, const float* oy, const float* oz,
                       const float* dx, const float* dy, const float* dz,
                       const float* tnear, const float* tfar, const int* rref,
                       int n, int n_tris, int any_hit, int ceiling,
                       float* t, int* prim, int* counts, int* overflow,
                       void* stream) {
  if ((width != 16 && width != 32) || depth < 1 || depth > MAX_DEPTH)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const WalkArgs w = {table, n_rows - width / 16, depth,
                        {ox, oy, oz, dx, dy, dz, tnear, tfar, rref},
                        n, n_tris, ceiling, t, prim, counts, overflow};
    cudaStream_t s = (cudaStream_t)stream;
    if (width == 32)
      any_hit ? launch<32, true>(w, s) : launch<32, false>(w, s);
    else
      any_hit ? launch<16, true>(w, s) : launch<16, false>(w, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
