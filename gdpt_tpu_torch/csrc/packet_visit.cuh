// Ray set-up, table constants and the one-thread-per-ray visit bodies of
// the packet-table BVH walk. The visit microbenchmark (visit_microbench.cu,
// K5) times these bodies, as the reference's microbenchmark times its
// own. The solo and dual walks (packet_trace.cu, K3; packet_trace_dual.cu,
// K4) walk a ray with a group of lanes (packet_group.cuh) and take only
// the ray set-up (Ray, make_ray, RayArrays) and the constants from here.
//
// Table layout (gdpt_tpu_torch/accel/packet_trace.py): (R, 128) int32 rows
// with f32 payloads as bit patterns. A supernode is one row (16 children)
// or two (32): cols k*6..k*6+5 child AABB, cols 96..111 child refs, row A
// col 120 the validity bits, col 121 the axis the children are sorted
// along. A leaf group is one row (12 primitives) or two (24): cols 0..107
// 12 x (v0, e1, e2), cols 108..119 prim ids (-1 pads); a sphere rides as
// (center, radius, 0...) with prim id >= n_tris.
//
// The tests are the reference's, operation for operation
// (gdpt_tpu/accel/packet_trace.py `super_mask`, `visit_leaf`): the slab
// test bound*inv - org*inv with the |c| < 1e-18 direction guard,
// t_in <= t_out with tnear and the running best folded in;
// Moeller-Trumbore with strict t < best; the sphere roots. Every source
// that includes this file is built with --fmad=false, so each multiply
// and add is rounded on its own, as in the plain PyTorch versions.
//
// Rows are read 16 bytes at a time: two boxes are 12 floats = three
// aligned float4 loads, four primitives are 36 floats = nine, their ids
// one int4. The *_sld variants read the same data with scalar 4-byte
// loads (the microbenchmark's "scalar load" modes).

#pragma once

#include <cuda_runtime.h>

#define BLOCK 128
#define MAX_DEPTH 32
#define LEAF_TRIS 12
#define ROW_MASK ((1 << 22) - 1)

__device__ __forceinline__ float inv_dir(float c) {
  const bool tiny = fabsf(c) < 1e-18f;
  return 1.0f / (tiny ? (c < 0.0f ? -1e-20f : 1e-20f) : c);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;  // origin, direction
  float ix, iy, iz;              // guarded 1 / direction
  float oix, oiy, oiz;           // origin * inverse direction
  float tnear;
};

struct RayArrays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tnear, *tfar;
  const int* rref;  // per-ray start ref, or null for the root (row 0)
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz, float tnear) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ix = inv_dir(dx); r.iy = inv_dir(dy); r.iz = inv_dir(dz);
  r.oix = ox * r.ix; r.oiy = oy * r.iy; r.oiz = oz * r.iz;
  r.tnear = tnear;
  return r;
}

// ---------------------------------------------------------------------------
// Supernode visit: slab tests of the child boxes into a bit mask.
// ---------------------------------------------------------------------------

struct Boxes2 { float4 a, b, c; };  // two child boxes, 12 floats

// Boxes 2p and 2p+1 (p in 0..7) of one row.
__device__ __forceinline__ Boxes2 load_boxes2(const int* row, int p) {
  const float4* q = reinterpret_cast<const float4*>(row + p * 12);
  Boxes2 g;
  g.a = __ldg(q); g.b = __ldg(q + 1); g.c = __ldg(q + 2);
  return g;
}

__device__ __forceinline__ Boxes2 load_boxes2_sld(const int* row, int p) {
  const float* f = reinterpret_cast<const float*>(row) + p * 12;
  Boxes2 g;
  g.a = make_float4(__ldg(f), __ldg(f + 1), __ldg(f + 2), __ldg(f + 3));
  g.b = make_float4(__ldg(f + 4), __ldg(f + 5), __ldg(f + 6), __ldg(f + 7));
  g.c = make_float4(__ldg(f + 8), __ldg(f + 9), __ldg(f + 10), __ldg(f + 11));
  return g;
}

// Bit h is set when the ray enters box h of the pair within [tnear, best].
__device__ __forceinline__ unsigned test_boxes2(const Boxes2& g, const Ray& r, float best) {
  const float bx[2][6] = {{g.a.x, g.a.y, g.a.z, g.a.w, g.b.x, g.b.y},
                          {g.b.z, g.b.w, g.c.x, g.c.y, g.c.z, g.c.w}};
  unsigned bits = 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* b = bx[h];
    const float t0x = b[0] * r.ix - r.oix, t1x = b[3] * r.ix - r.oix;
    const float t0y = b[1] * r.iy - r.oiy, t1y = b[4] * r.iy - r.oiy;
    const float t0z = b[2] * r.iz - r.oiz, t1z = b[5] * r.iz - r.oiz;
    const float t_in = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), r.tnear));
    const float t_o = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                            fminf(fmaxf(t0z, t1z), best));
    if (t_in <= t_o) bits |= 1u << h;
  }
  return bits;
}

// The W children of a supernode whose first 16 boxes sit in row0 and, for
// W = 32, the other 16 in row1: the mask of children the ray enters,
// already cut to the valid ones (row0 col 120). The second row is reached
// as an offset from the first, and only where the width has one (a select
// between two pointers inside the loop cost the one-thread-per-ray walk
// that once ran these bodies 2-5%).
template <int W, bool SCALAR_LOADS = false>
__device__ __forceinline__ unsigned super_visit(const int* row0, const int* row1,
                                                const Ray& r, float best) {
  unsigned mask = 0u;
#pragma unroll 2
  for (int p = 0; p < W / 2; ++p) {
    const int* row = W == 32 ? row0 + (p >> 3) * (row1 - row0) : row0;
    const Boxes2 g = SCALAR_LOADS ? load_boxes2_sld(row, p & 7) : load_boxes2(row, p & 7);
    mask |= test_boxes2(g, r, best) << (2 * p);
  }
  return mask & (unsigned)__ldg(row0 + 120);
}

// Two independent 16-wide supernode visits with their bodies interleaved:
// both rows' loads of a box pair are started before either test.
__device__ __forceinline__ void super_visit2(const int* row_a, const Ray& ra, float best_a,
                                             unsigned& mask_a, const int* row_b,
                                             const Ray& rb, float best_b, unsigned& mask_b) {
  unsigned ma = 0u, mb = 0u;
#pragma unroll 2
  for (int p = 0; p < 8; ++p) {
    const Boxes2 ga = load_boxes2(row_a, p);
    const Boxes2 gb = load_boxes2(row_b, p);
    ma |= test_boxes2(ga, ra, best_a) << (2 * p);
    mb |= test_boxes2(gb, rb, best_b) << (2 * p);
  }
  mask_a = ma & (unsigned)__ldg(row_a + 120);
  mask_b = mb & (unsigned)__ldg(row_b + 120);
}

// ---------------------------------------------------------------------------
// Leaf visit: primitive tests, four slots at a time.
// ---------------------------------------------------------------------------

struct Geo4 { float g[36]; };  // four primitives x (v0, e1, e2)

// Ids of slots 4q..4q+3 (q in 0..2) of one leaf row.
__device__ __forceinline__ int4 load_ids4(const int* row, int q) {
  return __ldg(reinterpret_cast<const int4*>(row + 108) + q);
}

__device__ __forceinline__ int4 load_ids4_sld(const int* row, int q) {
  const int* f = row + 108 + 4 * q;
  return make_int4(__ldg(f), __ldg(f + 1), __ldg(f + 2), __ldg(f + 3));
}

__device__ __forceinline__ Geo4 load_geo4(const int* row, int q) {
  const float4* gq = reinterpret_cast<const float4*>(row + q * 36);
  Geo4 o;
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    const float4 v = __ldg(gq + m);
    o.g[4 * m] = v.x; o.g[4 * m + 1] = v.y; o.g[4 * m + 2] = v.z; o.g[4 * m + 3] = v.w;
  }
  return o;
}

__device__ __forceinline__ Geo4 load_geo4_sld(const int* row, int q) {
  const float* f = reinterpret_cast<const float*>(row) + q * 36;
  Geo4 o;
#pragma unroll
  for (int m = 0; m < 36; ++m) o.g[m] = __ldg(f + m);
  return o;
}

// Tests the (up to) four primitives in slot order against [tnear, best),
// folding a hit into (best, prim). Returns true when any_hit is set and
// a primitive blocks the ray (the later slots are then not tested).
__device__ __forceinline__ bool test_prims4(const int4& ids, const Geo4& geo, const Ray& r,
                                            int n_tris, bool any_hit, float& best,
                                            int& prim, int& n_tests) {
  const int pids[4] = {ids.x, ids.y, ids.z, ids.w};
  bool blocked = false;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if (blocked) break;
    const int pid = pids[h];
    if (pid < 0) continue;
    ++n_tests;
    const float* g = geo.g + 9 * h;
    const float v0x = g[0], v0y = g[1], v0z = g[2];
    const float e1x = g[3], e1y = g[4], e1z = g[5];
    const float e2x = g[6], e2y = g[7], e2z = g[8];
    const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
    float tt;
    bool hit;
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
      hit = disc >= 0.0f && a2 != 0.0f && (use_lo || use_hi);
    } else {
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
      hit = det != 0.0f && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
            tt >= r.tnear && tt < best;
    }
    if (hit) {
      best = tt;
      prim = pid;
      blocked = any_hit;
    }
  }
  return blocked;
}

// A leaf group of S rows (row0, and row1 for S = 2). STOP_AT_PAD: ids fill
// a group from the front, so the walk stops at the first four-slot chunk
// whose first id is a pad; the microbenchmark, which reads arbitrary rows
// as leaves, tests every slot (pads are skipped one by one).
template <int S, bool STOP_AT_PAD, bool SCALAR_LOADS = false>
__device__ __forceinline__ bool leaf_visit(const int* row0, const int* row1, const Ray& r,
                                           int n_tris, bool any_hit, float& best, int& prim,
                                           int& n_tests) {
  for (int q4 = 0; q4 < 3 * S; ++q4) {
    const int* row = S == 2 ? row0 + (q4 / 3) * (row1 - row0) : row0;
    const int q = S == 2 ? q4 % 3 : q4;
    const int4 ids = SCALAR_LOADS ? load_ids4_sld(row, q) : load_ids4(row, q);
    if (STOP_AT_PAD && ids.x < 0) break;
    const Geo4 geo = SCALAR_LOADS ? load_geo4_sld(row, q) : load_geo4(row, q);
    if (test_prims4(ids, geo, r, n_tris, any_hit, best, prim, n_tests)) return true;
  }
  return false;
}

// Two independent one-row leaf visits with their bodies interleaved: per
// four-slot chunk both rows' loads are started before either test; A's
// chunk is tested before B's. The two sides may name the same (best,
// prim) (the microbenchmark does): the tests then fold in this order.
template <bool STOP_AT_PAD>
__device__ __forceinline__ void leaf_visit2(
    const int* row_a, const Ray& ra, float& best_a, int& prim_a, int& tests_a, bool& blocked_a,
    const int* row_b, const Ray& rb, float& best_b, int& prim_b, int& tests_b, bool& blocked_b,
    int n_tris, bool any_hit) {
  bool done_a = false, done_b = false;
  blocked_a = blocked_b = false;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    int4 ids_a = make_int4(-1, -1, -1, -1), ids_b = ids_a;
    Geo4 geo_a, geo_b;
    if (!done_a) {
      ids_a = load_ids4(row_a, q);
      done_a = STOP_AT_PAD && ids_a.x < 0;
    }
    if (!done_b) {
      ids_b = load_ids4(row_b, q);
      done_b = STOP_AT_PAD && ids_b.x < 0;
    }
    if (!done_a) geo_a = load_geo4(row_a, q);
    if (!done_b) geo_b = load_geo4(row_b, q);
    if (!done_a)
      done_a = blocked_a = test_prims4(ids_a, geo_a, ra, n_tris, any_hit, best_a, prim_a, tests_a);
    if (!done_b)
      done_b = blocked_b = test_prims4(ids_b, geo_b, rb, n_tris, any_hit, best_b, prim_b, tests_b);
  }
}

// A 16-wide supernode visit of one ray interleaved with a one-row leaf
// visit of another: box pairs 3q..3q+2 ride with leaf chunk q.
template <bool STOP_AT_PAD>
__device__ __forceinline__ void super_leaf_visit(
    const int* row_s, const Ray& rs, float best_s, unsigned& mask_s,
    const int* row_l, const Ray& rl, float& best_l, int& prim_l, int& tests_l, bool& blocked_l,
    int n_tris, bool any_hit) {
  unsigned ms = 0u;
  bool done = false;
  blocked_l = false;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    int4 ids = make_int4(-1, -1, -1, -1);
    Geo4 geo;
    if (!done) {
      ids = load_ids4(row_l, q);
      done = STOP_AT_PAD && ids.x < 0;
    }
    Boxes2 bx[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (3 * q + k < 8) bx[k] = load_boxes2(row_s, 3 * q + k);
    if (!done) geo = load_geo4(row_l, q);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (3 * q + k < 8) ms |= test_boxes2(bx[k], rs, best_s) << (2 * (3 * q + k));
    if (!done)
      done = blocked_l = test_prims4(ids, geo, rl, n_tris, any_hit, best_l, prim_l, tests_l);
  }
  mask_s = ms & (unsigned)__ldg(row_s + 120);
}
