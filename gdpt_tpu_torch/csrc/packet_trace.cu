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
// Walk: one thread per ray with its own stack, where the TPU walks a
// 1024-ray packet over one shared stack (it has no per-lane gather and
// pays for the union of its rays' nodes). A supernode visit tests its W
// child boxes into a bit mask and pushes ONE entry (row | reversed << 30,
// mask); each later step peels the nearest pending child: the lowest set
// bit, or the highest when the ray runs against the row's sort axis. So
// the stack is as deep as the tree (at most stack_n / W entries, 32
// compiled in), not W times that, and children are visited nearest first
// by the ray's own direction. An iteration ceiling (4R + 64 visits, as
// the reference's) ends a walk over a malformed table. A push that finds
// the stack full (a table whose stack_n understates its depth) is never
// dropped silently: the ray stops, its deepest count reads depth + 1 and
// the kernel sets *overflow, which the wrapper turns into an error.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32): the work depends on the
// rays. Bytes: 40 per ray in and out (44 with start refs), plus each table
// row the rays visit, once. Operations: a supernode visit is W slab tests
// of 25 operations (6 mul, 6 sub, 12 min/max, 1 compare), a primitive
// test 52 (Moeller-Trumbore); the optional counts output gives a run's
// visits. On a 409,612-triangle scene (24.4 MB of table, under the 50 MB
// L2) a bounce ray makes about 2 supernode and 2 leaf visits with 16
// primitive tests: 0.67 Gop and 31 MB per 262,144 rays, about 10 us
// either way. The kernel takes some 35 times that: every
// thread reads rows that no other thread of its warp may want, so a
// warp-wide load touches up to 32 sectors, and each visit waits on the
// child ref of the one before. The rows are therefore read 16 bytes at
// a time (two boxes are three aligned float4 loads, four primitives
// nine), which halved the time of the first version's scalar 4-byte
// loads. Rays sorted by the caller keep a warp's threads in one subtree.
// A warp sharing a row and shared-memory staging of the top levels are
// later work (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC. --fmad=false keeps every multiply and add
// separately rounded, as the plain PyTorch version does.

#include <cuda_runtime.h>

#define BLOCK 128
#define MAX_DEPTH 32
#define LEAF_TRIS 12
#define ROW_MASK ((1 << 22) - 1)

__device__ __forceinline__ float inv_dir(float c) {
  const bool tiny = fabsf(c) < 1e-18f;
  return 1.0f / (tiny ? (c < 0.0f ? -1e-20f : 1e-20f) : c);
}

template <int W>
__global__ void __launch_bounds__(BLOCK)
packet_trace_kernel(const int* __restrict__ table, int n_rows, int depth,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ tnear_in, const float* __restrict__ tfar_in,
                    const int* __restrict__ rref, int n, int n_tris, int any_hit,
                    int ceiling, float* __restrict__ t_out, int* __restrict__ prim_out,
                    int* __restrict__ counts, int* __restrict__ overflow) {
  constexpr int S = W / 16;  // rows per supernode and per leaf group
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tnear = tnear_in[i];
  float best = tfar_in[i];
  int prim = -1;
  int n_super = 0, n_leaf = 0, n_tests = 0, deepest = 0;
  if (best >= tnear) {
    const float o_x = ox[i], o_y = oy[i], o_z = oz[i];
    const float d_x = dx[i], d_y = dy[i], d_z = dz[i];
    const float i_x = inv_dir(d_x), i_y = inv_dir(d_y), i_z = inv_dir(d_z);
    const float oi_x = o_x * i_x, oi_y = o_y * i_y, oi_z = o_z * i_z;
    const int last = n_rows - S;  // row clamp that leaves room for row B
    int stk_row[MAX_DEPTH];
    unsigned stk_mask[MAX_DEPTH];
    int sp = 0;
    int node = rref ? rref[i] : 0;
    for (int it = 0; it < ceiling; ++it) {
      if (node >= 0) {
        // ---- supernode visit ----
        const int srow = min(node, last);
        const int* row = table + (size_t)srow * 128;
        unsigned mask = 0u;
#pragma unroll 2
        for (int p = 0; p < W / 2; ++p) {
          // Two boxes = 12 floats = three aligned 16-byte loads.
          const float4* q = reinterpret_cast<const float4*>(row + (p >> 3) * 128 + (p & 7) * 12);
          const float4 a = __ldg(q), b4 = __ldg(q + 1), c = __ldg(q + 2);
          const float bx[2][6] = {{a.x, a.y, a.z, a.w, b4.x, b4.y},
                                  {b4.z, b4.w, c.x, c.y, c.z, c.w}};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* b = bx[h];
            const float t0x = b[0] * i_x - oi_x, t1x = b[3] * i_x - oi_x;
            const float t0y = b[1] * i_y - oi_y, t1y = b[4] * i_y - oi_y;
            const float t0z = b[2] * i_z - oi_z, t1z = b[5] * i_z - oi_z;
            const float t_in = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                     fmaxf(fminf(t0z, t1z), tnear));
            const float t_o = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                    fminf(fmaxf(t0z, t1z), best));
            if (t_in <= t_o) mask |= 1u << (2 * p + h);
          }
        }
        mask &= (unsigned)row[120];
        ++n_super;
        if (mask != 0u) {
          if (sp >= depth) {  // the table is deeper than its stack_n says
            deepest = depth + 1;
            atomicOr(overflow, 1);
            break;
          }
          const int axis = row[121];
          const float sgn = axis == 0 ? d_x : (axis == 1 ? d_y : d_z);
          stk_row[sp] = srow | ((sgn <= 0.0f ? 1 : 0) << 30);
          stk_mask[sp] = mask;
          ++sp;
          deepest = max(deepest, sp);
        }
      } else {
        // ---- leaf visit ----
        const int lrow = min((~node) & ROW_MASK, last);
        const int* row = table + (size_t)lrow * 128;
        ++n_leaf;
        bool blocked = false;
        for (int q4 = 0; q4 < 3 * S && !blocked; ++q4) {
          // Four primitives = 36 floats = nine aligned 16-byte loads;
          // their ids = one.
          const int* r = row + (q4 / 3) * 128;
          const int4 ids = __ldg(reinterpret_cast<const int4*>(r + 108) + q4 % 3);
          if (ids.x < 0) break;  // ids fill a group from the front
          const float4* gq = reinterpret_cast<const float4*>(r + (q4 % 3) * 36);
          float gg[36];
#pragma unroll
          for (int m = 0; m < 9; ++m) {
            const float4 v = __ldg(gq + m);
            gg[4 * m] = v.x; gg[4 * m + 1] = v.y; gg[4 * m + 2] = v.z; gg[4 * m + 3] = v.w;
          }
          const int pids[4] = {ids.x, ids.y, ids.z, ids.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            if (blocked) break;
            const int pid = pids[h];
            if (pid < 0) continue;
            ++n_tests;
            const float* g = gg + 9 * h;
            const float v0x = g[0], v0y = g[1], v0z = g[2];
            const float e1x = g[3], e1y = g[4], e1z = g[5];
            const float e2x = g[6], e2y = g[7], e2z = g[8];
            const float tx = o_x - v0x, ty = o_y - v0y, tz = o_z - v0z;
            float tt;
            bool hit;
            if (n_tris >= 0 && pid >= n_tris) {
              const float r_s = e1x;
              const float a2 = d_x * d_x + d_y * d_y + d_z * d_z;
              const float inv_a = 1.0f / (a2 != 0.0f ? a2 : 1.0f);
              const float tm = -(d_x * tx + d_y * ty + d_z * tz) * inv_a;
              const float mx = tx + d_x * tm, my = ty + d_y * tm, mz = tz + d_z * tm;
              const float disc = r_s * r_s - (mx * mx + my * my + mz * mz);
              const float dtq = sqrtf(fmaxf(disc, 0.0f) * inv_a);
              const float s0 = tm - dtq, s1 = tm + dtq;
              const bool use_lo = s0 >= tnear && s0 < best;
              const bool use_hi = s1 >= tnear && s1 < best;
              tt = use_lo ? s0 : s1;
              hit = disc >= 0.0f && a2 != 0.0f && (use_lo || use_hi);
            } else {
              const float px = d_y * e2z - d_z * e2y;
              const float py = d_z * e2x - d_x * e2z;
              const float pz = d_x * e2y - d_y * e2x;
              const float det = e1x * px + e1y * py + e1z * pz;
              const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
              const float uu = (tx * px + ty * py + tz * pz) * inv_det;
              const float qx = ty * e1z - tz * e1y;
              const float qy = tz * e1x - tx * e1z;
              const float qz = tx * e1y - ty * e1x;
              const float vv = (d_x * qx + d_y * qy + d_z * qz) * inv_det;
              tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
              hit = det != 0.0f && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                    tt >= tnear && tt < best;
            }
            if (hit) {
              best = tt;
              prim = pid;
              blocked = any_hit != 0;
            }
          }
        }
        if (blocked) break;
      }
      // ---- next node: peel the nearest pending child ----
      if (sp == 0) break;
      const int e = stk_row[sp - 1];
      unsigned m = stk_mask[sp - 1];
      const int k = (e >> 30) ? 31 - __clz(m) : __ffs(m) - 1;
      m &= ~(1u << k);
      if (m == 0u) --sp; else stk_mask[sp - 1] = m;
      node = table[(size_t)((e & ROW_MASK) + (k >> 4)) * 128 + 96 + (k & 15)];
    }
  }
  t_out[i] = best;
  prim_out[i] = prim;
  if (counts) {
    counts[4 * i + 0] = n_super;
    counts[4 * i + 1] = n_leaf;
    counts[4 * i + 2] = n_tests;
    counts[4 * i + 3] = deepest;
  }
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
    const int blocks = (n + BLOCK - 1) / BLOCK;
    cudaStream_t s = (cudaStream_t)stream;
    if (width == 32)
      packet_trace_kernel<32><<<blocks, BLOCK, 0, s>>>(
          table, n_rows, depth, ox, oy, oz, dx, dy, dz, tnear, tfar, rref, n,
          n_tris, any_hit, ceiling, t, prim, counts, overflow);
    else
      packet_trace_kernel<16><<<blocks, BLOCK, 0, s>>>(
          table, n_rows, depth, ox, oy, oz, dx, dy, dz, tnear, tfar, rref, n,
          n_tris, any_hit, ceiling, t, prim, counts, overflow);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
