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

#include "packet_visit.cuh"

// The visit bodies and the per-ray walk state live in packet_visit.cuh,
// shared with the dual walk (K4) and the visit microbenchmark (K5).
template <int W>
__global__ void __launch_bounds__(BLOCK)
packet_trace_kernel(const int* __restrict__ table, int n_rows, int depth, RayArrays rays,
                    int n, int n_tris, int any_hit, int ceiling,
                    float* __restrict__ t_out, int* __restrict__ prim_out,
                    int* __restrict__ counts, int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int last = n_rows - W / 16;  // row clamp that leaves room for row B
  Walk w;
  WalkStack stk;
  walk_init(w, rays, i, n);
  if (w.live) {
    for (int it = 0; it < ceiling; ++it) {
      if (!walk_visit<W>(w, stk, table, last, depth, n_tris, any_hit != 0, overflow)) break;
      if (!walk_pop(w, stk, table)) break;
    }
  }
  walk_store(w, i, t_out, prim_out, counts);
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
    const RayArrays rays = {ox, oy, oz, dx, dy, dz, tnear, tfar, rref};
    if (width == 32)
      packet_trace_kernel<32><<<blocks, BLOCK, 0, s>>>(
          table, n_rows, depth, rays, n, n_tris, any_hit, ceiling, t, prim, counts, overflow);
    else
      packet_trace_kernel<16><<<blocks, BLOCK, 0, s>>>(
          table, n_rows, depth, rays, n, n_tris, any_hit, ceiling, t, prim, counts, overflow);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
