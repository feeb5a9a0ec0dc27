// Dual BVH walk over a 16-wide packet table: one thread walks two rays
// with their visit bodies interleaved, Hopper (K4).
//
// Replaces the Pallas TPU kernel of gdpt_tpu/accel/packet_trace.py:
//   packet_trace_dual_kernel <- _make_kernel_dual (pallas_call at :1159,
//   chosen at :1143 by _trace_packets(dual=True)): K3's contract on
//   16-wide tables, two independent packets walked per grid step.
//
// What the TPU kernel is for: its solo walk stalls on a dependent chain
// (pop -> row load -> test -> push), and a second, independent walk fills
// the stalls. K3 on this card has the same chain per thread (the child
// ref of one visit names the row of the next), so this kernel carries
// the idea over, not the TPU's packet machinery: each thread owns two
// rays, each with its own (row, mask) stack, best t and prim. Per loop
// iteration every live ray makes one visit, and where both are live the
// two visits run as one interleaved body (packet_visit.cuh: super_visit2,
// leaf_visit2, super_leaf_visit), in which the 16-byte row loads of both
// rays are started before either ray's arithmetic. The loop ends when both
// rays have drained (or are blocked, any hit); a drained ray idles
// without touching its state. The reference measured its dual kernel
// slower than solo on its TPU (packet_trace.py:842-850) and kept it as an
// A/B switch; PERF.md has what this card says.
//
// The two rays never interact and every test is K3's in K3's order, so
// each ray's (t, prim) and visit counts equal K3's on the same table bit
// for bit.
//
// Pairing: thread j of block b takes rays b*2*BLOCK + j and
// b*2*BLOCK + BLOCK + j. Neighbouring threads then read neighbouring
// elements of the ray arrays for the first ray and again for the second,
// so both sets of loads and both sets of stores coalesce (pairing rays 2j
// and 2j+1 would stride every access by two). Where the second index is
// >= n the second ray is dead from the start, as the reference pads an
// odd packet count with one dead packet. For morton-sorted rays the two
// rays of a thread lie BLOCK places apart in the sort: near, not
// adjacent.
//
// Contract: gdpt_trace_packets' (packet_trace.cu) with width 16 only:
// eight (N,) ray arrays, an optional per-ray start ref, n_tris for
// in-table spheres, closest or any hit, the visit ceiling counted per
// ray, optional (N, 4) counts, the overflow flag.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32): K3's, from the rays' own
// visits: 40 B per ray plus 512 B per table row read; 25 operations per
// slab test, 52 per primitive test. Two 32-entry stacks double the local
// memory per thread (512 B).
//
// Build: as packet_trace.cu (--fmad=false).

#include <cuda_runtime.h>

#include "packet_visit.cuh"

__global__ void __launch_bounds__(BLOCK)
packet_trace_dual_kernel(const int* __restrict__ table, int n_rows, int depth, RayArrays rays,
                         int n, int n_tris, int any_hit_i, int ceiling,
                         float* __restrict__ t_out, int* __restrict__ prim_out,
                         int* __restrict__ counts, int* __restrict__ overflow) {
  const int ia = blockIdx.x * (2 * BLOCK) + threadIdx.x;
  const int ib = ia + BLOCK;
  if (ia >= n) return;
  const bool any_hit = any_hit_i != 0;
  const int last = n_rows - 1;
  Walk a, b;
  WalkStack stk_a, stk_b;
  walk_init(a, rays, ia, n);
  walk_init(b, rays, ib, n);
  while (a.live || b.live) {
    const bool live_a = a.live, live_b = b.live, both = live_a && live_b;
    const bool sup_a = a.node >= 0, sup_b = b.node >= 0;
    const int ra = sup_a ? super_row(a, last) : leaf_row(a, last);
    const int rb = sup_b ? super_row(b, last) : leaf_row(b, last);
    const int* row_a = table + (size_t)ra * 128;
    const int* row_b = table + (size_t)rb * 128;
    bool go_a = false, go_b = false;
    if (both && sup_a && sup_b) {
      unsigned ma, mb;
      super_visit2(row_a, a.ray, a.best, ma, row_b, b.ray, b.best, mb);
      go_a = walk_push(a, stk_a, table, ra, ma, depth, overflow);
      go_b = walk_push(b, stk_b, table, rb, mb, depth, overflow);
    } else if (both && !sup_a && !sup_b) {
      bool blk_a, blk_b;
      leaf_visit2<true>(row_a, a.ray, a.best, a.prim, a.n_tests, blk_a,
                        row_b, b.ray, b.best, b.prim, b.n_tests, blk_b, n_tris, any_hit);
      ++a.n_leaf;
      ++b.n_leaf;
      go_a = !blk_a;
      go_b = !blk_b;
    } else if (both && sup_a) {
      unsigned ma;
      bool blk_b;
      super_leaf_visit<true>(row_a, a.ray, a.best, ma, row_b, b.ray, b.best, b.prim,
                             b.n_tests, blk_b, n_tris, any_hit);
      go_a = walk_push(a, stk_a, table, ra, ma, depth, overflow);
      ++b.n_leaf;
      go_b = !blk_b;
    } else if (both) {  // a at a leaf group, b at a supernode
      unsigned mb;
      bool blk_a;
      super_leaf_visit<true>(row_b, b.ray, b.best, mb, row_a, a.ray, a.best, a.prim,
                             a.n_tests, blk_a, n_tris, any_hit);
      ++a.n_leaf;
      go_a = !blk_a;
      go_b = walk_push(b, stk_b, table, rb, mb, depth, overflow);
    } else {  // one ray alone: K3's visit
      if (live_a) go_a = walk_visit<16>(a, stk_a, table, last, depth, n_tris, any_hit, overflow);
      if (live_b) go_b = walk_visit<16>(b, stk_b, table, last, depth, n_tris, any_hit, overflow);
    }
    // One pop per ray on a common path, whatever kind of visit it made.
    if (live_a) walk_next(a, stk_a, table, ceiling, go_a);
    if (live_b) walk_next(b, stk_b, table, ceiling, go_b);
  }
  walk_store(a, ia, t_out, prim_out, counts);
  if (ib < n) walk_store(b, ib, t_out, prim_out, counts);
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a depth the kernel does not take. The table
// must be 16-wide (the wrapper checks). overflow: one int the kernel ORs
// 1 into when a ray's stack ran full.
int gdpt_trace_packets_dual(const int* table, int n_rows, int depth,
                            const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const float* tnear, const float* tfar, const int* rref,
                            int n, int n_tris, int any_hit, int ceiling,
                            float* t, int* prim, int* counts, int* overflow,
                            void* stream) {
  if (depth < 1 || depth > MAX_DEPTH) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + 2 * BLOCK - 1) / (2 * BLOCK);
    const RayArrays rays = {ox, oy, oz, dx, dy, dz, tnear, tfar, rref};
    packet_trace_dual_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        table, n_rows, depth, rays, n, n_tris, any_hit, ceiling, t, prim, counts, overflow);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
