// Dual BVH walk over a 16-wide packet table: a group of 16 lanes walks a
// pair of adjacent rays, one after the other, Hopper (K4).
//
// Replaces the Pallas TPU kernel of gdpt_tpu/accel/packet_trace.py:
//   packet_trace_dual_kernel <- _make_kernel_dual (pallas_call at :1159,
//   chosen at :1143 by _trace_packets(dual=True)): K3's contract on
//   16-wide tables, two independent packets walked per grid step.
//
// What the TPU kernel is for: its solo walk stalls on a dependent chain
// (pop -> row load -> test -> push), and a second, independent walk fills
// the stalls. On this card the solo walk K3 (packet_trace.cu) is a group
// of lanes per ray, and what bounds it is the chain of instructions of
// each visit (loads, slab or primitive tests, ballots, pop, shuffles)
// over the warps an SM holds, not load latency inside a group: its time
// per visit is the same on rows that hit L1. Walking a pair with both
// visits in flight (both rays' loads issued before either test) needs
// both rays' state in every lane: 64 registers with about 170 B of spill,
// or 72 and fewer warps, and it lost to walking the pair in turn on every
// ray set (PERF.md has the designs and their times on an NVIDIA H100 80GB
// HBM3 at 700.00 W). So K4 is K3's walk (packet_group.cuh's walk_group)
// with a 16-lane group taking the pair in turn, at K3's 48 registers; the
// pair pays off where the gradpath lane pool's batches carry many dead
// lanes: lanes 0 and 1 check both rays at once and settle a dead one
// (tfar < tnear: a miss, no work), and the grid has half K3's groups.
//
// Pairing: group q of the grid walks rays 2q and 2q + 1 of the caller's
// order, which the wrapper's callers sort by morton key. Every visit is
// K3's, so each ray's (t, prim) and visit counts equal K3's on the same
// table bit for bit.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32): K3's, from the rays' own
// visits: 40 B per ray plus 512 B per table row read; 25 operations per
// slab test, 52 per primitive test.
//
// Build: as packet_trace.cu (--fmad=false).

#include <cuda_runtime.h>

#include "packet_group.cuh"

// A pair of rays per group of 16 lanes; __launch_bounds__(128, 10) caps
// registers at 48 per thread, as K3's.
template <bool ANY, bool COUNTS>
__global__ void __launch_bounds__(WALK_BLOCK, 10) packet_trace_dual_kernel(WalkArgs w) {
  walk_group<16, 2, ANY, COUNTS>(w);
}

template <bool ANY, bool COUNTS>
static void launch(const WalkArgs& w, cudaStream_t s) {
  packet_trace_dual_kernel<ANY, COUNTS><<<walk_blocks(w.n, 16, 2), WALK_BLOCK, 0, s>>>(w);
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
    const WalkArgs w = {table, n_rows - 1, depth, {ox, oy, oz, dx, dy, dz, tnear, tfar, rref},
                        n, n_tris, ceiling, t, prim, counts, overflow};
    cudaStream_t s = (cudaStream_t)stream;
    if (any_hit)
      counts ? launch<true, true>(w, s) : launch<true, false>(w, s);
    else
      counts ? launch<false, true>(w, s) : launch<false, false>(w, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
