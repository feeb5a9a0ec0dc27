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
// The dual walk K4 (packet_trace_dual.cu) is this walk with a 16-wide
// group taking two rays in turn. Registers are held to 48 per thread
// (__launch_bounds__(128, 10)), which buys 40 resident warps per SM for a
// few bytes of spill. PERF.md has the designs this was measured against
// (one ray per group, a group of W / 2 lanes, persistent and resident
// grids, leaf rows staged in shared memory) and their times.
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
// same when the rows hit L1, so coherent rays, whose shared rows the
// microbenchmark K5 (visit_microbench.cu) visits at a fraction of the
// cost, gain nothing here (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC. --fmad=false keeps every multiply and add
// separately rounded, as the plain PyTorch version does.

#include <cuda_runtime.h>

// packet_group.cuh holds the walk (walk_group, walk_ray), which K4
// shares, with its lane group, tests, pop order and leaf reduction; it
// takes packet_visit.cuh's ray set-up and table constants.
#include "packet_group.cuh"

// A warp's two consecutive rays: K = W / 16 per group of W lanes.
template <int W, bool ANY, bool COUNTS>
__global__ void __launch_bounds__(WALK_BLOCK, 10) packet_trace_kernel(WalkArgs w) {
  walk_group<W, W / 16, ANY, COUNTS>(w);
}

template <int W, bool ANY, bool COUNTS>
static void launch(const WalkArgs& w, cudaStream_t s) {
  packet_trace_kernel<W, ANY, COUNTS><<<walk_blocks(w.n, W, W / 16), WALK_BLOCK, 0, s>>>(w);
}

template <int W>
static void dispatch(const WalkArgs& w, bool any_hit, cudaStream_t s) {
  if (any_hit)
    w.counts ? launch<W, true, true>(w, s) : launch<W, true, false>(w, s);
  else
    w.counts ? launch<W, false, true>(w, s) : launch<W, false, false>(w, s);
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
    width == 32 ? dispatch<32>(w, any_hit, s) : dispatch<16>(w, any_hit, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
