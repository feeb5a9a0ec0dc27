// Ray set-up and table constants of the packet-table BVH walk, shared by
// the solo and dual walks (packet_trace.cu, K3; packet_trace_dual.cu, K4;
// both through packet_group.cuh) and the visit microbenchmark
// (visit_microbench.cu, K5), which each keep their own visit bodies.
//
// Table layout (gdpt_tpu_torch/accel/packet_trace.py): (R, 128) int32 rows
// with f32 payloads as bit patterns. A supernode is one row (16 children)
// or two (32): cols k*6..k*6+5 child AABB, cols 96..111 child refs, row A
// col 120 the validity bits, col 121 the axis the children are sorted
// along. A leaf group is one row (12 primitives) or two (24): cols 0..107
// 12 x (v0, e1, e2), cols 108..119 prim ids (-1 pads); a sphere rides as
// (center, radius, 0...) with prim id >= n_tris.
//
// The ray set-up is the reference's (gdpt_tpu/accel/packet_trace.py): the
// guarded inverse direction (|c| < 1e-18 -> +-1e20) and origin times it.
// Every source that includes this file is built with --fmad=false, so
// each multiply and add is rounded on its own, as in the plain PyTorch
// versions.

#pragma once

#include <cuda_runtime.h>

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
