// Brute-force ray casting for scenes of at most 128 primitives, Hopper.
//
// Replaces the two Pallas TPU kernels of gdpt_tpu/accel/pallas_intersect.py:
//   K1 intersect_brute_kernel <- _tri_kernel_body (pallas_call at :170,
//      launched by pallas_intersect_brute): closest hit of each ray over
//      all triangles (Moeller-Trumbore) then all spheres.
//   K2 occluded_brute_kernel  <- _anyhit_kernel_body (pallas_call at :307,
//      launched by pallas_occluded_brute): any hit within [tnear, tfar).
//
// Contract: soups are (9, T) rows v0.xyz e1.xyz e2.xyz and (4, S) rows
// center.xyz radius, T, S <= 128. Rays are six (N,) component arrays and
// a per-ray tfar; both kernels look for hits within [tnear, tfar), and a
// lane with tfar <= tnear (or NaN) is dead: it runs no test. K1's running
// best is replaced on strict t < best, so the lowest primitive index wins
// a tie and every triangle comes before every sphere. K1 writes t, prim,
// u, v and the unnormalized geometric normal (cross(e1, e2), or hit -
// centre for a sphere); a miss, dead lanes included, gets t = BIG, prim
// -1, u = v = 0, g = (0, 0, 1). u and v are the closest triangle's, also
// when a sphere in front of it wins, as in the TPU kernel. K2 writes 0/1
// as float.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), for K1 at the 512x512 cbox (T = 32, S = 0, N = 262,144, all
// live): bytes: 28 in + 28 out per ray = 14.7 MB -> 4.4 us; operations:
// 52 per ray-triangle pair (46 f32 add/sub/mul/div of Moeller-Trumbore
// plus 6 compares) x 32 x N = 0.44 G -> 6.5 us. So K1 is bound by
// arithmetic where rays are live, and by the miss records it writes where
// they are dead (tfar in, 28 B out a lane). K2 does the same 52 per pair,
// but only up to the first blocking triangle. Without fused multiply-adds
// every operation takes its own instruction slot, so the bit-exact
// ceiling is about twice the operations bound.
//
// Design:
// - Live rays only. A block of 256 threads takes a tile of 512
//   consecutive lanes, two per thread (x and x + 256, so loads and stores
//   coalesce). Each thread reads its lanes' tfar; dead lanes write their
//   miss record (K1) or 0 (K2) at once. A ballot per warp, one barrier
//   and a sum over the tile's warp counts list the live lanes in shared
//   memory, in lane order; a tile with none is done. The threads then
//   cast the list in turn (thread x its entries x and x + 256), so full
//   warps work on live rays, neighbouring in the image, and a warp whose
//   entries ran out exits. K2's lanes leave the primitive loop at their
//   first blocker; a warp leaves when all of its lanes have.
// - Launch shape. 40 (K1) and 37 (K2) registers, no spill: six blocks
//   per SM, so the 512 tiles of a 262,144-lane batch run in one wave of
//   the 132 SMs with two rays a thread when all are live. A tile of one
//   lane per thread needs two waves at these registers; capping them at
//   32 for one wave of 256-lane tiles spills, and four lanes per thread
//   lose where most lanes are live (PERF.md).
// - Primitives off the load path. A tile with live lanes stages the
//   soups into shared memory as rows of float4 (a triangle in 2 x 16 B +
//   4 B, a sphere in 16 B), read by every lane at the same step: a
//   broadcast, 3 loads per triangle instead of 9.
// - Less work per closer hit: the loop keeps the winning index, t, u and
//   v; the normal is computed once after the loop, from the winning
//   index, with the same operations.
// - No branch around the reciprocal (tri_test): 3-7% less time a sample.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC. --fmad=false keeps every multiply and add
// separately rounded, as the plain PyTorch versions do, so the kernels
// match them bit for bit; division and sqrt are IEEE-rounded by default
// (-prec-div=true, -prec-sqrt=true).

#include <cuda_runtime.h>

#define MAX_PRIMS 128
#define BIG 1e30f

// max() that propagates NaN like torch.clamp_min / jnp.maximum.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// The soups in shared memory: triangle k is tri[3k] = (v0.xyz, e1.x),
// tri[3k + 1] = (e1.yz, e2.xy) and tri[3k + 2].x = e2.z; sphere k is
// sph[k] = (center.xyz, radius).
struct Soups {
  float4 tri[3 * MAX_PRIMS];
  float4 sph[MAX_PRIMS];
};

__device__ __forceinline__ void stage_soups(Soups& s, const float* __restrict__ tri, int n_tris,
                                            const float* __restrict__ sph, int n_sph) {
  float* st = reinterpret_cast<float*>(s.tri);
  for (int i = threadIdx.x; i < 9 * n_tris; i += blockDim.x) {
    const int c = i / n_tris;
    st[12 * (i - c * n_tris) + c] = tri[i];
  }
  float* ss = reinterpret_cast<float*>(s.sph);
  for (int i = threadIdx.x; i < 4 * n_sph; i += blockDim.x) {
    const int c = i / n_sph;
    ss[4 * (i - c * n_sph) + c] = sph[i];
  }
}

#define BLOCK 256
#define LANES 2  // lanes per thread in a block's tile

// The live lanes (tfar > tnear) of the block's tile of LANES * BLOCK
// consecutive lanes, in lane order, into list[]; returns their count,
// the same in every thread. Thread x reads lanes x and x + BLOCK of the
// tile and sets bit j of dead where lane x + j * BLOCK exists and is
// dead. warp_n holds LANES * BLOCK / 32 ints.
__device__ __forceinline__ int live_lanes(const float* __restrict__ tfar, int n, float tnear,
                                          unsigned& dead, int* list, int* warp_n) {
  const int base = blockIdx.x * (LANES * BLOCK) + threadIdx.x;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  float tf[LANES];
#pragma unroll
  for (int j = 0; j < LANES; ++j) tf[j] = base + j * BLOCK < n ? tfar[base + j * BLOCK] : 0.0f;
  unsigned m[LANES];
  dead = 0u;
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
    const int i = base + j * BLOCK;
    const bool live = i < n && tf[j] > tnear;
    if (i < n && !live) dead |= 1u << j;
    m[j] = __ballot_sync(0xffffffffu, live);
    if (l == 0) warp_n[j * (BLOCK / 32) + w] = __popc(m[j]);
  }
  __syncthreads();
  // Every thread sums the tile's warp counts itself: a tile with no live
  // lane is done after one barrier.
  int total = 0, before[LANES];
#pragma unroll
  for (int c = 0; c < LANES * (BLOCK / 32); ++c) {
    if (c % (BLOCK / 32) == w) before[c / (BLOCK / 32)] = total;
    total += warp_n[c];
  }
  if (total) {
#pragma unroll
    for (int j = 0; j < LANES; ++j)
      if (m[j] >> l & 1u) list[before[j] + __popc(m[j] & ((1u << l) - 1u))] = base + j * BLOCK;
  }
  return total;
}

// Moeller-Trumbore, in the reference's operation order: whether the ray
// hits triangle k within [tnear, tmax). The reciprocal is taken whatever
// det is and selected away where det == 0, with no branch around it:
// __frcp_rn is IEEE round-to-nearest, so it is the value 1.0f / det
// rounds to (inf at +-0, then discarded).
__device__ __forceinline__ bool tri_test(const Soups& s, int k, const Ray& r, float tnear,
                                         float tmax, float& t_out, float& u_out, float& v_out) {
  const float4 a = s.tri[3 * k], b = s.tri[3 * k + 1];
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = s.tri[3 * k + 2].x;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float rcp = __frcp_rn(det);
  const float inv = det != 0.0f ? rcp : 0.0f;
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  t_out = t;
  u_out = u;
  v_out = v;
  return det != 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tnear && t < tmax;
}

// Ray-sphere roots t0 <= t1 of sphere k; returns disc >= 0 && a != 0.
__device__ __forceinline__ bool sph_roots(const Soups& s, int k, const Ray& r, float& t0,
                                          float& t1) {
  const float4 c = s.sph[k];
  const float vx = r.ox - c.x;
  const float vy = r.oy - c.y;
  const float vz = r.oz - c.z;
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float inv_a = 1.0f / (a != 0.0f ? a : 1.0f);
  const float tm = -(r.dx * vx + r.dy * vy + r.dz * vz) * inv_a;
  const float mx = vx + r.dx * tm;
  const float my = vy + r.dy * tm;
  const float mz = vz + r.dz * tm;
  const float disc = c.w * c.w - (mx * mx + my * my + mz * mz);
  const float dt = sqrtf(max_nan(disc, 0.0f) * inv_a);
  t0 = tm - dt;
  t1 = tm + dt;
  return disc >= 0.0f && a != 0.0f;
}

struct HitOut {
  float* t;
  int* prim;
  float* u;
  float* v;
  float* gx;
  float* gy;
  float* gz;
  __device__ __forceinline__ void miss(int i) const {
    t[i] = BIG;
    prim[i] = -1;
    u[i] = 0.0f;
    v[i] = 0.0f;
    gx[i] = 0.0f;
    gy[i] = 0.0f;
    gz[i] = 1.0f;
  }
};

struct RayIn {
  const float* ox;
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* tfar;
  __device__ __forceinline__ Ray load(int i) const {
    return Ray{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
  }
};

// K1 for one live lane i.
__device__ __forceinline__ void closest(const Soups& s, int n_tris, int n_sph, const RayIn& in,
                                        int i, float tnear, const HitOut& out) {
  const Ray r = in.load(i);
  float best = in.tfar[i], bu = 0.0f, bv = 0.0f;
  int bp = -1;
  for (int k = 0; k < n_tris; ++k) {
    float t, u, v;
    if (tri_test(s, k, r, tnear, best, t, u, v)) {
      best = t;
      bp = k;
      bu = u;
      bv = v;
    }
  }
  for (int k = 0; k < n_sph; ++k) {
    float t0, t1;
    const bool ok = sph_roots(s, k, r, t0, t1);
    const bool use_lo = t0 >= tnear && t0 < best;
    const bool use_hi = t1 >= tnear && t1 < best;
    if (ok && (use_lo || use_hi)) {
      best = use_lo ? t0 : t1;
      bp = n_tris + k;
    }
  }
  if (bp < 0) {
    out.miss(i);
    return;
  }
  float gx, gy, gz;
  if (bp < n_tris) {
    const float4 a = s.tri[3 * bp], b = s.tri[3 * bp + 1];
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = s.tri[3 * bp + 2].x;
    gx = e1y * e2z - e1z * e2y;
    gy = e1z * e2x - e1x * e2z;
    gz = e1x * e2y - e1y * e2x;
  } else {
    const float4 c = s.sph[bp - n_tris];
    gx = r.ox + best * r.dx - c.x;
    gy = r.oy + best * r.dy - c.y;
    gz = r.oz + best * r.dz - c.z;
  }
  out.t[i] = best;
  out.prim[i] = bp;
  out.u[i] = bu;
  out.v[i] = bv;
  out.gx[i] = gx;
  out.gy[i] = gy;
  out.gz[i] = gz;
}

// K2 for one live lane i.
__device__ __forceinline__ float occluded(const Soups& s, int n_tris, int n_sph, const RayIn& in,
                                          int i, float tnear) {
  const Ray r = in.load(i);
  const float t_max = in.tfar[i];
  bool blocked = false;
  for (int k = 0; k < n_tris && !blocked; ++k) {
    float t, u, v;
    blocked = tri_test(s, k, r, tnear, t_max, t, u, v);
  }
  for (int k = 0; k < n_sph && !blocked; ++k) {
    float t0, t1;
    const bool ok = sph_roots(s, k, r, t0, t1);
    blocked = ok && ((t0 >= tnear && t0 < t_max) || (t1 >= tnear && t1 < t_max));
  }
  return blocked ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(BLOCK)
intersect_brute_kernel(const float* __restrict__ tri, int n_tris,
                       const float* __restrict__ sph, int n_sph, RayIn in, int n, float tnear,
                       HitOut out) {
  __shared__ Soups s;
  __shared__ int list[LANES * BLOCK];
  __shared__ int warp_n[LANES * BLOCK / 32];
  unsigned dead;
  const int n_live = live_lanes(in.tfar, n, tnear, dead, list, warp_n);
#pragma unroll
  for (int j = 0; j < LANES; ++j)
    if (dead >> j & 1u) out.miss(blockIdx.x * (LANES * BLOCK) + j * BLOCK + threadIdx.x);
  if (n_live == 0) return;
  stage_soups(s, tri, n_tris, sph, n_sph);
  __syncthreads();
  for (int j = threadIdx.x; j < n_live; j += BLOCK) closest(s, n_tris, n_sph, in, list[j], tnear, out);
}

__global__ void __launch_bounds__(BLOCK)
occluded_brute_kernel(const float* __restrict__ tri, int n_tris,
                      const float* __restrict__ sph, int n_sph, RayIn in, int n, float tnear,
                      float* __restrict__ blocked_out) {
  __shared__ Soups s;
  __shared__ int list[LANES * BLOCK];
  __shared__ int warp_n[LANES * BLOCK / 32];
  unsigned dead;
  const int n_live = live_lanes(in.tfar, n, tnear, dead, list, warp_n);
#pragma unroll
  for (int j = 0; j < LANES; ++j)
    if (dead >> j & 1u) blocked_out[blockIdx.x * (LANES * BLOCK) + j * BLOCK + threadIdx.x] = 0.0f;
  if (n_live == 0) return;
  stage_soups(s, tri, n_tris, sph, n_sph);
  __syncthreads();
  for (int j = threadIdx.x; j < n_live; j += BLOCK) {
    const int i = list[j];
    blocked_out[i] = occluded(s, n_tris, n_sph, in, i, tnear);
  }
}

extern "C" {

// Both return cudaGetLastError() after the launch (0 on success).

int gdpt_intersect_brute(const float* tri, int n_tris, const float* sph, int n_sph,
                         const float* ox, const float* oy, const float* oz,
                         const float* dx, const float* dy, const float* dz, const float* tfar,
                         int n, float tnear,
                         float* t, int* prim, float* u, float* v,
                         float* gx, float* gy, float* gz, void* stream) {
  if (n > 0) {
    intersect_brute_kernel<<<(n + LANES * BLOCK - 1) / (LANES * BLOCK), BLOCK, 0,
                             (cudaStream_t)stream>>>(
        tri, n_tris, sph, n_sph, RayIn{ox, oy, oz, dx, dy, dz, tfar}, n, tnear,
        HitOut{t, prim, u, v, gx, gy, gz});
  }
  return (int)cudaGetLastError();
}

int gdpt_occluded_brute(const float* tri, int n_tris, const float* sph, int n_sph,
                        const float* ox, const float* oy, const float* oz,
                        const float* dx, const float* dy, const float* dz,
                        const float* tfar, int n, float tnear,
                        float* blocked, void* stream) {
  if (n > 0) {
    occluded_brute_kernel<<<(n + LANES * BLOCK - 1) / (LANES * BLOCK), BLOCK, 0,
                            (cudaStream_t)stream>>>(
        tri, n_tris, sph, n_sph, RayIn{ox, oy, oz, dx, dy, dz, tfar}, n, tnear, blocked);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
