// Brute-force ray casting for scenes of at most 128 primitives, Hopper.
//
// Replaces the two Pallas TPU kernels of gdpt_tpu/accel/pallas_intersect.py:
//   K1 intersect_brute_kernel <- _tri_kernel_body (pallas_call at :170,
//      launched by pallas_intersect_brute): closest hit of each ray over
//      all triangles (Moeller-Trumbore) then all spheres.
//   K2 occluded_brute_kernel  <- _anyhit_kernel_body (pallas_call at :307,
//      launched by pallas_occluded_brute): any hit within [tnear, tfar).
//
// Contract (as the TPU kernels'): soups are (9, T) rows v0.xyz e1.xyz
// e2.xyz and (4, S) rows center.xyz radius, T, S <= 128. Rays are six
// (N,) component arrays. K1 ignores tfar: inactive lanes get a real hit
// that the caller masks. Its running best is replaced on strict t < best,
// so the lowest primitive index wins a tie. Outputs t (BIG on a miss),
// prim (-1), u, v and the unnormalized geometric normal (cross(e1, e2),
// or hit - centre for a sphere; (0, 0, 1) on a miss). K2 takes a per-ray
// tfar (dead lanes carry tfar <= tnear) and writes 0/1 as float.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores), for K1 at the 512x512 cbox (T = 32, S = 0, N = 262,144):
//   bytes: 24 in + 28 out per ray = 13.6 MB  -> 4.1 us;
//   operations: 52 per ray-triangle pair (46 f32 add/sub/mul/div of
//   Moeller-Trumbore plus 6 compares) x 32 x N = 0.44 G -> 6.5 us.
// So K1 is bound by arithmetic. K2 does the same 52 per pair, but only
// up to the first blocking triangle, and none for dead lanes.
//
// Design: one thread per ray, 128 threads per block. Each block stages
// both soups (<= 128 x 13 floats, 6.6 KB) into shared memory; every
// thread of a warp then reads the same primitive at the same step, a
// broadcast with no bank conflict. Rays are read as SoA component arrays
// (coalesced), with the ragged last block masked and no padding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC. --fmad=false keeps every multiply and add
// separately rounded, as the plain PyTorch versions do, so the kernels
// match them operation for operation; division and sqrt are IEEE-rounded
// by default (-prec-div=true, -prec-sqrt=true).

#include <cuda_runtime.h>

#define MAX_PRIMS 128
#define BLOCK 128
#define BIG 1e30f

// max() that propagates NaN like torch.clamp_min / jnp.maximum.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ void stage_soups(float* s_tri, const float* tri, int n_tris,
                                            float* s_sph, const float* sph, int n_sph) {
  for (int i = threadIdx.x; i < 9 * n_tris; i += blockDim.x) s_tri[i] = tri[i];
  for (int i = threadIdx.x; i < 4 * n_sph; i += blockDim.x) s_sph[i] = sph[i];
  __syncthreads();
}

// Moeller-Trumbore, in the reference's operation order. Returns whether
// the ray hits within [tnear, tmax).
__device__ __forceinline__ bool tri_test(const float* s_tri, int n_tris, int k,
                                         float o_x, float o_y, float o_z,
                                         float d_x, float d_y, float d_z,
                                         float tnear, float tmax,
                                         float* t_out, float* u_out, float* v_out) {
  const float v0x = s_tri[0 * n_tris + k], v0y = s_tri[1 * n_tris + k], v0z = s_tri[2 * n_tris + k];
  const float e1x = s_tri[3 * n_tris + k], e1y = s_tri[4 * n_tris + k], e1z = s_tri[5 * n_tris + k];
  const float e2x = s_tri[6 * n_tris + k], e2y = s_tri[7 * n_tris + k], e2z = s_tri[8 * n_tris + k];
  const float px = d_y * e2z - d_z * e2y;
  const float py = d_z * e2x - d_x * e2z;
  const float pz = d_x * e2y - d_y * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv = det != 0.0f ? 1.0f / det : 0.0f;
  const float tx = o_x - v0x;
  const float ty = o_y - v0y;
  const float tz = o_z - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (d_x * qx + d_y * qy + d_z * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return det != 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tnear && t < tmax;
}

// Ray-sphere roots t0 <= t1; returns disc >= 0 && a != 0.
__device__ __forceinline__ bool sph_roots(const float* s_sph, int n_sph, int k,
                                          float o_x, float o_y, float o_z,
                                          float d_x, float d_y, float d_z,
                                          float* t0, float* t1) {
  const float cx = s_sph[0 * n_sph + k], cy = s_sph[1 * n_sph + k];
  const float cz = s_sph[2 * n_sph + k], r = s_sph[3 * n_sph + k];
  const float vx = o_x - cx;
  const float vy = o_y - cy;
  const float vz = o_z - cz;
  const float a = d_x * d_x + d_y * d_y + d_z * d_z;
  const float inv_a = 1.0f / (a != 0.0f ? a : 1.0f);
  const float tm = -(d_x * vx + d_y * vy + d_z * vz) * inv_a;
  const float mx = vx + d_x * tm;
  const float my = vy + d_y * tm;
  const float mz = vz + d_z * tm;
  const float disc = r * r - (mx * mx + my * my + mz * mz);
  const float dt = sqrtf(max_nan(disc, 0.0f) * inv_a);
  *t0 = tm - dt;
  *t1 = tm + dt;
  return disc >= 0.0f && a != 0.0f;
}

__global__ void __launch_bounds__(BLOCK)
intersect_brute_kernel(const float* __restrict__ tri, int n_tris,
                       const float* __restrict__ sph, int n_sph,
                       const float* __restrict__ ox, const float* __restrict__ oy,
                       const float* __restrict__ oz, const float* __restrict__ dx,
                       const float* __restrict__ dy, const float* __restrict__ dz,
                       int n, float tnear,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       float* __restrict__ gx_out, float* __restrict__ gy_out,
                       float* __restrict__ gz_out) {
  __shared__ float s_tri[9 * MAX_PRIMS];
  __shared__ float s_sph[4 * MAX_PRIMS];
  stage_soups(s_tri, tri, n_tris, s_sph, sph, n_sph);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float o_x = ox[i], o_y = oy[i], o_z = oz[i];
  const float d_x = dx[i], d_y = dy[i], d_z = dz[i];
  float bt = BIG, bu = 0.0f, bv = 0.0f, bgx = 0.0f, bgy = 0.0f, bgz = 1.0f;
  int bp = -1;
  for (int k = 0; k < n_tris; ++k) {
    float t, u, v;
    if (tri_test(s_tri, n_tris, k, o_x, o_y, o_z, d_x, d_y, d_z, tnear, bt, &t, &u, &v)) {
      const float e1x = s_tri[3 * n_tris + k], e1y = s_tri[4 * n_tris + k], e1z = s_tri[5 * n_tris + k];
      const float e2x = s_tri[6 * n_tris + k], e2y = s_tri[7 * n_tris + k], e2z = s_tri[8 * n_tris + k];
      bt = t;
      bp = k;
      bu = u;
      bv = v;
      bgx = e1y * e2z - e1z * e2y;
      bgy = e1z * e2x - e1x * e2z;
      bgz = e1x * e2y - e1y * e2x;
    }
  }
  for (int k = 0; k < n_sph; ++k) {
    float t0, t1;
    const bool ok = sph_roots(s_sph, n_sph, k, o_x, o_y, o_z, d_x, d_y, d_z, &t0, &t1);
    const bool use_lo = t0 >= tnear && t0 < bt;
    const bool use_hi = t1 >= tnear && t1 < bt;
    if (ok && (use_lo || use_hi)) {
      const float t = use_lo ? t0 : t1;
      bt = t;
      bp = n_tris + k;
      bgx = o_x + t * d_x - s_sph[0 * n_sph + k];
      bgy = o_y + t * d_y - s_sph[1 * n_sph + k];
      bgz = o_z + t * d_z - s_sph[2 * n_sph + k];
    }
  }
  t_out[i] = bt;
  prim_out[i] = bp;
  u_out[i] = bu;
  v_out[i] = bv;
  gx_out[i] = bgx;
  gy_out[i] = bgy;
  gz_out[i] = bgz;
}

__global__ void __launch_bounds__(BLOCK)
occluded_brute_kernel(const float* __restrict__ tri, int n_tris,
                      const float* __restrict__ sph, int n_sph,
                      const float* __restrict__ ox, const float* __restrict__ oy,
                      const float* __restrict__ oz, const float* __restrict__ dx,
                      const float* __restrict__ dy, const float* __restrict__ dz,
                      const float* __restrict__ tfar, int n, float tnear,
                      float* __restrict__ blocked_out) {
  __shared__ float s_tri[9 * MAX_PRIMS];
  __shared__ float s_sph[4 * MAX_PRIMS];
  stage_soups(s_tri, tri, n_tris, s_sph, sph, n_sph);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t_max = tfar[i];
  float blocked = 0.0f;
  // A dead lane (tfar <= tnear) can hit nothing: every test needs
  // tnear <= t < tfar. Skipping its loops leaves the result unchanged.
  if (t_max > tnear) {
    const float o_x = ox[i], o_y = oy[i], o_z = oz[i];
    const float d_x = dx[i], d_y = dy[i], d_z = dz[i];
    for (int k = 0; k < n_tris && blocked == 0.0f; ++k) {
      float t, u, v;
      if (tri_test(s_tri, n_tris, k, o_x, o_y, o_z, d_x, d_y, d_z, tnear, t_max, &t, &u, &v))
        blocked = 1.0f;
    }
    for (int k = 0; k < n_sph && blocked == 0.0f; ++k) {
      float t0, t1;
      const bool ok = sph_roots(s_sph, n_sph, k, o_x, o_y, o_z, d_x, d_y, d_z, &t0, &t1);
      if (ok && ((t0 >= tnear && t0 < t_max) || (t1 >= tnear && t1 < t_max))) blocked = 1.0f;
    }
  }
  blocked_out[i] = blocked;
}

extern "C" {

// Both return cudaGetLastError() after the launch (0 on success).

int gdpt_intersect_brute(const float* tri, int n_tris, const float* sph, int n_sph,
                         const float* ox, const float* oy, const float* oz,
                         const float* dx, const float* dy, const float* dz,
                         int n, float tnear,
                         float* t, int* prim, float* u, float* v,
                         float* gx, float* gy, float* gz, void* stream) {
  if (n > 0) {
    const int blocks = (n + BLOCK - 1) / BLOCK;
    intersect_brute_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        tri, n_tris, sph, n_sph, ox, oy, oz, dx, dy, dz, n, tnear,
        t, prim, u, v, gx, gy, gz);
  }
  return (int)cudaGetLastError();
}

int gdpt_occluded_brute(const float* tri, int n_tris, const float* sph, int n_sph,
                        const float* ox, const float* oy, const float* oz,
                        const float* dx, const float* dy, const float* dz,
                        const float* tfar, int n, float tnear,
                        float* blocked, void* stream) {
  if (n > 0) {
    const int blocks = (n + BLOCK - 1) / BLOCK;
    occluded_brute_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        tri, n_tris, sph, n_sph, ox, oy, oz, dx, dy, dz, tfar, n, tnear, blocked);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
