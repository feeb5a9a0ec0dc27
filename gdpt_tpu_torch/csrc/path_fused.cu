// The path integrator's per-lane work between two casts, one kernel per
// stage, for brute-force Lambertian scenes lit by mesh area lights
// (integrators/path_fused.py: supports, trace_paths_fused), Hopper.
//
// Replaces no TPU kernel: the JAX package leaves this work to XLA's
// fusion of integrators/path_soa.py:trace_paths_soa. In PyTorch the same
// work ran as some 5,300 elementwise and index kernels a 1-spp sample at
// depth 6, each over columns of 262,144 lanes, about 2 us each against
// 0.3 us of bytes; a sample now makes 12 stage launches, path_primary,
// six path_after_hit and five path_after_shadow, around its six K1 and
// five K2 casts: 23 in all.
//
//   path_primary       the pixel draws, the filter's warp and the camera
//                      ray: K1's ray columns.
//   path_after_hit     shade_hit on K1's hit; the first hit's emission, or
//                      the MIS of a BSDF-sampled hit, Russian roulette and
//                      the state's updates; then, where another bounce
//                      follows, the light sample and NEE's terms: K2's
//                      shadow-ray columns.
//   path_after_shadow  NEE's contribution under K2's mask, the BSDF sample
//                      with its eval and pdf: K1's next ray columns.
//
// Contract: the lane state is an (R, n) float32 block of rows (Row below,
// path_fused.ROWS); a kernel reads and writes only its own lane's column.
// NEE's terms are computed again in path_after_shadow, and the BSDF's eval
// and pdf again in path_after_hit, from the unchanged state: the same
// operations on the same inputs, fewer bytes than storing them. The seed
// and the sample index are read from 0-d int64 tensors on the device, so
// a replay of a captured graph renders the seed it is handed.
//
// Bound on the H100 (3.35 TB/s), each byte read once and written once
// (tools/profile_render.FUSED_BYTES): a later path_after_hit reads K1's
// 28 B and 108 B of state and lane id a lane and writes 104 B,
// path_after_shadow reads 104 B and writes 36 B, path_primary reads 16 B
// and writes 28 B; at 262,144 lanes 63, 37 and 12 MB: 18.8, 11.0 and
// 3.4 us. The arithmetic (a few hundred flops, a few PCG hashes and a
// light pick a lane) is far below the 67 TFLOP/s of f32. Design: one
// thread a lane over coalesced SoA rows, 256 threads a block; the
// scene's tables are small and stay in L1/L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false

#include <cuda_runtime.h>

#include "path_fused.cuh"

namespace {

using pf::V3;

// Rows of the lane state (path_fused.ROWS).
enum Row {
  POS = 0,     // 3: the vertex's position; the origin of K1's and K2's rays
  RDIR = 3,    // 3: K1's ray direction
  TFAR = 6,    // K1's tfar
  SDIR = 7,    // 3: K2's shadow-ray direction
  STFAR = 10,  // K2's tfar
  DIR = 11,    // 3: the path's direction into the vertex
  GN = 14,     // 3: the vertex's geometric normal, flipped toward SN
  SN = 17,     // 3: its shading normal
  REFL = 20,   // 3: its reflectance
  TP = 23,     // 3: throughput
  RAD = 26,    // 3: radiance
  RAYS = 29,   // rays traced
  ACTIVE = 30, // 0/1
  N_ROWS = 31
};

constexpr int BLOCK = 256;

// Counter streams of path_soa (_CTR_*), 16 a bounce.
constexpr uint32_t CTR_PIXEL = 0, CTR_LIGHT_UV = 1, CTR_LIGHT_W = 2, CTR_BSDF_UV = 3,
                   CTR_BSDF_W = 4, CTR_STRIDE = 16;

struct State {
  float* p;
  int n;
  __device__ float& at(int row, int i) const { return p[(size_t)row * n + i]; }
  __device__ V3 v3(int row, int i) const { return {at(row, i), at(row + 1, i), at(row + 2, i)}; }
  __device__ void put(int row, int i, V3 v) const {
    at(row, i) = v.x;
    at(row + 1, i) = v.y;
    at(row + 2, i) = v.z;
  }
};

struct Draws {
  const long long* ray_idx;
  const long long* seed;
  const long long* sample;
  __device__ pf::Rng rng(int i, int threefry) const {
    return pf::Rng((uint32_t)*seed, (uint32_t)ray_idx[i], (uint32_t)*sample, threefry != 0);
  }
};

struct Hit {
  const float *t, *u, *v, *gx, *gy, *gz;
  const int* prim;
};

// NEE's light sample and terms at the state's vertex, for bounce b.
__device__ __forceinline__ pf::Nee nee_at(const pf::Scene& s, const State& st, const pf::Rng& rng,
                                          int i, uint32_t b) {
  float lu0, lu1, lw, lsw;
  rng(b * CTR_STRIDE + CTR_LIGHT_UV, lu0, lu1);
  rng(b * CTR_STRIDE + CTR_LIGHT_W, lw, lsw);
  const V3 sn = st.v3(SN, i);
  return pf::nee_light(s, st.v3(POS, i), pf::neg(st.v3(DIR, i)), st.v3(GN, i),
                       pf::coordinate_system(sn), st.v3(REFL, i), st.at(ACTIVE, i) > 0.0f, lu0,
                       lu1, lw, lsw);
}

__device__ __forceinline__ void put_shadow_ray(const pf::Scene& s, const State& st, int i,
                                               const pf::Nee& nee) {
  st.put(SDIR, i, nee.dl);
  st.at(STFAR, i) = nee.need ? s.shadow_scale * nee.dist : -1.0f;
}

__global__ void __launch_bounds__(BLOCK) path_primary(pf::Scene s, State st, Draws dr,
                                                      const float* xs, const float* ys) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= st.n) return;
  float u0, u1;
  dr.rng(i, s.threefry)(CTR_PIXEL, u0, u1);
  // primary_rays_soa
  const float px0 = (xs[i] + u0) / s.width, py0 = (ys[i] + u1) / s.height;
  const float pxx = px0 * s.width, pxy = py0 * s.height;
  const float fx = floorf(pxx), fy = floorf(pxy);
  const float ux = pxx - fx, uy = pxy - fy;
  float ox, oy;
  if (s.filter_kind == pf::FILTER_BOX) {
    ox = (2.0f * ux - 1.0f) * s.filter_c;
    oy = (2.0f * uy - 1.0f) * s.filter_c;
  } else if (s.filter_kind == pf::FILTER_TENT) {
    const float h = s.filter_c;
    const float lox = h * (sqrtf(pf::clamp_min(2.0f * ux, 0.0f)) - 1.0f);
    const float hix = h * (1.0f - sqrtf(pf::clamp_min(1.0f - 2.0f * (ux - 0.5f), 0.0f)));
    const float loy = h * (sqrtf(pf::clamp_min(2.0f * uy, 0.0f)) - 1.0f);
    const float hiy = h * (1.0f - sqrtf(pf::clamp_min(1.0f - 2.0f * (uy - 0.5f), 0.0f)));
    ox = ux < 0.5f ? lox : hix;
    oy = uy < 0.5f ? loy : hiy;
  } else {  // Gaussian, Box-Muller
    const float r = s.filter_c * sqrtf(-2.0f * logf(pf::clamp_min(ux, pf::eps8())));
    const float phi = pf::two_pi() * uy;
    ox = r * cosf(phi);
    oy = r * sinf(phi);
  }
  const float px = ((fx + 0.5f) + ox) / s.width, py = ((fy + 0.5f) + oy) / s.height;
  const float* m = s.s2c;
  const float ptw = (m[12] * px + m[13] * py) + m[15];
  const V3 pt = {((m[0] * px + m[1] * py) + m[3]) / ptw, ((m[4] * px + m[5] * py) + m[7]) / ptw,
                 ((m[8] * px + m[9] * py) + m[11]) / ptw};
  const V3 dc = pf::normalize(pt);
  const float* c = s.c2w;
  const V3 d = pf::normalize({(c[0] * dc.x + c[1] * dc.y) + c[2] * dc.z,
                              (c[4] * dc.x + c[5] * dc.y) + c[6] * dc.z,
                              (c[8] * dc.x + c[9] * dc.y) + c[10] * dc.z});
  st.put(POS, i, {c[3], c[7], c[11]});
  st.put(RDIR, i, d);
  st.at(TFAR, i) = pf::big();
}

// b: the bounce whose cast K1 just made (0: the camera ray); more: whether
// bounce b + 1 follows (its shadow ray is written); rr: whether Russian
// roulette runs at this bounce.
__global__ void __launch_bounds__(BLOCK) path_after_hit(pf::Scene s, State st, Draws dr, Hit h,
                                                        int b, int more, int rr) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= st.n) return;
  const pf::Rng rng = dr.rng(i, s.threefry);
  const V3 org = st.v3(POS, i), d_out = st.v3(RDIR, i);
  const pf::Vertex nxt = pf::shade(s, org, d_out, h.t[i], h.prim[i], h.u[i], h.v[i],
                                   {h.gx[i], h.gy[i], h.gz[i]});
  const V3 zero = {0.0f, 0.0f, 0.0f};
  bool active;
  if (b == 0) {
    st.put(RAD, i, nxt.valid ? pf::emission(s, nxt.gn, nxt.light_id, pf::neg(d_out)) : zero);
    st.put(TP, i, {1.0f, 1.0f, 1.0f});
    st.at(RAYS, i) = 1.0f;
    active = nxt.valid;
    st.put(POS, i, nxt.pos);
    st.put(GN, i, nxt.gn);
    st.put(SN, i, nxt.sn);
    st.put(REFL, i, nxt.refl);
    st.put(DIR, i, d_out);
  } else {
    // The BSDF sample's eval and pdf, as path_after_shadow computed them.
    const V3 din = pf::neg(st.v3(DIR, i)), gn = st.v3(GN, i), sn = st.v3(SN, i);
    const float pdf_b = pf::lambert(din, d_out, gn, pf::coordinate_system(sn));
    const V3 f_b = pf::scale(st.v3(REFL, i), pdf_b);
    active = st.at(ACTIVE, i) > 0.0f;
    const V3 tp = st.v3(TP, i);
    // Emissive hit with MIS (path_soa.trace_paths_soa's path.mis).
    const float dd = pf::dot(pf::sub(nxt.pos, org), pf::sub(nxt.pos, org));
    const float g2 = nxt.valid ? fabsf(pf::dot(d_out, nxt.gn)) / pf::clamp_min(dd, pf::eps20())
                               : 1.0f;
    const float p2a = pdf_b * g2;
    const bool hit_light = nxt.valid & (nxt.light_id >= 0) & active;
    const V3 l_emit = pf::emission(s, nxt.gn, nxt.light_id, pf::neg(d_out));
    const int lid = pf::clampi(max(nxt.light_id, 0), 0, s.n_lights - 1);
    const int lshape = pf::clampi(max(s.light_shape[lid], 0), 0, s.n_shapes - 1);
    const float p1h = s.light_pmf[lid] * (1.0f / pf::clamp_min(s.shape_area[lshape], pf::eps20()));
    const float w2 = (p2a * p2a) / pf::clamp_min(p1h * p1h + p2a * p2a, pf::eps30());
    const float sc = (g2 * w2) / pf::clamp_min(p2a, pf::eps30());
    const V3 contrib = pf::scale(pf::mul(pf::mul(tp, f_b), l_emit), sc);
    st.put(RAD, i, pf::add(st.v3(RAD, i), hit_light ? contrib : zero));
    // Russian roulette and the state's updates (path.update); the eta
    // scale of a Lambertian path stays 1, and x / 1 is x.
    active = active & nxt.valid;
    V3 new_tp = pf::scale(pf::mul(tp, f_b), g2 / pf::clamp_min(p2a, pf::eps30()));
    float rr_prob = 1.0f;
    if (rr) {
      float w, u_rr;
      rng((uint32_t)b * CTR_STRIDE + CTR_BSDF_W, w, u_rr);
      rr_prob = pf::clamp_max(pf::vmax(new_tp), pf::rr_cap());
      active = active & (u_rr <= rr_prob);
    }
    new_tp = pf::scale(new_tp, 1.0f / pf::clamp_min(rr_prob, pf::eps20()));
    if (active) {
      st.put(TP, i, new_tp);
      st.put(POS, i, nxt.pos);
      st.put(GN, i, nxt.gn);
      st.put(SN, i, nxt.sn);
      st.put(REFL, i, nxt.refl);
      st.put(DIR, i, d_out);
    }
  }
  st.at(ACTIVE, i) = active ? 1.0f : 0.0f;
  if (more) put_shadow_ray(s, st, i, nee_at(s, st, rng, i, (uint32_t)b + 1));
}

// b: the bounce whose shadow ray K2 just cast.
__global__ void __launch_bounds__(BLOCK) path_after_shadow(pf::Scene s, State st, Draws dr,
                                                           const float* blocked, int b) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= st.n) return;
  const pf::Rng rng = dr.rng(i, s.threefry);
  const pf::Nee nee = nee_at(s, st, rng, i, (uint32_t)b);
  // nee_soa after its cast.
  const float g = nee.g_geo * (1.0f - blocked[i]);
  const float p2 = nee.p2_raw * g;
  const bool ok = (g > 0.0f) & (nee.p1 > 0.0f) & nee.need;
  const float w1 = ok ? (nee.p1 * nee.p1) / pf::clamp_min(nee.p1 * nee.p1 + p2 * p2, pf::eps30())
                      : 0.0f;
  const float sc = (g * w1) / pf::clamp_min(nee.p1, pf::eps30());
  const V3 zero = {0.0f, 0.0f, 0.0f};
  const V3 contrib = ok ? pf::scale(pf::mul(nee.f, nee.l_emit), sc) : zero;
  st.put(RAD, i, pf::add(st.v3(RAD, i), pf::mul(st.v3(TP, i), contrib)));
  float rays = st.at(RAYS, i) + (nee.need ? 1.0f : 0.0f);
  // BSDF sampling (path.bsdf) and the bounce ray (path.update).
  float bu0, bu1;
  rng((uint32_t)b * CTR_STRIDE + CTR_BSDF_UV, bu0, bu1);
  const V3 din = pf::neg(st.v3(DIR, i)), gn = st.v3(GN, i);
  const pf::Frame frame = pf::coordinate_system(st.v3(SN, i));
  bool valid;
  const V3 d_out = pf::sample_lambert(din, gn, frame, bu0, bu1, valid);
  const float pdf_b = pf::lambert(din, d_out, gn, frame);
  const bool active = (st.at(ACTIVE, i) > 0.0f) & valid & (pdf_b > 0.0f);
  st.at(RAYS, i) = rays + (active ? 1.0f : 0.0f);
  st.at(ACTIVE, i) = active ? 1.0f : 0.0f;
  st.put(RDIR, i, d_out);
  st.at(TFAR, i) = active ? pf::big() : -1.0f;
}

pf::Scene unpack(const void* const* p, const int* iv, const float* fv) {
  pf::Scene s;
  int k = 0;
  auto f = [&]() { return (const float*)p[k++]; };
  auto in = [&]() { return (const int*)p[k++]; };
  auto bl = [&]() { return (const bool*)p[k++]; };
  s.tri = f();
  for (auto& c : s.n) c = f();
  for (auto& c : s.uv) c = f();
  s.has_n = bl();
  s.has_uv = bl();
  s.tri_mat = in();
  s.tri_light = in();
  s.refl_kind = in();
  for (auto& c : s.refl_c0) c = f();
  for (auto& c : s.refl_c1) c = f();
  for (auto& c : s.refl_uv) c = f();
  s.light_cdf = f();
  s.light_pmf = f();
  s.light_shape = in();
  for (auto& c : s.light_i) c = f();
  s.light_tri_cdf = f();
  s.light_tri_first = in();
  s.shape_kind = in();
  s.shape_area = f();
  s.s2c = f();
  s.c2w = f();
  s.n_tris = iv[0], s.n_mat = iv[1], s.n_lights = iv[2], s.tri_cdf_cols = iv[3];
  s.n_shapes = iv[4], s.filter_kind = iv[5], s.any_normals = iv[6], s.any_uvs = iv[7];
  s.threefry = iv[8];
  s.width = fv[0], s.height = fv[1], s.filter_c = fv[2], s.shadow_scale = fv[3];
  return s;
}

unsigned grid(int n) { return (unsigned)((n + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 on success). ptrs,
// ints and floats: the scene's tables, counts and constants in unpack's
// order (path_fused._scene_args); state: the (31, n) float32 lane state.

int gdpt_path_primary(const void* const* ptrs, const int* ints, const float* floats, float* state,
                      int n, const long long* ray_idx, const long long* seed,
                      const long long* sample, const float* xs, const float* ys, void* stream) {
  if (n > 0) {
    path_primary<<<grid(n), BLOCK, 0, (cudaStream_t)stream>>>(
        unpack(ptrs, ints, floats), State{state, n}, Draws{ray_idx, seed, sample}, xs, ys);
  }
  return (int)cudaGetLastError();
}

int gdpt_path_after_hit(const void* const* ptrs, const int* ints, const float* floats, float* state,
                        int n, const long long* ray_idx, const long long* seed,
                        const long long* sample, const float* t, const int* prim, const float* u,
                        const float* v, const float* gx, const float* gy, const float* gz, int b,
                        int more, int rr, void* stream) {
  if (n > 0) {
    path_after_hit<<<grid(n), BLOCK, 0, (cudaStream_t)stream>>>(
        unpack(ptrs, ints, floats), State{state, n}, Draws{ray_idx, seed, sample},
        Hit{t, u, v, gx, gy, gz, prim}, b, more, rr);
  }
  return (int)cudaGetLastError();
}

int gdpt_path_after_shadow(const void* const* ptrs, const int* ints, const float* floats,
                           float* state, int n, const long long* ray_idx, const long long* seed,
                           const long long* sample, const float* blocked, int b, void* stream) {
  if (n > 0) {
    path_after_shadow<<<grid(n), BLOCK, 0, (cudaStream_t)stream>>>(
        unpack(ptrs, ints, floats), State{state, n}, Draws{ray_idx, seed, sample}, blocked, b);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
