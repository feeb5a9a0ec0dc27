// Per-lane device functions of the path integrator's fused stages
// (csrc/path_fused.cu), kept apart so that a later fusion of the
// gradient-domain bounce can include them: the counter-based uniforms
// (pcg3d, or threefry2x32), the Frisvad frame, the Lambertian lobe's
// sample, eval and pdf, the reflectance slot (constant or checkerboard)
// and the mesh-light point sample.
//
// Every function repeats, operation for operation, what the plain
// PyTorch code computes (core/soa.py, ops/materials_soa.py,
// integrators/path_soa.py) so that the kernels give its bits. Built with
// --fmad=false and without --use_fast_math, so a * b + c is two rounded
// operations and sqrtf, logf, sinf, cosf and division are the precise
// ones that PyTorch's CUDA kernels call. PyTorch's semantics carried over:
// - a tensor divided by a Python scalar is a multiply by the scalar's
//   float reciprocal (INV_PI), and `1.0 / t` is the reciprocal 1.0f / t;
// - Python constants are folded in double and rounded once (the hex
//   constants below, and the floats the wrapper passes);
// - clamp_min, clamp_max, clamp and maximum keep a NaN (fmaxf does not);
// - a * b * c is (a * b) * c; torch.where selects;
// - the RNG's uint32 arithmetic is the int64 `& 0xFFFFFFFF` of core/soa.py.

#pragma once

#include <cstdint>

namespace pf {

// float32 constants of Python doubles, rounded once.
__device__ __forceinline__ float rng_scale() { return __int_as_float(0x2f7ffffe); }  // 1/4294967808
__device__ __forceinline__ float degen_z() { return __int_as_float(0xbf7fffef); }    // -1 + 1e-6
__device__ __forceinline__ float two_pi() { return __int_as_float(0x40c90fdb); }     // 2 pi
__device__ __forceinline__ float inv_pi() { return __int_as_float(0x3ea2f983); }     // 1f / pi
__device__ __forceinline__ float big() { return __int_as_float(0x7149f2ca); }        // 1e30
__device__ __forceinline__ float eps20() { return __int_as_float(0x1e3ce508); }      // 1e-20
__device__ __forceinline__ float eps30() { return __int_as_float(0x0da24260); }      // 1e-30
__device__ __forceinline__ float eps8() { return __int_as_float(0x322bcc77); }       // 1e-8
__device__ __forceinline__ float rr_cap() { return __int_as_float(0x3f733333); }     // 0.95

constexpr int SHAPE_MESH = 0;
constexpr int TEX_CHECKER = 2;
constexpr int FILTER_BOX = 0;
constexpr int FILTER_TENT = 1;

// ---- PyTorch's NaN-keeping clamps --------------------------------------

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// ---- vectors -----------------------------------------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float vmax(V3 v) { return maximum(maximum(v.x, v.y), v.z); }
// soa.normalize: v * (1 / clamp_min(|v|, 1e-20)).
__device__ __forceinline__ V3 normalize(V3 v) {
  return scale(v, 1.0f / clamp_min(sqrtf(dot(v, v)), eps20()));
}

// ---- counter-based uniforms (core/soa.py: Streams, uniform2) -----------

__device__ __forceinline__ uint32_t lcg(uint32_t v) { return v * 1664525u + 1013904223u; }
__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }
// threefry2x32's rotations, as a function so that the unrolled rounds fold
// them to constants (an array would live in local memory).
__device__ __forceinline__ constexpr int threefry_rot(int k) {
  return k == 0 ? 13 : k == 1 ? 15 : k == 2 ? 26 : k == 3 ? 6 : k == 4 ? 17 : k == 5 ? 29
       : k == 6 ? 16 : 24;
}

// uniform2 at fixed (seed, stream, sample) for any counter; the words
// that do not depend on the counter are made once.
struct Rng {
  uint32_t a, b, c;
  bool threefry;

  __device__ __forceinline__ Rng(uint32_t seed, uint32_t stream, uint32_t sample, bool tf)
      : threefry(tf) {
    if (tf) {
      a = seed, b = stream, c = sample;
    } else {
      // murmur3-finalizer premix of the stream id
      uint32_t t = stream * 0x9E3779B9u;
      t ^= t >> 16;
      t *= 0x85EBCA6Bu;
      t ^= t >> 13;
      a = lcg(t);
      b = 0;
      c = lcg(seed + sample * 0x9E3779B9u);
    }
  }

  // Two uniforms in [0, 1) at counter ctr.
  __device__ __forceinline__ void operator()(uint32_t ctr, float& u0, float& u1) const {
    uint32_t r0, r1;
    if (threefry) {
      // threefry2x32, 20 rounds: keys (seed, stream), counters (ctr, sample)
      const uint32_t k2 = a ^ b ^ 0x1BD11BDAu;
      uint32_t x0 = ctr + a, x1 = c + b;
#pragma unroll
      for (int block = 0; block < 5; ++block) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x0 += x1;
          x1 = rotl(x1, threefry_rot((block % 2) * 4 + i));
          x1 ^= x0;
        }
        const int j0 = (block + 1) % 3, j1 = (block + 2) % 3;
        x0 += j0 == 0 ? a : j0 == 1 ? b : k2;
        x1 += (j1 == 0 ? a : j1 == 1 ? b : k2) + (uint32_t)(block + 1);
      }
      r0 = x0, r1 = x1;
    } else {
      // pcg3d after its first LCG step of each word
      uint32_t x = a, y = lcg(ctr), z = c;
      x += y * z;
      y += z * x;
      z += x * y;
      x ^= x >> 16;
      y ^= y >> 16;
      z ^= z >> 16;
      x += y * z;
      y += z * x;
      r0 = x, r1 = y;
    }
    u0 = __uint2float_rn(r0) * rng_scale();
    u1 = __uint2float_rn(r1) * rng_scale();
  }
};

// ---- frames and the Lambertian lobe (ops/materials_soa.py) -------------

struct Frame {
  V3 t, b, n;
};

// Frisvad's basis, branch-free as soa.coordinate_system.
__device__ __forceinline__ Frame coordinate_system(V3 n) {
  const bool degen = n.z < degen_z();
  const float safe_z = degen ? 0.0f : n.z;
  const float a = 1.0f / (safe_z + 1.0f);
  const float b = (-n.x * n.y) * a;
  if (degen) return {{0.0f, -1.0f, 0.0f}, {-1.0f, 0.0f, 0.0f}, n};
  return {{1.0f - (n.x * n.x) * a, b, -n.x}, {b, 1.0f - (n.y * n.y) * a, -n.y}, n};
}

// _refl_frame: the frame flipped (times -1) to the side of din.
__device__ __forceinline__ Frame refl_frame(Frame f, V3 din) {
  const float s = dot(f.n, din) < 0.0f ? -1.0f : 1.0f;
  return {scale(f.t, s), scale(f.b, s), scale(f.n, s)};
}

__device__ __forceinline__ V3 to_world(Frame f, V3 v) {
  return {f.t.x * v.x + f.b.x * v.y + f.n.x * v.z, f.t.y * v.x + f.b.y * v.y + f.n.y * v.z,
          f.t.z * v.x + f.b.z * v.y + f.n.z * v.z};
}

// pdf_lambertian (eval_lambertian is refl times it): |cos| / pi on the
// side of din, 0 where din or dout is below the geometric normal.
__device__ __forceinline__ float lambert(V3 din, V3 dout, V3 gn, Frame f0) {
  const Frame f = refl_frame(f0, din);
  const bool ok = (dot(gn, din) >= 0.0f) & (dot(gn, dout) >= 0.0f);
  return ok ? clamp_min(dot(f.n, dout), 0.0f) * inv_pi() : 0.0f;
}

// sample_lambertian: a cosine-weighted direction and its valid flag.
__device__ __forceinline__ V3 sample_lambert(V3 din, V3 gn, Frame f0, float u0, float u1,
                                             bool& valid) {
  const Frame f = refl_frame(f0, din);
  const float phi = two_pi() * u0;
  const float r = sqrtf(u1);
  const V3 local = {r * cosf(phi), r * sinf(phi), sqrtf(clamp(1.0f - u1, 0.0f, 1.0f))};
  valid = dot(gn, din) >= 0.0f;
  return to_world(f, local);
}

// ---- the scene's tables --------------------------------------------------

struct Scene {
  const float* tri;  // (9, T) rows v0.xyz e1.xyz e2.xyz
  const float* n[9];  // tri_n0.xyz, tri_n1.xyz, tri_n2.xyz
  const float* uv[6];  // tri_uv0_u, _v, tri_uv1_u, _v, tri_uv2_u, _v
  const bool* has_n;
  const bool* has_uv;
  const int* tri_mat;
  const int* tri_light;
  const int* refl_kind;  // the materials' reflectance slot
  const float* refl_c0[3];
  const float* refl_c1[3];
  const float* refl_uv[4];  // uscale, vscale, uoffset, voffset
  const float* light_cdf;  // (L + 1,)
  const float* light_pmf;
  const int* light_shape;
  const float* light_i[3];
  const float* light_tri_cdf;  // (L, K)
  const int* light_tri_first;
  const int* shape_kind;
  const float* shape_area;
  const float* s2c;  // camera sample_to_cam, 4 x 4
  const float* c2w;  // camera cam_to_world, 4 x 4
  int n_tris, n_mat, n_lights, tri_cdf_cols, n_shapes;
  int filter_kind, any_normals, any_uvs, threefry;
  float width, height, filter_c;  // filter_c: box w/2, tent w/2, gaussian stddev
  float shadow_scale;  // float(1 - shadow_epsilon)
};

__device__ __forceinline__ V3 tri_row(const Scene& s, int row, int t) {
  const float* p = s.tri + row * 3 * s.n_tris;
  return {p[t], p[s.n_tris + t], p[2 * s.n_tris + t]};
}

// Component arrays are passed one by one: an address taken inside the
// kernel's parameter struct could move the struct to local memory.
__device__ __forceinline__ V3 gather3(const float* x, const float* y, const float* z, int i) {
  return {x[i], y[i], z[i]};
}

// The vertex normal interpolated at barycentrics (b0, b1, b2) of triangle t.
__device__ __forceinline__ V3 interp_normal(const Scene& s, int t, float b0, float b1, float b2) {
  const V3 n0 = gather3(s.n[0], s.n[1], s.n[2], t);
  const V3 n1 = gather3(s.n[3], s.n[4], s.n[5], t);
  const V3 n2 = gather3(s.n[6], s.n[7], s.n[8], t);
  return normalize(add(add(scale(n0, b0), scale(n1, b1)), scale(n2, b2)));
}

// Python's float remainder by 1.0, as torch.remainder.
__device__ __forceinline__ float rem1(float a) {
  float m = fmodf(a, 1.0f);
  if ((m != 0.0f) && (m < 0.0f)) m += 1.0f;
  return m;
}

__device__ __forceinline__ int checker_axis(float l) {
  int r = ((int)(l * 2.0f)) % 2;
  if ((r != 0) && (r < 0)) r += 2;
  return 2 * r - 1;
}

// The reflectance slot of material mid at (uv_u, uv_v): its constant, or
// its checkerboard (materials_soa._eval_spec_slot without images).
__device__ __forceinline__ V3 reflectance(const Scene& s, int mid, float uv_u, float uv_v) {
  mid = clampi(mid, 0, s.n_mat - 1);
  const V3 c0 = gather3(s.refl_c0[0], s.refl_c0[1], s.refl_c0[2], mid);
  if (s.refl_kind[mid] != TEX_CHECKER) return c0;
  const float lu = rem1(uv_u * s.refl_uv[0][mid] + s.refl_uv[2][mid]);
  const float lv = rem1(uv_v * s.refl_uv[1][mid] + s.refl_uv[3][mid]);
  if (checker_axis(lu) * checker_axis(lv) == 1) return c0;
  return gather3(s.refl_c1[0], s.refl_c1[1], s.refl_c1[2], mid);
}

// ---- a hit's vertex (path_soa.shade_hit on triangles) -------------------

struct Vertex {
  V3 pos, gn, sn;  // gn flipped toward sn
  V3 refl;
  int light_id;
  bool valid;
};

__device__ __forceinline__ Vertex shade(const Scene& s, V3 org, V3 d, float t, int prim_id,
                                        float hu, float hv, V3 gn_raw) {
  Vertex v;
  v.pos = add(org, scale(d, t));
  const int tid = clampi(max(prim_id, 0), 0, s.n_tris - 1);
  const V3 gn = normalize(gn_raw);
  V3 sn = gn;
  if (s.any_normals && s.has_n[tid]) sn = interp_normal(s, tid, (1.0f - hu) - hv, hu, hv);
  float uv_u = hu + hv, uv_v = hv;
  if (s.any_uvs && s.has_uv[tid]) {
    const float b0 = (1.0f - hu) - hv;
    uv_u = (s.uv[0][tid] * b0 + s.uv[2][tid] * hu) + s.uv[4][tid] * hv;
    uv_v = (s.uv[1][tid] * b0 + s.uv[3][tid] * hu) + s.uv[5][tid] * hv;
  }
  v.sn = sn;
  v.gn = dot(gn, sn) < 0.0f ? neg(gn) : gn;
  v.refl = reflectance(s, s.tri_mat[tid], uv_u, uv_v);
  v.light_id = s.tri_light[tid];
  v.valid = prim_id >= 0;
  return v;
}

// path_soa.emission toward view_dir.
__device__ __forceinline__ V3 emission(const Scene& s, V3 gn, int light_id, V3 view_dir) {
  const bool ok = (light_id >= 0) & (dot(gn, view_dir) > 0.0f);
  const int l = clampi(light_id, 0, s.n_lights - 1);
  return ok ? gather3(s.light_i[0], s.light_i[1], s.light_i[2], l) : V3{0.0f, 0.0f, 0.0f};
}

// ---- NEE's light sample (path_soa.sample_light_point, nee_soa) ---------

struct Nee {
  V3 dl, f, l_emit;
  float dist, g_geo, p1, p2_raw;
  bool need;
};

// The mesh-light pick and point sample at `pos`, and NEE's terms up to
// its shadow ray (nee_soa before the cast); refl, gn and frame are the
// vertex's, din = -d its view direction.
__device__ __forceinline__ Nee nee_light(const Scene& s, V3 pos, V3 din, V3 gn, Frame frame,
                                         V3 refl, bool active, float u0, float u1, float uw,
                                         float us) {
  int c = 0;
  for (int k = 0; k <= s.n_lights; ++k) c += s.light_cdf[k] <= uw;
  const int lid = clampi(c - 1, 0, s.n_lights - 1);
  const int shape = max(s.light_shape[lid], 0);
  const float* row = s.light_tri_cdf + (size_t)lid * s.tri_cdf_cols;
  int cnt = 0;
  for (int k = 0; k < s.tri_cdf_cols; ++k) cnt += row[k] <= us;
  const int local = clampi(cnt - 1, 0, s.tri_cdf_cols - 2);
  const int tri = clampi(s.light_tri_first[lid] + local, 0, s.n_tris - 1);
  const V3 v0 = tri_row(s, 0, tri), e1 = tri_row(s, 1, tri), e2 = tri_row(s, 2, tri);
  const float a = sqrtf(clamp(u0, 0.0f, 1.0f));
  const float b1 = 1.0f - a;
  const float b2 = a * u1;
  V3 ln = normalize(cross(e1, e2));
  const V3 sn = interp_normal(s, tri, (1.0f - b1) - b2, b1, b2);
  if (s.has_n[tri] & (dot(ln, sn) < 0.0f)) ln = neg(ln);
  const V3 p_mesh = add(add(v0, scale(e1, b1)), scale(e2, b2));
  const int sh = clampi(shape, 0, s.n_shapes - 1);
  const bool is_mesh = s.shape_kind[sh] == SHAPE_MESH;
  const V3 p_l = is_mesh ? p_mesh : V3{0.0f, 0.0f, 0.0f};
  const V3 n_l = is_mesh ? ln : V3{0.0f, 0.0f, 1.0f};
  const float pdf = is_mesh ? 1.0f / clamp_min(s.shape_area[sh], eps20()) : 0.0f;

  Nee r;
  const V3 to_l = sub(p_l, pos);
  r.dist = sqrtf(dot(to_l, to_l));
  r.dl = scale(to_l, 1.0f / clamp_min(r.dist, eps20()));
  r.g_geo = clamp_min(-dot(r.dl, n_l), 0.0f) / clamp_min(r.dist * r.dist, eps20());
  r.p1 = s.light_pmf[lid] * pdf;
  r.p2_raw = lambert(din, r.dl, gn, frame);
  r.f = scale(refl, r.p2_raw);
  r.l_emit = dot(n_l, neg(r.dl)) > 0.0f ? gather3(s.light_i[0], s.light_i[1], s.light_i[2], lid)
                                        : V3{0.0f, 0.0f, 0.0f};
  r.need = active & (r.g_geo > 0.0f) & (r.p1 > 0.0f) & (vmax(r.f) > 0.0f) & (vmax(r.l_emit) > 0.0f);
  return r;
}

}  // namespace pf
