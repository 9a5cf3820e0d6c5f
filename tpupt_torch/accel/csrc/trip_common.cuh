// Device code shared by the trip kernels (trip_kernels.cu) and the
// differentiable trip's kernels (diff_trip_kernels.cu): the lane state's
// rows, the scene table's rows, 3-vectors with torch's rounding, the
// counter-based RNG, the background and materials.shade; and the size of
// a persistent grid (resident_ctas).  See
// trip_kernels.cu for what they replace and for the numerics: every float
// operation runs in the torch body's order and is rounded once (the
// library is built with --fmad=false and no fast math).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;  // packets.BIG = intersect.BIG_T
constexpr int kThreads = 256;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvPi = 0.3183098861837907f;  // materials.INV_PI

// F rows (trip_kernel.F_KEYS)
enum {
  F_ROX, F_ROY, F_ROZ, F_RDX, F_RDY, F_RDZ, F_TMIN,
  F_RADX, F_RADY, F_RADZ, F_COLX, F_COLY, F_COLZ, F_NX, F_NY, F_NZ, F_DEPTH,
  F_ACX, F_ACY, F_ACZ, F_ANX, F_ANY, F_ANZ, F_ADEPTH, F_PDFW,
};
// I rows (trip_kernel.I_KEYS)
enum { I_ALIVE, I_SEED, I_BOUNCE, I_K, I_SEGS, I_DONE, I_SPEC };
// a sphere object's row of the scene table: inverse matrix rows 0-2, matrix
// rows 0-2, centre, radius, object id (trip_kernel.SPHERE_ROW)
constexpr int kSphereRow = 29;
constexpr int kMatRow = 9;  // type, albedo, fuzz, ior, emission
constexpr int kLightRow = 8;  // centre, radius, emission, object id
constexpr int kTriLightRow = 11;  // p0, e1, e2, object id, material
// material tags and primitive kinds (core/types.py)
constexpr int kDiffuse = 0, kMetal = 1, kDielectric = 2, kEmissive = 3;
constexpr int kPrimNone = -1, kPrimSphere = 0, kPrimTriangle = 1;
// integrator.NEE_UNROLL_MAX: up to this many sphere lights NEE samples
// each, above one per lane
constexpr int kUnrollMax = 4;
constexpr unsigned kFull = 0xffffffffu;  // a warp's lanes

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
// Vec3.dot: (x*x' + y*y') + z*z'
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
// Vec3.cross
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }

// torch.clamp and torch.maximum on CUDA: NaN in, NaN out
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return isnan(v) ? v : fminf(v, hi); }
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.sign: (0 < a) - (a < 0), so 0 at +-0 and at NaN
__device__ __forceinline__ float sign(float a) { return (float)((0.0f < a) - (a < 0.0f)); }

// Vec3.normalize: v * rsqrt(clamp(|v|^2, min=1e-12))
__device__ __forceinline__ V3 normalize(V3 v) { return v * rsqrtf(clamp_min(dot(v, v), 1e-12f)); }
// glm::reflect
__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return d - n * (2.0f * dot(d, n)); }
// glm::refract for a unit incident direction (vec.refract)
__device__ __forceinline__ V3 refract(V3 uv, V3 n, float eta) {
  float ct = clamp_max(dot(-uv, n), 1.0f);
  V3 perp = (uv + n * ct) * eta;
  float k = 1.0f - dot(perp, perp);
  return perp + n * (-sqrtf(clamp_min(k, 1e-12f)));
}

// vec.transform_point / transform_vector with the 3 x 4 rows m[0..11];
// transform_normal with the inverse's columns
__device__ __forceinline__ V3 xform_point(const float* m, V3 v) {
  return v3(m[0] * v.x + m[1] * v.y + m[2] * v.z + m[3],
            m[4] * v.x + m[5] * v.y + m[6] * v.z + m[7],
            m[8] * v.x + m[9] * v.y + m[10] * v.z + m[11]);
}
__device__ __forceinline__ V3 xform_vector(const float* m, V3 v) {
  return v3(m[0] * v.x + m[1] * v.y + m[2] * v.z,
            m[4] * v.x + m[5] * v.y + m[6] * v.z,
            m[8] * v.x + m[9] * v.y + m[10] * v.z);
}
__device__ __forceinline__ V3 xform_normal(const float* inv, V3 n) {
  return v3(inv[0] * n.x + inv[4] * n.y + inv[8] * n.z,
            inv[1] * n.x + inv[5] * n.y + inv[9] * n.z,
            inv[2] * n.x + inv[6] * n.y + inv[10] * n.z);
}

// rng.py: the Wang hash and the counter-based uniform draw, in uint32
__device__ __forceinline__ uint32_t wang_hash(uint32_t a) {
  a = (a + 0x7ED55D16u) + (a << 12);
  a = (a ^ 0xC761C23Cu) ^ (a >> 19);
  a = (a + 0x165667B1u) + (a << 5);
  a = (a + 0xD3A2646Cu) ^ (a << 9);
  a = (a + 0xFD7046C5u) + (a << 3);
  a = (a ^ 0xB55A4F09u) ^ (a >> 16);
  return a;
}
__device__ __forceinline__ float uniform(uint32_t seed, uint32_t counter) {
  uint32_t bits = wang_hash(seed + counter * 0x9E3779B9u);
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}
// rng.bounce_counter: 2 + 16 * bounce + lane
__device__ __forceinline__ uint32_t bounce_counter(int bounce, int lane) {
  return 2u + (uint32_t)bounce * 16u + (uint32_t)lane;
}

struct HitRec {
  bool mask, front;
  int kind, obj, mat;
  float t;  // hit.t: BIG where nothing was hit
  V3 point, normal;
};

// intersect.background_color
__device__ __forceinline__ V3 background(const float* bg, V3 rd) {
  V3 unit = normalize(rd);
  float t = 0.5f * (unit.y + 1.0f);
  return v3(bg[0] + t * (bg[3] - bg[0]), bg[1] + t * (bg[4] - bg[1]), bg[2] + t * (bg[5] - bg[2]));
}

struct Scatter {
  V3 ro, rd, mult, emitted, albedo;
  float t_min, pdf_w;
  int mtype;
  bool is_emis, specular;
  // what the differentiable trip's backward reads again: the unit-sphere
  // sample, the offset's 1e-4 * sign(rd . n), the diffuse sum, the metal's
  // horizon test, the dielectric's index ratio, unit incident direction and
  // reflect-or-refract choice, and the material's fuzz and index
  V3 s, d_sum, unit_d;
  float k_off, ratio, fuzz, ior;
  bool degenerate, metal_ok, reflect_diel;
};

// materials.shade of a lane that hit: every lobe, the material's tag selects
__device__ __forceinline__ Scatter shade(const float* tab, int mat_off, const HitRec& h, V3 rd,
                                         float t_min, uint32_t seed, int bounce) {
  const float* mr = tab + mat_off + h.mat * kMatRow;
  Scatter o;
  o.mtype = (int)mr[0];
  o.albedo = v3(mr[1], mr[2], mr[3]);
  const float fuzz = mr[4], ior = mr[5];
  const V3 emission = v3(mr[6], mr[7], mr[8]);
  const V3 n_ = h.normal;
  o.fuzz = fuzz;
  o.ior = ior;

  // sphere.random_in_unit_sphere
  float u0 = uniform(seed, bounce_counter(bounce, 0));
  float u1 = uniform(seed, bounce_counter(bounce, 1));
  float phi = kTwoPi * u0;
  float cos_s = 2.0f * u1 - 1.0f;
  float sin_s = sqrtf(clamp_min(1.0f - cos_s * cos_s, 1e-12f));
  V3 s = v3(cosf(phi) * sin_s, sinf(phi) * sin_s, cos_s);
  float u_fresnel = uniform(seed, bounce_counter(bounce, 2));

  o.s = s;
  o.k_off = 1e-4f * sign(dot(rd, n_));
  V3 off = h.point - n_ * o.k_off;
  // diffuse
  V3 d_sum = n_ + s;
  V3 d_diff = normalize(d_sum);
  bool degenerate = (fabsf(d_sum.x) < 1e-8f) & (fabsf(d_sum.y) < 1e-8f) &
                    (fabsf(d_sum.z) < 1e-8f);
  d_diff = sel(degenerate, n_, d_diff);
  o.d_sum = d_sum;
  o.degenerate = degenerate;
  // metal
  V3 d_metal = reflect(rd, n_) + s * fuzz;
  bool metal_ok = dot(d_metal, n_) > 0.0f;
  o.metal_ok = metal_ok;
  // dielectric
  float ratio = h.front ? 1.0f / ior : ior;
  V3 unit_d = normalize(rd);
  float cos_t = clamp_max(dot(-unit_d, n_), 1.0f);
  float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 1e-12f));
  bool cannot_refract = ratio * sin_t > 1.0f;
  float r0 = (1.0f - ratio) / (1.0f + ratio);
  r0 = r0 * r0;
  float p = 1.0f - cos_t;
  float schlick = r0 + (1.0f - r0) * (p * p * p * p * p);
  bool choose_reflect = cannot_refract | (schlick > u_fresnel);
  V3 d_diel = choose_reflect ? reflect(unit_d, n_) : refract(unit_d, n_, ratio);
  o.ratio = ratio;
  o.unit_d = unit_d;
  o.reflect_diel = choose_reflect;

  const bool is_diff = o.mtype == kDiffuse, is_metal = o.mtype == kMetal;
  const bool is_diel = o.mtype == kDielectric;
  const V3 zero = v3(0.0f, 0.0f, 0.0f), one = v3(1.0f, 1.0f, 1.0f);
  o.is_emis = o.mtype == kEmissive;
  o.rd = is_diff ? d_diff : (is_metal ? d_metal : d_diel);
  o.ro = is_diel ? h.point : off;
  o.t_min = is_diel ? 1e-5f : t_min;
  o.mult = is_diff ? o.albedo : (is_metal ? sel(metal_ok, o.albedo, zero) : one);
  o.emitted = sel(o.is_emis, emission, zero);
  o.specular = is_metal | is_diel;
  o.pdf_w = is_diff ? clamp_min(dot(d_diff, n_), 0.0f) * kInvPi : 0.0f;
  return o;
}

// N values of one type, as one aligned access
template <class T, int N> struct Vec;
template <class T> struct Vec<T, 1> { using type = T; };
template <> struct Vec<unsigned char, 2> { using type = unsigned short; };
template <> struct Vec<unsigned char, 4> { using type = unsigned int; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<int, 2> { using type = int2; };
template <> struct Vec<int, 4> { using type = int4; };

// Entries first .. first + N - 1 of a row (fill past n): one access where
// they lie in range and the address allows, else one each
template <class T, int N>
__device__ __forceinline__ void load_lanes(const T* row, int first, int n, T fill, T (&v)[N]) {
  using W = typename Vec<T, N>::type;
  const T* p = row + first;
  if (first + N <= n && ((uintptr_t)p & (sizeof(W) - 1)) == 0u) {
    const W q = *reinterpret_cast<const W*>(p);
    for (int k = 0; k < N; ++k) v[k] = reinterpret_cast<const T*>(&q)[k];
  } else {
    for (int k = 0; k < N; ++k) v[k] = first + k < n ? p[k] : fill;
  }
}

template <class T, int N>
__device__ __forceinline__ void store_lanes(T* row, int first, int n, const T (&v)[N]) {
  using W = typename Vec<T, N>::type;
  T* p = row + first;
  if (first + N <= n && ((uintptr_t)p & (sizeof(W) - 1)) == 0u) {
    W q;
    for (int k = 0; k < N; ++k) reinterpret_cast<T*>(&q)[k] = v[k];
    *reinterpret_cast<W*>(p) = q;
  } else {
    for (int k = 0; k < N; ++k) {
      if (first + k < n) p[k] = v[k];
    }
  }
}

// CTAs a persistent grid of `kernel` takes: as many as the card holds at
// once at the kernel's occupancy, found once per device and shared memory
struct Resident {
  int device = -1;
  size_t smem = 0;
  int ctas = 0;
};

template <class K>
cudaError_t resident_ctas(Resident& r, K kernel, int threads, size_t smem, int* ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (r.device != dev || r.smem != smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    }
    if (err != cudaSuccess) return err;
    r.device = dev;
    r.smem = smem;
    r.ctas = (per_sm > 1 ? per_sm : 1) * sms;
  }
  *ctas = r.ctas;
  return cudaSuccess;
}

}  // namespace
