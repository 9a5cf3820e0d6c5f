// The forward trip of the path tracer as hand-written CUDA kernels for
// Hopper (sm_90a), with a plain C interface bound by ctypes
// (tpupt_torch/render/trip_kernel.py, which also holds their torch twins).
//
// What they replace.  In the JAX package the forward trip is XLA code, not
// Pallas: the trips of tpupt/render/integrator.py `_render_chained` run in
// one lax.while_loop, as do the bounces of the forward `trace_sample`, and
// XLA fuses each trip body into a few device kernels.  The body is
// `_bounce_body` (integrator.py), the sphere pass (tpupt/render/intersect.py
// `_sphere_pass`) and the sweep's ray rows (tpupt/accel/packets.py
// `_pack_rows`), `materials.shade` and `russian_roulette`
// (tpupt/render/materials.py), the Wang hash (tpupt/sampling/rng.py
// `wang_hash`, `uniform`), `random_in_unit_sphere` (tpupt/sampling/sphere.py),
// `background_color`, and, chained, the fold of a finished sample and the
// restart of its lane (`_fresh_state` with tpupt/core/camera.py
// `generate_rays`).  With emitters the body also runs next-event estimation
// (NEE) with multiple importance sampling: `_weighted_emission` with
// `_light_pdf_at_hit`, and `_nee_direct_light` (`_nee_mesh_light`, the
// sphere lights unrolled or `_nee_sampled_light`, `sample_light_sphere`,
// the shadow rays' sphere test of `occlusion_anyhit`).  The port's body
// route (integrator._bounce_body) runs each of those operations as its own
// eager torch kernel, about a thousand launches a trip (three thousand
// with NEE).  Here a trip is
//
//   trip_head   one thread a lane: the sphere pass over the scene's sphere
//               objects in order (a later hit at an equal t overwrites an
//               earlier one), its hit record, and the eight (np, 256) f32
//               rows and the live mask that treelet_closest_hit takes
//               (a dead lane: its -BIG seed and mask only);
//   treelet_closest_hit (treelet_kernels.cu), for scenes with a mesh;
//   trip_tail   one thread a lane: the triangle half of the hit record,
//               the body (background on a miss, the first bounce's normal
//               and depth, all four BSDF lobes, emission, roulette) and,
//               chained, the segment count, the bounce cap, the (n-1)/n
//               fold of colour, normal and depth, k, done, and a fresh
//               primary ray for a lane that restarts; it counts the lanes
//               left to trace with one atomic a warp, which the host reads
//               (4 bytes) in place of a reduction over the lanes.
//
// and with emitters
//
//   trip_head, treelet_closest_hit as above;
//   trip_nee    one thread a lane: the hit record, background, normal and
//               depth, the BSDF lobes, the MIS-weighted emission, and per
//               NEE term (the mesh light; each sphere light up to four, or
//               one sampled per lane) the light sample, its shadow ray's
//               sphere test, its contribution, and the ray packed into the
//               term's packet-aligned region of one row buffer, as
//               treelet_any_hit takes it;
//   treelet_any_hit on every term's rows at once, for scenes with a mesh;
//   trip_tail   its NEE mode: the lit terms' contributions added in the
//               body's order, then roulette, the fold and the count.
//
// The lane state is SoA in device memory (F: 25 f32 rows, I: 7 i32 rows,
// row-major (rows, N)), updated in place: a lane reads and writes only its
// own entries, so no lane ever reads what another writes.
//
// What bounds them on this card: bytes.  A live lane moves ~120 bytes
// through trip_head, ~250 through trip_tail and ~150 + 45 a NEE term
// through trip_nee, and does a few hundred float operations (a thousand
// with four lights), far below the 67 TFLOP/s FP32 rate (~20 operations a
// byte at 3.35 TB/s).  So the design keeps every access coalesced (one
// thread a lane, SoA rows, the packed rows written in the sweeps' own
// layout), reads and writes a lane's state only where the lane needs it
// (in trip_head a dead lane reads 4 bytes and writes the sweep's 5; in
// trip_tail a lane that is done reads 12 bytes and writes 4; in trip_nee a
// dead lane writes each term's 5), so a late trip with few live lanes
// costs little more than its launch, and keeps the scene's small tables
// (spheres, materials, the background, the lights, the camera) in one
// table that every thread reads at the same address.
//
// Numerics: every float operation runs in the torch body's order and is
// rounded once, as PyTorch's CUDA kernels round it (the library is built
// with --fmad=false and no fast math): sqrtf, rsqrtf (torch.rsqrt), sinf
// and cosf (torch.sin, torch.cos), IEEE division (a / b, and 1.0f / x for
// torch's reciprocal, which is also what `c / tensor` computes, times c),
// clamps that propagate NaN as torch.clamp does, and torch.sign's 0 at 0.
// The hash runs in native uint32.

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

// intersect._sphere_roots of one sphere object (its table row s) for a ray
// and the window [t_min, t_bound]: the object-space quadratic.  Returns
// whether it hits, with the root taken and the object-space ray.
__device__ __forceinline__ bool sphere_roots(const float* s, V3 ro, V3 rd, float t_min,
                                             float t_bound, float* t_obj, V3* oo, V3* od) {
  const float* inv = s;
  V3 c = v3(s[24], s[25], s[26]);
  float r = s[27];
  *oo = xform_point(inv, ro);
  *od = normalize(xform_vector(inv, rd));
  V3 oc = *oo - c;
  float a = dot(*od, *od);
  float b = 2.0f * dot(*od, oc);
  float cc = dot(oc, oc) - r * r;
  float disc = b * b - 4.0f * a * cc;
  float sq = sqrtf(clamp_min(disc, 0.0f));
  float t1 = (-b - sq) / (2.0f * a);
  float t2 = (-b + sq) / (2.0f * a);
  bool use1 = (t1 >= t_min) & (t1 <= t_bound);
  bool use2 = (t2 >= t_min) & (t2 <= t_bound);
  *t_obj = use1 ? t1 : t2;
  return (disc >= 0.0f) & (use1 | use2);
}

// --- trip_head ---------------------------------------------------------------

// intersect._sphere_candidate of one sphere object (its table row s) for a
// ray and the window [t_min, t_bound]: the object-space quadratic, the
// winning t re-measured in world units.  Returns whether it hits.
__device__ __forceinline__ bool sphere_candidate(const float* s, V3 ro, V3 rd, float t_min,
                                                 float t_bound, float* t_w, V3* point_w,
                                                 V3* normal_w, bool* front) {
  const float* inv = s;
  const float* m = s + 12;
  V3 c = v3(s[24], s[25], s[26]);
  float r = s[27];
  float t_obj;
  V3 oo, od;
  bool hit = sphere_roots(s, ro, rd, t_min, t_bound, &t_obj, &oo, &od);
  V3 point_obj = oo + od * t_obj;
  *point_w = xform_point(m, point_obj);
  V3 rel = *point_w - ro;
  *t_w = sqrtf(clamp_min(dot(rel, rel), 1e-30f));
  V3 outward = (point_obj - c) * (1.0f / r);
  *front = dot(od, outward) < 0.0f;
  *normal_w = xform_normal(inv, sel(*front, outward, -outward));
  return hit;
}

__global__ void __launch_bounds__(kThreads) trip_head_kernel(
    const float* __restrict__ F, const int* __restrict__ I, int n, int n_pad,
    const float* __restrict__ tab, int n_sph, float* __restrict__ hrec, int* __restrict__ hint,
    float* __restrict__ rows, unsigned char* __restrict__ act) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) {
    if (rows != nullptr && i < n_pad) {  // pad lanes, as packets._pack_rows pads
      const float pad[8] = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f, -kBig};
      for (int r = 0; r < 8; ++r) rows[(size_t)r * n_pad + i] = pad[r];
      act[i] = 0;
    }
    return;
  }
  if (I[(size_t)I_ALIVE * n + i] == 0) {
    // a dead lane: the sweep's -BIG seed and mask only.  Its record and ray
    // rows keep what they held, since neither the sweep (which takes a lane
    // with a -BIG seed out of its cull and walk) nor trip_tail reads them.
    if (rows != nullptr) {
      rows[(size_t)7 * n_pad + i] = -kBig;
      act[i] = 0;
    }
    return;
  }
  const V3 ro = v3(F[(size_t)F_ROX * n + i], F[(size_t)F_ROY * n + i], F[(size_t)F_ROZ * n + i]);
  const V3 rd = v3(F[(size_t)F_RDX * n + i], F[(size_t)F_RDY * n + i], F[(size_t)F_RDZ * n + i]);
  const float t_min = F[(size_t)F_TMIN * n + i];
  float t_best = kBig;
  V3 point = v3(0.0f, 0.0f, 0.0f), normal = v3(0.0f, 0.0f, 0.0f);
  int code = -1;  // object * 2 + front of the winning sphere, -1: none
  for (int o = 0; o < n_sph; ++o) {
    const float* s = tab + o * kSphereRow;
    float t_w;
    V3 pw, nw;
    bool fr;
    if (sphere_candidate(s, ro, rd, t_min, t_best, &t_w, &pw, &nw, &fr)) {
      t_best = t_w;
      point = pw;
      normal = nw;
      code = (int)s[28] * 2 + (fr ? 1 : 0);
    }
  }
  hrec[0 * (size_t)n + i] = t_best;
  hrec[1 * (size_t)n + i] = point.x;
  hrec[2 * (size_t)n + i] = point.y;
  hrec[3 * (size_t)n + i] = point.z;
  hrec[4 * (size_t)n + i] = normal.x;
  hrec[5 * (size_t)n + i] = normal.y;
  hrec[6 * (size_t)n + i] = normal.z;
  hint[i] = code;
  if (rows != nullptr) {  // the sweep's rows, seeded with the sphere pass's t
    const float vals[8] = {ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, t_min, t_best};
    for (int r = 0; r < 8; ++r) rows[(size_t)r * n_pad + i] = vals[r];
    act[i] = 1;
  }
}

// --- the body, shared by trip_tail and trip_nee -------------------------------

// What trip_head and the closest-hit sweep hand the body; the sweep's
// outputs are flat over the packed lanes and null without a mesh.
struct RecordArgs {
  const float* hrec;
  const int* hint;
  const float* s_t;
  const int* s_slot;
  const float* s_nx;
  const float* s_ny;
  const float* s_nz;
  const float* s_obj;
};

struct HitRec {
  bool mask, front;
  int kind, obj, mat;
  float t;  // hit.t: BIG where nothing was hit
  V3 point, normal;
};

// intersect.hit_record: the sphere pass's record, replaced by the sweep's
// winner where a triangle won
__device__ __forceinline__ HitRec hit_record(const RecordArgs& r, const float* tab, int obj_off,
                                             int n, int i, V3 ro, V3 rd) {
  HitRec h;
  const int code = r.hint[i];
  h.mask = code >= 0;
  h.kind = h.mask ? kPrimSphere : kPrimNone;
  h.front = h.mask && (code & 1);
  h.obj = h.mask ? code >> 1 : -1;
  h.mat = h.mask ? (int)tab[obj_off + h.obj] : 0;
  float t_best = r.hrec[0 * (size_t)n + i];
  h.point = v3(r.hrec[1 * (size_t)n + i], r.hrec[2 * (size_t)n + i], r.hrec[3 * (size_t)n + i]);
  h.normal = v3(r.hrec[4 * (size_t)n + i], r.hrec[5 * (size_t)n + i], r.hrec[6 * (size_t)n + i]);
  if (r.s_slot != nullptr && r.s_slot[i] >= 0) {
    float t_mesh = r.s_t[i];
    int obj_w = max((int)r.s_obj[i], 0);
    V3 outward = normalize(v3(r.s_nx[i], r.s_ny[i], r.s_nz[i]));
    bool tri_front = dot(rd, outward) < 0.0f;
    t_best = t_mesh;
    h.mask = true;
    h.kind = kPrimTriangle;
    h.obj = obj_w;
    h.point = ro + rd * t_mesh;
    h.normal = sel(tri_front, outward, -outward);
    h.front = tri_front;
    h.mat = (int)tab[obj_off + obj_w];
  }
  h.t = h.mask ? t_best : kBig;
  return h;
}

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

  // sphere.random_in_unit_sphere
  float u0 = uniform(seed, bounce_counter(bounce, 0));
  float u1 = uniform(seed, bounce_counter(bounce, 1));
  float phi = kTwoPi * u0;
  float cos_s = 2.0f * u1 - 1.0f;
  float sin_s = sqrtf(clamp_min(1.0f - cos_s * cos_s, 1e-12f));
  V3 s = v3(cosf(phi) * sin_s, sinf(phi) * sin_s, cos_s);
  float u_fresnel = uniform(seed, bounce_counter(bounce, 2));

  V3 off = h.point - n_ * (1e-4f * sign(dot(rd, n_)));
  // diffuse
  V3 d_sum = n_ + s;
  V3 d_diff = normalize(d_sum);
  bool degenerate = (fabsf(d_sum.x) < 1e-8f) & (fabsf(d_sum.y) < 1e-8f) &
                    (fabsf(d_sum.z) < 1e-8f);
  d_diff = sel(degenerate, n_, d_diff);
  // metal
  V3 d_metal = reflect(rd, n_) + s * fuzz;
  bool metal_ok = dot(d_metal, n_) > 0.0f;
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

// --- trip_nee ----------------------------------------------------------------

// The light tables of the scene table from nee_off (trip_kernel.TripPlan.tables)
struct Lights {
  const float* sph;  // n_lights LIGHT_ROW rows
  float select;  // float32(1 / n_lights)
  float area, area_c;  // the emissive triangles' total area, and clamped at 1e-30
  const float* cum;  // n_tri CDF entries
  const float* tri;  // n_tri TRI_LIGHT_ROW rows
  int n_lights, n_tri;
};

__device__ __forceinline__ Lights lights_of(const float* tab, int nee_off, int n_lights, int n_tri) {
  Lights L;
  const float* p = tab + nee_off;
  L.sph = p;
  p += n_lights * kLightRow;
  L.select = p[0];
  L.area = p[1];
  L.area_c = p[2];
  L.cum = p + 3;
  L.tri = p + 3 + n_tri;
  L.n_lights = n_lights;
  L.n_tri = n_tri;
  return L;
}

// integrator._cone_pdf: whether ro lies outside the sphere, and the
// cone-sampling pdf of the sphere seen from ro times `selection`
__device__ __forceinline__ float cone_pdf(V3 ro, V3 center, float radius, float selection,
                                          bool* outside) {
  V3 oc = ro - center;
  float d2 = dot(oc, oc);
  float sin2 = clamp2(radius * radius / clamp_min(d2, 1e-12f), 0.0f, 1.0f);
  float cos_max = sqrtf(clamp_min(1.0f - sin2, 0.0f));
  *outside = d2 > radius * radius;
  return selection / clamp_min(kTwoPi * (1.0f - cos_max), 1e-12f);
}

// integrator._light_pdf_at_hit for a lane whose hit absorbs (an emitter)
__device__ __forceinline__ float light_pdf_at_hit(const Lights& L, const HitRec& h, V3 ro, V3 rd) {
  float pl = 0.0f;
  if (h.kind == kPrimSphere) {
    for (int li = 0; li < L.n_lights; ++li) {
      const float* s = L.sph + li * kLightRow;
      if ((int)s[7] != h.obj) continue;
      bool outside;
      float pdf = cone_pdf(ro, load3(s), s[3], L.n_lights > kUnrollMax ? L.select : 1.0f,
                           &outside);
      if (outside) pl = pdf;
      break;  // the light table's objects are distinct
    }
  }
  if (L.n_tri > 0 && h.kind == kPrimTriangle) {
    // hit.normal faces against the unit ray, so cos_l = -(rd . n)
    float cos_l = clamp_min(-dot(rd, h.normal), 1e-6f);
    pl = h.t * h.t / (cos_l * L.area_c);
  }
  return pl;
}

// materials.sample_light_sphere: cone sampling of a sphere light seen from p
__device__ __forceinline__ V3 sample_light_sphere(V3 center, float radius, V3 p, float u1,
                                                  float u2, float* pdf, bool* valid) {
  V3 d = center - p;
  float dist2 = dot(d, d);
  *valid = dist2 > radius * radius;
  V3 w = d * rsqrtf(clamp_min(dist2, 1e-12f));
  float sin2_max = clamp2(radius * radius / clamp_min(dist2, 1e-12f), 0.0f, 1.0f);
  float cos_max = sqrtf(clamp_min(1.0f - sin2_max, 0.0f));
  float cos_t = 1.0f + u1 * (cos_max - 1.0f);
  float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
  float phi = kTwoPi * u2;
  float sgn = w.z >= 0.0f ? 1.0f : -1.0f;
  float a = -(1.0f / (sgn + w.z));  // torch: reciprocal(sign + w.z) * -1.0
  float b = w.x * w.y * a;
  V3 t1 = v3(1.0f + sgn * w.x * w.x * a, sgn * b, -sgn * w.x);
  V3 t2 = v3(b, sgn + w.y * w.y * a, -w.y);
  V3 dir = w * cos_t + t1 * (sin_t * cosf(phi)) + t2 * (sin_t * sinf(phi));
  *pdf = 1.0f / clamp_min(kTwoPi * (1.0f - cos_max), 1e-8f);
  return dir;
}

// integrator._t_light: the shadow window's end at the sphere light's near side
__device__ __forceinline__ float t_light(V3 p, V3 dir, V3 center, float radius) {
  V3 oc = p - center;
  float b = dot(dir, oc);
  float disc = clamp_min(b * b - (dot(oc, oc) - radius * radius), 0.0f);
  return -b - sqrtf(disc);
}

// intersect.sphere_occlusion of one shadow ray: a sphere object other than
// `exclude` hits it in [1e-4, t_limit]
__device__ __forceinline__ bool sphere_occluded(const float* tab, int n_sph, V3 p, V3 dir,
                                                float t_limit, int exclude) {
  for (int o = 0; o < n_sph; ++o) {
    const float* s = tab + o * kSphereRow;
    if ((int)s[28] == exclude) continue;
    float t_obj;
    V3 oo, od;
    if (sphere_roots(s, p, dir, 1e-4f, t_limit, &t_obj, &oo, &od)) return true;
  }
  return false;
}

// One NEE term's sample (integrator.NeeTerm): its shadow ray, the lanes
// whose sample is valid, the light its sphere test skips, its contribution
struct Term {
  V3 dir, contrib;
  float t_limit;
  bool active;
  int light;
};

// integrator._nee_mesh_sample
__device__ __forceinline__ Term mesh_term(const float* tab, int mat_off, const Lights& L, V3 p,
                                          V3 n, V3 thr_alb, uint32_t seed, int bounce) {
  Term t;
  float u_sel = uniform(seed, bounce_counter(bounce, 12));
  float u1 = uniform(seed, bounce_counter(bounce, 13));
  float u2 = uniform(seed, bounce_counter(bounce, 14));
  int idx = 0;  // the CDF inverted by compare-count
  for (int k = 0; k < L.n_tri; ++k) idx += u_sel >= L.cum[k];
  idx = min(idx, L.n_tri - 1);
  const float* row = L.tri + idx * kTriLightRow;
  const V3 p0 = load3(row), e1 = load3(row + 3), e2 = load3(row + 6);
  const int lmat = (int)row[10];
  float su = sqrtf(u1);
  V3 x = p0 + e1 * (1.0f - su) + e2 * (u2 * su);
  V3 d = x - p;
  float dist2 = clamp_min(dot(d, d), 1e-12f);
  float dist = sqrtf(dist2);
  t.dir = d * (1.0f / dist);
  V3 nlv = cross(e1, e2);
  float cos_l = fabsf(dot(t.dir, nlv)) * rsqrtf(clamp_min(dot(nlv, nlv), 1e-30f));
  t.active = cos_l > 1e-6f;
  t.t_limit = dist * (float)(1.0 - 1e-3);
  t.light = -1;
  float p_b = clamp_min(dot(n, t.dir), 0.0f) * kInvPi;
  float cla = cos_l * L.area;
  float scale = p_b * cla / (dist2 + p_b * cla);
  t.contrib = thr_alb * scale * load3(tab + mat_off + lmat * kMatRow + 6);
  return t;
}

// one sphere light's sample: unrolled (light li, counters 4 + 2 li and
// 5 + 2 li) or sampled per lane (li from counter 4, counters 5 and 6)
__device__ __forceinline__ Term sphere_term(const Lights& L, int li, bool sampled, V3 p, V3 n,
                                            V3 thr_alb, uint32_t seed, int bounce) {
  Term t;
  const float* s = L.sph + li * kLightRow;
  const V3 center = load3(s);
  const float radius = s[3];
  float u1 = uniform(seed, bounce_counter(bounce, sampled ? 5 : 4 + 2 * li));
  float u2 = uniform(seed, bounce_counter(bounce, sampled ? 6 : 5 + 2 * li));
  float pdf;
  t.dir = sample_light_sphere(center, radius, p, u1, u2, &pdf, &t.active);
  t.t_limit = t_light(p, t.dir, center, radius);
  t.light = (int)s[7];
  float p_b = clamp_min(dot(n, t.dir), 0.0f) * kInvPi;
  if (sampled) {  // the technique's pdf is pdf / nl
    const float nl = (float)L.n_lights;
    t.contrib = thr_alb * (p_b * nl / (pdf + nl * p_b)) * load3(s + 4);
  } else {
    t.contrib = thr_alb * (p_b / (pdf + p_b)) * load3(s + 4);
  }
  return t;
}

struct NeeArgs {
  float* F;
  int* I;
  int n, n_pad;
  RecordArgs rec;
  const float* tab;
  int n_sph, mat_off, obj_off, bg_off, nee_off, n_lights, n_tri;
  unsigned char* alive_next;
  float* contrib;  // (terms, 3, n)
  unsigned char* mask;  // (terms, n_pad)
  float* rows;  // (8, terms, n_pad), null without a mesh
};

__device__ __forceinline__ int nee_terms(int n_lights, int n_tri) {
  return (n_tri > 0 ? 1 : 0) + (n_lights > kUnrollMax ? 1 : n_lights);
}

__global__ void __launch_bounds__(kThreads) trip_nee_kernel(const NeeArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int n = a.n, n_pad = a.n_pad;
  const int terms = nee_terms(a.n_lights, a.n_tri);
  const size_t rows_stride = (size_t)terms * n_pad;  // one packed row of every term
  if (i >= n) {  // pad lanes, as packets._pack_rows pads
    if (i < n_pad) {
      const float pad[8] = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f, -kBig};
      for (int t = 0; t < terms; ++t) {
        a.mask[(size_t)t * n_pad + i] = 0;
        if (a.rows != nullptr) {
          for (int r = 0; r < 8; ++r) a.rows[r * rows_stride + (size_t)t * n_pad + i] = pad[r];
        }
      }
    }
    return;
  }
  float* F = a.F;
  int* I = a.I;
#define FR(row) F[(size_t)(row) * n + i]
#define IR(row) I[(size_t)(row) * n + i]
  // a lane NEE samples nothing for: every term's mask and -BIG seed only
  auto closed = [&](int t) {
    a.mask[(size_t)t * n_pad + i] = 0;
    if (a.rows != nullptr) a.rows[7 * rows_stride + (size_t)t * n_pad + i] = -kBig;
  };
  if (IR(I_ALIVE) == 0) {
    for (int t = 0; t < terms; ++t) closed(t);
    return;
  }
  const uint32_t seed = (uint32_t)IR(I_SEED);
  const int bounce = IR(I_BOUNCE);
  const V3 ro = v3(FR(F_ROX), FR(F_ROY), FR(F_ROZ));
  const V3 rd = v3(FR(F_RDX), FR(F_RDY), FR(F_RDZ));
  const V3 col = v3(FR(F_COLX), FR(F_COLY), FR(F_COLZ));
  V3 rad = v3(FR(F_RADX), FR(F_RADY), FR(F_RADZ));
  const HitRec h = hit_record(a.rec, a.tab, a.obj_off, n, i, ro, rd);

  if (!h.mask) rad = rad + col * background(a.tab + a.bg_off, rd);
  if (bounce == 0 && h.mask) {
    FR(F_NX) = h.normal.x;
    FR(F_NY) = h.normal.y;
    FR(F_NZ) = h.normal.z;
    FR(F_DEPTH) = h.t;
  }
  const Lights L = lights_of(a.tab, a.nee_off, a.n_lights, a.n_tri);
  bool alive2 = false, diffuse = false;
  V3 albedo = v3(0.0f, 0.0f, 0.0f);
  if (h.mask) {
    const Scatter sc = shade(a.tab, a.mat_off, h, rd, FR(F_TMIN), seed, bounce);
    if (sc.is_emis) {
      // integrator._weighted_emission: 1 after a specular scatter, else the
      // balance heuristic pdf_w / (pdf_w + pdf_light)
      const float pb = FR(F_PDFW);
      const float w = IR(I_SPEC) != 0
          ? 1.0f : pb / clamp_min(pb + light_pdf_at_hit(L, h, ro, rd), 1e-20f);
      rad = rad + col * sc.emitted * w;
    }
    FR(F_ROX) = sc.ro.x;
    FR(F_ROY) = sc.ro.y;
    FR(F_ROZ) = sc.ro.z;
    FR(F_RDX) = sc.rd.x;
    FR(F_RDY) = sc.rd.y;
    FR(F_RDZ) = sc.rd.z;
    FR(F_TMIN) = sc.t_min;
    const V3 col2 = col * sc.mult;
    FR(F_COLX) = col2.x;
    FR(F_COLY) = col2.y;
    FR(F_COLZ) = col2.z;
    FR(F_PDFW) = sc.pdf_w;
    IR(I_SPEC) = sc.specular ? 1 : 0;
    alive2 = !sc.is_emis;
    diffuse = sc.mtype == kDiffuse;
    albedo = sc.albedo;
  }
  FR(F_RADX) = rad.x;
  FR(F_RADY) = rad.y;
  FR(F_RADZ) = rad.z;
  a.alive_next[i] = alive2 ? 1 : 0;

  // NEE's terms (integrator._nee_samples), each with its shadow ray's
  // sphere test; the any-hit sweep and the sum come after
  if (!diffuse) {
    for (int t = 0; t < terms; ++t) closed(t);
    return;
  }
  const V3 p = h.point + h.normal * 1e-4f;  // the scatter's offset
  const V3 thr_alb = col * albedo;
  for (int t = 0; t < terms; ++t) {
    Term tm;
    if (t == 0 && a.n_tri > 0) {
      tm = mesh_term(a.tab, a.mat_off, L, p, h.normal, thr_alb, seed, bounce);
    } else if (a.n_lights > kUnrollMax) {
      float u = uniform(seed, bounce_counter(bounce, 4));
      int li = min((int)(u * (float)a.n_lights), a.n_lights - 1);
      tm = sphere_term(L, li, true, p, h.normal, thr_alb, seed, bounce);
    } else {
      tm = sphere_term(L, t - (a.n_tri > 0 ? 1 : 0), false, p, h.normal, thr_alb, seed, bounce);
    }
    if (!tm.active || sphere_occluded(a.tab, a.n_sph, p, tm.dir, tm.t_limit, tm.light)) {
      closed(t);
      continue;
    }
    a.mask[(size_t)t * n_pad + i] = 1;
    a.contrib[((size_t)t * 3 + 0) * n + i] = tm.contrib.x;
    a.contrib[((size_t)t * 3 + 1) * n + i] = tm.contrib.y;
    a.contrib[((size_t)t * 3 + 2) * n + i] = tm.contrib.z;
    if (a.rows != nullptr) {  // the any-hit sweep's rows, the window's end as the t cap
      const float vals[8] = {p.x, p.y, p.z, tm.dir.x, tm.dir.y, tm.dir.z, 1e-4f, tm.t_limit};
      for (int r = 0; r < 8; ++r) a.rows[r * rows_stride + (size_t)t * n_pad + i] = vals[r];
    }
  }
#undef FR
#undef IR
}

// --- trip_tail ---------------------------------------------------------------

struct TailArgs {
  float* F;
  int* I;
  int n;
  RecordArgs rec;
  const float* tab;
  int mat_off, obj_off, bg_off;
  // camera: viewport width and height, then the camera-to-world rows 0-2
  const float* cam;
  int pix0, width, height, it0, spp, max_bounces, rr_start, chained;
  // the NEE mode's inputs (trip_nee's, and treelet_any_hit's occlusion on
  // its rows, null without a mesh)
  int n_pad, n_lights, n_tri;
  const unsigned char* alive_next;
  const float* contrib;
  const unsigned char* mask;
  const unsigned char* occ;
  int* count;
};

// integrator._fresh_state with camera.generate_rays for pixel `pix` at
// sample `iteration`: the seed, the origin and the unit direction.
__device__ __forceinline__ uint32_t fresh_ray(const TailArgs& a, int pix, int iteration, V3* ro,
                                              V3* rd) {
  uint32_t seed = wang_hash(wang_hash((uint32_t)pix) ^ (uint32_t)iteration);
  float fx = (float)(pix % a.width) + uniform(seed, 0u);
  float fy = (float)(pix / a.width) + uniform(seed, 1u);
  float u = fx / (float)(a.width - 1);
  float v = ((float)a.height - fy) / (float)(a.height - 1);
  const float* m = a.cam + 2;
  V3 d = v3((u - 0.5f) * a.cam[0], (v - 0.5f) * a.cam[1], -1.0f);
  *rd = normalize(xform_vector(m, d));
  *ro = v3(m[3], m[7], m[11]);
  return seed;
}

// integrator._nee_resolve: the lit terms' contributions in the body's order
__device__ __forceinline__ V3 nee_sum(const TailArgs& a, int i) {
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  V3 total = zero;
  const int terms = nee_terms(a.n_lights, a.n_tri);
  for (int t = 0; t < terms; ++t) {
    const size_t j = (size_t)t * a.n_pad + i;
    const bool lit = a.mask[j] != 0 && !(a.occ != nullptr && a.occ[j] != 0);
    V3 c = zero;
    if (lit) {
      c = v3(a.contrib[((size_t)t * 3 + 0) * a.n + i], a.contrib[((size_t)t * 3 + 1) * a.n + i],
             a.contrib[((size_t)t * 3 + 2) * a.n + i]);
    }
    if (t == 0 && a.n_tri > 0) {
      total = c;  // the mesh term starts the sum
    } else if (a.n_lights > kUnrollMax) {
      total = total + c;
    } else if (lit) {
      total = total + c;
    }
  }
  return total;
}

template <bool kNee>
__global__ void __launch_bounds__(kThreads) trip_tail_kernel(const TailArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int n = a.n;
  bool left = false;  // still to trace after this trip: counted per warp
  if (i < n) {
    float* F = a.F;
    int* I = a.I;
#define FR(row) F[(size_t)(row) * n + i]
#define IR(row) I[(size_t)(row) * n + i]
    const bool alive = IR(I_ALIVE) != 0;
    bool done = a.chained && IR(I_DONE) != 0;
    const int bounce = IR(I_BOUNCE);
    // a lane that is done and dead: the body and the fold change nothing
    // but its bounce counter
    const bool touched = alive || (a.chained && !done);
    V3 ro, rd, rad, col, nrm;
    float t_min = 0.0f, depth = 0.0f;
    bool alive2 = false;
    if (touched) {
      ro = v3(FR(F_ROX), FR(F_ROY), FR(F_ROZ));
      rd = v3(FR(F_RDX), FR(F_RDY), FR(F_RDZ));
      t_min = FR(F_TMIN);
      rad = v3(FR(F_RADX), FR(F_RADY), FR(F_RADZ));
      col = v3(FR(F_COLX), FR(F_COLY), FR(F_COLZ));
      nrm = v3(FR(F_NX), FR(F_NY), FR(F_NZ));
      depth = FR(F_DEPTH);
    }
    if (alive) {
      const uint32_t seed = (uint32_t)IR(I_SEED);
      if (kNee) {
        // trip_nee left the body's state; NEE's sum joins the radiance
        rad = rad + nee_sum(a, i);
        alive2 = a.alive_next[i] != 0;
      } else {
        const HitRec h = hit_record(a.rec, a.tab, a.obj_off, n, i, ro, rd);
        if (!h.mask) rad = rad + col * background(a.tab + a.bg_off, rd);
        if (bounce == 0 && h.mask) {
          nrm = h.normal;
          depth = h.t;
        }
        if (h.mask) {
          const Scatter sc = shade(a.tab, a.mat_off, h, rd, t_min, seed, bounce);
          // the emission term without NEE (integrator._weighted_emission)
          rad = rad + col * sc.emitted;
          ro = sc.ro;
          rd = sc.rd;
          t_min = sc.t_min;
          col = col * sc.mult;
          alive2 = !sc.is_emis;
        }
      }
      if (alive2 && bounce >= a.rr_start) {  // materials.russian_roulette
        float u = uniform(seed, bounce_counter(bounce, 3));
        float p_s = clamp2(maximum(maximum(col.x, col.y), col.z), 0.05f, 0.95f);
        bool survive = u < p_s;
        float inv_p = 1.0f / p_s;
        if (survive) col = col * inv_p;
        alive2 = survive;
      }
    }

    const int b2 = bounce + 1;
    if (a.chained) {
      bool capped = alive2 && b2 >= a.max_bounces;
      bool ended = !done && (!alive2 || capped);
      bool need = false;
      int k = 0;
      if (ended) {  // fold the finished sample into the lane's averages
        k = IR(I_K);
        V3 fin = capped ? rad + col : rad;
        int git = a.it0 + k;
        float nf = (float)(git + 1);
        bool first = git == 0;
        V3 ac = v3(FR(F_ACX), FR(F_ACY), FR(F_ACZ));
        V3 an = v3(FR(F_ANX), FR(F_ANY), FR(F_ANZ));
        float ad = FR(F_ADEPTH);
        float w = nf - 1.0f;
        ac = first ? fin : v3((ac.x * w + fin.x) / nf, (ac.y * w + fin.y) / nf,
                              (ac.z * w + fin.z) / nf);
        an = first ? nrm : v3((an.x * w + nrm.x) / nf, (an.y * w + nrm.y) / nf,
                              (an.z * w + nrm.z) / nf);
        ad = first ? depth : (ad * w + depth) / nf;
        FR(F_ACX) = ac.x;
        FR(F_ACY) = ac.y;
        FR(F_ACZ) = ac.z;
        FR(F_ANX) = an.x;
        FR(F_ANY) = an.y;
        FR(F_ANZ) = an.z;
        FR(F_ADEPTH) = ad;
        k += 1;
        done = k >= a.spp;
        need = !done;
        IR(I_K) = k;
        IR(I_DONE) = done ? 1 : 0;
      }
      if (need) {  // the lane's next sample: a fresh primary ray
        uint32_t s2 = fresh_ray(a, a.pix0 + i, a.it0 + k, &ro, &rd);
        t_min = 1e-4f;  // camera.T_MIN_PRIMARY
        rad = v3(0.0f, 0.0f, 0.0f);
        col = v3(1.0f, 1.0f, 1.0f);
        nrm = -rd;
        depth = 1e6f;
        IR(I_SEED) = (int)s2;
        if (kNee) {  // _fresh_state: no scatter yet, so the next hit takes full weight
          IR(I_SPEC) = 1;
          FR(F_PDFW) = 0.0f;
        }
      }
      if (touched) {
        FR(F_ROX) = ro.x;
        FR(F_ROY) = ro.y;
        FR(F_ROZ) = ro.z;
        FR(F_RDX) = rd.x;
        FR(F_RDY) = rd.y;
        FR(F_RDZ) = rd.z;
        FR(F_TMIN) = t_min;
        FR(F_RADX) = rad.x;
        FR(F_RADY) = rad.y;
        FR(F_RADZ) = rad.z;
        FR(F_COLX) = col.x;
        FR(F_COLY) = col.y;
        FR(F_COLZ) = col.z;
        FR(F_NX) = nrm.x;
        FR(F_NY) = nrm.y;
        FR(F_NZ) = nrm.z;
        FR(F_DEPTH) = depth;
        IR(I_ALIVE) = need || (alive2 && !ended);
        IR(I_SEGS) = IR(I_SEGS) + (alive ? 1 : 0);
      }
      IR(I_BOUNCE) = need ? 0 : b2;
      left = !done;
    } else {
      if (alive) {
        FR(F_ROX) = ro.x;
        FR(F_ROY) = ro.y;
        FR(F_ROZ) = ro.z;
        FR(F_RDX) = rd.x;
        FR(F_RDY) = rd.y;
        FR(F_RDZ) = rd.z;
        FR(F_TMIN) = t_min;
        FR(F_RADX) = rad.x;
        FR(F_RADY) = rad.y;
        FR(F_RADZ) = rad.z;
        FR(F_COLX) = col.x;
        FR(F_COLY) = col.y;
        FR(F_COLZ) = col.z;
        FR(F_NX) = nrm.x;
        FR(F_NY) = nrm.y;
        FR(F_NZ) = nrm.z;
        FR(F_DEPTH) = depth;
        IR(I_ALIVE) = alive2;
        IR(I_SEGS) = IR(I_SEGS) + 1;
      }
      IR(I_BOUNCE) = b2;
      left = alive2;
    }
#undef FR
#undef IR
  }
  // every thread of the warp reaches the vote, out-of-range ones with 0
  const unsigned votes = __ballot_sync(0xffffffffu, left);
  if ((threadIdx.x & 31) == 0 && votes != 0u) atomicAdd(a.count, __popc(votes));
}

}  // namespace

extern "C" {

// trip_head over n lanes; rows/act (the sweep's packed rows, n_pad >= n
// lanes) may be null for a scene without meshes.
int tpupt_trip_head(const float* F, const int* I, int n, int n_pad, const float* tab, int n_sph,
                    float* hrec, int* hint, float* rows, unsigned char* act,
                    cudaStream_t stream) {
  const int lanes = rows != nullptr ? n_pad : n;
  if (lanes > 0) {
    trip_head_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        F, I, n, n_pad, tab, n_sph, hrec, hint, rows, act);
  }
  return (int)cudaGetLastError();
}

// trip_nee over n lanes (n_pad >= n, a packet multiple: each NEE term's
// region of mask and rows); the sweep's outputs and rows may be null (no
// mesh).
int tpupt_trip_nee(float* F, int* I, int n, int n_pad, const float* hrec, const int* hint,
                   const float* s_t, const int* s_slot, const float* s_nx, const float* s_ny,
                   const float* s_nz, const float* s_obj, const float* tab, int n_sph,
                   int mat_off, int obj_off, int bg_off, int nee_off, int n_lights, int n_tri,
                   unsigned char* alive_next, float* contrib, unsigned char* mask, float* rows,
                   cudaStream_t stream) {
  NeeArgs a{F,       I,       n,       n_pad,    {hrec, hint, s_t, s_slot, s_nx, s_ny, s_nz, s_obj},
            tab,     n_sph,   mat_off, obj_off,  bg_off,     nee_off,  n_lights,  n_tri,
            alive_next, contrib, mask, rows};
  if (n_pad > 0) {
    trip_nee_kernel<<<(n_pad + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// trip_tail over n lanes; the sweep's outputs may be null (no mesh).  With
// alive_next (a scene with emitters) it runs the NEE mode on trip_nee's
// outputs and the any-hit sweep's occ (null without a mesh).  Zeroes
// *count, then adds the lanes left to trace.
int tpupt_trip_tail(float* F, int* I, int n, const float* hrec, const int* hint,
                    const float* s_t, const int* s_slot, const float* s_nx, const float* s_ny,
                    const float* s_nz, const float* s_obj, const float* tab, int mat_off,
                    int obj_off, int bg_off, const float* cam, int pix0, int width, int height,
                    int it0, int spp, int max_bounces, int rr_start, int chained, int n_pad,
                    int n_lights, int n_tri, const unsigned char* alive_next,
                    const float* contrib, const unsigned char* mask, const unsigned char* occ,
                    int* count, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  TailArgs a{F,       I,        n,       {hrec, hint, s_t, s_slot, s_nx, s_ny, s_nz, s_obj},
             tab,     mat_off,  obj_off, bg_off,   cam,      pix0,   width,  height,
             it0,     spp,      max_bounces, rr_start, chained, n_pad, n_lights, n_tri,
             alive_next, contrib, mask,  occ,      count};
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    if (alive_next != nullptr) {
      trip_tail_kernel<true><<<blocks, kThreads, 0, stream>>>(a);
    } else {
      trip_tail_kernel<false><<<blocks, kThreads, 0, stream>>>(a);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
