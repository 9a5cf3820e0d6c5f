// The forward trip of the path tracer as two hand-written CUDA kernels for
// Hopper (sm_90a), with a plain C interface bound by ctypes
// (tpupt_torch/render/trip_kernel.py, which also holds their torch twins).
//
// What they replace.  In the JAX package the forward trip is XLA code, not
// Pallas: the trips of tpupt/render/integrator.py `_render_chained` run in
// one lax.while_loop, as do the bounces of the forward `trace_sample`, and
// XLA fuses each trip body into a few device kernels.  The body is
// `_bounce_body` (integrator.py) without next-event estimation, the sphere
// pass (tpupt/render/intersect.py `_sphere_pass`) and the sweep's ray rows
// (tpupt/accel/packets.py `_pack_rows`), `materials.shade` and
// `russian_roulette` (tpupt/render/materials.py), the Wang hash
// (tpupt/sampling/rng.py `wang_hash`, `uniform`), `random_in_unit_sphere`
// (tpupt/sampling/sphere.py), `background_color`, and, chained, the fold
// of a finished sample and the restart of its lane (`_fresh_state` with
// tpupt/core/camera.py `generate_rays`).  The port's body route
// (integrator._bounce_body) runs each of those operations as its own eager
// torch kernel, about a thousand launches a trip.  Here a trip is
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
// The lane state is SoA in device memory (F: 24 f32 rows, I: 6 i32 rows,
// row-major (rows, N)), updated in place: a lane reads and writes only its
// own entries, so no lane ever reads what another writes.
//
// What bounds them on this card: bytes.  A live lane moves ~120 bytes
// through trip_head and ~250 through trip_tail and does a few hundred
// float operations, far below the 67 TFLOP/s FP32 rate (~20 operations a
// byte at 3.35 TB/s).  So the design keeps every access coalesced (one
// thread a lane, SoA rows, the packed rows written in the sweep's own
// layout), reads and writes a lane's state only where the lane needs it
// (in trip_head a dead lane reads 4 bytes and writes the sweep's 5; in
// trip_tail a lane that is done reads 12 bytes and writes 4), so a late
// trip with few live lanes costs little more than its launch, and keeps
// the scene's small tables (spheres, materials, the background, the
// camera) in one table that every thread reads at the same address.
//
// Numerics: every float operation runs in the torch body's order and is
// rounded once, as PyTorch's CUDA kernels round it (the library is built
// with --fmad=false and no fast math): sqrtf, rsqrtf (torch.rsqrt), sinf
// and cosf (torch.sin, torch.cos), IEEE division (a / b, and 1.0f / x for
// torch's reciprocal), clamps that propagate NaN as torch.clamp does, and
// torch.sign's 0 at 0.  The hash runs in native uint32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;  // packets.BIG = intersect.BIG_T
constexpr int kThreads = 256;

// F rows (trip_kernel.F_KEYS)
enum {
  F_ROX, F_ROY, F_ROZ, F_RDX, F_RDY, F_RDZ, F_TMIN,
  F_RADX, F_RADY, F_RADZ, F_COLX, F_COLY, F_COLZ, F_NX, F_NY, F_NZ, F_DEPTH,
  F_ACX, F_ACY, F_ACZ, F_ANX, F_ANY, F_ANZ, F_ADEPTH,
};
// I rows (trip_kernel.I_KEYS)
enum { I_ALIVE, I_SEED, I_BOUNCE, I_K, I_SEGS, I_DONE };
// a sphere object's row of the scene table: inverse matrix rows 0-2, matrix
// rows 0-2, centre, radius, material (trip_kernel.SPHERE_ROW)
constexpr int kSphereRow = 29;
constexpr int kMatRow = 9;  // type, albedo, fuzz, ior, emission
// material tags (core/types.py)
constexpr int kDiffuse = 0, kMetal = 1, kDielectric = 2, kEmissive = 3;

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
  V3 oo = xform_point(inv, ro);
  V3 od = normalize(xform_vector(inv, rd));
  V3 oc = oo - c;
  float a = dot(od, od);
  float b = 2.0f * dot(od, oc);
  float cc = dot(oc, oc) - r * r;
  float disc = b * b - 4.0f * a * cc;
  float sq = sqrtf(clamp_min(disc, 0.0f));
  float t1 = (-b - sq) / (2.0f * a);
  float t2 = (-b + sq) / (2.0f * a);
  bool use1 = (t1 >= t_min) & (t1 <= t_bound);
  bool use2 = (t2 >= t_min) & (t2 <= t_bound);
  bool hit = (disc >= 0.0f) & (use1 | use2);
  float t_obj = use1 ? t1 : t2;
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
  int code = -1;  // material * 2 + front of the winning sphere, -1: none
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

// --- trip_tail ---------------------------------------------------------------

struct TailArgs {
  float* F;
  int* I;
  int n;
  const float* hrec;
  const int* hint;
  // treelet_closest_hit's outputs, flat over the packed lanes; null
  // without a mesh
  const float* s_t;
  const int* s_slot;
  const float* s_nx;
  const float* s_ny;
  const float* s_nz;
  const float* s_obj;
  const float* tab;
  int mat_off, obj_off, bg_off;
  // camera: viewport width and height, then the camera-to-world rows 0-2
  const float* cam;
  int pix0, width, height, it0, spp, max_bounces, rr_start, chained;
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
      // the hit record: the sphere pass's, replaced by the sweep's winner
      // where a triangle won (intersect.hit_record)
      const int code = a.hint[i];
      bool mask = code >= 0;
      bool front = mask && (code & 1);
      int mat = mask ? code >> 1 : 0;
      float t_best = a.hrec[0 * (size_t)n + i];
      V3 point = v3(a.hrec[1 * (size_t)n + i], a.hrec[2 * (size_t)n + i],
                    a.hrec[3 * (size_t)n + i]);
      V3 normal = v3(a.hrec[4 * (size_t)n + i], a.hrec[5 * (size_t)n + i],
                     a.hrec[6 * (size_t)n + i]);
      if (a.s_slot != nullptr && a.s_slot[i] >= 0) {
        float t_mesh = a.s_t[i];
        int obj_w = max((int)a.s_obj[i], 0);
        V3 outward = normalize(v3(a.s_nx[i], a.s_ny[i], a.s_nz[i]));
        bool tri_front = dot(rd, outward) < 0.0f;
        t_best = t_mesh;
        mask = true;
        point = ro + rd * t_mesh;
        normal = sel(tri_front, outward, -outward);
        front = tri_front;
        mat = (int)a.tab[a.obj_off + obj_w];
      }
      const float hit_t = mask ? t_best : kBig;

      if (!mask) {  // background light on a miss (intersect.background_color)
        const float* bg = a.tab + a.bg_off;
        V3 unit = normalize(rd);
        float t = 0.5f * (unit.y + 1.0f);
        V3 sky = v3(bg[0] + t * (bg[3] - bg[0]), bg[1] + t * (bg[4] - bg[1]),
                    bg[2] + t * (bg[5] - bg[2]));
        rad = rad + col * sky;
      }
      if (bounce == 0 && mask) {
        nrm = normal;
        depth = hit_t;
      }
      if (mask) {
        // materials.shade: every lobe, the material's tag selects
        const float* mr = a.tab + a.mat_off + mat * kMatRow;
        const int mtype = (int)mr[0];
        const V3 albedo = v3(mr[1], mr[2], mr[3]);
        const float fuzz = mr[4], ior = mr[5];
        const V3 emission = v3(mr[6], mr[7], mr[8]);
        const V3 n_ = normal;

        // sphere.random_in_unit_sphere
        float u0 = uniform(seed, bounce_counter(bounce, 0));
        float u1 = uniform(seed, bounce_counter(bounce, 1));
        float phi = 6.283185307179586f * u0;
        float cos_s = 2.0f * u1 - 1.0f;
        float sin_s = sqrtf(clamp_min(1.0f - cos_s * cos_s, 1e-12f));
        V3 s = v3(cosf(phi) * sin_s, sinf(phi) * sin_s, cos_s);
        float u_fresnel = uniform(seed, bounce_counter(bounce, 2));

        V3 off = point - n_ * (1e-4f * sign(dot(rd, n_)));
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
        float ratio = front ? 1.0f / ior : ior;
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

        const bool is_diff = mtype == kDiffuse, is_metal = mtype == kMetal;
        const bool is_diel = mtype == kDielectric, is_emis = mtype == kEmissive;
        const V3 zero = v3(0.0f, 0.0f, 0.0f), one = v3(1.0f, 1.0f, 1.0f);
        V3 new_rd = is_diff ? d_diff : (is_metal ? d_metal : d_diel);
        V3 new_ro = is_diel ? point : off;
        float new_t_min = is_diel ? 1e-5f : t_min;
        V3 mult = is_diff ? albedo : (is_metal ? sel(metal_ok, albedo, zero) : one);
        V3 emitted = sel(is_emis, emission, zero);
        // the emission term without NEE (integrator._weighted_emission)
        rad = rad + col * emitted;
        ro = new_ro;
        rd = new_rd;
        t_min = new_t_min;
        col = col * mult;
        alive2 = !is_emis;
        if (alive2 && bounce >= a.rr_start) {  // materials.russian_roulette
          float u = uniform(seed, bounce_counter(bounce, 3));
          float p_s = clamp2(maximum(maximum(col.x, col.y), col.z), 0.05f, 0.95f);
          bool survive = u < p_s;
          float inv_p = 1.0f / p_s;
          if (survive) col = col * inv_p;
          alive2 = survive;
        }
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

// trip_tail over n lanes; the sweep's outputs may be null (no mesh).
// Zeroes *count, then adds the lanes left to trace.
int tpupt_trip_tail(float* F, int* I, int n, const float* hrec, const int* hint,
                    const float* s_t, const int* s_slot, const float* s_nx, const float* s_ny,
                    const float* s_nz, const float* s_obj, const float* tab, int mat_off,
                    int obj_off, int bg_off, const float* cam, int pix0, int width, int height,
                    int it0, int spp, int max_bounces, int rr_start, int chained, int* count,
                    cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  TailArgs a{F,       I,       n,      hrec, hint,  s_t,    s_slot, s_nx,
             s_ny,    s_nz,    s_obj,  tab,  mat_off, obj_off, bg_off, cam,
             pix0,    width,   height, it0,  spp,   max_bounces, rr_start, chained,
             count};
  if (n > 0) trip_tail_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
