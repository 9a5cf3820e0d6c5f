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
//   trip_head   the sphere pass over the scene's sphere objects in order
//               (a later hit at an equal t overwrites an earlier one), its
//               hit record, and the eight (np, 256) f32 rows and the live
//               mask that treelet_closest_hit takes (a dead lane: its -BIG
//               seed and mask only; CTAs of 512 lanes: see below);
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
//   trip_nee    the hit record, background, normal and depth, the BSDF
//               lobes, the MIS-weighted emission, and per NEE term (the
//               mesh light; each sphere light up to four, or one sampled
//               per lane) the light sample, its shadow ray's sphere test,
//               its contribution, and the ray packed into the term's
//               packet-aligned region of one row buffer, as
//               treelet_any_hit takes it (a persistent grid: see below);
//   treelet_any_hit on every term's rows at once, for scenes with a mesh;
//   trip_tail   its NEE mode: the lit terms' contributions added in the
//               body's order, then roulette, the fold and the count.
//
// A render of a scene without meshes or emitters stops issuing trips once
// the lanes still to trace fit in one resident wave of
//
//   trip_drain  the lanes still to trace listed, then each run on one
//               thread, trip after trip, to its end (its section below).
//
// The lane state is SoA in device memory (F: 25 f32 rows, I: 7 i32 rows,
// row-major (rows, N)), updated in place: a lane reads and writes only its
// own entries, so no lane ever reads what another writes.
//
// What bounds them on this card: bytes.  A live lane moves ~120 bytes
// through trip_head, ~250 through trip_tail and ~150 + 45 a NEE term
// through trip_nee, and does a few hundred float operations (a thousand
// with four lights), far below the 67 TFLOP/s FP32 rate (~20 operations a
// byte at 3.35 TB/s; on the lit scenes' dense trips, with every sphere
// tested by every ray and shadow ray, the issue of those tests comes
// near).  So the design keeps every access coalesced (SoA rows, the packed
// rows written in the sweeps' own layout, neighbouring lanes on
// neighbouring threads), reads and writes a lane's state only where the
// lane needs it (in trip_head a dead lane reads 4 bytes and writes the
// sweep's 5; in trip_tail a lane that is done reads 12 bytes and writes 4;
// in trip_nee a dead lane writes each term's 5), so a late trip with few
// live lanes costs little more than its launch, and keeps the scene's
// small tables (spheres, materials, the background, the lights, the
// camera) in one table that every thread reads at the same address.
//
// trip_nee is shaped by what held a thread-a-lane design back: a grid of
// 256-lane CTAs ran in ~2.6 waves at 80 registers, a warp mixed four cases
// (a miss, an emitter, a specular hit, a diffuse hit that runs every NEE
// term and its loop over the sphere objects) and ran as long as its
// costliest lane, every padded lane of a late trip launched a thread, and
// the mesh light's CDF was inverted by counting compares over every
// emissive triangle.  So:
//   - a persistent grid, as many CTAs as the card holds at once (two an SM
//     at ~90 registers), whose warps each take chunks of 64 lanes by their
//     index in the grid: no counter and no barrier after the start, so the
//     warps of an SM drift apart and one's loads overlap another's
//     arithmetic;
//   - the scene table up to the emissive triangles' rows is staged once a
//     CTA in shared memory where it fits, so the sphere test's loop, the
//     shading and the CDF search read shared memory;
//   - a thread reads its two alive flags in one load and closes its lanes'
//     entries in every term (mask 0, the -BIG seed) in one store each; the
//     warp queues its live lanes in lane order and runs them one a thread:
//     the hit, shading and write-back, then on a diffuse hit each NEE term
//     in the same thread, which rewrites the entries of a lit term.  A
//     chunk with no live lane costs its flags and those stores;
//   - the CDF is inverted by binary search (the same index: cum never
//     decreases), and a sphere whose quadratic has no real root skips the
//     roots' two divides (sphere_roots: its answer is no either way).
//
// trip_head was one thread a lane too, and computed every sphere's
// candidate whole (two transforms, the quadratic, two divides, the world
// point and t, the normal) where only the winner's is kept.  trip_nee's
// persistent grid lost on bunny's dense trips (uniform work: a warp's
// chunks taken by grid index ran 5-8% behind the hardware's own handing
// out of CTAs; PERF.md §6), so trip_head is a grid over every lane in
// CTAs of 512 lanes:
//   - a thread reads its two alive flags in one load and writes its lanes'
//     mask in one store and, where a lane is not live, its -BIG seed (one
//     store where neither is); a CTA with no live lane is done after one
//     barrier, so a sparse trip costs little more than reading the flags;
//   - otherwise the sphere rows are staged in shared memory (where there
//     are two or more) and each thread runs its live lanes in place (lanes
//     t and t + 256 of the CTA, a warp's lanes neighbours), both lanes'
//     rays read before either's pass;
//   - the sphere pass is lazy: a sphere's world t is measured only where
//     its quadratic hits the window, its roots' divides only where the
//     discriminant is >= 0 (the answer is no otherwise, whatever the
//     roots), and the winner's normal once, after the loop, from the values
//     its candidate computed: the same operations in the same order, so the
//     same bits.
//
// Numerics: every float operation runs in the torch body's order and is
// rounded once, as PyTorch's CUDA kernels round it (the library is built
// with --fmad=false and no fast math): sqrtf, rsqrtf (torch.rsqrt), sinf
// and cosf (torch.sin, torch.cos), IEEE division (a / b, and 1.0f / x for
// torch's reciprocal, which is also what `c / tensor` computes, times c),
// clamps that propagate NaN as torch.clamp does, and torch.sign's 0 at 0.
// The hash runs in native uint32.  The device code these kernels share
// with the differentiable trip's (diff_trip_kernels.cu) is in
// trip_common.cuh: the lane state's rows, 3-vectors, the RNG, the
// background and materials.shade.

#include "trip_common.cuh"

namespace {


// intersect._sphere_roots of one sphere object (its table row s) for a ray
// and the window [t_min, t_bound]: the object-space quadratic.  Returns
// whether it hits, with the root taken and the object-space ray.  Where the
// discriminant is not >= 0 the answer is no whatever the roots, so their
// two divides are skipped (t_obj is then not set).
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
  if (!(disc >= 0.0f)) return false;
  float sq = sqrtf(clamp_min(disc, 0.0f));
  float t1 = (-b - sq) / (2.0f * a);
  float t2 = (-b + sq) / (2.0f * a);
  bool use1 = (t1 >= t_min) & (t1 <= t_bound);
  bool use2 = (t2 >= t_min) & (t2 <= t_bound);
  *t_obj = use1 ? t1 : t2;
  return use1 | use2;
}

// --- the grids of trip_head and trip_nee ---------------------------------------

// trip_nee: a persistent grid of CTAs whose warps each take chunks of
// kWarpLanes lanes (kLanePer a thread, whose alive flags it reads in one
// load)
constexpr int kGridThreads = kThreads;
constexpr int kGridWarps = kGridThreads / 32;
constexpr int kWarpLanes = 64;
constexpr int kLanePer = kWarpLanes / 32;
// n_pad is a multiple of a packet's 256 lanes, so the chunks tile it
static_assert(256 % kWarpLanes == 0 && (kLanePer == 1 || kLanePer == 2 || kLanePer == 4),
              "a packet holds whole chunks, and a thread's lanes go out in one store");
// The scene table up to the emissive triangles' rows (which a term reads
// once, at a random row) is staged in shared memory where it fits (32 KB)
constexpr int kStageMax = 8192;

// The CTA's shared memory: each warp's queue of its chunk's live lanes
// (trip_head: the CTA's live flags), then the staged table
extern __shared__ float4 grid_sm[];  // float4: 16-byte aligned
constexpr int kTabB = (2 * kGridWarps * kWarpLanes + 15) / 16 * 16;

__device__ __forceinline__ unsigned short* sm_queue(int warp) {
  return reinterpret_cast<unsigned short*>(grid_sm) + warp * kWarpLanes;
}
__device__ __forceinline__ float* sm_tab() {
  return reinterpret_cast<float*>(reinterpret_cast<char*>(grid_sm) + kTabB);
}

static_assert(kTabB + 4 * kStageMax <= 48 * 1024, "a CTA's shared memory needs no opt-in");

size_t grid_smem_bytes(int n_stage) { return (size_t)kTabB + sizeof(float) * (size_t)n_stage; }

// The first n_stage floats of tab into shared memory
__device__ __forceinline__ void stage_table(const float* tab, int n_stage) {
  float* st = sm_tab();
  for (int e = threadIdx.x; e < n_stage; e += kGridThreads) st[e] = tab[e];
}

// --- trip_head ---------------------------------------------------------------

// A grid over every lane (the packed rows' pad lanes included) in CTAs of
// kHeadLanes lanes, kHeadPer a thread, whose alive flags it reads in one
// load
constexpr int kHeadPer = 2;
constexpr int kHeadLanes = kThreads * kHeadPer;
// the CTA's live flags, in shared memory before the staged sphere rows
static_assert(kHeadLanes <= kTabB, "a CTA's live flags fit before the staged table");

struct HeadArgs {
  const float* F;
  const int* I;
  int n, n_pad;
  const float* tab;
  int n_sph;
  float* hrec;
  int* hint;
  float* rows;  // (8, n_pad), null without a mesh
  unsigned char* act;
  int n_stage;  // floats of tab staged in shared memory: the sphere rows, or none
};

// intersect._sphere_pass of one ray over the sphere rows of tab, in the
// scene's order (a later hit at an equal t overwrites an earlier one: the
// window is t1 <= t_best): its t (BIG where no sphere was hit), world
// point and normal; returns object * 2 + front of the winning sphere (-1:
// none).  The pass is lazy: a sphere's world t is measured only where its
// quadratic hits the window, and the winner's normal once, after the loop,
// from the values its candidate computed (intersect._sphere_candidate's
// operations in its order, so the same bits as computing every candidate
// whole and keeping the winner's)
__device__ __forceinline__ int sphere_pass(const float* tab, int n_sph, V3 ro, V3 rd, float t_min,
                                           float& t_best, V3& point, V3& normal) {
  t_best = kBig;
  int win = -1;  // the winning sphere's row
  V3 od_w = v3(0.0f, 0.0f, 0.0f), pobj_w = od_w;
  point = od_w;
  for (int o = 0; o < n_sph; ++o) {
    const float* s = tab + o * kSphereRow;
    float t_obj;
    V3 oo, od;
    if (!sphere_roots(s, ro, rd, t_min, t_best, &t_obj, &oo, &od)) continue;
    const V3 point_obj = oo + od * t_obj;
    const V3 point_w = xform_point(s + 12, point_obj);
    const V3 rel = point_w - ro;
    t_best = sqrtf(clamp_min(dot(rel, rel), 1e-30f));
    win = o;
    od_w = od;
    pobj_w = point_obj;
    point = point_w;
  }
  normal = v3(0.0f, 0.0f, 0.0f);
  int code = -1;
  if (win >= 0) {
    const float* s = tab + win * kSphereRow;
    const V3 outward = (pobj_w - v3(s[24], s[25], s[26])) * (1.0f / s[27]);
    const bool front = dot(od_w, outward) < 0.0f;
    normal = xform_normal(s, sel(front, outward, -outward));
    code = (int)s[28] * 2 + (front ? 1 : 0);
  }
  return code;
}

// Live lanes idx[k] (-1: none): every lane's ray read first, then for each
// its sphere pass (sphere_pass), its record, and the sweep's rows seeded
// with its t
template <bool kStaged>
__device__ __forceinline__ void head_lanes(const HeadArgs& a, const int (&idx)[kHeadPer]) {
  const float* tab = kStaged ? sm_tab() : a.tab;
  const int n = a.n;
  V3 ro[kHeadPer], rd[kHeadPer];
  float t_min[kHeadPer];
#pragma unroll
  for (int k = 0; k < kHeadPer; ++k) {
    const int i = idx[k];
    if (i < 0) continue;
    ro[k] = v3(a.F[(size_t)F_ROX * n + i], a.F[(size_t)F_ROY * n + i], a.F[(size_t)F_ROZ * n + i]);
    rd[k] = v3(a.F[(size_t)F_RDX * n + i], a.F[(size_t)F_RDY * n + i], a.F[(size_t)F_RDZ * n + i]);
    t_min[k] = a.F[(size_t)F_TMIN * n + i];
  }
#pragma unroll
  for (int k = 0; k < kHeadPer; ++k) {
    const int i = idx[k];
    if (i < 0) continue;
    float t_best;
    V3 point, normal;
    const int code = sphere_pass(tab, a.n_sph, ro[k], rd[k], t_min[k], t_best, point, normal);
    a.hrec[0 * (size_t)n + i] = t_best;
    a.hrec[1 * (size_t)n + i] = point.x;
    a.hrec[2 * (size_t)n + i] = point.y;
    a.hrec[3 * (size_t)n + i] = point.z;
    a.hrec[4 * (size_t)n + i] = normal.x;
    a.hrec[5 * (size_t)n + i] = normal.y;
    a.hrec[6 * (size_t)n + i] = normal.z;
    a.hint[i] = code;
    if (a.rows != nullptr) {  // the sweep's rows (its mask went out with the flags)
      const float vals[8] = {ro[k].x, ro[k].y, ro[k].z, rd[k].x, rd[k].y, rd[k].z, t_min[k],
                             t_best};
      for (int r = 0; r < 8; ++r) a.rows[(size_t)r * a.n_pad + i] = vals[r];
    }
  }
}

// The sweep's mask of lanes first .. first + kHeadPer - 1 in one store, and
// the -BIG seed of those not live (one store where none is); pad lanes
// (past n) also take packets._pack_rows' pad rows.  A dead lane's record
// and ray rows keep what they held, since neither the sweep (which takes a
// lane with a -BIG seed out of its cull and walk) nor the kernels after it
// read them.
__device__ __forceinline__ void head_close(const HeadArgs& a, int first,
                                           const int (&flags)[kHeadPer]) {
  using Mask = Vec<unsigned char, kHeadPer>::type;
  using Cap = Vec<float, kHeadPer>::type;
  Mask m;
  bool any = false;
  for (int k = 0; k < kHeadPer; ++k) {
    reinterpret_cast<unsigned char*>(&m)[k] = flags[k] != 0 ? 1 : 0;
    any |= flags[k] != 0;
  }
  *reinterpret_cast<Mask*>(a.act + first) = m;
  float* seed = a.rows + (size_t)7 * a.n_pad + first;
  if (!any) {
    Cap c;
    for (int k = 0; k < kHeadPer; ++k) reinterpret_cast<float*>(&c)[k] = -kBig;
    *reinterpret_cast<Cap*>(seed) = c;
  } else {
    for (int k = 0; k < kHeadPer; ++k) {
      if (flags[k] == 0) seed[k] = -kBig;
    }
  }
  const float pad[7] = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f};
  for (int k = max(a.n - first, 0); k < kHeadPer; ++k) {
    for (int r = 0; r < 7; ++r) a.rows[(size_t)r * a.n_pad + first + k] = pad[r];
  }
}

// Thread t's share of the CTA's lanes: its kHeadPer flags read in one load
// and, with a mesh, its lanes' mask and dead lanes' seeds written
// (head_close); the flags kept in shared memory.  Returns whether one of
// its lanes is live
__device__ __forceinline__ bool head_flags(const HeadArgs& a, int base, unsigned char* live) {
  const int lanes = a.rows != nullptr ? a.n_pad : a.n;
  const int first = base + threadIdx.x * kHeadPer;
  const int* alive = a.I + (size_t)I_ALIVE * a.n;
  int flags[kHeadPer];
  load_lanes(alive, first, a.n, 0, flags);
  // n_pad is a multiple of a packet's 256 lanes, so a thread's lanes lie
  // all inside it or all past it
  if (a.rows != nullptr && first < lanes) head_close(a, first, flags);
  bool any = false;
  for (int k = 0; k < kHeadPer; ++k) {
    live[threadIdx.x * kHeadPer + k] = flags[k] != 0 ? 1 : 0;
    any |= flags[k] != 0;
  }
  return any;
}

// Thread t's live lanes in place: lanes t, t + kThreads, ... of the CTA (a
// warp's lanes neighbours), their rays read together (head_lanes)
template <bool kStaged>
__device__ __forceinline__ void head_run(const HeadArgs& a, int base, const unsigned char* live) {
  int idx[kHeadPer];
  for (int k = 0; k < kHeadPer; ++k) {
    const int off = threadIdx.x + kThreads * k;
    idx[k] = live[off] ? base + off : -1;
  }
  head_lanes<kStaged>(a, idx);
}

// One CTA: its kHeadLanes lanes' flags, mask and seeds (head_flags); a CTA
// with no live lane is done after one barrier.  Otherwise the sphere rows
// are staged and the live lanes run in place (head_run).  A dead or pad
// lane costs its flag and its share of the mask and seed stores, so a
// sparse trip costs little more than reading the flags
template <bool kStaged>
__device__ __forceinline__ void head_cta(const HeadArgs& a) {
  unsigned char* live = reinterpret_cast<unsigned char*>(grid_sm);
  const int base = blockIdx.x * kHeadLanes;
  if (!__syncthreads_or(head_flags(a, base, live))) return;
  if (kStaged) {
    stage_table(a.tab, a.n_stage);
    __syncthreads();
  }
  head_run<kStaged>(a, base, live);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) trip_head_kernel(const HeadArgs a) {
  head_cta<kStaged>(a);
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


// The hit record of a sphere pass's record: a hit where code >= 0 (object
// * 2 + front), t then, else BIG
__device__ __forceinline__ HitRec sphere_hit(const float* tab, int obj_off, int code, float t,
                                             V3 point, V3 normal) {
  HitRec h;
  h.mask = code >= 0;
  h.kind = h.mask ? kPrimSphere : kPrimNone;
  h.front = h.mask && (code & 1);
  h.obj = h.mask ? code >> 1 : -1;
  h.mat = h.mask ? (int)tab[obj_off + h.obj] : 0;
  h.t = h.mask ? t : kBig;
  h.point = point;
  h.normal = normal;
  return h;
}

// intersect.hit_record: the sphere pass's record, replaced by the sweep's
// winner where a triangle won
__device__ __forceinline__ HitRec hit_record(const RecordArgs& r, const float* tab, int obj_off,
                                             int n, int i, V3 ro, V3 rd) {
  HitRec h = sphere_hit(
      tab, obj_off, r.hint[i], r.hrec[0 * (size_t)n + i],
      v3(r.hrec[1 * (size_t)n + i], r.hrec[2 * (size_t)n + i], r.hrec[3 * (size_t)n + i]),
      v3(r.hrec[4 * (size_t)n + i], r.hrec[5 * (size_t)n + i], r.hrec[6 * (size_t)n + i]));
  if (r.s_slot != nullptr && r.s_slot[i] >= 0) {
    float t_mesh = r.s_t[i];
    int obj_w = max((int)r.s_obj[i], 0);
    V3 outward = normalize(v3(r.s_nx[i], r.s_ny[i], r.s_nz[i]));
    bool tri_front = dot(rd, outward) < 0.0f;
    h.t = t_mesh;
    h.mask = true;
    h.kind = kPrimTriangle;
    h.obj = obj_w;
    h.point = ro + rd * t_mesh;
    h.normal = sel(tri_front, outward, -outward);
    h.front = tri_front;
    h.mat = (int)tab[obj_off + obj_w];
  }
  return h;
}

// --- trip_nee ----------------------------------------------------------------

// Where the emissive triangles' rows start in the scene table
// (trip_kernel.TripPlan.tables): after the sphere lights, 1 / n_lights,
// the area and its clamp, and the CDF
__host__ __device__ __forceinline__ int tri_rows_off(int nee_off, int n_lights, int n_tri) {
  return nee_off + n_lights * kLightRow + 3 + n_tri;
}

// The light tables of the scene table from nee_off; the triangle rows are
// passed apart, since the staged table may hold all but them
struct Lights {
  const float* sph;  // n_lights LIGHT_ROW rows
  float select;  // float32(1 / n_lights)
  float area, area_c;  // the emissive triangles' total area, and clamped at 1e-30
  const float* cum;  // n_tri CDF entries
  const float* tri;  // n_tri TRI_LIGHT_ROW rows
  int n_lights, n_tri;
};

__device__ __forceinline__ Lights lights_of(const float* tab, const float* tri, int nee_off,
                                            int n_lights, int n_tri) {
  Lights L;
  const float* p = tab + nee_off;
  L.sph = p;
  p += n_lights * kLightRow;
  L.select = p[0];
  L.area = p[1];
  L.area_c = p[2];
  L.cum = p + 3;
  L.tri = tri;
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

// One sphere object (its table row s) of intersect.sphere_occlusion: it
// hits the shadow ray in [1e-4, t_limit] (sphere_roots' quadratic, which
// skips the roots' divides where no real root exists)
__device__ __forceinline__ bool sphere_blocks(const float* s, V3 p, V3 dir, float t_limit) {
  float t_obj;
  V3 oo, od;
  return sphere_roots(s, p, dir, 1e-4f, t_limit, &t_obj, &oo, &od);
}

// intersect.sphere_occlusion of one shadow ray: a sphere object other than
// `exclude` hits it
__device__ __forceinline__ bool sphere_occluded(const float* tab, int n_sph, V3 p, V3 dir,
                                                float t_limit, int exclude) {
  for (int o = 0; o < n_sph; ++o) {
    const float* s = tab + o * kSphereRow;
    if ((int)s[28] != exclude && sphere_blocks(s, p, dir, t_limit)) return true;
  }
  return false;
}

// The area CDF inverted: the number of entries <= u, by binary search.
// cum never decreases, so the entries <= u are a prefix and this is the
// count integrator._nee_mesh_sample takes, clamped to the last triangle
__device__ __forceinline__ int cdf_index(const float* cum, int n, float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (u >= cum[mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return min(lo, n - 1);
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
  const float* row = L.tri + cdf_index(L.cum, L.n_tri, u_sel) * kTriLightRow;
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
  int terms;  // NEE's terms a diffuse lane samples
  int n_stage;  // floats of tab staged in shared memory: all but the triangle rows, or none
};

__host__ __device__ __forceinline__ int nee_terms(int n_lights, int n_tri) {
  return (n_tri > 0 ? 1 : 0) + (n_lights > kUnrollMax ? 1 : n_lights);
}

// The table the CTA reads (the staged one where it is)
template <bool kStaged>
__device__ __forceinline__ const float* nee_table(const NeeArgs& a) {
  return kStaged ? sm_tab() : a.tab;
}

// Its light tables, the triangle rows from device memory
template <bool kStaged>
__device__ __forceinline__ Lights nee_lights(const NeeArgs& a) {
  return lights_of(nee_table<kStaged>(a), a.tab + tri_rows_off(a.nee_off, a.n_lights, a.n_tri),
                   a.nee_off, a.n_lights, a.n_tri);
}

// Lanes first .. first + kLanePer - 1 closed in every term's region (mask 0,
// the -BIG seed), one store each; pad lanes (past n) also take
// packets._pack_rows' pad rows.  nee_term rewrites the lanes NEE lights.
__device__ __forceinline__ void close_lanes(const NeeArgs& a, int first) {
  const size_t rows_stride = (size_t)a.terms * a.n_pad;
  const float pad[7] = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f};
  using Mask = Vec<unsigned char, kLanePer>::type;
  using Cap = Vec<float, kLanePer>::type;
  const Mask m{};
  Cap c;
  for (int k = 0; k < kLanePer; ++k) reinterpret_cast<float*>(&c)[k] = -kBig;
  for (int t = 0; t < a.terms; ++t) {
    const size_t j = (size_t)t * a.n_pad + first;
    *reinterpret_cast<Mask*>(a.mask + j) = m;
    if (a.rows == nullptr) continue;
    *reinterpret_cast<Cap*>(a.rows + 7 * rows_stride + j) = c;
    for (int k = max(a.n - first, 0); k < kLanePer; ++k) {
      for (int r = 0; r < 7; ++r) a.rows[r * rows_stride + j + k] = pad[r];
    }
  }
}

// NEE term t of diffuse lane i (p the shadow rays' origin):
// integrator._nee_samples' term (the mesh light; each sphere light up to
// kUnrollMax, else one sampled per lane), its shadow ray's sphere test and,
// where no sphere occludes it, its mask, contribution and the any-hit
// sweep's rows (the window's end as the t cap) over what close_lanes wrote
template <bool kStaged>
__device__ __forceinline__ void nee_term(const NeeArgs& a, int t, int i, V3 p, V3 nrm, V3 thr_alb,
                                         uint32_t seed, int bounce) {
  const float* tb = nee_table<kStaged>(a);
  const Lights L = nee_lights<kStaged>(a);
  Term tm;
  if (t == 0 && a.n_tri > 0) {
    tm = mesh_term(tb, a.mat_off, L, p, nrm, thr_alb, seed, bounce);
  } else if (a.n_lights > kUnrollMax) {
    float u = uniform(seed, bounce_counter(bounce, 4));
    int li = min((int)(u * (float)a.n_lights), a.n_lights - 1);
    tm = sphere_term(L, li, true, p, nrm, thr_alb, seed, bounce);
  } else {
    tm = sphere_term(L, t - (a.n_tri > 0 ? 1 : 0), false, p, nrm, thr_alb, seed, bounce);
  }
  if (!tm.active || sphere_occluded(tb, a.n_sph, p, tm.dir, tm.t_limit, tm.light)) return;
  a.mask[(size_t)t * a.n_pad + i] = 1;
  a.contrib[((size_t)t * 3 + 0) * a.n + i] = tm.contrib.x;
  a.contrib[((size_t)t * 3 + 1) * a.n + i] = tm.contrib.y;
  a.contrib[((size_t)t * 3 + 2) * a.n + i] = tm.contrib.z;
  if (a.rows != nullptr) {
    const size_t rows_stride = (size_t)a.terms * a.n_pad;
    const float vals[8] = {p.x, p.y, p.z, tm.dir.x, tm.dir.y, tm.dir.z, 1e-4f, tm.t_limit};
    for (int r = 0; r < 8; ++r) a.rows[r * rows_stride + (size_t)t * a.n_pad + i] = vals[r];
  }
}

// Live lane i: the hit record, background, the first hit's normal and
// depth, shading, the MIS-weighted emission, the lane state written back
// and alive_next, as the body runs them; then, on a diffuse hit, each NEE
// term (nee_term)
template <bool kStaged>
__device__ __forceinline__ void nee_lane(const NeeArgs& a, int i) {
  const float* tb = nee_table<kStaged>(a);
  float* F = a.F;
  int* I = a.I;
  const int n = a.n;
#define FR(row) F[(size_t)(row) * n + i]
#define IR(row) I[(size_t)(row) * n + i]
  const uint32_t seed = (uint32_t)IR(I_SEED);
  const int bounce = IR(I_BOUNCE);
  const V3 ro = v3(FR(F_ROX), FR(F_ROY), FR(F_ROZ));
  const V3 rd = v3(FR(F_RDX), FR(F_RDY), FR(F_RDZ));
  const V3 col = v3(FR(F_COLX), FR(F_COLY), FR(F_COLZ));
  V3 rad = v3(FR(F_RADX), FR(F_RADY), FR(F_RADZ));
  const HitRec h = hit_record(a.rec, tb, a.obj_off, n, i, ro, rd);

  if (!h.mask) rad = rad + col * background(tb + a.bg_off, rd);
  if (bounce == 0 && h.mask) {
    FR(F_NX) = h.normal.x;
    FR(F_NY) = h.normal.y;
    FR(F_NZ) = h.normal.z;
    FR(F_DEPTH) = h.t;
  }
  bool alive2 = false, diffuse = false;
  V3 albedo = v3(0.0f, 0.0f, 0.0f);
  if (h.mask) {
    const Scatter sc = shade(tb, a.mat_off, h, rd, FR(F_TMIN), seed, bounce);
    if (sc.is_emis) {
      // integrator._weighted_emission: 1 after a specular scatter, else the
      // balance heuristic pdf_w / (pdf_w + pdf_light)
      const float pb = FR(F_PDFW);
      const float w = IR(I_SPEC) != 0
          ? 1.0f
          : pb / clamp_min(pb + light_pdf_at_hit(nee_lights<kStaged>(a), h, ro, rd), 1e-20f);
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
#undef FR
#undef IR
  if (!diffuse) return;
  const V3 p = h.point + h.normal * 1e-4f;  // the scatter's offset
  const V3 thr_alb = col * albedo;
  for (int t = 0; t < a.terms; ++t) {
    nee_term<kStaged>(a, t, i, p, h.normal, thr_alb, seed, bounce);
  }
}

// The CTA's share of the trip: the table staged, then each warp on its
// own: chunk c of kWarpLanes lanes to warp c % (the grid's warps).  A
// thread reads its kLanePer alive flags in one load and closes its lanes'
// entries; the warp queues its live lanes in lane order and runs them one
// a thread (nee_lane).  No barrier after the staging, so the warps of an
// SM drift apart and one's loads overlap another's arithmetic; a dead or
// pad lane costs its alive flag and its share of the closing stores.
template <bool kStaged>
__device__ __forceinline__ void nee_cta(const NeeArgs& a) {
  if (kStaged) stage_table(a.tab, a.n_stage);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = gridDim.x * kGridWarps;
  const int chunks = a.n_pad / kWarpLanes;
  const int* alive = a.I + (size_t)I_ALIVE * a.n;
  unsigned short* queue = sm_queue(warp);
  for (int c = blockIdx.x * kGridWarps + warp; c < chunks; c += warps) {
    const int lane0 = c * kWarpLanes, first = lane0 + lane * kLanePer;
    int flags[kLanePer];
    load_lanes(alive, first, a.n, 0, flags);
    close_lanes(a, first);
    // the live lanes' queue in lane order: the thread's count, then its
    // exclusive sum over the warp
    int own = 0;
    for (int k = 0; k < kLanePer; ++k) own += flags[k] != 0 ? 1 : 0;
    int incl = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    const int n_live = __shfl_sync(kFull, incl, 31);
    int at = incl - own;
    for (int k = 0; k < kLanePer; ++k) {
      if (flags[k] != 0) queue[at++] = (unsigned short)(lane * kLanePer + k);
    }
    __syncwarp();
    for (int j = lane; j < n_live; j += 32) nee_lane<kStaged>(a, lane0 + queue[j]);
    __syncwarp();  // the queue is the next chunk's
  }
}

// Two CTAs an SM: ~90 registers and no spill (at three, 80 registers
// spill, which costs more than the third CTA gains)
template <bool kStaged>
__global__ void __launch_bounds__(kGridThreads, 2) trip_nee_kernel(const NeeArgs a) {
  nee_cta<kStaged>(a);
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

// A lane's path between trips: the F rows a trip reads and writes
struct Path {
  V3 ro, rd, rad, col, nrm;
  float t_min, depth;
};

// lane i's entry of F's row `row` (the four functions below take F, n, i)
#define FR(row) F[(size_t)(row) * n + i]

__device__ __forceinline__ Path load_path(const float* F, int n, int i) {
  Path p;
  p.ro = v3(FR(F_ROX), FR(F_ROY), FR(F_ROZ));
  p.rd = v3(FR(F_RDX), FR(F_RDY), FR(F_RDZ));
  p.t_min = FR(F_TMIN);
  p.rad = v3(FR(F_RADX), FR(F_RADY), FR(F_RADZ));
  p.col = v3(FR(F_COLX), FR(F_COLY), FR(F_COLZ));
  p.nrm = v3(FR(F_NX), FR(F_NY), FR(F_NZ));
  p.depth = FR(F_DEPTH);
  return p;
}

__device__ __forceinline__ void store_path(float* F, int n, int i, const Path& p) {
  FR(F_ROX) = p.ro.x;
  FR(F_ROY) = p.ro.y;
  FR(F_ROZ) = p.ro.z;
  FR(F_RDX) = p.rd.x;
  FR(F_RDY) = p.rd.y;
  FR(F_RDZ) = p.rd.z;
  FR(F_TMIN) = p.t_min;
  FR(F_RADX) = p.rad.x;
  FR(F_RADY) = p.rad.y;
  FR(F_RADZ) = p.rad.z;
  FR(F_COLX) = p.col.x;
  FR(F_COLY) = p.col.y;
  FR(F_COLZ) = p.col.z;
  FR(F_NX) = p.nrm.x;
  FR(F_NY) = p.nrm.y;
  FR(F_NZ) = p.nrm.z;
  FR(F_DEPTH) = p.depth;
}

// The chained loop's running averages of a lane's colour, normal and depth
struct Acc {
  V3 col, nrm;
  float depth;
};

__device__ __forceinline__ Acc load_acc(const float* F, int n, int i) {
  return Acc{v3(FR(F_ACX), FR(F_ACY), FR(F_ACZ)), v3(FR(F_ANX), FR(F_ANY), FR(F_ANZ)),
             FR(F_ADEPTH)};
}

__device__ __forceinline__ void store_acc(float* F, int n, int i, const Acc& acc) {
  FR(F_ACX) = acc.col.x;
  FR(F_ACY) = acc.col.y;
  FR(F_ACZ) = acc.col.z;
  FR(F_ANX) = acc.nrm.x;
  FR(F_ANY) = acc.nrm.y;
  FR(F_ANZ) = acc.nrm.z;
  FR(F_ADEPTH) = acc.depth;
}
#undef FR

// The no-emitter body of a live lane on its hit h (integrator._bounce_body
// without NEE, up to roulette): background on a miss, the first bounce's
// normal and depth, shading and emission.  Returns whether the path goes on
__device__ __forceinline__ bool body(const float* tab, int mat_off, int bg_off, const HitRec& h,
                                     uint32_t seed, int bounce, Path& p) {
  if (!h.mask) p.rad = p.rad + p.col * background(tab + bg_off, p.rd);
  if (bounce == 0 && h.mask) {
    p.nrm = h.normal;
    p.depth = h.t;
  }
  if (!h.mask) return false;
  const Scatter sc = shade(tab, mat_off, h, p.rd, p.t_min, seed, bounce);
  // the emission term without NEE (integrator._weighted_emission)
  p.rad = p.rad + p.col * sc.emitted;
  p.ro = sc.ro;
  p.rd = sc.rd;
  p.t_min = sc.t_min;
  p.col = p.col * sc.mult;
  return !sc.is_emis;
}

// materials.russian_roulette from bounce rr_start: whether a path that
// goes on survives (its throughput rescaled)
__device__ __forceinline__ bool roulette(uint32_t seed, int bounce, int rr_start, bool alive2,
                                         V3& col) {
  if (alive2 && bounce >= rr_start) {
    float u = uniform(seed, bounce_counter(bounce, 3));
    float p_s = clamp2(maximum(maximum(col.x, col.y), col.z), 0.05f, 0.95f);
    bool survive = u < p_s;
    float inv_p = 1.0f / p_s;
    if (survive) col = col * inv_p;
    alive2 = survive;
  }
  return alive2;
}

// integrator._chain_step's (n-1)/n fold of a finished sample (global
// sample index git: colour fin, normal nrm, depth) into acc
__device__ __forceinline__ void fold(int git, V3 fin, V3 nrm, float depth, Acc& acc) {
  float nf = (float)(git + 1);
  bool first = git == 0;
  float w = nf - 1.0f;
  acc.col = first ? fin : v3((acc.col.x * w + fin.x) / nf, (acc.col.y * w + fin.y) / nf,
                             (acc.col.z * w + fin.z) / nf);
  acc.nrm = first ? nrm : v3((acc.nrm.x * w + nrm.x) / nf, (acc.nrm.y * w + nrm.y) / nf,
                             (acc.nrm.z * w + nrm.z) / nf);
  acc.depth = first ? depth : (acc.depth * w + depth) / nf;
}

// The lane's next sample (integrator._fresh_state): a fresh primary ray
// for pixel pix at sample `iteration`; returns its seed
__device__ __forceinline__ uint32_t restart(const TailArgs& a, int pix, int iteration, Path& p) {
  const uint32_t seed = fresh_ray(a, pix, iteration, &p.ro, &p.rd);
  p.t_min = 1e-4f;  // camera.T_MIN_PRIMARY
  p.rad = v3(0.0f, 0.0f, 0.0f);
  p.col = v3(1.0f, 1.0f, 1.0f);
  p.nrm = -p.rd;
  p.depth = 1e6f;
  return seed;
}

template <bool kNee>
__global__ void __launch_bounds__(kThreads) trip_tail_kernel(const TailArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int n = a.n;
  bool left = false;  // still to trace after this trip: counted per warp
  if (i < n) {
    float* F = a.F;
    int* I = a.I;
#define IR(row) I[(size_t)(row) * n + i]
    const bool alive = IR(I_ALIVE) != 0;
    bool done = a.chained && IR(I_DONE) != 0;
    const int bounce = IR(I_BOUNCE);
    // a lane that is done and dead: the body and the fold change nothing
    // but its bounce counter
    const bool touched = alive || (a.chained && !done);
    Path p;
    if (touched) p = load_path(F, n, i);
    bool alive2 = false;
    if (alive) {
      const uint32_t seed = (uint32_t)IR(I_SEED);
      if (kNee) {
        // trip_nee left the body's state; NEE's sum joins the radiance
        p.rad = p.rad + nee_sum(a, i);
        alive2 = a.alive_next[i] != 0;
      } else {
        const HitRec h = hit_record(a.rec, a.tab, a.obj_off, n, i, p.ro, p.rd);
        alive2 = body(a.tab, a.mat_off, a.bg_off, h, seed, bounce, p);
      }
      alive2 = roulette(seed, bounce, a.rr_start, alive2, p.col);
    }

    const int b2 = bounce + 1;
    if (a.chained) {
      bool capped = alive2 && b2 >= a.max_bounces;
      bool ended = !done && (!alive2 || capped);
      bool need = false;
      if (ended) {  // fold the finished sample into the lane's averages
        int k = IR(I_K);
        Acc acc = load_acc(F, n, i);
        fold(a.it0 + k, capped ? p.rad + p.col : p.rad, p.nrm, p.depth, acc);
        store_acc(F, n, i, acc);
        k += 1;
        done = k >= a.spp;
        need = !done;
        IR(I_K) = k;
        IR(I_DONE) = done ? 1 : 0;
        if (need) {  // the lane's next sample: a fresh primary ray
          IR(I_SEED) = (int)restart(a, a.pix0 + i, a.it0 + k, p);
          if (kNee) {  // _fresh_state: no scatter yet, so the next hit takes full weight
            IR(I_SPEC) = 1;
            F[(size_t)F_PDFW * n + i] = 0.0f;
          }
        }
      }
      if (touched) {
        store_path(F, n, i, p);
        IR(I_ALIVE) = need || (alive2 && !ended);
        IR(I_SEGS) = IR(I_SEGS) + (alive ? 1 : 0);
      }
      IR(I_BOUNCE) = need ? 0 : b2;
      left = !done;
    } else {
      if (alive) {
        store_path(F, n, i, p);
        IR(I_ALIVE) = alive2;
        IR(I_SEGS) = IR(I_SEGS) + 1;
      }
      IR(I_BOUNCE) = b2;
      left = alive2;
    }
#undef IR
  }
  // every thread of the warp reaches the vote, out-of-range ones with 0
  const unsigned votes = __ballot_sync(0xffffffffu, left);
  if ((threadIdx.x & 31) == 0 && votes != 0u) atomicAdd(a.count, __popc(votes));
}

// --- trip_drain --------------------------------------------------------------

// The tail of a render of a scene without meshes or emitters in one
// launch, once its lanes still to trace fit in one resident wave of
// trip_drain_kernel.  The lanes are listed (trip_drain_compact_kernel: a
// warp's live lanes at their ranks behind one atomic), then each listed
// lane runs on one thread, its state in registers, trip after trip until it
// is done or the loop's trips are spent, and writes its state back once.
// A lane's trip is the issued trip's: trip_head's sphere pass, then
// trip_tail's hit record, body, roulette and, chained, fold and restart,
// the same functions in the same order, so the same bits.  A done lane's
// bounce counter (which nothing reads) stops at its last trip.  The scene
// table is staged in shared memory once a CTA where it fits.  What it
// replaces: the late trips of a large render (~7,900 of ~8,500 at
// 3840x2160, 200 spp), each two launches over every lane and a 4-byte read
// by the host for a few thousand live lanes.

struct DrainArgs {
  TailArgs t;  // the lane state, the scene table, the camera, the loop's settings
  int n_sph;
  int trips;  // the loop's trips left: no lane runs more
  int* ids;   // the listed lanes, at most cap
  int cap;
  int* len;     // the lanes the compaction found (those past cap are not listed)
  int n_stage;  // floats of tab staged in shared memory: the whole table, or none
};

// Lane i onto the list where `live`: the warp's live lanes at their ranks
// among them, behind one atomic
__device__ __forceinline__ void drain_list(const DrainArgs& d, int i, bool live) {
  const unsigned votes = __ballot_sync(kFull, live);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && votes != 0u) base = atomicAdd(d.len, __popc(votes));
  base = __shfl_sync(kFull, base, 0);
  const int at = base + __popc(votes & ((1u << lane) - 1u));
  if (live && at < d.cap) d.ids[at] = i;
}

// The lanes still to trace: not done (chained), else alive
__global__ void __launch_bounds__(kThreads) trip_drain_compact_kernel(const DrainArgs d) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int n = d.t.n;
  bool live = false;
  if (i < n) {
    live = d.t.chained ? d.t.I[(size_t)I_DONE * n + i] == 0 : d.t.I[(size_t)I_ALIVE * n + i] != 0;
  }
  drain_list(d, i, live);
}

// Lane i's remaining trips; its state written back once.  Returns whether
// it is left to trace (chained: not done when the trips are spent, which
// the bound rules out; per sample the trips end at the bounce cap)
template <bool kStaged>
__device__ __forceinline__ bool drain_lane(const DrainArgs& d, int i) {
  const TailArgs& a = d.t;
  const float* tab = kStaged ? sm_tab() : a.tab;
  float* F = a.F;
  int* I = a.I;
  const int n = a.n;
#define IR(row) I[(size_t)(row) * n + i]
  Path p = load_path(F, n, i);
  bool alive = IR(I_ALIVE) != 0;
  bool done = a.chained && IR(I_DONE) != 0;
  uint32_t seed = (uint32_t)IR(I_SEED);
  int bounce = IR(I_BOUNCE), k = IR(I_K), segs = IR(I_SEGS);
  Acc acc;
  if (a.chained) acc = load_acc(F, n, i);
  for (int trip = 0; trip < d.trips && (a.chained ? !done : alive); ++trip) {
    bool alive2 = false;
    if (alive) {
      float t;
      V3 point, normal;
      const int code = sphere_pass(tab, d.n_sph, p.ro, p.rd, p.t_min, t, point, normal);
      const HitRec h = sphere_hit(tab, a.obj_off, code, t, point, normal);
      alive2 = body(tab, a.mat_off, a.bg_off, h, seed, bounce, p);
      alive2 = roulette(seed, bounce, a.rr_start, alive2, p.col);
      segs += 1;
    }
    const int b2 = bounce + 1;
    if (a.chained) {
      const bool capped = alive2 && b2 >= a.max_bounces;
      const bool ended = !alive2 || capped;  // not done inside the loop
      bool need = false;
      if (ended) {
        fold(a.it0 + k, capped ? p.rad + p.col : p.rad, p.nrm, p.depth, acc);
        k += 1;
        done = k >= a.spp;
        need = !done;
        if (need) seed = restart(a, a.pix0 + i, a.it0 + k, p);
      }
      alive = need || (alive2 && !ended);
      bounce = need ? 0 : b2;
    } else {
      alive = alive2;
      bounce = b2;
    }
  }
  store_path(F, n, i, p);
  IR(I_ALIVE) = alive ? 1 : 0;
  IR(I_SEED) = (int)seed;
  IR(I_BOUNCE) = bounce;
  IR(I_SEGS) = segs;
  if (a.chained) {
    store_acc(F, n, i, acc);
    IR(I_K) = k;
    IR(I_DONE) = done ? 1 : 0;
  }
#undef IR
  return a.chained && !done;
}

// A CTA of listed lanes, one a thread (a CTA past the list leaves at
// once): the table staged, each lane drained, the lanes left added to
// count with one atomic a warp, and by CTA 0 the lanes the list could not
// hold, so that count reads 0 exactly when every lane was drained
template <bool kStaged>
__device__ __forceinline__ void drain_cta(const DrainArgs& d) {
  const int listed = min(*d.len, d.cap);
  if ((int)blockIdx.x * kThreads >= listed) return;
  if (kStaged) {
    stage_table(d.t.tab, d.n_stage);
    __syncthreads();
  }
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  const bool left = slot < listed && drain_lane<kStaged>(d, d.ids[slot]);
  const unsigned votes = __ballot_sync(kFull, left);
  if ((threadIdx.x & 31) == 0 && votes != 0u) atomicAdd(d.t.count, __popc(votes));
  if (slot == 0 && *d.len > d.cap) atomicAdd(d.t.count, *d.len - d.cap);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) trip_drain_kernel(const DrainArgs d) {
  drain_cta<kStaged>(d);
}

// Floats of a scene table of n_tab floats that trip_drain stages
int drain_stage(int n_tab) { return n_tab <= kStageMax ? n_tab : 0; }

// CTAs of trip_drain_kernel<kStaged> resident at once with smem bytes
template <bool kStaged>
cudaError_t drain_ctas(size_t smem, int* ctas) {
  static Resident resident;
  return resident_ctas(resident, trip_drain_kernel<kStaged>, kThreads, smem, ctas);
}

// One trip_head launch over `ctas` CTAs of kHeadLanes lanes (kStaged: with
// the sphere rows staged)
template <bool kStaged>
void launch_head(const HeadArgs& a, int ctas, cudaStream_t stream) {
  const auto kernel = trip_head_kernel<kStaged>;
  const size_t smem = grid_smem_bytes(a.n_stage);
  kernel<<<ctas, kThreads, smem, stream>>>(a);
}

// One trip_nee launch (kStaged: with the staged table): as many CTAs as
// the card holds at once, or one for each kGridWarps chunks where there are
// fewer chunks
template <bool kStaged>
cudaError_t launch_nee(const NeeArgs& a, size_t smem, cudaStream_t stream) {
  const auto kernel = trip_nee_kernel<kStaged>;
  static Resident resident;
  int ctas = 0;
  const cudaError_t err = resident_ctas(resident, kernel, kGridThreads, smem, &ctas);
  if (err != cudaSuccess) return err;
  const int need = (a.n_pad / kWarpLanes + kGridWarps - 1) / kGridWarps;
  kernel<<<ctas < need ? ctas : need, kGridThreads, smem, stream>>>(a);
  return cudaSuccess;
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
    // the sphere rows staged where a ray tests two or more (one row is read
    // once a lane, from the L1 cache, either way: staging it costs a
    // barrier and gains nothing)
    const int sph = n_sph * kSphereRow;
    const int n_stage = n_sph > 1 && sph <= kStageMax ? sph : 0;
    const HeadArgs a{F, I, n, n_pad, tab, n_sph, hrec, hint, rows, act, n_stage};
    const int ctas = (lanes + kHeadLanes - 1) / kHeadLanes;
    if (n_stage > 0) {
      launch_head<true>(a, ctas, stream);
    } else {
      launch_head<false>(a, ctas, stream);
    }
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
  if (n_pad <= 0) return (int)cudaGetLastError();
  const int head = tri_rows_off(nee_off, n_lights, n_tri);
  const int n_stage = head <= kStageMax ? head : 0;
  const int terms = nee_terms(n_lights, n_tri);
  NeeArgs a{F,       I,       n,       n_pad,    {hrec, hint, s_t, s_slot, s_nx, s_ny, s_nz, s_obj},
            tab,     n_sph,   mat_off, obj_off,  bg_off,     nee_off,  n_lights,  n_tri,
            alive_next, contrib, mask, rows, terms, n_stage};
  const size_t smem = grid_smem_bytes(n_stage);
  const cudaError_t err = n_stage > 0 ? launch_nee<true>(a, smem, stream)
                                      : launch_nee<false>(a, smem, stream);
  if (err != cudaSuccess) return (int)err;
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

// The lanes one resident wave of trip_drain holds on the current device,
// for a scene table of n_tab floats: its CTAs resident at once times their
// threads.
int tpupt_trip_drain_wave(int n_tab, int* lanes) {
  const int n_stage = drain_stage(n_tab);
  const size_t smem = grid_smem_bytes(n_stage);
  int ctas = 0;
  const cudaError_t err = n_stage > 0 ? drain_ctas<true>(smem, &ctas)
                                      : drain_ctas<false>(smem, &ctas);
  if (err != cudaSuccess) return (int)err;
  *lanes = ctas * kThreads;
  return (int)cudaSuccess;
}

// trip_drain over n lanes of a scene without meshes or emitters: lists
// the lanes still to trace in ids (cap entries; *len the lanes found),
// runs each to its end within `trips` trips, and zeroes *count, then adds
// the lanes left to trace and those the list could not hold.
int tpupt_trip_drain(float* F, int* I, int n, const float* tab, int n_tab, int n_sph, int mat_off,
                     int obj_off, int bg_off, const float* cam, int pix0, int width, int height,
                     int it0, int spp, int max_bounces, int rr_start, int chained, int trips,
                     int* ids, int cap, int* len, int* count, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(len, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || cap <= 0) return (int)cudaGetLastError();
  const int n_stage = drain_stage(n_tab);
  const TailArgs t{F,       I,        n,       {},         tab,     mat_off, obj_off,
                   bg_off,  cam,      pix0,    width,      height,  it0,     spp,
                   max_bounces, rr_start, chained, 0,     0,       0,       nullptr,
                   nullptr, nullptr,  nullptr, count};
  const DrainArgs d{t, n_sph, trips, ids, cap, len, n_stage};
  const int blocks = (n + kThreads - 1) / kThreads;
  trip_drain_compact_kernel<<<blocks, kThreads, 0, stream>>>(d);
  const int ctas = (cap + kThreads - 1) / kThreads;
  const size_t smem = grid_smem_bytes(n_stage);
  if (n_stage > 0) {
    trip_drain_kernel<true><<<ctas, kThreads, smem, stream>>>(d);
  } else {
    trip_drain_kernel<false><<<ctas, kThreads, smem, stream>>>(d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
