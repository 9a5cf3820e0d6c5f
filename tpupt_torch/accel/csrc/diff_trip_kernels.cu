// The differentiable trip of the path tracer, forward and backward, as
// hand-written CUDA kernels for Hopper (sm_90a), with a plain C interface
// bound by ctypes (tpupt_torch/render/diff_trip.py and
// tpupt_torch/accel/slot_scatter.py, which also hold their torch twins).
//
// What they replace.  In the JAX package a differentiable sample is XLA
// code, not Pallas: `trace_sample(differentiable=True)`
// (tpupt/render/integrator.py:804) scans `_bounce_body` (:499) over the
// bounces with `refine_hit` (tpupt/render/intersect.py:450), which reads the
// winner triangle's rows through the `_fetch_tri_rows` custom VJP
// (:415-447); XLA fuses the scan and its transpose into a few device kernels
// and keeps each bounce's inputs as the scan's residuals.  The port's body
// route runs each of those operations as its own eager torch kernel and
// its autograd node (~55,000 kernels a 1024^2, 4 spp, 8-bounce step).  Here
// a bounce of a scene without emitters is
//
//   trip_head (trip_kernels.cu): the sphere pass and the sweep's rows;
//   treelet_closest_hit(payload=True) (treelet_kernels.cu), with a mesh;
//   diff_trip_fwd  refine_hit's closed form (the sphere branch through the
//                  object's matrices, the triangle branch on the payload's
//                  p0, e1, e2) on each live lane, then the body
//                  without emitters (background on a miss, the first
//                  bounce's normal and depth, all four BSDF lobes,
//                  emission, roulette), the lane state updated in place;
//                  it keeps the bounce's residuals (the ray, t_min and
//                  throughput it found, its hit's object and slot: 48 bytes
//                  a lane that hits, 32 one that misses, which keeps only
//                  its direction and throughput) and counts the lanes left
//                  with one atomic a warp (a persistent grid: see below);
//
// and the backward pass, one bounce at a time in reverse:
//
//   diff_trip_bwd  the bounce recomputed from its residuals by the forward's
//                  own code (so every discrete choice, the winner's branch,
//                  front, the lobe, roulette, comes out as it did), then its
//                  vector-Jacobian product by hand: the cotangent of the
//                  bounce's outputs (ray, radiance, throughput, normal,
//                  depth) in, that of its inputs out, in place; the leaf
//                  cotangents (each sphere's centre and radius, each
//                  material's albedo, fuzz, index and emission, the
//                  background) summed in double into a table in the layout
//                  of the trip kernels' scene table; and (K6:
//                  `_fetch_tri_rows`'s backward, intersect.py:436) the
//                  winner triangle's cotangent added into the slot table's
//                  gradient;
//   slot_scatter   the same scatter as a kernel of its own: an (N, 9)
//                  cotangent added into the (K*L, 9) slot table's gradient
//                  at each lane's slot (-1: nothing), for the body route's
//                  `_FetchTriRows` (lit differentiable renders and any
//                  intersector passed in); a slot past the table fails the
//                  launch, as index_add_'s does.
//
// The backward reproduces autograd's conventions, not the calculus:
// torch.clamp passes the gradient at equality and not past it,
// torch.maximum splits a tie in halves, torch.where gives the unselected
// branch an exact zero (so a lane only takes its branch's derivatives),
// torch.sign has none, and the floored determinant of the triangle
// branch none where it was floored.
//
// What bounds them on this card: bytes.  A lane moves only what its case
// needs: diff_trip_fwd ~100 bytes a lane that misses (its direction,
// radiance and throughput read, the radiance written, the residuals the
// backward reads) and ~180 a lane that hits (the state read and written,
// the residuals), plus the sweep's winner and payload on a triangle and
// the normal and depth on bounce 0; diff_trip_bwd ~90 a miss lane and ~140
// a hit lane, plus the winner's table row and its slot row's gradient on a
// triangle and the normal's and depth's cotangents on bounce 0.  That is
// for a few hundred float operations a lane (~800 a hit backward), well
// under the 67 TFLOP/s FP32 rate's ~20 operations a byte.
//
// Both kernels are shaped by what held a thread-a-lane design back: a
// bounce's live lanes thin out (5% of them on bunny's bounce 2, a few
// hundred of a million on the last), the three cases (miss, sphere,
// triangle) lie interleaved in pixel order, so a warp ran every branch one
// after another, a sphere hit found its table row by a linear search, a
// backward hit lane keeps ~125 registers live (two 256-thread CTAs an SM),
// and the leaf sums meet in a few dozen words.  So, in the backward:
//   - a persistent grid, as many CTAs as the card holds at once, takes
//     chunks of 2,048 lanes from a work counter in device memory, which the
//     launch's last take sets back to 0 (no host read, and no memset: one
//     device operation a bounce);
//   - a CTA reads a chunk's codes 16 bytes a load and queues its live
//     lanes in shared memory by case, in lane order; its warps then take
//     the queues 32 lanes of one case at a time, so a warp runs one branch
//     on full warps, and a dead lane costs its 4-byte code: the work
//     follows the live lanes, not N;
//   - every load a lane's case needs is issued before any is used, so that
//     a warp waits on memory once (the triangle row, which needs the slot,
//     twice: the slot is asked for first);
//   - the leaf sums go through the warp (per key, its entries' shuffle
//     trees side by side), then the CTA's table in shared memory, kept over
//     all its chunks and added into the global table once: ~(CTAs) double
//     atomics a word a bounce, not one a 256-lane block;
//   - on the triangle queue the winner's 9 cotangents go straight into the
//     slot table's gradient: the queue is in lane order, so neighbouring
//     pixels on one triangle are neighbouring lanes of the warp, whose runs
//     of one slot sum their rows by a segmented shuffle tree (the same steps
//     in every lane) before one lane of each run makes the row's 9 atomics:
//     no (9, N) buffer between two kernels, and no second launch; a slot
//     past the table fails the launch, as it does in slot_scatter.
// The forward (diff_trip_fwd) is lighter a lane, and there the backward's
// design lost (PERF.md §6): a persistent grid over chunks taken by
// grid index ran as long as its most loaded warp on a bounce of uneven
// chunks, a work counter's one atomic a chunk bound a sparse bounce, and
// the queues by case saved less divergence than their bookkeeping and
// registers cost.  So: a grid over every lane in CTAs of 512
// lanes (the hardware hands them out as SMs free up); a thread reads its
// two lanes' flags in one 8-byte load (their hints, slots and objects only
// where one of them is alive) and writes both lanes' code and slot
// residuals 8 bytes a row, so a dead lane costs 12 bytes, and a CTA with no
// live lane is done after one barrier; otherwise each thread runs its lanes
// in place (lanes t and t + 256 of the CTA, a warp's lanes neighbours),
// every load a lane needs issued before any is used (the payload's nine
// rows on a triangle only); the lanes left are summed a warp, one atomic a
// warp.  The scene table is read from device memory (staging it, with an
// object-to-row map in place of sphere_row's search, timed equal on the
// BASELINE step: PERF.md §6).
// slot_scatter, bound by its 4-byte slot a lane and a triangle lane's row:
// a persistent grid, a thread's four slots read in one 16-byte load and
// passed round the warp so that each round holds 32 neighbouring lanes, a
// warp without a row in a round leaving at once, only a lane with a row
// reading it, and the same segmented sums over runs of one slot.
//
// Numerics: as in trip_kernels.cu (trip_common.cuh): every forward
// operation runs in the torch body's order, rounded once, so the forward is
// bit-equal to the body route.  The backward's per-lane arithmetic runs in
// another order than autograd's; its leaf sums over a million lanes run in
// double, so the order of their atomics, which is not fixed, costs no
// float32 bits.  The slot table's gradient is summed by float32 atomics in
// no fixed order (a row takes the lanes of a few hundred pixels at most).

#include <cassert>

#include "trip_common.cuh"

namespace {

// a bounce's float residuals (diff_trip.RES_F_KEYS): the lane's ray, t_min
// and throughput as the bounce found them
enum { R_ROX, R_ROY, R_ROZ, R_RDX, R_RDY, R_RDZ, R_TMIN, R_COLX, R_COLY, R_COLZ };
// its int residuals (diff_trip.RES_I_KEYS): the hit's code and the sweep's
// slot (-1 without a triangle)
enum { R_CODE, R_SLOT };
// a code: object * 2 + 1 on a triangle, object * 2 on a sphere, or
constexpr int kMiss = -1;  // alive, nothing hit
constexpr int kDead = -2;  // not alive at the bounce
// the cotangent rows (diff_trip.G_KEYS)
enum {
  G_ROX, G_ROY, G_ROZ, G_RDX, G_RDY, G_RDZ, G_RADX, G_RADY, G_RADZ,
  G_COLX, G_COLY, G_COLZ, G_NX, G_NY, G_NZ, G_DEPTH,
};
// leaf cotangents a lane adds: a sphere's centre and radius; a material's
// albedo, fuzz, ior and emission; the background's bg_down and bg_up
constexpr int kSphLeaf = 4, kMatLeaf = 8, kBgLeaf = 6;

// The row of sphere object `obj` in the scene table
__device__ __forceinline__ int sphere_row(const float* tab, int n_sph, int obj) {
  for (int k = 0; k < n_sph; ++k) {
    if ((int)tab[k * kSphereRow + 28] == obj) return k;
  }
  return 0;  // not reached: the sphere pass names only rows of this table
}

// intersect.refine_hit on one lane, and what its backward reads again
struct Refine {
  bool tri, front;
  float t;
  V3 P, N;
  // the triangle branch
  V3 p0, e1, e2, h, w, q, cr;
  float f, num;
  bool floored;
  // the sphere branch: its table row
  int row;
  V3 oo, odr, od, oc, pobj, rel;
  float a, b, cc, a4, disc, sq, den, t1, t2, t_obj, l2, rr;
  bool use1;
};

// the triangle branch on the winner's world p0, e1, e2
__device__ __forceinline__ void refine_triangle(V3 ro, V3 rd, V3 p0, V3 e1, V3 e2, Refine& r) {
  r.tri = true;
  r.p0 = p0;
  r.e1 = e1;
  r.e2 = e2;
  r.h = cross(rd, e2);
  const float det = dot(e1, r.h);
  r.floored = fabsf(det) < 1e-12f;
  r.f = 1.0f / (r.floored ? 1e-12f : det);  // torch: reciprocal(where(...)) * 1.0
  r.w = ro - p0;
  r.q = cross(r.w, e1);
  r.num = dot(e2, r.q);
  r.t = r.f * r.num;
  r.P = ro + rd * r.t;
  r.cr = cross(e1, e2);
  const V3 outward = normalize(r.cr);
  r.front = dot(rd, outward) < 0.0f;
  r.N = sel(r.front, outward, -outward);
}

// the sphere branch on sphere row `row`: the object-space quadratic with
// its discriminant floored at 1e-12, t1 where it lies past t_min, the world
// point and t, the normal through the inverse transpose
__device__ __forceinline__ void refine_sphere(const float* tab, int row, V3 ro, V3 rd, float t_min,
                                              Refine& r) {
  const float* s = tab + row * kSphereRow;
  const float* inv = s;
  const float* m = s + 12;
  const V3 c = v3(s[24], s[25], s[26]);
  const float rad = s[27];
  r.tri = false;
  r.row = row;
  r.oo = xform_point(inv, ro);
  r.odr = xform_vector(inv, rd);
  r.od = normalize(r.odr);
  r.oc = r.oo - c;
  r.a = dot(r.od, r.od);
  r.b = 2.0f * dot(r.od, r.oc);
  r.cc = dot(r.oc, r.oc) - rad * rad;
  r.a4 = 4.0f * r.a;
  r.disc = r.b * r.b - r.a4 * r.cc;
  r.sq = sqrtf(clamp_min(r.disc, 1e-12f));
  r.den = 2.0f * r.a;
  r.t1 = (-r.b - r.sq) / r.den;
  r.t2 = (-r.b + r.sq) / r.den;
  r.use1 = r.t1 >= t_min;
  r.t_obj = r.use1 ? r.t1 : r.t2;
  r.pobj = r.oo + r.od * r.t_obj;
  r.P = xform_point(m, r.pobj);
  r.rel = r.P - ro;
  r.l2 = dot(r.rel, r.rel);
  r.t = sqrtf(clamp_min(r.l2, 1e-30f));
  r.rr = 1.0f / rad;
  const V3 outward = (r.pobj - c) * r.rr;
  r.front = dot(r.od, outward) < 0.0f;
  r.N = xform_normal(inv, sel(r.front, outward, -outward));
}

struct Scene {
  const float* tab;
  int n_sph, mat_off, obj_off, bg_off;
};

// One live lane's bounce on its hit (code >= 0): the refined hit, shading,
// the throughput and, from rr_start on, roulette
struct Bounce {
  Refine r;
  Scatter sc;
  int mat;
  V3 c;  // the throughput after shading, before roulette
  bool alive2, rr_on, survive;
  float m1, p_raw, inv_p;
};

// (row: the sphere's table row, read on a sphere hit only)
__device__ __forceinline__ void bounce_forward(const Scene& sc, int bounce, int rr_start, V3 ro,
                                               V3 rd, float t_min, V3 col, uint32_t seed, int code,
                                               int row, V3 p0, V3 e1, V3 e2, Bounce& B) {
  const int obj = code >> 1;
  if (code & 1) {
    refine_triangle(ro, rd, p0, e1, e2, B.r);
  } else {
    refine_sphere(sc.tab, row, ro, rd, t_min, B.r);
  }
  HitRec h;
  h.mask = true;
  h.kind = B.r.tri ? kPrimTriangle : kPrimSphere;
  h.obj = obj;
  h.mat = B.mat = (int)sc.tab[sc.obj_off + obj];
  h.front = B.r.front;
  h.t = B.r.t;
  h.point = B.r.P;
  h.normal = B.r.N;
  B.sc = shade(sc.tab, sc.mat_off, h, rd, t_min, seed, bounce);
  B.c = col * B.sc.mult;
  B.alive2 = !B.sc.is_emis;
  B.rr_on = B.alive2 && bounce >= rr_start;
  B.survive = true;
  if (B.rr_on) {  // materials.russian_roulette
    const float u = uniform(seed, bounce_counter(bounce, 3));
    B.m1 = maximum(B.c.x, B.c.y);
    B.p_raw = maximum(B.m1, B.c.z);
    const float p = clamp2(B.p_raw, 0.05f, 0.95f);
    B.survive = u < p;
    B.inv_p = 1.0f / p;
  }
}

// --- diff_trip_fwd -----------------------------------------------------------

struct FwdArgs {
  float* F;
  int* I;
  int n;
  const int* hint;  // trip_head's: sphere object * 2 + front, -1 for none
  // the payload sweep's slot, object and p0x..e2z over the packed lanes;
  // null without a mesh
  const int* s_slot;
  const float* s_obj;
  const float* pay[9];
  Scene scene;
  int bounce, rr_start;
  float* res_f;  // (10, n), null: keep no residuals
  int* res_i;  // (2, n)
  int* count;
};

// A grid over every lane in CTAs of kFwdLanes lanes, kFwdPer a thread,
// whose flags, hints and slots it reads in one load a row
constexpr int kFwdThreads = kThreads;
constexpr int kFwdPer = 2;
constexpr int kFwdLanes = kFwdThreads * kFwdPer;

// The alive flags of lanes first .. first + kFwdPer - 1 (0 past n)
__device__ __forceinline__ void fwd_flags(const FwdArgs& a, int first, int (&alive)[kFwdPer]) {
  load_lanes(a.I + (size_t)I_ALIVE * a.n, first, a.n, 0, alive);
}

// The codes of lanes first .. first + kFwdPer - 1 from their alive flags:
// kDead where a lane is not alive (or lies past n), else
// intersect_scene_ids_diff's winner (the sweep's object * 2 + 1 where a
// triangle won, else the sphere pass's object * 2, else kMiss); their code
// and slot residuals written, every lane's, in one store a row.  The hints
// and the sweep's slots and objects are read only where one of the lanes is
// alive.
__device__ __forceinline__ void fwd_codes(const FwdArgs& a, int first,
                                          const int (&alive)[kFwdPer], int (&code)[kFwdPer]) {
  const int n = a.n;
  int hint[kFwdPer], slot[kFwdPer];
  float obj[kFwdPer];
  bool any = false;
  for (int k = 0; k < kFwdPer; ++k) {
    any |= alive[k] != 0;
    hint[k] = slot[k] = -1;
    obj[k] = 0.0f;
  }
  if (any) {
    load_lanes(a.hint, first, n, -1, hint);
    if (a.s_slot != nullptr) {
      load_lanes(a.s_slot, first, n, -1, slot);
      load_lanes(a.s_obj, first, n, 0.0f, obj);
    }
  }
  for (int k = 0; k < kFwdPer; ++k) {
    const bool live = alive[k] != 0;
    code[k] = !live ? kDead
                    : (slot[k] >= 0 ? max((int)obj[k], 0) * 2 + 1
                                    : (hint[k] >= 0 ? (hint[k] >> 1) * 2 : kMiss));
    slot[k] = live ? slot[k] : -1;
  }
  if (a.res_i != nullptr) {
    store_lanes(a.res_i + (size_t)R_CODE * n, first, n, code);
    store_lanes(a.res_i + (size_t)R_SLOT * n, first, n, slot);
  }
}

#define FR(row) a.F[(size_t)(row) * a.n + i]
#define IR(row) a.I[(size_t)(row) * a.n + i]
#define RES(row) a.res_f[(size_t)(row) * a.n + i]

// A live lane that missed: the path leaves with the background; its ray and
// throughput stay as they are, and the backward reads only rd and col
// again.  Returns whether it is left to trace (never)
__device__ __forceinline__ bool fwd_miss(const FwdArgs& a, int i) {
  const V3 rd = v3(FR(F_RDX), FR(F_RDY), FR(F_RDZ));
  const V3 rad = v3(FR(F_RADX), FR(F_RADY), FR(F_RADZ));
  const V3 col = v3(FR(F_COLX), FR(F_COLY), FR(F_COLZ));
  const int segs = IR(I_SEGS);
  const V3 out = rad + col * background(a.scene.tab + a.scene.bg_off, rd);
  FR(F_RADX) = out.x;
  FR(F_RADY) = out.y;
  FR(F_RADZ) = out.z;
  if (a.res_f != nullptr) {
    RES(R_RDX) = rd.x;
    RES(R_RDY) = rd.y;
    RES(R_RDZ) = rd.z;
    RES(R_COLX) = col.x;
    RES(R_COLY) = col.y;
    RES(R_COLZ) = col.z;
  }
  IR(I_ALIVE) = 0;
  IR(I_SEGS) = segs + 1;
  return false;
}

// A live lane that hit (code): refine_hit, the body, roulette, the lane
// state and residuals written.  Every load the lane needs is issued before
// any is used (the payload's nine rows on a triangle only), so a warp waits
// on memory once.  Returns whether it is left to trace
__device__ __forceinline__ bool fwd_hit(const FwdArgs& a, int i, int code) {
  const Scene& sc = a.scene;
  const bool tri = code & 1;
  const V3 ro = v3(FR(F_ROX), FR(F_ROY), FR(F_ROZ));
  const V3 rd = v3(FR(F_RDX), FR(F_RDY), FR(F_RDZ));
  const float t_min = FR(F_TMIN);
  const V3 rad = v3(FR(F_RADX), FR(F_RADY), FR(F_RADZ));
  const V3 col = v3(FR(F_COLX), FR(F_COLY), FR(F_COLZ));
  const uint32_t seed = (uint32_t)IR(I_SEED);
  const int segs = IR(I_SEGS);
  V3 p0 = v3(0.0f, 0.0f, 0.0f), e1 = p0, e2 = p0;
  if (tri) {
    p0 = v3(a.pay[0][i], a.pay[1][i], a.pay[2][i]);
    e1 = v3(a.pay[3][i], a.pay[4][i], a.pay[5][i]);
    e2 = v3(a.pay[6][i], a.pay[7][i], a.pay[8][i]);
  }
  const int obj = code >> 1;
  const int row = tri ? 0 : sphere_row(sc.tab, sc.n_sph, obj);
  Bounce B;
  bounce_forward(sc, a.bounce, a.rr_start, ro, rd, t_min, col, seed, code, row, p0, e1, e2, B);
  // the emission term without emitters to sample
  const V3 out = rad + col * B.sc.emitted;
  if (a.bounce == 0) {
    FR(F_NX) = B.r.N.x;
    FR(F_NY) = B.r.N.y;
    FR(F_NZ) = B.r.N.z;
    FR(F_DEPTH) = B.r.t;
  }
  V3 c = B.c;
  bool left = B.alive2;
  if (B.rr_on) {
    if (B.survive) c = c * B.inv_p;
    left = B.survive;
  }
  if (a.res_f != nullptr) {
    const float vals[10] = {ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, t_min, col.x, col.y, col.z};
    for (int r = 0; r < 10; ++r) RES(r) = vals[r];
  }
  FR(F_ROX) = B.sc.ro.x;
  FR(F_ROY) = B.sc.ro.y;
  FR(F_ROZ) = B.sc.ro.z;
  FR(F_RDX) = B.sc.rd.x;
  FR(F_RDY) = B.sc.rd.y;
  FR(F_RDZ) = B.sc.rd.z;
  FR(F_TMIN) = B.sc.t_min;
  FR(F_RADX) = out.x;
  FR(F_RADY) = out.y;
  FR(F_RADZ) = out.z;
  FR(F_COLX) = c.x;
  FR(F_COLY) = c.y;
  FR(F_COLZ) = c.z;
  IR(I_ALIVE) = left ? 1 : 0;
  IR(I_SEGS) = segs + 1;
  return left;
}

#undef FR
#undef IR
#undef RES

// Lane i with its code: nothing on a dead lane, a miss, or a hit of either
// kind, one shade for both.  Returns whether it is left to trace
__device__ __forceinline__ bool fwd_any(const FwdArgs& a, int i, int code) {
  if (code == kDead) return false;
  if (code == kMiss) return fwd_miss(a, i);
  return fwd_hit(a, i, code);
}

// Thread t's share of the CTA's lanes: their flags, codes and code and
// slot residuals (fwd_codes), the codes kept in shared memory.  Returns
// whether one of its lanes is live
__device__ __forceinline__ bool fwd_scan(const FwdArgs& a, int base, int* codes) {
  const int first = base + threadIdx.x * kFwdPer;
  int flags[kFwdPer], code[kFwdPer];
  fwd_flags(a, first, flags);
  fwd_codes(a, first, flags, code);
  bool any = false;
  for (int k = 0; k < kFwdPer; ++k) {
    codes[threadIdx.x * kFwdPer + k] = code[k];
    any |= code[k] != kDead;
  }
  return any;
}

// Thread t's lanes in place: lanes t, t + kFwdThreads, ... of the CTA (a
// warp's lanes neighbours), each as its code says (fwd_any).  Returns how
// many it leaves to trace
__device__ __forceinline__ int fwd_run(const FwdArgs& a, int base, const int* codes) {
  int left = 0;
  for (int k = 0; k < kFwdPer; ++k) {
    const int off = threadIdx.x + kFwdThreads * k;
    if (base + off < a.n) left += fwd_any(a, base + off, codes[off]) ? 1 : 0;
  }
  return left;
}

// One CTA: its kFwdLanes lanes' flags read and their code and slot
// residuals written, one access a thread and row (fwd_scan); a CTA with no
// live lane is done after one barrier, so a dead lane costs 12 bytes.
// Otherwise the live lanes run in place (fwd_run); the lanes left are
// summed a warp, one atomic a warp.
__device__ __forceinline__ void fwd_cta(const FwdArgs& a, int* codes) {
  const int base = blockIdx.x * kFwdLanes;
  if (!__syncthreads_or(fwd_scan(a, base, codes))) return;
  int left = fwd_run(a, base, codes);
  for (int o = 16; o > 0; o >>= 1) left += __shfl_xor_sync(kFull, left, o);
  if ((threadIdx.x & 31) == 0 && left != 0) atomicAdd(a.count, left);
}

__global__ void __launch_bounds__(kFwdThreads) diff_trip_fwd_kernel(const FwdArgs a) {
  __shared__ int codes[kFwdLanes];
  fwd_cta(a, codes);
}

// --- diff_trip_bwd -----------------------------------------------------------

// Backward of Vec3.normalize, v * rsqrt(clamp(|v|^2, min=1e-12)), for the
// cotangent g of its result
__device__ __forceinline__ V3 normalize_bwd(V3 v, V3 g) {
  const float l2 = dot(v, v);
  const float inv = rsqrtf(clamp_min(l2, 1e-12f));
  // rsqrt's derivative -0.5 x^-1.5, through the clamp where it passes
  const float g_l2 = l2 >= 1e-12f ? -0.5f * dot(g, v) * (inv * inv * inv) : 0.0f;
  return g * inv + v * (2.0f * g_l2);
}

// Backward of vec.reflect, d - n * (2 (d . n)): adds into gd and gn
__device__ __forceinline__ void reflect_bwd(V3 d, V3 n, V3 g, V3& gd, V3& gn) {
  const float two_q = 2.0f * dot(d, n);
  const float g_q = 2.0f * -dot(g, n);
  gd = gd + g + n * g_q;
  gn = gn - g * two_q + d * g_q;
}

// Backward of vec.refract for a unit incident uv: adds into guv and gn,
// returns the cotangent of eta
__device__ __forceinline__ float refract_bwd(V3 uv, V3 n, float eta, V3 g, V3& guv, V3& gn) {
  const float dv = dot(-uv, n);
  const float ct = clamp_max(dv, 1.0f);
  const V3 w = uv + n * ct;
  const V3 perp = w * eta;
  const float k = 1.0f - dot(perp, perp);
  const float sq = sqrtf(clamp_min(k, 1e-12f));
  // perp + n * (-sq)
  gn = gn + g * (-sq);
  const float g_sq = -dot(g, n);
  const float g_k = k >= 1e-12f ? g_sq / (2.0f * sq) : 0.0f;
  const V3 g_perp = g + perp * (2.0f * -g_k);
  const V3 g_w = g_perp * eta;
  const float g_eta = dot(g_perp, w);
  const float g_ct = dot(g_w, n);
  const float g_dv = dv <= 1.0f ? g_ct : 0.0f;
  guv = guv + g_w - n * g_dv;
  gn = gn + g_w * ct + (-uv) * g_dv;
  return g_eta;
}

// torch.maximum(a, b)'s backward: a tie splits g in halves
__device__ __forceinline__ void maximum_bwd(float a, float b, float g, float& ga, float& gb) {
  if (a == b) {
    ga = gb = g * 0.5f;
  } else {
    ga = a < b ? 0.0f : g;
    gb = a > b ? 0.0f : g;
  }
}

struct BwdArgs {
  float* G;  // (16, n), the cotangent of the bounce's outputs in, its inputs' out
  int n;
  const float* res_f;
  const int* res_i;
  const int* seed;  // the lane state's seed row
  const float* tri;  // the slot table (K*L, 9), null without a mesh
  int tri_rows;  // its rows (0 without a mesh)
  Scene scene;
  int n_mat, bounce, rr_start;
  double* gtab;  // the leaf cotangents, in the scene table's layout
  float* g_slot;  // (K*L, 9) the slot table's gradient, null: not wanted
  int* work;  // the chunks taken so far: 0 at the launch, and set back to 0 by its last take
};

// The cases of a live lane, one queue each
enum { C_MISS, C_SPHERE, C_TRI, kCases };
// Lanes a CTA takes from the work counter at a time: kPer a thread, whose
// codes it reads 16 bytes a load
constexpr int kBwdThreads = kThreads;
constexpr int kChunk = 2048;
constexpr int kPer = kChunk / kBwdThreads;
constexpr int kWarps = kBwdThreads / 32;
static_assert(32 * kPer < 1024, "a warp's count of one case must fit its 10-bit field");
// the CTA's control words in shared memory, after its leaf table: the chunk
// taken, each warp's case counts, each warp's first queue place by case,
// the chunk's count by case
constexpr int kCtl = 1 + kWarps + kWarps * kCases + kCases;

// The block's leaf table in shared memory (a compact layout: kSphLeaf a
// sphere row, then kMatLeaf a material, then the background), zeroed
__device__ __forceinline__ void block_table_zero(double* sm, int n_ent) {
  for (int e = threadIdx.x; e < n_ent; e += kBwdThreads) sm[e] = 0.0;
  __syncthreads();
}

// Each lane's W cotangents of leaf row `key` (-1: none): the warp's lanes of
// one key sum theirs (32 floats: a few ulps), the W sums side by side, and
// one of them adds the sums into the block's table, in double, at base +
// key * W, where a sum is not zero; the loop runs once for each key the
// warp holds
template <int W>
__device__ __forceinline__ void warp_add_keyed(double* sm, int base, int key, const float (&v)[W]) {
  unsigned todo = __ballot_sync(kFull, key >= 0);
  while (todo != 0u) {
    const int leader = __ffs(todo) - 1;
    const int k = __shfl_sync(kFull, key, leader);
    const bool mine = key == k;
    float acc[W];
    for (int j = 0; j < W; ++j) acc[j] = mine ? v[j] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) {
      for (int j = 0; j < W; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
    }
    if ((int)(threadIdx.x & 31) == leader) {
      for (int j = 0; j < W; ++j) {
        if (acc[j] != 0.0f) atomicAdd(&sm[base + k * W + j], (double)acc[j]);
      }
    }
    todo &= ~__ballot_sync(kFull, mine);
  }
}

// entry e of the compact table at its place in the scene table's layout
__device__ __forceinline__ int leaf_index(const BwdArgs& a, int e) {
  const int sph = a.scene.n_sph * kSphLeaf, mat = a.n_mat * kMatLeaf;
  if (e < sph) return (e / kSphLeaf) * kSphereRow + 24 + e % kSphLeaf;
  if (e < sph + mat) return a.scene.mat_off + ((e - sph) / kMatLeaf) * kMatRow + 1 + (e - sph) % kMatLeaf;
  return a.scene.bg_off + (e - sph - mat);
}

// The block's sums into the global table: one atomic an entry that holds one
__device__ __forceinline__ void block_table_flush(double* sm, const BwdArgs& a, int n_ent) {
  __syncthreads();
  for (int e = threadIdx.x; e < n_ent; e += kBwdThreads) {
    const double v = sm[e];
    if (v != 0.0) atomicAdd(a.gtab + leaf_index(a, e), v);
  }
}

// Add each lane's row v into row s of g (s < 0: nothing).  A warp with no
// row leaves at once.  Otherwise the runs of equal s over the warp's lanes
// (the lanes come in lane order, and neighbouring pixels hit one triangle)
// sum their rows by a segmented tree of shuffles, the same steps in every
// lane, and each run's first lane makes the row's 9 atomics; a slot that
// comes back after another makes a run of its own
__device__ __forceinline__ void scatter_row(float* g, int s, const float (&v)[9]) {
  if (__ballot_sync(kFull, s >= 0) == 0u) return;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, s, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != s);
  const unsigned later = lane == 31 ? 0u : heads & (kFull << (lane + 1));
  const int last = later != 0u ? __ffs(later) - 2 : 31;  // the run's last lane
  float acc[9];
  for (int k = 0; k < 9; ++k) acc[k] = v[k];
  for (int o = 1; o < 32; o <<= 1) {
    for (int k = 0; k < 9; ++k) {
      const float t = __shfl_down_sync(kFull, acc[k], o);
      if (lane + o <= last) acc[k] += t;
    }
  }
  if (s >= 0 && ((heads >> lane) & 1u)) {
    for (int k = 0; k < 9; ++k) atomicAdd(&g[(size_t)s * 9 + k], acc[k]);
  }
}

#define GR(row) a.G[(size_t)(row) * a.n + i]
#define RF(row) a.res_f[(size_t)(row) * a.n + i]

// The backward of a lane that missed: radiance += col * background(rd),
// bg = down + t (up - down), t = 0.5 (normalize(rd).y + 1).  The
// background's cotangents go into bv; the radiance's cotangent, which the
// bounce leaves as it is, is read and not written
__device__ __forceinline__ void miss_lane(const BwdArgs& a, int i, float (&bv)[kBgLeaf]) {
  V3 grd = v3(GR(G_RDX), GR(G_RDY), GR(G_RDZ));
  const V3 grad = v3(GR(G_RADX), GR(G_RADY), GR(G_RADZ));
  V3 gcol = v3(GR(G_COLX), GR(G_COLY), GR(G_COLZ));
  const V3 rd = v3(RF(R_RDX), RF(R_RDY), RF(R_RDZ));
  const V3 col = v3(RF(R_COLX), RF(R_COLY), RF(R_COLZ));
  const float* bg = a.scene.tab + a.scene.bg_off;
  const float t = 0.5f * (normalize(rd).y + 1.0f);
  const V3 g_bg = grad * col;
  gcol = gcol + grad * background(bg, rd);
  float g_t = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float gk = k == 0 ? g_bg.x : (k == 1 ? g_bg.y : g_bg.z);
    bv[k] = gk - gk * t;
    bv[3 + k] = gk * t;
    g_t += gk * (bg[3 + k] - bg[k]);
  }
  grd = grd + normalize_bwd(rd, v3(0.0f, 0.5f * g_t, 0.0f));
  GR(G_RDX) = grd.x;
  GR(G_RDY) = grd.y;
  GR(G_RDZ) = grd.z;
  GR(G_COLX) = gcol.x;
  GR(G_COLY) = gcol.y;
  GR(G_COLZ) = gcol.z;
}

// The backward of a lane that hit a triangle (kTri) or a sphere: the bounce
// recomputed from its residuals by the forward's own code, then its VJP.
// The material's cotangents go into mv (row mkey); a sphere's into sv (row
// skey); the winner triangle's p0, e1, e2 into tv (slot table row slot)
template <bool kTri>
__device__ __forceinline__ void hit_lane(const BwdArgs& a, int i, int& mkey, float (&mv)[kMatLeaf],
                                         int& skey, float (&sv)[kSphLeaf], int& slot,
                                         float (&tv)[9]) {
  // the cotangents of what the bounce leaves as it is (the radiance's
  // always, the normal and depth after bounce 0) pass to its inputs
  // unchanged, so they are not written; every load the lane needs is
  // issued here, before any is used, so that a warp waits on memory once
  // (the triangle row, which needs its slot, twice)
  if (kTri) slot = a.res_i[(size_t)R_SLOT * a.n + i];  // first: the row's load waits on it
  const V3 grd = v3(GR(G_RDX), GR(G_RDY), GR(G_RDZ));
  const V3 grad = v3(GR(G_RADX), GR(G_RADY), GR(G_RADZ));
  const V3 gcol = v3(GR(G_COLX), GR(G_COLY), GR(G_COLZ));
  const V3 rd = v3(RF(R_RDX), RF(R_RDY), RF(R_RDZ));
  const V3 col = v3(RF(R_COLX), RF(R_COLY), RF(R_COLZ));
  const V3 gro = v3(GR(G_ROX), GR(G_ROY), GR(G_ROZ));
  const V3 ro = v3(RF(R_ROX), RF(R_ROY), RF(R_ROZ));
  const float t_min = RF(R_TMIN);
  const int code = a.res_i[(size_t)R_CODE * a.n + i];
  const uint32_t seed = (uint32_t)a.seed[i];
  V3 gn = v3(0.0f, 0.0f, 0.0f);
  float gdep = 0.0f;
  if (a.bounce == 0) {
    gn = v3(GR(G_NX), GR(G_NY), GR(G_NZ));
    gdep = GR(G_DEPTH);
  }
  V3 p0 = v3(0.0f, 0.0f, 0.0f), e1 = p0, e2 = p0;
  if (kTri) {
    // a slot past the table is a fault upstream (slot_scatter and
    // index_add_ assert on it too): the launch fails, and the next call on
    // the stream raises
    assert((unsigned)slot < (unsigned)a.tri_rows && "diff_trip_bwd: slot past the end of the table");
    const float* row = a.tri + (size_t)slot * 9;
    p0 = load3(row);
    e1 = load3(row + 3);
    e2 = load3(row + 6);
  }
  Bounce B;
  // the code with its case's bit set as the queue says, so the compiler
  // keeps only that case's refine branch
  bounce_forward(a.scene, a.bounce, a.rr_start, ro, rd, t_min, col, seed, kTri ? code | 1 : code & ~1,
                 kTri ? 0 : sphere_row(a.scene.tab, a.scene.n_sph, code >> 1), p0, e1, e2, B);
  const Scatter& sc = B.sc;
  const Refine& r = B.r;
  // roulette: a survivor's throughput c * (1 / p), p the clamped largest
  // channel of c
  V3 gc = gcol;
  if (B.rr_on && B.survive) {
    gc = gcol * B.inv_p;
    const float g_p = -dot(gcol, B.c) * (B.inv_p * B.inv_p);
    const float g_raw = (B.p_raw >= 0.05f && B.p_raw <= 0.95f) ? g_p : 0.0f;
    float g_m1, gx, gy, gz;
    maximum_bwd(B.m1, B.c.z, g_raw, g_m1, gz);
    maximum_bwd(B.c.x, B.c.y, g_m1, gx, gy);
    gc = gc + v3(gx, gy, gz);
  }
  // throughput out = col * mult, radiance += col * emitted
  const V3 gcol_in = gc * sc.mult + grad * sc.emitted;
  const V3 g_mult = gc * col;
  mkey = B.mat;
  if (sc.mtype == kDiffuse || (sc.mtype == kMetal && sc.metal_ok)) {
    mv[0] = g_mult.x;
    mv[1] = g_mult.y;
    mv[2] = g_mult.z;
  }
  if (sc.is_emis) {
    const V3 g_em = grad * col;
    mv[5] = g_em.x;
    mv[6] = g_em.y;
    mv[7] = g_em.z;
  }
  V3 gP = gro, gN = v3(0.0f, 0.0f, 0.0f), gro_in = gN, grd_in = gN;
  float gt = 0.0f;
  // the scatter's origin: the point, or point - n * k_off off a dielectric
  if (sc.mtype != kDielectric) gN = -(gro * sc.k_off);
  // its direction, by the material's lobe (an emitter's is the dielectric
  // lobe's, as materials.shade selects it)
  if (sc.mtype == kDiffuse) {
    gN = gN + (sc.degenerate ? grd : normalize_bwd(sc.d_sum, grd));
  } else if (sc.mtype == kMetal) {
    reflect_bwd(rd, r.N, grd, grd_in, gN);
    mv[3] = dot(grd, sc.s);
  } else {
    V3 g_unit = v3(0.0f, 0.0f, 0.0f);
    if (sc.reflect_diel) {
      reflect_bwd(sc.unit_d, r.N, grd, g_unit, gN);
    } else {
      const float g_eta = refract_bwd(sc.unit_d, r.N, sc.ratio, grd, g_unit, gN);
      // the ratio is 1 / ior entering, ior leaving
      mv[4] = r.front ? -g_eta * (sc.ratio * sc.ratio) : g_eta;
    }
    grd_in = grd_in + normalize_bwd(rd, g_unit);
  }
  if (a.bounce == 0) {  // the first hit's normal and depth, not its inputs'
    gN = gN + gn;
    gt = gdep;
  }
  if (kTri) {
    const V3 g_cr = normalize_bwd(r.cr, r.front ? gN : -gN);
    V3 ge1 = cross(r.e2, g_cr), ge2 = cross(g_cr, r.e1);
    // P = ro + rd t, t = f * (e2 . q), q = (ro - p0) x e1, f = 1 / det
    gro_in = gro_in + gP;
    grd_in = grd_in + gP * r.t;
    const float g_t = gt + dot(gP, rd);
    const float g_f = g_t * r.num, g_num = g_t * r.f;
    ge2 = ge2 + r.q * g_num;
    const V3 g_q = r.e2 * g_num;
    const V3 g_w = cross(r.e1, g_q);
    ge1 = ge1 + cross(g_q, r.w);
    gro_in = gro_in + g_w;
    // det = e1 . (rd x e2), floored at 1e-12 in magnitude
    const float g_det = r.floored ? 0.0f : -g_f * (r.f * r.f);
    ge1 = ge1 + r.h * g_det;
    const V3 g_h = r.e1 * g_det;
    grd_in = grd_in + cross(r.e2, g_h);
    ge2 = ge2 + cross(g_h, rd);
    const float vals[9] = {-g_w.x, -g_w.y, -g_w.z, ge1.x, ge1.y, ge1.z, ge2.x, ge2.y, ge2.z};
    for (int k = 0; k < 9; ++k) tv[k] = vals[k];
  } else {
    const float* s = a.scene.tab + r.row * kSphereRow;
    const float* inv = s;
    const float* m = s + 12;
    const V3 c = v3(s[24], s[25], s[26]);
    const float rad = s[27];
    // t = |P - ro|, clamped at 1e-30 under the root (the VJP's quotients
    // need no correct rounding: __fdividef, within 2 ulp)
    const float g_l2 = r.l2 >= 1e-30f ? __fdividef(gt, 2.0f * r.t) : 0.0f;
    const V3 g_rel = r.rel * (2.0f * g_l2);
    gP = gP + g_rel;
    gro_in = gro_in - g_rel;
    // N = inv^T (+-outward), outward = (pobj - c) / rad
    const V3 g_nsel = xform_vector(inv, gN);
    const V3 g_out = r.front ? g_nsel : -g_nsel;
    V3 g_pobj = g_out * r.rr;
    V3 g_c = -g_pobj;
    float g_r = -dot(g_out, r.pobj - c) * (r.rr * r.rr);
    // P = m pobj
    g_pobj = g_pobj + xform_normal(m, gP);
    // pobj = oo + od t_obj, t_obj = t1 or t2 = (-b -+ sq) / (2 a)
    V3 g_oo = g_pobj;
    V3 g_od = g_pobj * r.t_obj;
    const float g_tobj = dot(g_pobj, r.od);
    const float g_t1 = r.use1 ? g_tobj : 0.0f, g_t2 = r.use1 ? 0.0f : g_tobj;
    const float g_n1 = __fdividef(g_t1, r.den), g_n2 = __fdividef(g_t2, r.den);
    float g_a = 2.0f * (-g_t1 * __fdividef(r.t1, r.den) - g_t2 * __fdividef(r.t2, r.den));
    float g_b = -g_n1 - g_n2;
    const float g_sq = g_n2 - g_n1;
    // sq = sqrt(clamp(disc, 1e-12)), disc = b b - (4 a) cc
    const float g_disc = r.disc >= 1e-12f ? __fdividef(g_sq, 2.0f * r.sq) : 0.0f;
    g_b = g_b + 2.0f * r.b * g_disc;
    g_a = g_a + 4.0f * (-g_disc * r.cc);
    const float g_cc = -g_disc * r.a4;
    // cc = oc . oc - rad^2, b = 2 (od . oc), a = od . od
    V3 g_oc = r.oc * (2.0f * g_cc);
    g_r = g_r - 2.0f * rad * g_cc;
    const float g_dot = 2.0f * g_b;
    g_od = g_od + r.oc * g_dot + r.od * (2.0f * g_a);
    g_oc = g_oc + r.od * g_dot;
    // oc = oo - c, oo = inv ro, od = normalize(inv rd)
    g_oo = g_oo + g_oc;
    g_c = g_c - g_oc;
    gro_in = gro_in + xform_normal(inv, g_oo);
    grd_in = grd_in + xform_normal(inv, normalize_bwd(r.odr, g_od));
    skey = r.row;
    sv[0] = g_c.x;
    sv[1] = g_c.y;
    sv[2] = g_c.z;
    sv[3] = g_r;
  }
  // G is written only after the last read of the scene table, which it
  // could alias
  GR(G_ROX) = gro_in.x;
  GR(G_ROY) = gro_in.y;
  GR(G_ROZ) = gro_in.z;
  if (a.bounce == 0) {
    GR(G_NX) = 0.0f;
    GR(G_NY) = 0.0f;
    GR(G_NZ) = 0.0f;
    GR(G_DEPTH) = 0.0f;
  }
  GR(G_RDX) = grd_in.x;
  GR(G_RDY) = grd_in.y;
  GR(G_RDZ) = grd_in.z;
  GR(G_COLX) = gcol_in.x;
  GR(G_COLY) = gcol_in.y;
  GR(G_COLZ) = gcol_in.z;
}

#undef GR
#undef RF

// One warp's lanes of one case c (a lane with i < 0 holds none): each
// lane's backward, then the warp's leaf sums into the block's table and, on
// triangles, its winner rows into the slot table's gradient
__device__ __forceinline__ void case_warp(const BwdArgs& a, double* sm, int c, int i) {
  const int mat_base = a.scene.n_sph * kSphLeaf;
  if (c == C_MISS) {
    float bv[kBgLeaf] = {};
    if (i >= 0) miss_lane(a, i, bv);
    warp_add_keyed(sm, mat_base + a.n_mat * kMatLeaf, i >= 0 ? 0 : -1, bv);
    return;
  }
  int mkey = -1, skey = -1, slot = -1;
  float mv[kMatLeaf] = {}, sv[kSphLeaf] = {}, tv[9] = {};
  if (c == C_SPHERE) {
    if (i >= 0) hit_lane<false>(a, i, mkey, mv, skey, sv, slot, tv);
    warp_add_keyed(sm, 0, skey, sv);
  } else {
    if (i >= 0) hit_lane<true>(a, i, mkey, mv, skey, sv, slot, tv);
    if (a.g_slot != nullptr) scatter_row(a.g_slot, slot, tv);
  }
  warp_add_keyed(sm, mat_base, mkey, mv);
}

// Group g of a chunk's queues (n_miss, n_sph, n_tri lanes, the sphere
// queue's first group g_sph, the triangle queue's g_tri): its case c, and
// the queue place of its lane `lane` (-1: past its case's last)
__device__ __forceinline__ int group_place(int g, int lane, int n_miss, int n_sph, int n_tri,
                                           int g_sph, int g_tri, int& c) {
  int j, end;
  if (g < g_sph) {
    c = C_MISS, j = g * 32, end = n_miss;
  } else if (g < g_tri) {
    c = C_SPHERE, j = n_miss + (g - g_sph) * 32, end = n_miss + n_sph;
  } else {
    c = C_TRI, j = n_miss + n_sph + (g - g_tri) * 32, end = n_miss + n_sph + n_tri;
  }
  j += lane;
  return j < end ? j : -1;
}

// A code's case as a count in its 10-bit field (a dead lane: none)
__device__ __forceinline__ int case_count(int code) {
  return code == kDead ? 0 : (code == kMiss ? 1 : ((code & 1) ? 1 << 20 : 1 << 10));
}

// The next chunk from the work counter.  Each CTA takes until it is handed
// one past the last, so the launch's last take is its (chunks + CTAs)th: no
// CTA takes after it, and it sets the counter back to 0 for the next launch
// (no memset a launch)
__device__ __forceinline__ int take_chunk(int* work, int chunks) {
  const int t = atomicAdd(work, 1);
  if (t == chunks + (int)gridDim.x - 1) *work = 0;
  return t;
}

// The CTA's share of the bounce: chunks of kChunk lanes taken from the work
// counter until none is left.  A chunk's codes are read 16 bytes a load, and
// its live lanes queued in shared memory by case, in lane order (the three
// queues one after another); then each warp takes 32 queued lanes of one
// case at a time, so that a warp runs one branch.  A dead lane costs its
// code.  ctl holds kCtl words, queue kChunk lane offsets.
__device__ __forceinline__ void cta_lanes(const BwdArgs& a, double* sm, int* ctl,
                                          unsigned short* queue) {
  int* take = ctl;
  int* warp_tot = ctl + 1;
  int* warp_at = warp_tot + kWarps;  // [kWarps][kCases]
  int* cnt = warp_at + kWarps * kCases;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* codes = a.res_i + (size_t)R_CODE * a.n;
  const bool vec = ((uintptr_t)codes & 15u) == 0u;
  const int chunks = (int)(((long long)a.n + kChunk - 1) / kChunk);
  for (;;) {
    if (threadIdx.x == 0) *take = take_chunk(a.work, chunks);
    __syncthreads();
    if (*take >= chunks) break;  // the same for every thread
    const int lane0 = *take * kChunk, mine = lane0 + threadIdx.x * kPer;
    int code[kPer];
    if (vec && mine + kPer <= a.n) {
      for (int k = 0; k < kPer; k += 4) {
        const int4 v = *reinterpret_cast<const int4*>(codes + mine + k);
        code[k] = v.x;
        code[k + 1] = v.y;
        code[k + 2] = v.z;
        code[k + 3] = v.w;
      }
    } else {
      for (int k = 0; k < kPer; ++k) code[k] = mine + k < a.n ? codes[mine + k] : kDead;
    }
    // the thread's count by case, 10 bits a case (a warp holds at most 32 *
    // kPer of one), and its inclusive sum over the warp's threads
    int own = 0;
    for (int k = 0; k < kPer; ++k) own += case_count(code[k]);
    int incl = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (threadIdx.x < kCases) {  // each case's first place for each warp
      const int c = threadIdx.x;
      int run = 0;
      for (int w = 0; w < kWarps; ++w) {
        warp_at[w * kCases + c] = run;
        run += (warp_tot[w] >> (10 * c)) & 1023;
      }
      cnt[c] = run;
    }
    __syncthreads();
    // the thread's next place in each queue
    const int before = incl - own;
    int at_miss = warp_at[warp * kCases + C_MISS] + (before & 1023);
    int at_sph = cnt[C_MISS] + warp_at[warp * kCases + C_SPHERE] + ((before >> 10) & 1023);
    int at_tri = cnt[C_MISS] + cnt[C_SPHERE] + warp_at[warp * kCases + C_TRI] + (before >> 20);
    for (int k = 0; k < kPer; ++k) {
      const int code_k = code[k];
      if (code_k == kDead) continue;
      const int c = code_k == kMiss ? C_MISS : ((code_k & 1) ? C_TRI : C_SPHERE);
      queue[c == C_MISS ? at_miss : (c == C_TRI ? at_tri : at_sph)] =
          (unsigned short)(threadIdx.x * kPer + k);
      at_miss += c == C_MISS;
      at_sph += c == C_SPHERE;
      at_tri += c == C_TRI;
    }
    __syncthreads();
    // the queues in groups of 32 lanes of one case, group g to warp g % kWarps
    const int n_miss = cnt[C_MISS], n_sph = cnt[C_SPHERE], n_tri = cnt[C_TRI];
    const int g_sph = (n_miss + 31) >> 5, g_tri = g_sph + ((n_sph + 31) >> 5);
    const int g_end = g_tri + ((n_tri + 31) >> 5);
    for (int g = warp; g < g_end; g += kWarps) {
      int c;
      const int j = group_place(g, lane, n_miss, n_sph, n_tri, g_sph, g_tri, c);
      case_warp(a, sm, c, j >= 0 ? lane0 + queue[j] : -1);
    }
    __syncthreads();  // the queue and the control words are the next chunk's
  }
}

// A persistent grid: each CTA keeps its leaf table in shared memory over
// every chunk it takes and adds it into gtab once.  Two CTAs an SM (at most
// 128 registers a thread: a hit lane keeps ~125 live)
__global__ void __launch_bounds__(kBwdThreads, 2) diff_trip_bwd_kernel(const BwdArgs a) {
  extern __shared__ double sm[];
  const int n_ent = a.scene.n_sph * kSphLeaf + a.n_mat * kMatLeaf + kBgLeaf;
  int* ctl = reinterpret_cast<int*>(sm + n_ent);
  block_table_zero(sm, n_ent);
  cta_lanes(a, sm, ctl, reinterpret_cast<unsigned short*>(ctl + kCtl));
  block_table_flush(sm, a, n_ent);
}

// --- slot_scatter ------------------------------------------------------------

// The slots of a warp's 128 lanes from w0 on (-1 past n): read 16 bytes a
// thread (lanes w0 + 4 lane .. + 3) where the row is aligned and they lie in
// range, then passed round the warp so that round k holds lane w0 + 32 k +
// lane: a round's lanes are neighbours, whose runs of one slot scatter_row
// sums
__device__ __forceinline__ void round_slots(const int* slot, long long w0, int n, bool vec,
                                            int (&s)[4]) {
  const int lane = threadIdx.x & 31;
  const long long i4 = w0 + 4 * lane;
  int q[4];
  if (vec && i4 + 4 <= n) {
    const int4 v = *reinterpret_cast<const int4*>(slot + i4);
    q[0] = v.x;
    q[1] = v.y;
    q[2] = v.z;
    q[3] = v.w;
  } else {
    for (int e = 0; e < 4; ++e) q[e] = i4 + e < n ? slot[i4 + e] : -1;
  }
  for (int k = 0; k < 4; ++k) {
    const int src = 8 * k + (lane >> 2), e = lane & 3;
    const int e0 = __shfl_sync(kFull, q[0], src), e1 = __shfl_sync(kFull, q[1], src);
    const int e2 = __shfl_sync(kFull, q[2], src), e3 = __shfl_sync(kFull, q[3], src);
    s[k] = e == 0 ? e0 : (e == 1 ? e1 : (e == 2 ? e2 : e3));
  }
}

// A persistent grid strides over the lanes a warp's 128 at a time, so every
// lane of a warp runs the same iterations and scatter_row's votes see the
// whole warp
__global__ void __launch_bounds__(kThreads) slot_scatter_kernel(float* g, int rows, const int* slot,
                                                                const float* cot, int n,
                                                                int lane_stride, int comp_stride) {
  const bool vec = ((uintptr_t)slot & 15u) == 0u;
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kThreads * 4;
  for (long long w0 = ((long long)blockIdx.x * kThreads + (threadIdx.x & ~31u)) * 4; w0 < n;
       w0 += step) {
    int s[4];
    round_slots(slot, w0, n, vec, s);
    // only a lane with a row reads it; the four rounds' rows are all asked
    // for before the first is summed, so that a warp waits on memory once
    float v[4][9] = {};
    for (int k = 0; k < 4; ++k) {
      if (s[k] >= 0) {
        const long long i = w0 + 32 * k + lane;
        for (int j = 0; j < 9; ++j) v[k][j] = cot[(size_t)i * lane_stride + (size_t)j * comp_stride];
      }
    }
    for (int k = 0; k < 4; ++k) {
      // a slot past the table is a fault upstream (index_add_ asserts on it
      // too): the launch fails, and the next call on the stream raises
      assert(s[k] < rows && "slot_scatter: slot past the end of the table");
      scatter_row(g, s[k], v[k]);
    }
  }
}

}  // namespace

extern "C" {

// diff_trip_fwd over n lanes: the lane state (F, I) updated in place, the
// residuals into res_f/res_i (null: none kept), the lanes left into *count
// (zeroed first).  The sweep's slot, object and payload may be null (no
// mesh).
int tpupt_diff_trip_fwd(float* F, int* I, int n, const int* hint, const int* s_slot,
                        const float* s_obj, const float* p0x, const float* p0y, const float* p0z,
                        const float* e1x, const float* e1y, const float* e1z, const float* e2x,
                        const float* e2y, const float* e2z, const float* tab, int n_sph,
                        int mat_off, int obj_off, int bg_off, int bounce, int rr_start,
                        float* res_f, int* res_i, int* count, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  FwdArgs a{F,   I,       n,       hint,    s_slot, s_obj,
            {p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z},
            {tab, n_sph, mat_off, obj_off, bg_off},
            bounce, rr_start, res_f, res_i, count};
  // a CTA for each kFwdLanes lanes
  const int ctas = (int)(((long long)n + kFwdLanes - 1) / kFwdLanes);
  if (n > 0) diff_trip_fwd_kernel<<<ctas, kFwdThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Shared memory diff_trip_bwd's CTAs take for a scene: the leaf table in
// double, the control words and the queue of a chunk's lanes
size_t tpupt_diff_trip_bwd_smem_bytes(int n_sph, int n_mat) {
  return sizeof(double) * (size_t)(n_sph * kSphLeaf + n_mat * kMatLeaf + kBgLeaf) +
         sizeof(int) * kCtl + sizeof(unsigned short) * kChunk;
}

// diff_trip_bwd over n lanes: G updated in place, the leaf cotangents added
// into gtab (double, the scene table's layout), the winner triangles' into
// the slot table's gradient g_slot (null: not wanted).  tri, the slot table
// of tri_rows rows, may be null (no mesh).  work is one int of scratch, 0
// before the first launch on the stream, which each launch leaves at 0.
int tpupt_diff_trip_bwd(float* G, int n, const float* res_f, const int* res_i, const int* seed,
                        const float* tri, int tri_rows, const float* tab, int n_sph, int n_mat,
                        int mat_off, int obj_off, int bg_off, int bounce, int rr_start,
                        double* gtab, float* g_slot, int* work, cudaStream_t stream) {
  BwdArgs a{G, n, res_f, res_i, seed, tri, tri_rows, {tab, n_sph, mat_off, obj_off, bg_off},
            n_mat, bounce, rr_start, gtab, g_slot, work};
  const size_t smem = tpupt_diff_trip_bwd_smem_bytes(n_sph, n_mat);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(diff_trip_bwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    static Resident resident;
    int ctas = 0;
    const cudaError_t err = resident_ctas(resident, diff_trip_bwd_kernel, kBwdThreads, smem, &ctas);
    if (err != cudaSuccess) return (int)err;
    const int chunks = (int)(((long long)n + kChunk - 1) / kChunk);
    diff_trip_bwd_kernel<<<ctas < chunks ? ctas : chunks, kBwdThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// slot_scatter: g (rows, 9) += the rows of cot (lane i's component k at
// cot[i * lane_stride + k * comp_stride]) at slot[i], for slot[i] >= 0.
int tpupt_slot_scatter(float* g, int rows, const int* slot, const float* cot, int n,
                       int lane_stride, int comp_stride, cudaStream_t stream) {
  if (n > 0) {
    static Resident resident;
    int ctas = 0;
    cudaError_t err = resident_ctas(resident, slot_scatter_kernel, kThreads, 0, &ctas);
    if (err != cudaSuccess) return (int)err;
    const int groups = (int)(((long long)n + kThreads * 4 - 1) / (kThreads * 4));
    slot_scatter_kernel<<<ctas < groups ? ctas : groups, kThreads, 0, stream>>>(
        g, rows, slot, cot, n, lane_stride, comp_stride);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
