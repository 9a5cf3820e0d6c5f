// An experiment beside trip_drain (experiments/torch_trip_drain.py, phase
// "whole"): the drain fed from trip 0, without issued trips, by a
// persistent grid that takes the listed lanes from a counter.  Each
// iteration of a thread is one trip of its lane (drain_lane's loop body);
// a thread whose lane ends stores it and takes the next lane at once, so a
// warp's threads refill one by one and no lane waits for its warp's
// longest.  Built on its own with the library's flags:
//
//   nvcc -O3 -gencode=arch=compute_90a,code=sm_90a --fmad=false -std=c++17 \
//        -shared -Xcompiler -fPIC -Xptxas=-v experiments/trip_drain_all.cu -o <lib>.so
//
// It includes the library's source whole, so its functions are the
// library's, and exports tpupt_trip_drain_all with tpupt_trip_drain's
// interface.

#include "../tpupt_torch/accel/csrc/trip_kernels.cu"

namespace {

__device__ int g_next_slot;  // the list's next slot to take

// A lane's state in registers, as drain_lane holds it
struct Lane {
  Path p;
  Acc acc;
  uint32_t seed;
  int i, bounce, k, segs, trips;
  bool alive, done;
};

__device__ __forceinline__ void lane_load(const TailArgs& a, int i, Lane& L) {
  const int n = a.n;
  L.i = i;
  L.p = load_path(a.F, n, i);
  L.alive = a.I[(size_t)I_ALIVE * n + i] != 0;
  L.done = a.chained && a.I[(size_t)I_DONE * n + i] != 0;
  L.seed = (uint32_t)a.I[(size_t)I_SEED * n + i];
  L.bounce = a.I[(size_t)I_BOUNCE * n + i];
  L.k = a.I[(size_t)I_K * n + i];
  L.segs = a.I[(size_t)I_SEGS * n + i];
  L.trips = 0;
  if (a.chained) L.acc = load_acc(a.F, n, i);
}

__device__ __forceinline__ void lane_store(const TailArgs& a, const Lane& L) {
  const int n = a.n, i = L.i;
  store_path(a.F, n, i, L.p);
  a.I[(size_t)I_ALIVE * n + i] = L.alive ? 1 : 0;
  a.I[(size_t)I_SEED * n + i] = (int)L.seed;
  a.I[(size_t)I_BOUNCE * n + i] = L.bounce;
  a.I[(size_t)I_SEGS * n + i] = L.segs;
  if (a.chained) {
    store_acc(a.F, n, i, L.acc);
    a.I[(size_t)I_K * n + i] = L.k;
    a.I[(size_t)I_DONE * n + i] = L.done ? 1 : 0;
  }
}

// One trip of lane L: drain_lane's loop body
__device__ __forceinline__ void lane_trip(const TailArgs& a, const float* tab, int n_sph,
                                          Lane& L) {
  bool alive2 = false;
  if (L.alive) {
    float t;
    V3 point, normal;
    const int code = sphere_pass(tab, n_sph, L.p.ro, L.p.rd, L.p.t_min, t, point, normal);
    const HitRec h = sphere_hit(tab, a.obj_off, code, t, point, normal);
    alive2 = body(tab, a.mat_off, a.bg_off, h, L.seed, L.bounce, L.p);
    alive2 = roulette(L.seed, L.bounce, a.rr_start, alive2, L.p.col);
    L.segs += 1;
  }
  const int b2 = L.bounce + 1;
  if (a.chained) {
    const bool capped = alive2 && b2 >= a.max_bounces;
    const bool ended = !alive2 || capped;
    bool need = false;
    if (ended) {
      fold(a.it0 + L.k, capped ? L.p.rad + L.p.col : L.p.rad, L.p.nrm, L.p.depth, L.acc);
      L.k += 1;
      L.done = L.k >= a.spp;
      need = !L.done;
      if (need) L.seed = restart(a, a.pix0 + L.i, a.it0 + L.k, L.p);
    }
    L.alive = need || (alive2 && !ended);
    L.bounce = need ? 0 : b2;
  } else {
    L.alive = alive2;
    L.bounce = b2;
  }
  L.trips += 1;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) trip_drain_all_kernel(const DrainArgs d) {
  if (kStaged) {
    stage_table(d.t.tab, d.n_stage);
    __syncthreads();
  }
  const TailArgs& a = d.t;
  const float* tab = kStaged ? sm_tab() : a.tab;
  const int listed = min(*d.len, d.cap);
  Lane L;
  int slot = atomicAdd(&g_next_slot, 1);
  bool have = slot < listed;
  if (have) lane_load(a, d.ids[slot], L);
  int left = 0;
  while (have) {
    lane_trip(a, tab, d.n_sph, L);
    if ((a.chained ? L.done : !L.alive) || L.trips >= d.trips) {
      lane_store(a, L);
      left += a.chained && !L.done ? 1 : 0;
      slot = atomicAdd(&g_next_slot, 1);
      have = slot < listed;
      if (have) lane_load(a, d.ids[slot], L);
    }
  }
  if (left) atomicAdd(a.count, left);
  if (blockIdx.x == 0 && threadIdx.x == 0 && *d.len > d.cap) atomicAdd(a.count, *d.len - d.cap);
}

template <bool kStaged>
cudaError_t drain_all_ctas(size_t smem, int* ctas) {
  static Resident resident;
  return resident_ctas(resident, trip_drain_all_kernel<kStaged>, kThreads, smem, ctas);
}

}  // namespace

extern "C" {

// tpupt_trip_drain's interface; the drain as one resident wave that takes
// the listed lanes from a counter
int tpupt_trip_drain_all(float* F, int* I, int n, const float* tab, int n_tab, int n_sph,
                         int mat_off, int obj_off, int bg_off, const float* cam, int pix0,
                         int width, int height, int it0, int spp, int max_bounces, int rr_start,
                         int chained, int trips, int* ids, int cap, int* len, int* count,
                         cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(len, 0, sizeof(int), stream);
  const int zero = 0;
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbolAsync(g_next_slot, &zero, sizeof(int), 0, cudaMemcpyHostToDevice,
                                  stream);
  }
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || cap <= 0) return (int)cudaGetLastError();
  const int n_stage = drain_stage(n_tab);
  const TailArgs t{F,       I,        n,       {},         tab,     mat_off, obj_off,
                   bg_off,  cam,      pix0,    width,      height,  it0,     spp,
                   max_bounces, rr_start, chained, 0,     0,       0,       nullptr,
                   nullptr, nullptr,  nullptr, count};
  const DrainArgs d{t, n_sph, trips, ids, cap, len, n_stage};
  trip_drain_compact_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(d);
  const size_t smem = grid_smem_bytes(n_stage);
  int ctas = 0;
  err = n_stage > 0 ? drain_all_ctas<true>(smem, &ctas) : drain_all_ctas<false>(smem, &ctas);
  if (err != cudaSuccess) return (int)err;
  if (n_stage > 0) {
    trip_drain_all_kernel<true><<<ctas, kThreads, smem, stream>>>(d);
  } else {
    trip_drain_all_kernel<false><<<ctas, kThreads, smem, stream>>>(d);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
