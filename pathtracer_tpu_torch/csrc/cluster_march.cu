// Cluster march: the closest-hit kernel of the culled bunny render.
//
// Replaces the TPU kernel `_march_kernel` of pathtracer_tpu/ops/cluster_sweep.py
// (a Pallas kernel launched by `cluster_march`). It computes the same
// function, not the same blocks: one thread block per chunk of `ray_tile`
// rays (128 on the main path). The chunk walks its regular clusters in
// ascending chunk-entry order (`ids`/`ents`, sorted by the caller, with at
// least one +BIG sentinel slot at the end) and stops before slot j once
// max over its rays of min(t_best, gate) is not beyond ents[j]: no unvisited
// cluster can then beat any ray. `t_max` rejects hits at or beyond it (the
// NEE shadow query passes 1).
//
// What bounds it on an H100: the longest chunk's serial walk. On the bunny's
// 57,600-ray wavefronts only 73-81 of 450 chunks march at all, and the
// longest marches 25 slots (camera) or 57 (bounce, every cluster); the
// kernel ends when that chunk does, so its time is those slots times the
// time of one slot. The first version of this kernel gave a chunk one
// block of 4 warps, one thread per ray, four barriers per slot, a plain
// copy of the 12 x 4K column block, all four pair scalars and the full
// epilogue for every row, padding included: 21.3 us per slot on both
// wavefronts. This version runs the chunk on the sweep core of
// sweep_common.cuh, shared with the dense and window sweeps, and takes each
// slot's work G ways at once: 6.0 us per slot (device time from
// torch.profiler, `chip_smoke.py --bench`, NVIDIA H100 80GB HBM3 at 700 W),
// of which ~4.6 us is the sweep itself, near its instruction-issue bound on
// one SM, and ~1.5 us the slot's fixed cost.
// * Each thread carries kRT rays; a group of `lanes` threads (ceil(ray_tile
//   / kRT) rounded up to a warp) holds the chunk, and the block holds as
//   many groups as fit kMaxThreads, at most kMaxGroups (8 groups of 64
//   threads for 128 rays: 16 warps).
// * A slot's cluster is staged as records, only its real rows [lo, hi)
//   (`ranges`), typed by their own is_sphere rows; group g sweeps staged
//   rows g, g + G, ... into a slot-local best with the staged epilogue.
// * The merge is exact across slots: per slot, each ray's group results are
//   merged by smaller t, then smaller index (the cluster's first minimum,
//   as in the window sweep), and that is folded into the ray's running best
//   with a strict `<`, in slot order, as the twin does. (Merging groups that
//   carry their own running bests by (t, index) at the end would not be:
//   slots do not come in ascending cluster order, and on a tie at bit-equal
//   t across two slots the earlier slot must win, whatever its index.)
// * The stop test needs no barrier of its own: max over rays of min(t_best,
//   gate) > ents[j] holds where some ray has min(t_best, gate) > ents[j],
//   so the barrier that publishes slot j's records takes it as the block's
//   OR (__syncthreads_or). A slot has two barriers, that one and the one
//   that publishes the groups' results.
// * The next slot's cluster (`ids[j + 1]`) is copied with cp.async into
//   the other buffer while this one is swept, once this slot's stop test
//   has passed, so a chunk copies one cluster it does not sweep: the one at
//   which it stops.
//
// The reference's wide visits (W clusters per march step,
// pathtracer_tpu/ops/cluster_sweep.py:1099-1123) are not taken: they fed the
// TPU's matrix unit a wider operand per step and give the same bits as one
// cluster per step. Here they would pay only if a slot's fixed cost were
// more than half of a slot's time; it is a quarter (sweeping every slot
// twice adds 4.5-4.7 us to a 6.0-6.1 us slot).
//
// The parameters are constants, chosen on an H100 (PERF.md): kRT = 2 rays
// per thread, up to kMaxGroups = 8 groups, the cp.async double buffer.
// A cluster id outside [0, C_tot) or a range outside [0, K] fails a
// device-side assert, as in the window sweep. Arithmetic: the sweep core's
// records and staged epilogue round exactly like the separate PyTorch ops
// of the plain twin (`march_reference` in ops/cluster_sweep.py).

#include <cassert>
#include <cmath>

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using pt_sweep::kBig;
using pt_sweep::kFeat;
using pt_sweep::kOuts;
using pt_sweep::kRec;

constexpr int kRT = 2;
constexpr int kMaxGroups = 8;

// One slot's cluster: its id and real rows [lo, hi). The range is loaded a
// slot before it is used and checked where it is staged, so that no check
// waits on a load.
struct Slot {
  int c, lo, hi;
};

__device__ __forceinline__ Slot read_slot(int c, int C_tot,
                                          const int* __restrict__ ranges) {
  assert(0 <= c && c < C_tot);
  return Slot{c, ranges[2 * c], ranges[2 * c + 1]};
}

__global__ void __launch_bounds__(pt_sweep::kMaxThreads) cluster_march_kernel(
    const float* __restrict__ phi, const float* __restrict__ a,
    const float* __restrict__ gate, const int* __restrict__ ids,
    const float* __restrict__ ents, int n_slots, int C_tot,
    const float* __restrict__ cols, const int* __restrict__ is_sphere,
    const int* __restrict__ ranges, int K, float t_min, float t_max,
    int ray_tile, int lanes, float* __restrict__ t_out,
    int* __restrict__ best_out, int* __restrict__ slots_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int g = tid / lanes;
  const int j = tid - g * lanes;
  const int G = nthr / lanes;
  const int nr = lanes * kRT;  // slot-local results of one group
  const long long r0 = static_cast<long long>(chunk) * ray_tile;
  const int width = kFeat * kOuts * K;  // floats per cluster column block
  float* s_t = pt_sweep::merge_t(smem, 2, K);
  int* s_i = reinterpret_cast<int*>(s_t + G * nr);
  const int* ids_c = ids + static_cast<long long>(chunk) * n_slots;
  const float* ents_c = ents + static_cast<long long>(chunk) * n_slots;
  const int last = n_slots - 1;
  float e = ents_c[0];

  // the sweep's rays: group g, thread j holds rays j + i * lanes
  pt_sweep::RayTile<kRT> rt;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int q = j + i * lanes;
    pt_sweep::load_ray(rt, i, phi, a, r0 + q, q < ray_tile);
  }
  // the running bests: thread tid owns rays tid + i * nthr (< ray_tile),
  // whose results the groups leave at s_t[h * nr + q]. The stop test
  // max over rays of min(t_best, gate) > e is the block's OR of `go`, some
  // owned ray's min(t_best, gate) > e (the same for NaN: fmaxf and fminf
  // drop it, and NaN > e is false), taken by the barrier that starts a
  // slot.
  float own_t[kRT], own_g[kRT];
  int own_i[kRT];
  bool go = false;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int q = tid + i * nthr;
    own_t[i] = kBig;
    own_i[i] = -1;
    own_g[i] = q < ray_tile ? gate[r0 + q] : 0.0f;
    if (q < ray_tile) go = go || fminf(kBig, own_g[i]) > e;
  }

  auto stage = [&](Slot sl, int b) {
    assert(0 <= sl.lo && sl.lo <= sl.hi && sl.hi <= K);
    pt_sweep::stage_records<true>(
        cols + static_cast<long long>(sl.c) * width, is_sphere + sl.c * K,
        K, sl.lo, sl.hi - sl.lo, pt_sweep::run_buf(smem, 2, K, b));
    pt_sweep::cp_async_commit();
  };
  // registers run ahead of the walk: slot s's cluster (staged), slot
  // s + 1's (to stage once the test passes), slot s + 2's id, ents[s]
  Slot cur = read_slot(ids_c[0], C_tot, ranges);
  Slot nxt = read_slot(ids_c[min(1, last)], C_tot, ranges);
  int c2 = ids_c[min(2, last)];
  stage(cur, 0);
  int s = 0;
  for (;; ++s) {
    pt_sweep::cp_async_wait<0>();
    // A: slot s's records are visible, and the stop test before slot s
    if (!__syncthreads_or(go)) break;
    Slot after = nxt;
    if (s < last) {
      stage(nxt, (s + 1) & 1);
      e = ents_c[s + 1];
      after = read_slot(c2, C_tot, ranges);
      c2 = ids_c[min(s + 3, last)];
    } else {
      e = INFINITY;  // no slot after the last one
    }
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      rt.best[i].t = kBig;
      rt.best[i].idx = -1;
    }
    pt_sweep::sweep_records<kRT>(rt, pt_sweep::run_buf(smem, 2, K, s & 1),
                                 g, cur.hi - cur.lo, G, cur.c * K + cur.lo,
                                 t_min, t_max);
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      s_t[g * nr + j + i * lanes] = rt.best[i].t;
      s_i[g * nr + j + i * lanes] = rt.best[i].idx;
    }
    // B: the groups' results are visible; every read of buffer s & 1 is
    // done, so the next slot may copy into it
    __syncthreads();
    go = false;
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int q = tid + i * nthr;
      if (q < ray_tile) {
        // the cluster's first minimum: smaller t, then smaller index (-1,
        // no hit, loses every tie; it only comes with t = kBig)
        float tc = s_t[q];
        int ic = s_i[q];
#pragma unroll
        for (int h = 1; h < kMaxGroups; ++h) {
          if (h < G) {
            const float th = s_t[h * nr + q];
            const int ih = s_i[h * nr + q];
            if (th < tc || (th == tc && static_cast<unsigned>(ih) <
                                            static_cast<unsigned>(ic))) {
              tc = th;
              ic = ih;
            }
          }
        }
        if (tc < own_t[i]) {
          own_t[i] = tc;
          own_i[i] = ic;
        }
        go = go || fminf(own_t[i], own_g[i]) > e;
      }
    }
    cur = nxt;
    nxt = after;
  }
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int q = tid + i * nthr;
    if (q < ray_tile) {
      t_out[r0 + q] = own_t[i];
      best_out[r0 + q] = own_i[i];
    }
  }
  if (tid == 0) slots_out[chunk] = s;
}

}  // namespace

// Launches the march on `stream`; returns the cudaError_t of the launch (0 on
// success, cudaErrorInvalidValue for shapes it does not take). Shapes: phi
// (n_chunks*ray_tile, 12); a, gate, t_out, best_out (n_chunks*ray_tile,);
// ids, ents (n_chunks, n_slots), every id in [0, C_tot) (asserted on the
// device); cols (C_tot, 12, 4K); is_sphere (C_tot, K); ranges (C_tot, 2),
// the rows [lo, hi) of each cluster that are swept (asserted to lie in
// [0, K]); slots_out (n_chunks,). best_out is c * K + k of the winner, -1
// where nothing is hit. ray_tile is at most 2 * kMaxThreads.
extern "C" int cluster_march_launch(
    const float* phi, const float* a, const float* gate, const int* ids,
    const float* ents, int n_chunks, int n_slots, int ray_tile, int C_tot,
    const float* cols, const int* is_sphere, const int* ranges, int K,
    float t_min, float t_max, float* t_out, int* best_out, int* slots_out,
    void* stream) {
  // lanes: the threads of one group, kRT rays each, a whole number of
  // warps; as many groups as fit in kMaxThreads, at most kMaxGroups
  const int lanes = ((ray_tile + kRT - 1) / kRT + 31) / 32 * 32;
  if (ray_tile <= 0 || lanes > pt_sweep::kMaxThreads || n_slots < 1 ||
      C_tot < 1 || K <= 0 || n_chunks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_chunks == 0) return 0;
  const int fit = pt_sweep::kMaxThreads / lanes;
  const int groups = fit < kMaxGroups ? fit : kMaxGroups;
  // two run buffers and the merge arrays, which the stop test reads for
  // any number of groups
  const size_t smem = static_cast<size_t>(2) * K * (kRec + 1) * 4 +
                      static_cast<size_t>(groups) * lanes * kRT * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cluster_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cluster_march_kernel<<<n_chunks, lanes * groups, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      phi, a, gate, ids, ents, n_slots, C_tot, cols, is_sphere, ranges, K,
      t_min, t_max, ray_tile, lanes, t_out, best_out, slots_out);
  return static_cast<int>(cudaGetLastError());
}
