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

// ---------------------------------------------------------------------------
// The march's input preparation: `march_bin` and `march_order`.
//
// They replace no Pallas kernel. The reference computes the query's cull,
// binning key, stop gates, chunk orders and residual sweep
// (pathtracer_tpu/ops/cluster_sweep.py, `cluster_march` before its
// `pallas_call`) as array code that XLA fuses; these two kernels are the
// counterpart of that fusion. The plain twin, `march_inputs_reference` in
// ops/cluster_sweep.py, runs the same steps as some 150 PyTorch ops a query,
// each a launch of its own: the card idled while the host dispatched them
// (about 7 ms a query on an H100's host at any width, from 16,384 to 129,600
// rays), and the (C, R) entry tensors they wrote and read again outweighed
// the march kernel's own device time. They take the flat cull plan only (no
// cull2, sup 1, at most kMaxPrepClusters regular clusters); the wrapper sends
// every other plan to the twin.
//
// What bounds them: bytes, about 126 a lane (the ray in; the sorted ray,
// phi, a, the gate and the residual winner out; a chunk's order per
// ray_tile lanes), 8 more for each extra; the arithmetic, C slab tests a
// lane in each kernel and 8 residual rows, is small beside it. On an H100
// they take 6-17 us (march_bin) and 27-47 us (march_order) at 16,384 and
// 129,600 lanes, against a bound of 0.8-4.9 us: a query's preparation is
// now bound by its launches and the host's time to dispatch them. The design
// keeps the twin's (C, R) entries out of device memory: a ray's cull
// depends on that ray alone, so each kernel recomputes a lane's entries
// from its ray, and `march_order` reduces each box's chunk minimum in
// shared memory as it goes.
// * march_bin (only when the rays are sorted): one thread a lane, the boxes
//   staged in shared memory. It writes the lane's two-level bin key
//   kmin * (C + 1) + klast (first minimum entry, last touched box), or
//   C * (C + 2) where it touches nothing, as int32, and its `active` flag.
//   One stable torch.sort of the keys gives the order (the reference leaves
//   that sort to XLA too); an int32 key gives the int64 key's permutation.
// * march_order: one block a chunk, one thread a lane. Each thread takes its
//   lane through the order (or the identity) and writes the sorted ray, the
//   caller's per-lane state that rides the sort (up to PrepExtras::kMax
//   4-byte planes), phi, a, the stop gate and the residual tile's winner.
//   It folds each box's entry into the chunk's minimum: a warp's minimum by
//   __reduce_min_sync and a shared atomicMin, on the entry's bits mapped to
//   an order-keeping int (entries may be negative at the shadow query's
//   near-zero t_min, and are never NaN or -0: the twin's NaN-dropping
//   selects keep them finite or BIG, and tn - margin with tn > 0 is never
//   -0). The block then ranks the C (entry, id) pairs, ascending by entry
//   and then by id, which is torch.sort(..., stable=True), and writes the
//   chunk's ids and entries with the +BIG sentinel slot.
// Arithmetic: the twin's operation order (1 / d as IEEE division, then
// (cmin - o) * inv, then tn - ((1e-4 * |tn|) + 1e-6)), its float32
// constants (each Python scalar cast from its double, as torch casts it),
// first-minimum argmin (a NaN first, as torch's) and last-touched klast;
// with --fmad=false every output is the twin's to the bit.
// ---------------------------------------------------------------------------

// The caller's per-lane state that rides the binning sort: up to kMax (r,)
// tensors of 4-byte elements (src[i][lane * stride[i]]), each gathered into
// a contiguous dst[i] in the sorted order. Outside the unnamed namespace:
// a parameter type there would give march_order_launch internal linkage.
struct PrepExtras {
  static constexpr int kMax = 8;
  const unsigned* src[kMax];
  unsigned* dst[kMax];
  long long stride[kMax];
  int n;
};

namespace {

// CULL2_CLUSTERS in ops/cluster_sweep.py: the cull plan's switch to cull2
constexpr int kMaxPrepClusters = 2048;
constexpr int kResRows = 8;  // K_RES: the residual tile's last rows
constexpr int kOrderMaxThreads = 1024;
constexpr int kBinThreads = 256;
// The twin's Python scalars, each cast from its double as torch casts them.
constexpr float kBigF = static_cast<float>(3.0e38);
constexpr float kHalfBig = static_cast<float>(3.0e38 * 0.5);
constexpr float kMargin = static_cast<float>(1e-4);
constexpr float kMarginAbs = static_cast<float>(1e-6);
constexpr float kGateScale = static_cast<float>(1.0 + 1e-5);
constexpr float kGateAdd = static_cast<float>(1e-5);

// One lane's ray: (o, d) of the caller's lane `src`, zeros past the r real
// lanes; active where the caller's mask (if any) is set and d != 0.
struct PrepRay {
  float o[3], d[3], inv[3];
  bool active;
};

__device__ __forceinline__ PrepRay load_prep_ray(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ mask, long long r, long long src) {
  PrepRay y;
  const bool real = src < r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    y.o[k] = real ? o[3 * src + k] : 0.0f;
    y.d[k] = real ? d[3 * src + k] : 0.0f;
    y.inv[k] = 1.0f / y.d[k];
  }
  const bool nonzero = y.d[0] != 0.0f || y.d[1] != 0.0f || y.d[2] != 0.0f;
  y.active = nonzero && (mask == nullptr || (real && mask[src] != 0));
  return y;
}

// Stages the C boxes as box[6c .. 6c + 2] = cmin[c], box[6c + 3 ..] = cmax[c].
__device__ __forceinline__ void stage_boxes(const float* __restrict__ cmin,
                                            const float* __restrict__ cmax,
                                            int C, float* s_box) {
  const int nthr = blockDim.x;
  for (int i = threadIdx.x; i < 3 * C; i += nthr) {
    const int c = i / 3;
    const int ax = i - 3 * c;
    s_box[6 * c + ax] = cmin[i];
    s_box[6 * c + 3 + ax] = cmax[i];
  }
}

// The twin's `_cull_T` entry of an active ray against one box: the
// conservative entry distance, or BIG where the slab test misses.
__device__ __forceinline__ float cull_entry(const PrepRay& y,
                                            const float* box, float t_min) {
  float tn = t_min;
  float tf = kBigF;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float lo = (box[ax] - y.o[ax]) * y.inv[ax];
    const float hi = (box[3 + ax] - y.o[ax]) * y.inv[ax];
    const bool swap = y.inv[ax] < 0.0f;
    const float near = swap ? hi : lo;
    const float far = swap ? lo : hi;
    tn = near > tn ? near : tn;
    tf = far < tf ? far : tf;
  }
  if (tf < tn) return kBigF;
  return tn - (kMargin * fabsf(tn) + kMarginAbs);
}

// An order-keeping int of a float that is not NaN (-0 sorts below +0, and
// never occurs here); its own inverse.
__device__ __forceinline__ int ordered_bits(int i) {
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__global__ void __launch_bounds__(kBinThreads) march_bin_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ mask, long long r, long long r_pad,
    const float* __restrict__ cmin, const float* __restrict__ cmax, int C,
    float t_min, int* __restrict__ key_out,
    unsigned char* __restrict__ active_out) {
  extern __shared__ float4 prep_smem4[];
  float* s_box = reinterpret_cast<float*>(prep_smem4);
  stage_boxes(cmin, cmax, C, s_box);
  __syncthreads();
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (q >= r_pad) return;
  const PrepRay y = load_prep_ray(o, d, mask, r, q);
  int key = C * (C + 2);
  if (y.active) {
    float e_min = kBigF;
    int kmin = 0;
    int klast = -1;
    for (int c = 0; c < C; ++c) {
      const float e = cull_entry(y, s_box + 6 * c, t_min);
      if (e < e_min) {  // argmin's first minimum (entries are <= BIG)
        e_min = e;
        kmin = c;
      }
      if (e < kHalfBig) klast = c;
    }
    if (klast >= 0) key = kmin * (C + 1) + klast;
  }
  key_out[q] = key;
  active_out[q] = y.active ? 1 : 0;
}

// The twin's `_epilogue` of one (ray, residual row) pair from its four pair
// scalars: the hit t, or BIG where it misses or the row is not valid.
__device__ __forceinline__ float residual_t(float B, float C0, float P2,
                                            float P3, float a, bool sphere,
                                            bool valid, float t_min,
                                            float t_max) {
  if (sphere) {
    const float disc = B * B - a * C0;
    const float sqrt_d = disc > 0.0f ? sqrtf(disc) : 0.0f;
    const float inv_a = 1.0f / a;
    const float root0 = (-B - sqrt_d) * inv_a;
    const float root1 = (-B + sqrt_d) * inv_a;
    const bool ok0 = !((root0 < t_min) || (t_max < root0));
    const bool ok1 = !((root1 < t_min) || (t_max < root1));
    const float t = ok0 ? root0 : root1;
    return (disc >= 0.0f && (ok0 || ok1) && valid) ? t : kBigF;
  }
  const float inv_det = 1.0f / (B == 0.0f ? 1.0f : B);
  const float t = C0 * inv_det;
  const float b1 = P2 * inv_det;
  const float b2 = P3 * inv_det;
  const bool miss = (B == 0.0f) || (b1 <= 0.0f) || (b2 <= 0.0f) ||
                    (b1 + b2 >= 1.0f) || (t <= t_min) || (t >= t_max);
  return (!miss && valid) ? t : kBigF;
}

__global__ void __launch_bounds__(kOrderMaxThreads) march_order_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ mask,
    const long long* __restrict__ order, long long r, int C,
    const float* __restrict__ cmin, const float* __restrict__ cmax,
    float t_min, float t_max, int clamp_gate,
    const float* __restrict__ res_cols, const int* __restrict__ res_sph,
    const int* __restrict__ res_valid, int K, int b_base,
    float* __restrict__ o_out, float* __restrict__ d_out,
    unsigned char* __restrict__ active_out, long long* __restrict__ rid_out,
    float* __restrict__ phi_out, float* __restrict__ a_out,
    float* __restrict__ gate_out, int* __restrict__ ids_out,
    float* __restrict__ ents_out, float* __restrict__ t_res_out,
    int* __restrict__ b_res_out, const PrepExtras extras) {
  extern __shared__ float4 prep_smem4[];
  float* s_box = reinterpret_cast<float*>(prep_smem4);   // 6 C
  int* s_min = reinterpret_cast<int*>(s_box + 6 * C);    // C
  float* s_res = reinterpret_cast<float*>(s_min + C);    // 12 x 4 x 8
  int* s_sph = reinterpret_cast<int*>(s_res + kFeat * kOuts * kResRows);
  int* s_valid = s_sph + kResRows;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  stage_boxes(cmin, cmax, C, s_box);
  for (int c = tid; c < C; c += nthr) s_min[c] = ordered_bits(
      __float_as_int(kBigF));
  // the residual tile's last kResRows rows: feature f of output k of row j
  // at res_cols[f * 4K + k * K + K - kResRows + j]
  for (int i = tid; i < kFeat * kOuts * kResRows; i += nthr) {
    const int j = i % kResRows;
    const int fk = i / kResRows;
    const int f = fk / kOuts;
    const int k = fk - f * kOuts;
    s_res[i] = res_cols[f * kOuts * K + k * K + K - kResRows + j];
  }
  if (tid < kResRows) {
    s_sph[tid] = res_sph[tid];
    s_valid[tid] = res_valid[tid];
  }
  __syncthreads();

  const long long chunk = blockIdx.x;
  const long long gid = chunk * nthr + tid;
  const long long src = order != nullptr ? order[gid] : gid;
  const PrepRay y = load_prep_ray(o, d, mask, r, src);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o_out[3 * gid + k] = y.o[k];
    d_out[3 * gid + k] = y.d[k];
  }
  active_out[gid] = y.active ? 1 : 0;
  if (rid_out != nullptr) rid_out[gid] = src;
#pragma unroll
  for (int i = 0; i < PrepExtras::kMax; ++i) {
    if (i < extras.n) {
      extras.dst[i][gid] = extras.src[i][src * extras.stride[i]];
    }
  }

  // each box's entry: the lane's stop gate (its farthest touched entry) and
  // the chunk's minimum entry of the box
  const int lane = tid & 31;
  float far = -kBigF;
  for (int c = 0; c < C; ++c) {
    const float e = y.active ? cull_entry(y, s_box + 6 * c, t_min) : kBigF;
    const float v = e >= kHalfBig ? -kBigF : e;
    far = v > far ? v : far;
    const int m = __reduce_min_sync(0xffffffffu,
                                    ordered_bits(__float_as_int(e)));
    if (lane == 0) atomicMin(s_min + c, m);
  }
  float gate = far * kGateScale + kGateAdd;
  if (clamp_gate) gate = fminf(gate, t_max);
  gate_out[gid] = y.active ? gate : -kBigF;

  // phi = [d, o, o x d, o.d, |o|^2, 1] of d zeroed on inactive lanes, and
  // a = |d|^2 (1 where 0), as `ray_features` and `vec.dot` round them
  float de[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) de[k] = y.active ? y.d[k] : 0.0f;
  float p[kFeat];
  p[0] = de[0];
  p[1] = de[1];
  p[2] = de[2];
  p[3] = y.o[0];
  p[4] = y.o[1];
  p[5] = y.o[2];
  p[6] = y.o[1] * de[2] - y.o[2] * de[1];
  p[7] = y.o[2] * de[0] - y.o[0] * de[2];
  p[8] = y.o[0] * de[1] - y.o[1] * de[0];
  p[9] = (y.o[0] * de[0] + y.o[1] * de[1]) + y.o[2] * de[2];
  p[10] = (y.o[0] * y.o[0] + y.o[1] * y.o[1]) + y.o[2] * y.o[2];
  p[11] = 1.0f;
  float a = (de[0] * de[0] + de[1] * de[1]) + de[2] * de[2];
  a = a == 0.0f ? 1.0f : a;
#pragma unroll
  for (int f = 0; f < kFeat; ++f) phi_out[kFeat * gid + f] = p[f];
  a_out[gid] = a;

  // the residual rows: the pair scalars summed left to right (`contract`),
  // the epilogue, the first minimum (a NaN first, as torch's argmin; x != x
  // only for NaN)
  float best = 0.0f;
  int best_j = 0;
  for (int j = 0; j < kResRows; ++j) {
    float S[kOuts];
#pragma unroll
    for (int k = 0; k < kOuts; ++k) {
      float s = p[0] * s_res[k * kResRows + j];
#pragma unroll
      for (int f = 1; f < kFeat; ++f) {
        s = s + p[f] * s_res[(f * kOuts + k) * kResRows + j];
      }
      S[k] = s;
    }
    const float t = residual_t(S[0], S[1], S[2], S[3], a, s_sph[j] != 0,
                               s_valid[j] != 0, t_min, t_max);
    if (j == 0 || (best == best && (t != t || t < best))) {
      best = t;
      best_j = j;
    }
  }
  t_res_out[gid] = best;
  b_res_out[gid] = best < kHalfBig ? b_base + best_j : -1;

  // the chunk's order: box c goes to its rank among the (entry, id) pairs
  __syncthreads();
  const long long row = chunk * (C + 1);
  for (int c = tid; c < C; c += nthr) {
    const int mc = s_min[c];
    int rank = 0;
    for (int c2 = 0; c2 < C; ++c2) {
      const int m2 = s_min[c2];
      rank += (m2 < mc || (m2 == mc && c2 < c)) ? 1 : 0;
    }
    ids_out[row + rank] = c;
    ents_out[row + rank] = __int_as_float(ordered_bits(mc));
  }
  if (tid == 0) {
    ids_out[row + C] = 0;
    ents_out[row + C] = kBigF;
  }
}

// Sets a kernel's dynamic shared memory limit where it needs more than the
// default 48 KB.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Launches march_bin on `stream` over r_pad lanes (the first r the caller's,
// the rest padding); returns the cudaError_t of the launch. o, d (r, 3);
// mask (r,) bool or null; cmin, cmax (C, 3); key_out (r_pad,) int32;
// active_out (r_pad,) bool.
extern "C" int march_bin_launch(const float* o, const float* d,
                                const unsigned char* mask, long long r,
                                long long r_pad, const float* cmin,
                                const float* cmax, int C, float t_min,
                                int* key_out, unsigned char* active_out,
                                void* stream) {
  if (C < 1 || C > kMaxPrepClusters || r < 0 || r_pad < r) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (r_pad == 0) return 0;
  const size_t smem = static_cast<size_t>(6) * C * 4;
  const cudaError_t e = allow_smem(march_bin_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (r_pad + kBinThreads - 1) / kBinThreads;
  march_bin_kernel<<<static_cast<unsigned>(blocks), kBinThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      o, d, mask, r, r_pad, cmin, cmax, C, t_min, key_out, active_out);
  return static_cast<int>(cudaGetLastError());
}

// Launches march_order on `stream`: n_chunks blocks of ray_tile threads
// (a multiple of 32 up to 1024), lane q of the output taking the caller's
// lane order[q] (order null: q). res_cols is the residual tile's column
// block (12, 4K); res_sph, res_valid its is_sphere and valid_row rows
// K - 8 .. K - 1; b_base the global index of its row K - 8. Outputs, for
// R = n_chunks * ray_tile: o_out, d_out (R, 3); active_out (R,) bool;
// rid_out (R,) int64 or null; phi_out (R, 12); a_out, gate_out, t_res_out
// (R,); b_res_out (R,) int32; ids_out, ents_out (n_chunks, C + 1); and
// each of the `extras` (taken only where R == r: every lane real).
extern "C" int march_order_launch(
    const float* o, const float* d, const unsigned char* mask,
    const long long* order, long long r, int n_chunks, int ray_tile, int C,
    const float* cmin, const float* cmax, float t_min, float t_max,
    int clamp_gate, const float* res_cols, const int* res_sph,
    const int* res_valid, int K, int b_base, float* o_out, float* d_out,
    unsigned char* active_out, long long* rid_out, float* phi_out,
    float* a_out, float* gate_out, int* ids_out, float* ents_out,
    float* t_res_out, int* b_res_out, PrepExtras extras, void* stream) {
  if (C < 1 || C > kMaxPrepClusters || ray_tile <= 0 || ray_tile % 32 != 0 ||
      ray_tile > kOrderMaxThreads || n_chunks < 0 || K < kResRows || r < 0 ||
      extras.n < 0 || extras.n > PrepExtras::kMax ||
      (extras.n > 0 && static_cast<long long>(n_chunks) * ray_tile != r)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_chunks == 0) return 0;
  const size_t smem =
      (static_cast<size_t>(7) * C + kFeat * kOuts * kResRows + 2 * kResRows) *
      4;
  const cudaError_t e = allow_smem(march_order_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  march_order_kernel<<<n_chunks, ray_tile, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      o, d, mask, order, r, C, cmin, cmax, t_min, t_max, clamp_gate, res_cols,
      res_sph, res_valid, K, b_base, o_out, d_out, active_out, rid_out,
      phi_out, a_out, gate_out, ids_out, ents_out, t_res_out, b_res_out,
      extras);
  return static_cast<int>(cudaGetLastError());
}
