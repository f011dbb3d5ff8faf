// Window sweep: the closest-hit kernel of the "rounds" cluster strategy.
//
// Replaces the TPU kernel `_window_kernel` of
// pathtracer_tpu/ops/cluster_sweep.py (a Pallas kernel launched by
// `_window_pass`, used by `cluster_closest`). It computes the same function,
// not the same blocks: one thread block per chunk of `ray_tile` rays (128 on
// the main path), each thread carrying kRT of them, in G groups of threads. A
// chunk whose `skips` entry is set writes the identity (kBig, -1) and
// returns before any barrier (the test is uniform across the block).
// Otherwise the block sweeps the W consecutive clusters starts[i], ...,
// starts[i] + W - 1, each over its real rows [lo, hi) only (`ranges`; the
// tables' padding rows are radius-0 spheres at 3e37 that never hit): the
// next cluster's rows are copied (cp.async) as 192-byte records into one
// shared buffer while the current cluster is swept from the other, group g
// sweeps every G-th staged primitive, typed by its own is_sphere row (the
// residual tile is a mixed cluster; no cluster type is read), and merges
// with a strict `<`; the groups' results are merged at the end by the rule
// of sweep_common.cuh. The TPU kernel took each cluster's first minimum and
// merged clusters with a strict `<` in ascending order: the global first
// minimum over c * K + k, which that rule gives for any split. There is no
// stop test: a window always sweeps all W clusters (the residual pass
// W = 1, each round W = 4, the fallback W = C_reg).
//
// What bounds it on an H100: operations, and in a round the few live
// chunks. Each (ray, primitive) pair costs at most 61 (sphere) or 106
// (triangle) separate fp32 operations (--fmad=false, see sweep_common.cuh),
// and the core forms only what the result can depend on; against that, 2.8
// MB of ray features at the bunny's 57,600 rays and 25 KB of columns per
// cluster at K = 128. A round sweeps only the chunks that still hold an
// unresolved ray (84 of 450 in the bunny camera wavefront's first round),
// so one block of 4 warps per chunk, as in the first version, left most of
// the card idle: the groups give a round's block G times the warps, and
// the fallback's few live chunks walk their clusters G ways at once. The
// residual tile holds 3 real rows of 128 on the bunny, and only those are
// swept. The parameters are constants, chosen on an H100 (PERF.md): kRT = 2
// rays per thread; a group is ceil(ray_tile / kRT) threads rounded up to a
// warp, and a block holds as many groups as fit in 512 threads, at most
// kMaxGroups = 8 (8 groups of 64 threads for a 128-ray chunk); the cp.async
// double buffer.
//
// A window that leaves the tables (starts[i] < 0 or starts[i] + W > C_tot on
// a chunk that is not skipped), or a range outside [0, K], fails a
// device-side assert: PyTorch then raises at the stream's next
// synchronisation, as it does for an index out of range in its own kernels,
// and no host sync is spent on the check.

#include <cassert>

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using pt_sweep::kBig;
using pt_sweep::kFeat;
using pt_sweep::kOuts;

constexpr int kRT = 2;
constexpr int kMaxGroups = 8;

__global__ void __launch_bounds__(pt_sweep::kMaxThreads) window_sweep_kernel(
    const float* __restrict__ phi, const float* __restrict__ a,
    const int* __restrict__ starts, const int* __restrict__ skips, int W,
    int C_tot, const float* __restrict__ cols,
    const int* __restrict__ is_sphere, const int* __restrict__ ranges, int K,
    float t_min, int ray_tile, int lanes, float* __restrict__ t_out,
    int* __restrict__ best_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int g = tid / lanes;
  const int j = tid - g * lanes;
  const int G = blockDim.x / lanes;
  const long long r0 = static_cast<long long>(chunk) * ray_tile;

  if (skips[chunk] != 0) {  // uniform across the block
    if (g == 0) {
      for (int q = j; q < ray_tile; q += lanes) {
        t_out[r0 + q] = kBig;
        best_out[r0 + q] = -1;
      }
    }
    return;
  }
  pt_sweep::RayTile<kRT> rt;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int q = j + i * lanes;
    pt_sweep::load_ray(rt, i, phi, a, r0 + q, q < ray_tile);
  }
  const int start = starts[chunk];
  assert(start >= 0 && start <= C_tot - W);
  const int width = kFeat * kOuts * K;  // floats per cluster column block
  pt_sweep::run_pipeline<true>(
      W,
      [&](int r, int b) {
        const int c = start + r;
        const int lo = ranges[2 * c];
        const int hi = ranges[2 * c + 1];
        assert(0 <= lo && lo <= hi && hi <= K);
        pt_sweep::stage_records<true>(
            cols + static_cast<long long>(c) * width, is_sphere + c * K, K,
            lo, hi - lo, pt_sweep::run_buf(smem, 2, K, b));
      },
      [&](int r, int b) {
        const int c = start + r;
        const int lo = ranges[2 * c];
        pt_sweep::sweep_records<kRT>(
            rt, pt_sweep::run_buf(smem, 2, K, b), g, ranges[2 * c + 1] - lo,
            G, c * K + lo, t_min, kBig);
      });
  if (G > 1) {
    float* s_t = pt_sweep::merge_t(smem, 2, K);
    pt_sweep::merge_groups(rt, G, g, j, lanes, s_t,
                           reinterpret_cast<int*>(s_t + G * lanes * kRT));
    if (g != 0) return;
  }
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int q = j + i * lanes;
    if (q < ray_tile) {
      t_out[r0 + q] = rt.best[i].t;
      best_out[r0 + q] = rt.best[i].idx;
    }
  }
}

}  // namespace

// Launches the window sweep on `stream`; returns the cudaError_t of the
// launch (0 on success, cudaErrorInvalidValue for shapes it does not
// take). Shapes: phi (n_chunks*ray_tile, 12); a, t_out, best_out
// (n_chunks*ray_tile,); starts, skips (n_chunks,); cols (C_tot, 12, 4K);
// is_sphere (C_tot, K); ranges (C_tot, 2), the rows [lo, hi) of each
// cluster that are swept. Every chunk that is not skipped must have
// 0 <= starts[i] and starts[i] + W <= C_tot (asserted on the device).
// best_out is c * K + k of the winner, -1 where nothing is hit. ray_tile is
// at most 2 * kMaxThreads.
extern "C" int window_sweep_launch(const float* phi, const float* a,
                                   const int* starts, const int* skips,
                                   int n_chunks, int ray_tile, int W,
                                   int C_tot, const float* cols,
                                   const int* is_sphere, const int* ranges,
                                   int K, float t_min, float* t_out,
                                   int* best_out, void* stream) {
  // lanes: the threads of one group, kRT rays each, a whole number of
  // warps; as many groups as fit in kMaxThreads, at most kMaxGroups
  const int lanes = ((ray_tile + kRT - 1) / kRT + 31) / 32 * 32;
  if (ray_tile <= 0 || lanes > pt_sweep::kMaxThreads || W < 1 || K <= 0 ||
      n_chunks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_chunks == 0) return 0;
  const int fit = pt_sweep::kMaxThreads / lanes;
  const int groups = fit < kMaxGroups ? fit : kMaxGroups;
  const size_t smem = pt_sweep::sweep_smem_bytes(2, K, groups, lanes, kRT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  window_sweep_kernel<<<n_chunks, lanes * groups, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      phi, a, starts, skips, W, C_tot, cols, is_sphere, ranges, K, t_min,
      ray_tile, lanes, t_out, best_out);
  return static_cast<int>(cudaGetLastError());
}
