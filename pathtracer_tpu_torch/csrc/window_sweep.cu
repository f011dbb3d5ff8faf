// Window sweep: the closest-hit kernel of the "rounds" cluster strategy.
//
// Replaces the TPU kernel `_window_kernel` of
// pathtracer_tpu/ops/cluster_sweep.py (a Pallas kernel launched by
// `_window_pass`, used by `cluster_closest`). It computes the same function,
// not the same blocks: one thread block per chunk of `ray_tile` rays (128 on
// the main path), one thread per ray. A chunk whose `skips` entry is set
// writes the identity (kBig, -1) and returns. Otherwise the block sweeps the
// W consecutive clusters starts[i], ..., starts[i] + W - 1: per cluster it
// copies the 12 x 4K column block and both masks into shared memory, and
// every thread forms its ray's four pair scalars per primitive, runs the
// sphere or triangle epilogue by the primitive's own is_sphere row (the
// residual tile is a mixed cluster; no cluster type is read) and merges into
// its running best with a strict `<`. The TPU kernel took each cluster's
// first minimum and merged clusters with a strict `<` in ascending order;
// one strict-`<` walk over the global index c * K + k gives the same winner.
// There is no stop test, hence no block reduction: a window always sweeps
// all W clusters (the residual pass W = 1, each round W = 4, the fallback
// W = C_reg).
//
// What bounds it on an H100: operations. Each (ray, primitive) pair costs 61
// (sphere) or 106 (triangle) separate fp32 instructions (--fmad=false, see
// sweep_common.cuh), against 2.8 MB of ray features at the bunny's 57,600
// rays and 25 KB of columns per cluster at K = 128. A round sweeps only the
// chunks that still hold an unresolved ray (84 of 450 in the bunny camera
// wavefront's first round: 84 x 4 clusters x 128 prims x 128 rays), so
// the launch is a few blocks per SM at most and latency bound; the W = C_reg
// fallback over every chunk comes nearest the operation bound. This first
// version stages one cluster at a time and waits for it at a barrier; a
// cp.async or TMA double buffer of the next cluster's block and a persistent
// grid are left to later work.
//
// A window that leaves the tables (starts[i] < 0 or starts[i] + W > C_tot on
// a chunk that is not skipped) fails a device-side assert: PyTorch then
// raises at the stream's next synchronisation, as it does for an index out
// of range in its own kernels, and no host sync is spent on the check.

#include <cassert>

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using pt_sweep::kBig;
using pt_sweep::kFeat;
using pt_sweep::kOuts;

__global__ void __launch_bounds__(1024) window_sweep_kernel(
    const float* __restrict__ phi, const float* __restrict__ a,
    const int* __restrict__ starts, const int* __restrict__ skips, int W,
    int C_tot, const float* __restrict__ cols,
    const int* __restrict__ is_sphere, const int* __restrict__ valid_row,
    int K, float t_min,
    float* __restrict__ t_out, int* __restrict__ best_out) {
  extern __shared__ float smem[];
  float* s_cols = smem;
  int* s_sph = reinterpret_cast<int*>(smem + kFeat * kOuts * K);
  int* s_valid = s_sph + K;

  const int chunk = blockIdx.x;
  const long long r = static_cast<long long>(chunk) * blockDim.x + threadIdx.x;
  pt_sweep::Best best = {kBig, -1};
  if (skips[chunk] == 0) {  // uniform across the block
    float p[kFeat];
#pragma unroll
    for (int f = 0; f < kFeat; ++f) p[f] = phi[r * kFeat + f];
    const float ai = a[r];
    const float inv_a = 1.0f / ai;
    const int start = starts[chunk];
    assert(start >= 0 && start <= C_tot - W);
    for (int j = 0; j < W; ++j) {
      const int c = start + j;
      pt_sweep::stage_cluster(cols, is_sphere, valid_row, c, K, s_cols, s_sph,
                              s_valid);
      __syncthreads();
      // ct = 0: every primitive typed by its own is_sphere row
      best = pt_sweep::sweep_cluster(p, ai, inv_a, s_cols, s_sph, s_valid, 0,
                                     c, K, t_min, kBig, best);
      __syncthreads();  // all reads of this cluster precede the next load
    }
  }
  t_out[r] = best.t;
  best_out[r] = best.idx;
}

}  // namespace

// Launches the window sweep on `stream`; returns the cudaError_t of the
// launch (0 on success). Shapes: phi (n_chunks*ray_tile, 12); a, t_out,
// best_out (n_chunks*ray_tile,); starts, skips (n_chunks,); cols (C_tot, 12,
// 4K); is_sphere, valid_row (C_tot, K). Every chunk that is not skipped
// must have 0 <= starts[i] and starts[i] + W <= C_tot (asserted on the
// device). best_out is c * K + k of the winner, -1 where nothing is hit.
extern "C" int window_sweep_launch(const float* phi, const float* a,
                                   const int* starts, const int* skips,
                                   int n_chunks, int ray_tile, int W,
                                   int C_tot, const float* cols,
                                   const int* is_sphere, const int* valid_row,
                                   int K, float t_min,
                                   float* t_out, int* best_out,
                                   void* stream) {
  if (n_chunks == 0) return 0;
  const size_t smem = static_cast<size_t>(kFeat * kOuts * K + 2 * K) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  window_sweep_kernel<<<n_chunks, ray_tile, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      phi, a, starts, skips, W, C_tot, cols, is_sphere, valid_row, K, t_min,
      t_out, best_out);
  return static_cast<int>(cudaGetLastError());
}
