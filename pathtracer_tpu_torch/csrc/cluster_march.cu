// Cluster march: the closest-hit kernel of the culled bunny render.
//
// Replaces the TPU kernel `_march_kernel` of pathtracer_tpu/ops/cluster_sweep.py
// (a Pallas kernel launched by `cluster_march`). It computes the same
// function, not the same blocks: one thread block per chunk of `ray_tile`
// rays (128 on the main path), one thread per ray. The chunk walks its
// regular clusters in ascending chunk-entry order (`ids`/`ents`, sorted by
// the caller, with at least one +BIG sentinel slot at the end). Per slot the
// block copies the cluster's 12 x 4K column block and masks into shared
// memory; every thread forms its ray's four pair scalars per primitive, runs
// the sphere or triangle epilogue, and merges into its running best with a
// strict `<` (the lowest index wins ties, as in the reference). After each
// slot the block reduces max(min(t_best, gate)) over its rays and stops once
// that is not beyond the next slot's entry: no unvisited cluster can then
// beat any ray. The reference's W-wide windows are bit-identical to this
// one-cluster-per-slot march (cluster_sweep.py, _march_kernel's wide-visit
// note), so the port keeps only the latter.
//
// What bounds it on an H100: per-chunk latency. A sorted chunk marches only a
// few clusters (about 2.5 on the bunny), so a block does a few small shared
// memory loads and ~K x 100 scalar flops per thread between block-wide
// barriers; the kernel is far from the FLOP and memory-bandwidth roofs, and
// the launch is ~450 short blocks at the main path's 57,600 rays. The design
// keeps the whole march in one launch with no host round trip per slot.
// Tensor cores (wgmma), TMA copies of the column blocks and a persistent
// grid are left to later work.
//
// Arithmetic: the pair scalars, the sphere / triangle epilogue and the visit
// of one cluster come from sweep_common.cuh (shared with window_sweep.cu),
// so they round exactly like the separate PyTorch ops of the plain twin
// (`march_reference` in ops/cluster_sweep.py).

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using pt_sweep::kBig;
using pt_sweep::kFeat;
using pt_sweep::kOuts;

// Max over the block of `v`; every thread gets the result. `red` holds one
// float per warp.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();  // the previous call's readers are done with `red`
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < n_warps; ++w) m = fmaxf(m, red[w]);
  return m;
}

__global__ void __launch_bounds__(1024) cluster_march_kernel(
    const float* __restrict__ phi, const float* __restrict__ a,
    const float* __restrict__ gate, const int* __restrict__ ids,
    const float* __restrict__ ents, int n_slots,
    const float* __restrict__ cols, const int* __restrict__ is_sphere,
    const int* __restrict__ valid_row, const int* __restrict__ ctype, int K,
    float t_min, float t_max, float* __restrict__ t_out,
    int* __restrict__ best_out, int* __restrict__ slots_out) {
  extern __shared__ float smem[];
  __shared__ float s_red[32];
  const int width = kFeat * kOuts * K;  // floats per cluster column block
  float* s_cols = smem;
  int* s_sph = reinterpret_cast<int*>(smem + width);
  int* s_valid = s_sph + K;

  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const long long r = static_cast<long long>(chunk) * blockDim.x + tid;

  float p[kFeat];
#pragma unroll
  for (int f = 0; f < kFeat; ++f) p[f] = phi[r * kFeat + f];
  const float ai = a[r];
  const float inv_a = 1.0f / ai;
  const float g = gate[r];
  pt_sweep::Best best = {kBig, -1};

  const int* ids_c = ids + static_cast<long long>(chunk) * n_slots;
  const float* ents_c = ents + static_cast<long long>(chunk) * n_slots;
  int j = 0;
  for (; j < n_slots; ++j) {
    const float m = block_max(fminf(best.t, g), s_red);
    if (!(m > ents_c[j])) break;  // uniform across the block
    const int c = ids_c[j];
    pt_sweep::stage_cluster(cols, is_sphere, valid_row, c, K, s_cols, s_sph,
                            s_valid);
    __syncthreads();
    // ctype[c]: 0 mixed, 1 all-sphere, 2 all-triangle
    best = pt_sweep::sweep_cluster(p, ai, inv_a, s_cols, s_sph, s_valid,
                                   ctype[c], c, K, t_min, t_max, best);
    __syncthreads();  // all reads of this slot's block precede the next load
  }
  t_out[r] = best.t;
  best_out[r] = best.idx;
  if (tid == 0) slots_out[chunk] = j;
}

}  // namespace

// Launches the march on `stream`; returns the cudaError_t of the launch (0 on
// success). Shapes: phi (n_chunks*ray_tile, 12); a, gate, t_out, best_out
// (n_chunks*ray_tile,); ids, ents (n_chunks, n_slots); cols (C_tot, 12, 4K);
// is_sphere, valid_row (C_tot, K); ctype (C_tot,); slots_out (n_chunks,).
extern "C" int cluster_march_launch(
    const float* phi, const float* a, const float* gate, const int* ids,
    const float* ents, int n_chunks, int n_slots, int ray_tile,
    const float* cols, const int* is_sphere, const int* valid_row,
    const int* ctype, int K, float t_min, float t_max, float* t_out,
    int* best_out, int* slots_out, void* stream) {
  if (n_chunks == 0) return 0;
  const size_t smem = static_cast<size_t>(kFeat * kOuts * K + 2 * K) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cluster_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cluster_march_kernel<<<n_chunks, ray_tile, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      phi, a, gate, ids, ents, n_slots, cols, is_sphere, valid_row, ctype, K,
      t_min, t_max, t_out, best_out, slots_out);
  return static_cast<int>(cudaGetLastError());
}
