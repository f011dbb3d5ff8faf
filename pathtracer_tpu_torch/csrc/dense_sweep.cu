// Dense sweep: the closest hit of every ray against every primitive, for
// scenes too small to cluster (accel "pallas").
//
// Replaces the TPU kernel `_sweep_kernel` of pathtracer_tpu/ops/pallas_sweep.py
// (a Pallas kernel launched by `pallas_closest`). It computes the same
// function, not the same blocks. The TPU kernel ran a (ray tiles x prim
// tiles) grid whose prim axis was sequential, carrying (t, index) in its
// output block from one prim tile to the next. Here one thread owns one ray
// and carries that pair in registers while a loop inside the block walks
// every primitive in ascending order: blocks of kBlock rays, and the prims
// staged kSlice at a time into shared memory (their 12 x 4 columns and
// masks, laid out as in the caller's tables), which every thread then reads
// by broadcast. Per primitive a thread forms its four pair scalars, runs the
// sphere or triangle epilogue and merges with a strict `<`, so the lowest
// index wins a tie in t, as the TPU kernel's in-tile argmin followed by its
// strict cross-tile merge does. Threads past the ragged end of the wavefront
// help stage the columns but compute and write nothing, so the caller needs
// no padding rays.
//
// What bounds it on an H100: operations. Each (ray, prim) pair costs 48
// multiplies, 44 adds and about 20 epilogue operations, all separate fp32
// instructions (--fmad=false, see sweep_common.cuh). At the triangle world's
// 90,000-ray camera wavefront (601 prims in one 640-wide tile) that is about
// 57.6 M pairs and 6.3 GFLOP, against 123 KB of columns and 4.3 MB of ray
// features; the kernel sits far above the card's bytes-per-FLOP line. This
// first version keeps the arithmetic on the CUDA cores (no wgmma, no TMA):
// the tensor cores would need the split-precision products the port has
// dropped to stay exact.

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using pt_sweep::kBig;
using pt_sweep::kFeat;
using pt_sweep::kOuts;

constexpr int kBlock = 128;  // rays per block, one per thread
constexpr int kSlice = 64;   // prims staged in shared memory per step

__global__ void __launch_bounds__(kBlock) dense_sweep_kernel(
    const float* __restrict__ phi, const float* __restrict__ a, int n_rays,
    const float* __restrict__ cols, const int* __restrict__ is_sphere,
    const int* __restrict__ valid_row, int n_tiles, int tile, float t_min,
    float t_max, float* __restrict__ t_out, int* __restrict__ best_out) {
  // s_cols[(f * kOuts + o) * kSlice + k]: feature f of output o, prim k
  __shared__ float s_cols[kFeat * kOuts * kSlice];
  __shared__ int s_sph[kSlice];
  __shared__ int s_valid[kSlice];

  const int tid = threadIdx.x;
  const long long r = static_cast<long long>(blockIdx.x) * kBlock + tid;
  const bool live = r < n_rays;

  float p[kFeat];
#pragma unroll
  for (int f = 0; f < kFeat; ++f) p[f] = live ? phi[r * kFeat + f] : 0.0f;
  const float ai = live ? a[r] : 1.0f;
  const float inv_a = 1.0f / ai;
  float t_acc = kBig;
  int b_acc = -1;

  const int row = kOuts * tile;  // floats per feature row of one tile
  for (int t = 0; t < n_tiles; ++t) {
    const float* cols_t = cols + static_cast<long long>(t) * kFeat * row;
    const int base = t * tile;
    for (int k0 = 0; k0 < tile; k0 += kSlice) {
      for (int i = tid; i < kFeat * kOuts * kSlice; i += kBlock) {
        const int fo = i / kSlice;  // f * kOuts + o
        s_cols[i] = cols_t[(fo / kOuts) * row + (fo % kOuts) * tile + k0 +
                           (i % kSlice)];
      }
      for (int i = tid; i < kSlice; i += kBlock) {
        s_sph[i] = is_sphere[base + k0 + i];
        s_valid[i] = valid_row[base + k0 + i];
      }
      __syncthreads();
      if (live) {
        for (int k = 0; k < kSlice; ++k) {
          if (s_valid[k] == 0) continue;
          float S[kOuts];
#pragma unroll
          for (int o = 0; o < kOuts; ++o) {
            S[o] = pt_sweep::pair_scalar(p, s_cols + o * kSlice + k,
                                         kOuts * kSlice);
          }
          float th;
          const bool hit =
              s_sph[k] != 0
                  ? pt_sweep::sphere_hit(S[0], S[1], ai, inv_a, t_min, t_max,
                                         &th)
                  : pt_sweep::triangle_hit(S[0], S[1], S[2], S[3], t_min,
                                           t_max, &th);
          if (hit && th < t_acc) {
            t_acc = th;
            b_acc = base + k0 + k;
          }
        }
      }
      __syncthreads();  // all reads of this slice precede the next load
    }
  }
  if (live) {
    t_out[r] = t_acc;
    best_out[r] = b_acc;
  }
}

}  // namespace

// Launches the sweep on `stream`; returns the cudaError_t of the launch (0 on
// success, cudaErrorInvalidValue for a tile that is not a positive multiple
// of 64). Shapes: phi (n_rays, 12); a, t_out, best_out (n_rays,); cols
// (n_tiles, 12, 4 * tile); is_sphere, valid_row (n_tiles, tile). best_out is
// -1 where no primitive is hit.
extern "C" int dense_sweep_launch(const float* phi, const float* a, int n_rays,
                                  const float* cols, const int* is_sphere,
                                  const int* valid_row, int n_tiles, int tile,
                                  float t_min, float t_max, float* t_out,
                                  int* best_out, void* stream) {
  if (tile <= 0 || tile % kSlice != 0 || n_tiles <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  const int n_blocks = (n_rays + kBlock - 1) / kBlock;
  dense_sweep_kernel<<<n_blocks, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      phi, a, n_rays, cols, is_sphere, valid_row, n_tiles, tile, t_min, t_max,
      t_out, best_out);
  return static_cast<int>(cudaGetLastError());
}
