// Dense sweep: the closest hit of every ray against every primitive, for
// scenes too small to cluster (accel "pallas").
//
// Replaces the TPU kernel `_sweep_kernel` of pathtracer_tpu/ops/pallas_sweep.py
// (a Pallas kernel launched by `pallas_closest`). It computes the same
// function, not the same blocks. The TPU kernel ran a (ray tiles x prim
// tiles) grid whose prim axis was sequential, carrying (t, index) in its
// output block from one prim tile to the next. Here a block owns kLanes x
// kRT rays (each thread kRT of them, in registers) and walks only the real
// rows [lo, hi) of every prim tile (`ranges`; the padding rows after them
// are all-zero triangles, det == 0, which never hit), staging them a slice
// at a time into shared memory as 192-byte records (sweep_common.cuh). The
// block's threads form kGroups groups; group g sweeps every kGroups-th
// staged primitive, and the groups' partial
// results are merged at the end by the rule that gives the TPU kernel's
// first minimum (lowest index on a tie in t). Threads past the ragged end
// of the wavefront help stage but sweep and write nothing, so the caller
// needs no padding rays.
//
// What bounds it on an H100: instruction issue. A (ray, prim) pair costs at
// most 2 (sphere) or 4 (triangle) pair scalars of 12 products and 11 sums
// plus an epilogue: 61 or 106 separate fp32 operations, since the kernel is
// built --fmad=false to round like its plain twin. The triangle world's
// 90,000-ray camera wavefront against its 601 prims (DEF_PRIM_TILE 1,024,
// which pack_sweep_tables cuts to a 640-wide tile) is 54.1 M pairs, 4.46
// GFLOP of such operations at most, against 4.3 MB of ray features and
// 0.2 MB of columns: far above the card's bytes-per-FLOP line. What the
// design does about it: the first version read 48 scalar shared words per
// pair, formed four scalars for a sphere and swept the padding rows; now a
// thread reads 12 broadcast words per primitive and uses them for RT rays,
// a sphere forms two scalars, a triangle three (the fourth and the t tests
// only for the rare ray that passes the barycentric tests), and only real
// rows are swept. The parameters are constants, chosen on an H100 (PERF.md):
// kRT = 2 rays per thread, kGroups = 4 groups of kLanes = 128 threads (512
// threads, 256 rays per block), kSlice = 64 prims per staged run, copied
// with plain loads (a cp.async double buffer gained nothing here). This
// build issues about 55 instructions per sphere pair and 98 per triangle
// pair (its SASS), so issue, not shared memory, is the limit. The tensor
// cores stay unused: they would need split-precision products and give up
// the bit-equality with the twin.

#include <cassert>

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using pt_sweep::kBig;
using pt_sweep::kFeat;
using pt_sweep::kOuts;

constexpr int kRT = 2;
constexpr int kGroups = 4;
constexpr int kLanes = 128;
constexpr int kSlice = 64;
constexpr int kThreads = kGroups * kLanes;
constexpr size_t kSmem =
    pt_sweep::sweep_smem_bytes(1, kSlice, kGroups, kLanes, kRT);
static_assert(kThreads <= pt_sweep::kMaxThreads, "block too large");
static_assert(kSmem <= 48 * 1024, "needs the dynamic shared memory opt-in");

__global__ void __launch_bounds__(kThreads) dense_sweep_kernel(
    const float* __restrict__ phi, const float* __restrict__ a, int n_rays,
    const float* __restrict__ cols, const int* __restrict__ is_sphere,
    const int* __restrict__ ranges, int n_tiles, int tile, float t_min,
    float t_max, float* __restrict__ t_out, int* __restrict__ best_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int g = tid / kLanes;
  const int j = tid - g * kLanes;
  const long long r0 = static_cast<long long>(blockIdx.x) * kLanes * kRT;

  pt_sweep::RayTile<kRT> rt;
  bool any_live = false;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const long long r = r0 + j + i * kLanes;
    const bool live = r < n_rays;
    pt_sweep::load_ray(rt, i, phi, a, r, live);
    any_live = any_live || live;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int lo = ranges[2 * t];
    const int hi = ranges[2 * t + 1];
    assert(0 <= lo && lo <= hi && hi <= tile);
    const float* cols_t = cols + static_cast<long long>(t) * kFeat * kOuts *
                                     tile;
    const int* sph_t = is_sphere + static_cast<long long>(t) * tile;
    pt_sweep::run_pipeline<false>(
        (hi - lo + kSlice - 1) / kSlice,
        [&](int r, int b) {
          const int s = lo + r * kSlice;
          pt_sweep::stage_records<false>(
              cols_t, sph_t, tile, s, min(kSlice, hi - s),
              pt_sweep::run_buf(smem, 1, kSlice, b));
        },
        [&](int r, int b) {
          if (!any_live) return;
          const int s = lo + r * kSlice;
          pt_sweep::sweep_records<kRT>(
              rt, pt_sweep::run_buf(smem, 1, kSlice, b), g,
              min(kSlice, hi - s), kGroups, t * tile + s, t_min, t_max);
        });
  }
  float* s_t = pt_sweep::merge_t(smem, 1, kSlice);
  pt_sweep::merge_groups(rt, kGroups, g, j, kLanes, s_t,
                         reinterpret_cast<int*>(s_t + kThreads * kRT));
  if (g != 0) return;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const long long r = r0 + j + i * kLanes;
    if (r < n_rays) {
      t_out[r] = rt.best[i].t;
      best_out[r] = rt.best[i].idx;
    }
  }
}

}  // namespace

// Launches the sweep on `stream`; returns the cudaError_t of the launch (0 on
// success, cudaErrorInvalidValue for shapes it does not take). Shapes: phi
// (n_rays, 12); a, t_out, best_out (n_rays,); cols (n_tiles, 12, 4 * tile);
// is_sphere (n_tiles, tile); ranges (n_tiles, 2), the rows [lo, hi) of each
// tile that are swept (asserted on the device to lie in the tile). best_out
// is -1 where no primitive is hit.
extern "C" int dense_sweep_launch(const float* phi, const float* a, int n_rays,
                                  const float* cols, const int* is_sphere,
                                  const int* ranges, int n_tiles, int tile,
                                  float t_min, float t_max, float* t_out,
                                  int* best_out, void* stream) {
  if (tile <= 0 || n_tiles <= 0 || n_rays < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  constexpr long long per_block = static_cast<long long>(kLanes) * kRT;
  const int n_blocks = static_cast<int>((n_rays + per_block - 1) / per_block);
  dense_sweep_kernel<<<n_blocks, kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      phi, a, n_rays, cols, is_sphere, ranges, n_tiles, tile, t_min, t_max,
      t_out, best_out);
  return static_cast<int>(cudaGetLastError());
}
