// Uniform draws of the path tracer: float32 in [0, 1), each a pure
// function of (key, counter), bit-equal to the plain twins in
// pathtracer_tpu_torch/core/random.py and so to jax.random's bits.
//
// Replaces no Pallas kernel. On the TPU, XLA compiles each draw set of the
// JAX renderer and integrator (jax.random.uniform over a key, or over
// fold_in keys by ray id: pathtracer_tpu/render/integrator.py's
// _uniform_by_ray) into one fusion; this kernel is the port's counterpart
// of that fusion. The plain twin dispatches one int64 torch op per word
// operation, 365 for a by-ray set and 185 for a flat set, each a launch on
// the card; this kernel is one launch per set.
//
// Modes (one thread per ray, or per element for "flat"; all sums are plain
// uint32 sums, so kernel and twin agree to the bit):
//   0 flat    out[i] = u(y0 ^ y1), (y0, y1) = threefry(key, (i >> 32, i))
//   1 by_ray  (kk0, kk1) = threefry(key, (0, rid)), once per ray; then
//             out[r, c] = u(y0 ^ y1), (y0, y1) = threefry(kk, (0, c))
// with u(b) = bitcast((b >> 9) | 0x3F800000) - 1.
//
// What bounds it on an H100: nothing at these sizes but the launch. A
// threefry2x32 block is about 80 int32 operations (20 rounds of add,
// rotate, xor, and 5 key injections). The main path's largest set, "by_ray"
// with m = 6 on a 57,600-ray wavefront, is 7 blocks a ray, about 32 M
// operations (1.9 us at the 16.7 T int32 operations a second of 132 SMs x
// 64 INT32 lanes x 1.98 GHz), and moves 0.23 MB of ray ids in and 1.38 MB
// of uniforms out (0.48 us at 3.35 TB/s). Both are below the few
// microseconds that one launch costs, so the kernel's worth lies in the
// launches it removes, not in its rate. What the design does about it: one
// launch per draw set, the by-ray fold-in block computed once per ray, and
// rotations by funnel shift. A thread writes its ray's m consecutive floats
// (m <= 6 on the main path); coalescing them through shared memory would
// save nothing measurable at this size.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFlat = 0;
constexpr int kByRay = 1;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0,
                                     int r1, int r2, int r3) {
  x0 += x1;
  x1 = rotl(x1, r0) ^ x0;
  x0 += x1;
  x1 = rotl(x1, r1) ^ x0;
  x0 += x1;
  x1 = rotl(x1, r2) ^ x0;
  x0 += x1;
  x1 = rotl(x1, r3) ^ x0;
}

// The threefry2x32 block function (20 rounds) on the counter (x0, x1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k1;
  x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k0;
  x1 += k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k1;
  x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

// The top 23 bits as the mantissa of a float in [1, 2), minus 1 (exact).
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__global__ void __launch_bounds__(kThreads)
    flat_uniforms_kernel(uint32_t k0, uint32_t k1, long long n,
                         float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t x0 = static_cast<uint32_t>(i >> 32);
  uint32_t x1 = static_cast<uint32_t>(i);
  threefry2x32(k0, k1, x0, x1);
  out[i] = unit_float(x0 ^ x1);
}

__global__ void __launch_bounds__(kThreads)
    ray_uniforms_kernel(uint32_t k0, uint32_t k1,
                        const int* __restrict__ rid, long long n_rays, int m,
                        float* __restrict__ out) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  uint32_t kk0 = 0u;
  uint32_t kk1 = static_cast<uint32_t>(rid[r]);
  threefry2x32(k0, k1, kk0, kk1);
  float* row = out + r * m;
  for (int c = 0; c < m; ++c) {
    uint32_t y0 = 0u;
    uint32_t y1 = static_cast<uint32_t>(c);
    threefry2x32(kk0, kk1, y0, y1);
    row[c] = unit_float(y0 ^ y1);
  }
}

}  // namespace

// Launches one draw set on `stream`: `mode` 0 or 1 as above; `rid` (n
// int32 ray ids) is unused by "flat", whose output is (n,); "by_ray"
// writes (n, m) row-major. Returns cudaGetLastError() after the launch (0:
// launched), or cudaErrorInvalidValue for a mode, m or n it does not take.
extern "C" int ray_uniforms_launch(int mode, uint32_t k0, uint32_t k1,
                                   const int* rid, long long n, int m,
                                   float* out, void* stream) {
  if (n < 0 || (mode != kFlat && mode != kByRay) ||
      (mode == kByRay && (m < 1 || rid == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long n_blocks = (n + kThreads - 1) / kThreads;
  if (n_blocks > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(n_blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kFlat) {
    flat_uniforms_kernel<<<grid, kThreads, 0, s>>>(k0, k1, n, out);
  } else {
    ray_uniforms_kernel<<<grid, kThreads, 0, s>>>(k0, k1, rid, n, m, out);
  }
  return static_cast<int>(cudaGetLastError());
}
