// Stackless BVH traversal: the closest-hit kernel of the "bvh" route.
//
// Replaces no Pallas kernel. The JAX package runs this walk as one
// `jax.lax.while_loop` on the device (`traverse` in
// pathtracer_tpu/ops/traversal.py), a loop of gathers and selects over the
// whole wavefront that XLA compiles; this kernel is the port's counterpart
// of that loop. Its plain twin, `traverse_reference` in
// pathtracer_tpu_torch/ops/traversal.py, runs the same loop as torch ops
// from Python, about 232 of them a step, a launch each.
//
// One thread per ray. Each ray keeps (ptr, t_best, best) in registers and
// walks the fused node table until it reaches the done row or has taken
// `max_steps` steps. A step reads one row: the 16 floats (bmin, bmax, v0,
// e1, e2, radius) as four float4 loads and the int32 links (left, escape,
// primitive type, primitive id) as one int4. At an internal node a box hit
// descends to `left`, a miss follows `escape`; a leaf whose box is hit
// tests its primitive, keeps it only where t < t_best, and follows
// `escape`. The twin steps the whole wavefront in lockstep, but a ray's
// steps past the done row are exact no-ops there (the done row's inverted
// box never leads anywhere but back to itself, and it is no leaf), and
// both cap every ray at the same `max_steps`, so the per-ray loop gives
// the twin's bits.
//
// Arithmetic: the twin's, operation for operation, built with
// --fmad=false and no fast math (IEEE division and sqrt). The slab test's
// running bounds take an axis only where the comparison holds, so the NaN
// of an axis-aligned ray (0 * inf) falls through to the bound; fminf and
// fmaxf would order signed zeros their own way, so they are not used. Dot
// products sum x, y, z left to right, as core/vec.py does. 1 / d is the
// same in every step, so it is taken once a ray.
//
// What bounds it on an H100: the latency of the longest ray's chain of
// dependent row reads, not bytes or operations. The bunny's table is 7,238
// rows x 80 B (0.58 MB), which stays in L2, and a 57,600-ray wavefront
// needs a few microseconds of float32 operations over all its visits; but
// the longest ray takes some 1,050 steps, each of which must wait for the
// row that the last one chose. What the design does about it: the five
// loads of a row are issued together, the ray's state stays in registers,
// and nothing is synchronised across threads, so warps that finish early
// leave the SM to the rest. Ordering rays (by Morton code) or keeping the
// top of the tree in shared memory is later work.
//
// A pointer outside [0, n_rows) fails a device-side assert (the twin's
// index raises there).

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSphere = 1;   // scene/scene.py's PRIM_SPHERE

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// The slab test of ops/intersect.py::ray_aabb_hit on one ray and one box.
__device__ __forceinline__ bool box_hit(const float o[3], const float inv[3],
                                        const float bmin[3],
                                        const float bmax[3], float t_min,
                                        float t_max) {
  float tmin_r = t_min;
  float tmax_r = t_max;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (bmin[a] - o[a]) * inv[a];
    const float t1 = (bmax[a] - o[a]) * inv[a];
    const bool swap = inv[a] < 0.0f;
    const float lo = swap ? t1 : t0;
    const float hi = swap ? t0 : t1;
    tmin_r = lo > tmin_r ? lo : tmin_r;
    tmax_r = hi < tmax_r ? hi : tmax_r;
  }
  return !(tmax_r < tmin_r);
}

// ops/intersect.py::intersect_sphere: the nearer root in range, else the
// far root; `radius` is signed.
__device__ __forceinline__ bool sphere_hit(const float o[3], const float d[3],
                                           const float c[3], float radius,
                                           float t_min, float t_max,
                                           float* t) {
  const float ocx = o[0] - c[0];
  const float ocy = o[1] - c[1];
  const float ocz = o[2] - c[2];
  const float a = dot3(d[0], d[1], d[2], d[0], d[1], d[2]);
  const float half_b = dot3(ocx, ocy, ocz, d[0], d[1], d[2]);
  const float cc = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - radius * radius;
  const float disc = half_b * half_b - a * cc;
  const float sqrt_d = disc > 0.0f ? sqrtf(disc) : 0.0f;
  const float inv_a = 1.0f / a;
  const float root0 = (-half_b - sqrt_d) * inv_a;
  const float root1 = (-half_b + sqrt_d) * inv_a;
  const bool ok0 = !((root0 < t_min) || (t_max < root0));
  const bool ok1 = !((root1 < t_min) || (t_max < root1));
  *t = ok0 ? root0 : root1;
  return (disc >= 0.0f) && (ok0 || ok1);
}

// ops/intersect.py::intersect_triangle: Moller-Trumbore with the strict
// edge rejections and the det == 0 parallel reject.
__device__ __forceinline__ bool triangle_hit(const float o[3],
                                             const float d[3],
                                             const float v0[3],
                                             const float e1[3],
                                             const float e2[3], float t_min,
                                             float t_max, float* t) {
  const float s1x = d[1] * e2[2] - d[2] * e2[1];
  const float s1y = d[2] * e2[0] - d[0] * e2[2];
  const float s1z = d[0] * e2[1] - d[1] * e2[0];
  const float det = dot3(s1x, s1y, s1z, e1[0], e1[1], e1[2]);
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float sx = o[0] - v0[0];
  const float sy = o[1] - v0[1];
  const float sz = o[2] - v0[2];
  const float s2x = sy * e1[2] - sz * e1[1];
  const float s2y = sz * e1[0] - sx * e1[2];
  const float s2z = sx * e1[1] - sy * e1[0];
  const float tt = dot3(s2x, s2y, s2z, e2[0], e2[1], e2[2]) * inv_det;
  const float b1 = dot3(s1x, s1y, s1z, sx, sy, sz) * inv_det;
  const float b2 = dot3(s2x, s2y, s2z, d[0], d[1], d[2]) * inv_det;
  const float b12 = b1 + b2;
  const bool miss = (det == 0.0f) || (b1 >= 1.0f) || (b1 <= 0.0f) ||
                    (b2 >= 1.0f) || (b2 <= 0.0f) || (b12 <= 0.0f) ||
                    (b12 >= 1.0f) || (tt <= t_min) || (tt >= t_max);
  *t = tt;
  return !miss;
}

__global__ void __launch_bounds__(kThreads) bvh_traverse_kernel(
    const float* __restrict__ o_in, const float* __restrict__ d_in,
    long long n_rays, const float4* __restrict__ fdata,
    const int4* __restrict__ links, int n_rows, int done, int max_steps,
    float t_min, float t_max, long long* __restrict__ idx_out,
    float* __restrict__ t_out, unsigned char* __restrict__ valid_out) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  float o[3], d[3], inv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = o_in[3 * r + a];
    d[a] = d_in[3 * r + a];
    inv[a] = 1.0f / d[a];
  }
  int ptr = 0;
  float t_best = t_max;
  int best = -1;
  for (int steps = 0; ptr != done && steps < max_steps; ++steps) {
    assert(0 <= ptr && ptr < n_rows);
    const int4 link = links[ptr];
    const float4 f0 = fdata[4 * ptr];
    const float4 f1 = fdata[4 * ptr + 1];
    const float4 f2 = fdata[4 * ptr + 2];
    const float4 f3 = fdata[4 * ptr + 3];
    const float bmin[3] = {f0.x, f0.y, f0.z};
    const float bmax[3] = {f0.w, f1.x, f1.y};
    const bool hit_box = box_hit(o, inv, bmin, bmax, t_min, t_best);
    const bool is_leaf = link.z > 0;
    if (hit_box && is_leaf) {
      const float v0[3] = {f1.z, f1.w, f2.x};
      float t;
      bool hit;
      if (link.z == kSphere) {
        hit = sphere_hit(o, d, v0, f3.w, t_min, t_best, &t);
      } else {
        const float e1[3] = {f2.y, f2.z, f2.w};
        const float e2[3] = {f3.x, f3.y, f3.z};
        hit = triangle_hit(o, d, v0, e1, e2, t_min, t_best, &t);
      }
      if (hit && t < t_best) {
        t_best = t;
        best = link.w;
      }
    }
    ptr = (hit_box && !is_leaf) ? link.x : link.y;
  }
  const bool valid = best >= 0;
  idx_out[r] = valid ? best : 0;
  t_out[r] = t_best;
  valid_out[r] = valid ? 1 : 0;
}

}  // namespace

// Launches the traversal of `n_rays` rays on `stream`; returns the
// cudaError_t of the launch (0 on success, cudaErrorInvalidValue for
// arguments it does not take). o, d (n_rays, 3) float32; fdata (n_rows, 16)
// float32 and links (n_rows, 4) int32, both 16-byte aligned, with `done`
// the sentinel row; outputs idx (n_rays,) int64 (0 on a miss), t (n_rays,)
// float32 (t_max on a miss) and valid (n_rays,) bool as bytes.
extern "C" int bvh_traverse_launch(const float* o, const float* d,
                                   long long n_rays, const float* fdata,
                                   const int* links, int n_rows, int done,
                                   int max_steps, float t_min, float t_max,
                                   long long* idx, float* t,
                                   unsigned char* valid, void* stream) {
  if (n_rays < 0 || n_rows < 1 || done < 0 || done >= n_rows ||
      max_steps < 0 || reinterpret_cast<uintptr_t>(fdata) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(links) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  const long long n_blocks = (n_rays + kThreads - 1) / kThreads;
  if (n_blocks > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bvh_traverse_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      o, d, n_rays, reinterpret_cast<const float4*>(fdata),
      reinterpret_cast<const int4*>(links), n_rows, done, max_steps, t_min,
      t_max, idx, t, valid);
  return static_cast<int>(cudaGetLastError());
}
