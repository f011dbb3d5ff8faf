// Pair-scalar closest-hit arithmetic shared by the port's sweep kernels
// (cluster_march.cu, dense_sweep.cu).
//
// Every per-(ray, primitive) scalar of the sphere and triangle tests is the
// dot product of the ray's 12 features phi = [d, o, o x d, o.d, |o|^2, 1]
// with one of the primitive's four 12-wide columns (ops/tensor_sweep.py in
// the port). The functions below are the kernels' copies of `contract` and
// `_epilogue_sphere` / `_epilogue_tri` there: the same operations in the
// same order. Built with --fmad=false and without fast math, every product,
// sum, division and square root rounds like the separate PyTorch ops of the
// plain twins, so a kernel and its twin agree to the bit.
#pragma once

namespace pt_sweep {

constexpr float kBig = 3.0e38f;
constexpr int kFeat = 12;
constexpr int kOuts = 4;

// sum_f p[f] * col[f * stride], left to right.
__device__ __forceinline__ float pair_scalar(const float* p,
                                             const float* col, int stride) {
  float s = p[0] * col[0];
#pragma unroll
  for (int f = 1; f < kFeat; ++f) s = s + p[f] * col[f * stride];
  return s;
}

// Sphere: B = oc.d, C0 = |oc|^2 - r^2, a = |d|^2 and inv_a = 1 / a. The near
// root when it lies in [t_min, t_max], else the far root.
__device__ __forceinline__ bool sphere_hit(float B, float C0, float a,
                                           float inv_a, float t_min,
                                           float t_max, float* t) {
  const float disc = B * B - a * C0;
  const float sqrt_d = disc > 0.0f ? sqrtf(disc) : 0.0f;
  const float root0 = (-B - sqrt_d) * inv_a;
  const float root1 = (-B + sqrt_d) * inv_a;
  const bool ok0 = !((root0 < t_min) || (t_max < root0));
  const bool ok1 = !((root1 < t_min) || (t_max < root1));
  *t = ok0 ? root0 : root1;
  return (disc >= 0.0f) && (ok0 || ok1);
}

// Triangle (Moller-Trumbore): det, t * det, b1 * det, b2 * det. Strict
// rejections: det == 0, b1 <= 0, b2 <= 0, b1 + b2 >= 1, t outside
// (t_min, t_max).
__device__ __forceinline__ bool triangle_hit(float det, float tdet,
                                             float b1det, float b2det,
                                             float t_min, float t_max,
                                             float* t) {
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  *t = tdet * inv_det;
  const float b1 = b1det * inv_det;
  const float b2 = b2det * inv_det;
  return !((det == 0.0f) || (b1 <= 0.0f) || (b2 <= 0.0f) ||
           (b1 + b2 >= 1.0f) || (*t <= t_min) || (*t >= t_max));
}

}  // namespace pt_sweep
