// Pair-scalar closest-hit arithmetic shared by the port's sweep kernels
// (cluster_march.cu, dense_sweep.cu, window_sweep.cu).
//
// Every per-(ray, primitive) scalar of the sphere and triangle tests is the
// dot product of the ray's 12 features phi = [d, o, o x d, o.d, |o|^2, 1]
// with one of the primitive's four 12-wide columns (ops/tensor_sweep.py in
// the port). The functions below are the kernels' copies of `contract` and
// `_epilogue_sphere` / `_epilogue_tri` there: the same operations in the
// same order. Built with --fmad=false and without fast math, every product,
// sum, division and square root rounds like the separate PyTorch ops of the
// plain twins, so a kernel and its twin agree to the bit.
//
// The two cluster kernels (march and window sweep) also share the visit of
// one cluster: `stage_cluster` copies its column block and masks into
// shared memory, `sweep_cluster` runs one ray against its K primitives.
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

// Copies cluster c of the cluster tables into shared memory, every thread of
// the block striding: its kFeat x kOuts*K column block (cols is (C_tot,
// kFeat, kOuts*K)) into s_cols, and its is_sphere / valid_row rows (each
// (C_tot, K)) into s_sph / s_valid. The caller synchronises before reading.
// The stride is a signed int: striding by the unsigned blockDim.x made
// ptxas give the march 32 registers and a spill instead of 55 registers,
// and the march ~20% slower on an H100.
__device__ __forceinline__ void stage_cluster(
    const float* __restrict__ cols, const int* __restrict__ is_sphere,
    const int* __restrict__ valid_row, int c, int K, float* s_cols,
    int* s_sph, int* s_valid) {
  const int width = kFeat * kOuts * K;
  const int tid = threadIdx.x;
  const int n = blockDim.x;
  const float* src = cols + static_cast<long long>(c) * width;
  for (int i = tid; i < width; i += n) s_cols[i] = src[i];
  for (int i = tid; i < K; i += n) {
    s_sph[i] = is_sphere[c * K + i];
    s_valid[i] = valid_row[c * K + i];
  }
}

// A ray's running closest hit: t and the winner's global index (-1: none).
struct Best {
  float t;
  int idx;
};

// One ray (features p, a = |d|^2, inv_a = 1 / a) against the K staged
// primitives of cluster c, in ascending k: a hit in the window replaces
// `best` only where strictly nearer, so the lowest global index c * K + k
// wins a tie. ct says how a primitive is typed: 1 all-sphere, 2
// all-triangle, 0 each by its own s_sph row. The running best goes in and
// out by value, so it stays in registers.
__device__ __forceinline__ Best sweep_cluster(
    const float* p, float a, float inv_a, const float* s_cols,
    const int* s_sph, const int* s_valid, int ct, int c, int K, float t_min,
    float t_max, Best best) {
  for (int k = 0; k < K; ++k) {
    if (s_valid[k] == 0) continue;
    float S[kOuts];
#pragma unroll
    for (int o = 0; o < kOuts; ++o) {
      // feature f of output o at s_cols[f * kOuts * K + o * K + k]
      S[o] = pair_scalar(p, s_cols + o * K + k, kOuts * K);
    }
    const bool sph = (ct == 1) || (ct == 0 && s_sph[k] != 0);
    float t;
    const bool hit =
        sph ? sphere_hit(S[0], S[1], a, inv_a, t_min, t_max, &t)
            : triangle_hit(S[0], S[1], S[2], S[3], t_min, t_max, &t);
    if (hit && t < best.t) {
      best.t = t;
      best.idx = c * K + k;
    }
  }
  return best;
}

}  // namespace pt_sweep
