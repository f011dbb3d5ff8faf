// The bounce's shading step of the integrator: hit record, material scatter
// and path-state update, one thread a lane of the wavefront.
//
// Replaces no Pallas kernel. On the TPU, XLA fuses the JAX package's
// shading (pathtracer_tpu/render/integrator.py's bounce_step: the hit
// record from ops/intersect.hit_records_from_prims, scene/materials.scatter
// and the state update) into a few kernels; this kernel is the port's
// counterpart of that fusion. Its plain twin, `shade_reference` in
// pathtracer_tpu_torch/ops/shade.py, runs the same step as torch ops, some
// 340 of them a bounce, a launch each on the card.
//
// A lane reads its winner index, hit flag, ray (o, d) and path state
// (attenuation, emitted sum, alive, absorbed), and its six scatter uniforms
// and, under Russian roulette, one more. It gathers the winner's 64-byte
// row of the packed hit fields (ops/intersect.packed_hit_fields) as four
// float4 loads and the 48-byte row of its material
// (ops/shade.packed_material_fields) as three; then, in registers, it
// re-intersects the winner (sphere or triangle t), forms the hit point, the
// face normal and the sphere's UV, scatters by the material it has
// (lambertian with the nearest texel, metal with fuzz, dielectric with
// Schlick and refraction, emissive), and updates the state: emission,
// absorption, roulette, and the next ray. The twin evaluates every lobe for
// every lane and selects; a lane here evaluates only the lobe it selects,
// which gives the same values. It writes o, d, the attenuation, the
// emitted sum, alive and absorbed in place, so a bounce allocates nothing.
//
// Layouts: the attenuation and the emitted sum are three planes each, with
// one stride (3 for the columns of an (N, 3) tensor, 1 for the separate
// planes of the march's sorted payload). `absorbed` is a bool a lane, or,
// in the sorted wavefront, bit 29 of the payload's int32 flags word (ray id
// in bits 0-28, the NEE flag spec_prev in bit 30), decoded and encoded
// here.
//
// Arithmetic: the twin's, operation for operation and in its order. Every
// product goes through __fmul_rn, so no product is fused into a sum
// whatever the build's --fmad; division and sqrt are IEEE (__fdiv_rn,
// __fsqrt_rn); dot products sum x, y, z left to right, as core/vec.py
// does; clamps are fminf / fmaxf with NaN passed through, as torch's clamp
// kernels do; acosf, atan2f, sinf, cosf and powf are the CUDA math
// library's, which torch's CUDA ops call for float32. Python's float
// constants are rounded to float32 as torch rounds a scalar operand.
//
// What bounds it on an H100: the launch. A lane moves about 200 B (o, d,
// index, flags, attenuation, emitted sum and uniforms read, the state
// written, the two table rows, which stay in L2: 38 KB of rows on the
// triangle world, 232 KB on the bunny), so a 16,384-lane chunk moves about
// 3.3 MB, about 1 us at 3.35 TB/s, and its few hundred float32 operations
// a lane are less. The kernel's worth lies in the ~340 launches a bounce
// it removes. What the design does about it: one launch a bounce, the
// rows' loads issued together, dead lanes leave after touching their
// emitted sum.
//
// A winner index or material id outside its table fails a device-side
// assert (the twin's index raises there).

#include <cassert>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPrimRow = 16;   // floats of a packed hit-field row
constexpr int kMatRow = 12;    // floats of a packed material row
constexpr int kUniforms = 6;   // scatter uniforms a lane
constexpr int kAbsorbedBit = 29;
constexpr int kRidMask = (1 << kAbsorbedBit) - 1;

// scene/scene.py's tags
constexpr int kPrimSphere = 1;
constexpr int kMatLambertian = 1;
constexpr int kMatMetal = 2;
constexpr int kMatDielectric = 4;
constexpr int kMatEmissive = 8;

// core/vec.py's and the integrator's constants, rounded to float32 from
// the double as torch rounds a Python scalar
constexpr double kPiD = 3.1415926535897932385;
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kTwoPi = static_cast<float>(2.0 * kPiD);
constexpr float kPiInv = static_cast<float>(0.31830988618);
constexpr float kNearZero = static_cast<float>(1e-7);
constexpr float kPole = static_cast<float>(1e-12);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr float kRrContinue = static_cast<float>(0.8);
constexpr float kRrInvContinue = 1.25f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float divide(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
// s * a, a scalar a lane times each component
__device__ __forceinline__ V3 scale(float s, V3 a) {
  return {mul(s, a.x), mul(s, a.y), mul(s, a.z)};
}
__device__ __forceinline__ V3 mulv(V3 a, V3 b) {
  return {mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z)};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return mul(a.x, b.x) + mul(a.y, b.y) + mul(a.z, b.z);
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {mul(a.y, b.z) - mul(a.z, b.y), mul(a.z, b.x) - mul(a.x, b.z),
          mul(a.x, b.y) - mul(a.y, b.x)};
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// torch's clamp kernels: NaN passes, else fmaxf / fminf
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// core/vec.safe_sqrt: sqrt(x) where x > 0, else 0
__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? __fsqrt_rn(x) : 0.0f;
}

// core/vec.normalize: v / |v|
__device__ __forceinline__ V3 normalize(V3 a) {
  const float len = __fsqrt_rn(dot(a, a));
  return {divide(a.x, len), divide(a.y, len), divide(a.z, len)};
}

// core/sampling.uniform_on_sphere
__device__ __forceinline__ V3 on_sphere(float u1, float u2) {
  const float phi = mul(kTwoPi, u1);
  const float cos_t = 1.0f - mul(2.0f, u2);
  const float sin_t = __fsqrt_rn(clamp_min(1.0f - mul(cos_t, cos_t), 0.0f));
  return {mul(cosf(phi), sin_t), mul(sinf(phi), sin_t), cos_t};
}

// core/optics.reflect: v - 2 (v . n) n
__device__ __forceinline__ V3 reflect(V3 v, V3 n) {
  return sub(v, scale(mul(2.0f, dot(v, n)), n));
}

// core/optics.refract
__device__ __forceinline__ V3 refract(V3 uv, V3 n, float eta) {
  const float cos_t = clamp_max(dot(neg(uv), n), 1.0f);
  const V3 perp = scale(eta, add(uv, scale(cos_t, n)));
  const float a = fabsf(1.0f - dot(perp, perp));
  return add(perp, scale(-safe_sqrt(a), n));
}

// core/optics.reflectance (Schlick)
__device__ __forceinline__ float reflectance(float cosine, float ref_idx) {
  float r0 = divide(1.0f - ref_idx, ref_idx + 1.0f);
  r0 = mul(r0, r0);
  return r0 + mul(1.0f - r0, powf(1.0f - cosine, 5.0f));
}

__global__ void __launch_bounds__(kThreads) shade_bounce_kernel(
    long long n, const float* __restrict__ prims, long long n_prims,
    const float* __restrict__ mats, long long n_mats,
    const float* __restrict__ tex, int n_tex, int tex_h, int tex_w,
    const long long* __restrict__ idx,
    const unsigned char* __restrict__ hit_valid, float* __restrict__ o,
    float* __restrict__ d, float* a0, float* a1, float* a2,
    long long a_stride, float* e0, float* e1, float* e2, long long e_stride,
    unsigned char* __restrict__ alive, unsigned char* __restrict__ absorbed,
    int* __restrict__ flags, const float* __restrict__ u,
    const float* __restrict__ u_rr, float t_min, float t_max) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long ia = i * a_stride;
  const long long ie = i * e_stride;
  const V3 emitted = {e0[ie], e1[ie], e2[ie]};
  if (!(alive[i] != 0 && hit_valid[i] != 0)) {
    // the twin adds a zero to every lane's emitted sum, and a lane that
    // is dead or missed leaves the loop
    e0[ie] = emitted.x + 0.0f;
    e1[ie] = emitted.y + 0.0f;
    e2[ie] = emitted.z + 0.0f;
    alive[i] = 0;
    return;
  }

  // the winner's row: [type, v0, e1, e2, radius, tri_normal, mat, 0]
  const long long j = idx[i];
  assert(0 <= j && j < n_prims);
  const float4* row = reinterpret_cast<const float4*>(prims + j * kPrimRow);
  const float4 r0 = row[0];
  const float4 r1 = row[1];
  const float4 r2 = row[2];
  const float4 r3 = row[3];
  const bool is_sphere = static_cast<int>(r0.x) == kPrimSphere;
  const V3 v0 = {r0.y, r0.z, r0.w};
  const float radius = r2.z;
  const long long mat = static_cast<long long>(r3.z);
  assert(0 <= mat && mat < n_mats);
  const float4* mrow = reinterpret_cast<const float4*>(mats + mat * kMatRow);
  const float4 m0 = mrow[0];   // [type, albedo]
  const float4 m1 = mrow[1];   // [fuzz, ir, emit.x, emit.y]
  const float4 m2 = mrow[2];   // [emit.z, tex_id, 0, 0]

  const V3 ro = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const V3 rd = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};

  // ops/intersect.hit_records_from_prims: t of the winner, the hit point,
  // the face normal, the sphere's UV
  float t;
  if (is_sphere) {
    const V3 oc = sub(ro, v0);
    const float a = dot(rd, rd);
    const float half_b = dot(oc, rd);
    const float c = dot(oc, oc) - mul(radius, radius);
    const float disc = mul(half_b, half_b) - mul(a, c);
    const float sqrt_d = disc > 0.0f ? __fsqrt_rn(disc) : 0.0f;
    const float inv_a = divide(1.0f, a);
    const float root0 = mul(-half_b - sqrt_d, inv_a);
    const float root1 = mul(-half_b + sqrt_d, inv_a);
    const bool ok0 = !((root0 < t_min) || (t_max < root0));
    t = ok0 ? root0 : root1;
  } else {
    const V3 e1 = {r1.x, r1.y, r1.z};
    const V3 e2 = {r1.w, r2.x, r2.y};
    const V3 s1 = cross(rd, e2);
    const float det = dot(s1, e1);
    const float inv_det = divide(1.0f, det == 0.0f ? 1.0f : det);
    const V3 s2 = cross(sub(ro, v0), e1);
    t = mul(dot(s2, e2), inv_det);
  }
  const V3 p = add(ro, scale(t, rd));
  const float safe_r = radius == 0.0f ? 1.0f : radius;
  const V3 pc = sub(p, v0);
  const V3 sph_n = {divide(pc.x, safe_r), divide(pc.y, safe_r),
                    divide(pc.z, safe_r)};
  const V3 outward = is_sphere ? sph_n : V3{r2.w, r3.x, r3.y};
  const bool front_face = dot(rd, outward) < 0.0f;
  const V3 normal = sel(front_face, outward, neg(outward));
  float uv0 = 0.0f;
  float uv1 = 0.0f;
  if (is_sphere) {
    const float theta = acosf(clamp(-sph_n.y, -1.0f, 1.0f));
    const float x = sph_n.x;
    const float z = -sph_n.z;
    const bool on_pole = mul(x, x) + mul(z, z) < kPole;
    const float phi =
        atan2f(on_pole ? 0.0f : z, on_pole ? 1.0f : x) + kPi;
    uv0 = mul(mul(phi, 0.5f), kPiInv);
    uv1 = mul(theta, kPiInv);
  }

  // scene/materials.scatter, the lobe of the lane's material
  const int mtype = static_cast<int>(m0.x);
  const V3 albedo = {m0.y, m0.z, m0.w};
  const bool is_emissive = mtype == kMatEmissive;
  const float* ul = u + i * kUniforms;
  V3 direction = {0.0f, 0.0f, 0.0f};
  V3 attenuation = {1.0f, 1.0f, 1.0f};
  bool ok = !is_emissive;
  if (mtype == kMatLambertian) {
    direction = add(normal, on_sphere(ul[0], ul[1]));
    if (fabsf(direction.x) < kNearZero && fabsf(direction.y) < kNearZero &&
        fabsf(direction.z) < kNearZero) {
      direction = normal;
    }
    attenuation = albedo;
    const int tex_id = static_cast<int>(m2.y);
    if (n_tex > 0 && tex_id >= 0) {
      // materials.sample_texture: the nearest texel, v = 0 the bottom row
      // (the lower clamps keep a NaN uv inside the atlas, where the twin's
      // index raises)
      long long x = static_cast<long long>(
          mul(clamp(uv0, 0.0f, 1.0f), static_cast<float>(tex_w)));
      long long y = static_cast<long long>(
          mul(1.0f - clamp(uv1, 0.0f, 1.0f), static_cast<float>(tex_h)));
      x = x < 0 ? 0 : (x > tex_w - 1 ? tex_w - 1 : x);
      y = y < 0 ? 0 : (y > tex_h - 1 ? tex_h - 1 : y);
      const long long k = tex_id > n_tex - 1 ? n_tex - 1 : tex_id;
      const float* texel = tex + ((k * tex_h + y) * tex_w + x) * 3;
      attenuation = mulv(albedo, V3{texel[0], texel[1], texel[2]});
    }
  } else if (!is_emissive) {
    const V3 unit_in = normalize(rd);
    if (mtype == kMatMetal) {
      const float fuzz = m1.x;
      const V3 fuzz_vec = scale(powf(ul[4], kThird), on_sphere(ul[2], ul[3]));
      direction = add(reflect(unit_in, normal), scale(fuzz, fuzz_vec));
      ok = dot(direction, normal) > 0.0f;
      attenuation = albedo;
    } else {
      // the dielectric, and the twin's last branch for any other type
      const float ir = mtype == kMatDielectric ? m1.y : 1.0f;
      const float ratio = front_face ? divide(1.0f, ir) : ir;
      const float cos_t = clamp_max(dot(neg(unit_in), normal), 1.0f);
      const float sin_t = safe_sqrt(1.0f - mul(cos_t, cos_t));
      const bool cannot_refract = mul(ratio, sin_t) > 1.0f;
      const bool use_reflect =
          cannot_refract || reflectance(cos_t, ratio) > ul[5];
      direction = use_reflect ? reflect(unit_in, normal)
                              : refract(unit_in, normal, ratio);
    }
  }

  // render/integrator.trace's update (without NEE)
  const V3 atten = {a0[ia], a1[ia], a2[ia]};
  V3 emitted_new = add(emitted, V3{0.0f, 0.0f, 0.0f});
  if (is_emissive) {
    emitted_new = add(emitted, mulv(atten, V3{m1.z, m1.w, m2.x}));
  }
  e0[ie] = emitted_new.x;
  e1[ie] = emitted_new.y;
  e2[ie] = emitted_new.z;
  const int flag_word = flags != nullptr ? flags[i] : 0;
  bool is_absorbed = flags != nullptr ? ((flag_word >> kAbsorbedBit) & 1) != 0
                                      : absorbed[i] != 0;
  is_absorbed = is_absorbed || !ok || is_emissive;
  bool step = ok && !is_emissive;
  V3 bounce_atten = mulv(atten, attenuation);
  if (u_rr != nullptr) {
    const bool killed = step && u_rr[i] >= kRrContinue;
    bounce_atten = scale(step && !killed ? kRrInvContinue : 1.0f,
                         bounce_atten);
    step = step && !killed;
    is_absorbed = is_absorbed || killed;
  }
  if (step) {
    o[3 * i] = p.x;
    o[3 * i + 1] = p.y;
    o[3 * i + 2] = p.z;
    d[3 * i] = direction.x;
    d[3 * i + 1] = direction.y;
    d[3 * i + 2] = direction.z;
    a0[ia] = bounce_atten.x;
    a1[ia] = bounce_atten.y;
    a2[ia] = bounce_atten.z;
  }
  alive[i] = step ? 1 : 0;
  if (flags != nullptr) {
    flags[i] = (flag_word & kRidMask) |
               (static_cast<int>(is_absorbed) << kAbsorbedBit) |
               (((flag_word >> (kAbsorbedBit + 1)) & 1) << (kAbsorbedBit + 1));
  } else {
    absorbed[i] = is_absorbed ? 1 : 0;
  }
}

// The math library calls of the kernel, one a launch, for the card tests
// that hold them to torch's ops: 0 sinf(a), 1 cosf(a), 2 acosf(a),
// 3 atan2f(a, b), 4 powf(a, 5), 5 powf(a, 1/3), the exponents as the
// kernel passes them.
__global__ void __launch_bounds__(kThreads)
    shade_math_kernel(int fn, const float* __restrict__ a,
                      const float* __restrict__ b, long long n,
                      float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float x = a[i];
  float y;
  switch (fn) {
    case 0: y = sinf(x); break;
    case 1: y = cosf(x); break;
    case 2: y = acosf(x); break;
    case 3: y = atan2f(x, b[i]); break;
    case 4: y = powf(x, 5.0f); break;
    default: y = powf(x, kThird); break;
  }
  out[i] = y;
}

bool grid_for(long long n, dim3* grid) {
  const long long n_blocks = (n + kThreads - 1) / kThreads;
  if (n_blocks > 0x7FFFFFFFLL) return false;
  *grid = dim3(static_cast<unsigned>(n_blocks));
  return true;
}

}  // namespace

// Shades n lanes on `stream`, in place. `prims` (n_prims, 16) and `mats`
// (n_mats, 12) are the packed tables; `tex` (n_tex, tex_h, tex_w, 3), with
// n_tex 0 for none. `a0`-`a2` and `e0`-`e2` are the planes of the
// attenuation and the emitted sum, element i of plane k at ak[i * stride].
// Exactly one of `absorbed` (a bool a lane) and `flags` (the int32 payload
// word) is given; `u_rr` (n floats) is null without roulette. Returns
// cudaGetLastError() after the launch (0: launched), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int shade_bounce_launch(
    long long n, const float* prims, long long n_prims, const float* mats,
    long long n_mats, const float* tex, int n_tex, int tex_h, int tex_w,
    const long long* idx, const unsigned char* hit_valid, float* o, float* d,
    float* a0, float* a1, float* a2, long long a_stride, float* e0, float* e1,
    float* e2, long long e_stride, unsigned char* alive,
    unsigned char* absorbed, int* flags, const float* u, const float* u_rr,
    float t_min, float t_max, void* stream) {
  if (n < 0 || n_prims < 1 || n_mats < 1 || n_tex < 0 ||
      (n_tex > 0 && (tex_h < 1 || tex_w < 1)) ||
      (absorbed == nullptr) == (flags == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  dim3 grid;
  if (!grid_for(n, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  shade_bounce_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      n, prims, n_prims, mats, n_mats, tex, n_tex, tex_h, tex_w, idx,
      hit_valid, o, d, a0, a1, a2, a_stride, e0, e1, e2, e_stride, alive,
      absorbed, flags, u, u_rr, t_min, t_max);
  return static_cast<int>(cudaGetLastError());
}

// Launches shade_math_kernel: function `fn` (0-5 as above) of `a` (and
// `b` for atan2f) into `out`, n floats each.
extern "C" int shade_math_launch(int fn, const float* a, const float* b,
                                 long long n, float* out, void* stream) {
  if (n < 0 || fn < 0 || fn > 5 || (fn == 3 && b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  dim3 grid;
  if (!grid_for(n, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  shade_math_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fn, a, b, n, out);
  return static_cast<int>(cudaGetLastError());
}
