// The bounce's shading step of the integrator: hit record, material scatter
// and path-state update, one thread a lane of the wavefront; under
// next-event estimation (NEE), the same around the bounce's shadow query.
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
// Under NEE the bounce's shadow query comes between the light sample and the
// emitted sum, so the step is two kernels around it (ops/shade.shade_nee and
// shade_nee_finish; twins render/integrator.shade_nee_reference and
// ops/shade.shade_nee_finish_reference, the integrator's torch composition
// split at the query). shade_nee_kernel does all of the bounce that does not
// wait on the query: the hit record and scatter above, the balance-heuristic
// weight of a BSDF-sampled emitter hit, emission and absorption, one light
// sample from the packed light table (ops/shade.packed_light_fields, one
// 80-byte row an emitter), its shadow ray and its contribution should nothing
// occlude it, the next bounce's pdf and spec_prev, roulette and the next ray.
// Only those three floats a lane cross the query; shade_nee_finish_kernel
// adds them where the segment is unoccluded. A lane moves about 210 B in the
// first and 40 B in the second, so the pair's worth is, again, the ~600
// launches a bounce they replace.
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
constexpr int kLightRow = 20;  // floats of a packed light row
constexpr int kUniforms = 6;   // scatter uniforms a lane
constexpr int kNeeUniforms = 3;  // light-sample uniforms a lane
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
constexpr float kFourPi = static_cast<float>(4.0 * kPiD);
constexpr float kPiInv = static_cast<float>(0.31830988618);
constexpr float kNearZero = static_cast<float>(1e-7);
constexpr float kPole = static_cast<float>(1e-12);
constexpr float kThird = static_cast<float>(1.0 / 3.0);
constexpr float kRrContinue = static_cast<float>(0.8);
constexpr float kRrInvContinue = 1.25f;
// render/lights.py's clamps
constexpr float kMin8 = static_cast<float>(1e-8);
constexpr float kMin12 = static_cast<float>(1e-12);
constexpr float kMin20 = static_cast<float>(1e-20);
constexpr float kMinFuzz = static_cast<float>(1e-4);

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

// A row of the packed hit fields (ops/intersect.packed_hit_fields), four
// float4 loads: [type, v0, e1, e2, radius, tri_normal, mat, 0]. The light
// table's rows (ops/shade.packed_light_fields) start with the same 14
// floats.
struct PrimRow {
  bool is_sphere;
  V3 v0, e1, e2, tri_n;
  float radius;
  float r3z, r3w;  // the hit row's material id; the light row's emit.x, .y
};

__device__ __forceinline__ PrimRow load_prim(const float* rows, long long j,
                                             int row_floats) {
  const float4* row = reinterpret_cast<const float4*>(rows + j * row_floats);
  const float4 r0 = row[0];
  const float4 r1 = row[1];
  const float4 r2 = row[2];
  const float4 r3 = row[3];
  return {static_cast<int>(r0.x) == kPrimSphere,
          {r0.y, r0.z, r0.w},
          {r1.x, r1.y, r1.z},
          {r1.w, r2.x, r2.y},
          {r2.w, r3.x, r3.y},
          r2.z,
          r3.z,
          r3.w};
}

// A packed material row (ops/shade.packed_material_fields), three float4
// loads: [type, albedo], [fuzz, ir, emit.x, emit.y], [emit.z, tex_id, 0, 0]
struct Material {
  int type;
  V3 albedo;
  float fuzz, ir;
  V3 emit;
  int tex_id;
};

__device__ __forceinline__ Material load_material(const float* mats,
                                                  long long m) {
  const float4* mrow = reinterpret_cast<const float4*>(mats + m * kMatRow);
  const float4 m0 = mrow[0];
  const float4 m1 = mrow[1];
  const float4 m2 = mrow[2];
  return {static_cast<int>(m0.x), {m0.y, m0.z, m0.w}, m1.x, m1.y,
          {m1.z, m1.w, m2.x}, static_cast<int>(m2.y)};
}

struct Hit {
  V3 p, normal;
  float t, uv0, uv1;
  bool front_face;
};

// ops/intersect.hit_records_from_prims: t of the winner, the hit point, the
// face normal, the sphere's UV
__device__ __forceinline__ Hit hit_record(const PrimRow& w, V3 ro, V3 rd,
                                          float t_min, float t_max) {
  Hit h;
  if (w.is_sphere) {
    const V3 oc = sub(ro, w.v0);
    const float a = dot(rd, rd);
    const float half_b = dot(oc, rd);
    const float c = dot(oc, oc) - mul(w.radius, w.radius);
    const float disc = mul(half_b, half_b) - mul(a, c);
    const float sqrt_d = disc > 0.0f ? __fsqrt_rn(disc) : 0.0f;
    const float inv_a = divide(1.0f, a);
    const float root0 = mul(-half_b - sqrt_d, inv_a);
    const float root1 = mul(-half_b + sqrt_d, inv_a);
    const bool ok0 = !((root0 < t_min) || (t_max < root0));
    h.t = ok0 ? root0 : root1;
  } else {
    const V3 s1 = cross(rd, w.e2);
    const float det = dot(s1, w.e1);
    const float inv_det = divide(1.0f, det == 0.0f ? 1.0f : det);
    const V3 s2 = cross(sub(ro, w.v0), w.e1);
    h.t = mul(dot(s2, w.e2), inv_det);
  }
  h.p = add(ro, scale(h.t, rd));
  const float safe_r = w.radius == 0.0f ? 1.0f : w.radius;
  const V3 pc = sub(h.p, w.v0);
  const V3 sph_n = {divide(pc.x, safe_r), divide(pc.y, safe_r),
                    divide(pc.z, safe_r)};
  const V3 outward = w.is_sphere ? sph_n : w.tri_n;
  h.front_face = dot(rd, outward) < 0.0f;
  h.normal = sel(h.front_face, outward, neg(outward));
  h.uv0 = 0.0f;
  h.uv1 = 0.0f;
  if (w.is_sphere) {
    const float theta = acosf(clamp(-sph_n.y, -1.0f, 1.0f));
    const float x = sph_n.x;
    const float z = -sph_n.z;
    const bool on_pole = mul(x, x) + mul(z, z) < kPole;
    const float phi =
        atan2f(on_pole ? 0.0f : z, on_pole ? 1.0f : x) + kPi;
    h.uv0 = mul(mul(phi, 0.5f), kPiInv);
    h.uv1 = mul(theta, kPiInv);
  }
  return h;
}

struct Scattered {
  V3 direction, attenuation;
  V3 reflected;  // the metal's mirror direction (its lobe's axis)
  bool ok;
};

// scene/materials.scatter, the lobe of the lane's material
__device__ __forceinline__ Scattered scatter(const Material& m, const Hit& h,
                                             V3 rd, const float* ul,
                                             const float* tex, int n_tex,
                                             int tex_h, int tex_w) {
  Scattered s = {{0.0f, 0.0f, 0.0f}, {1.0f, 1.0f, 1.0f}, {0.0f, 0.0f, 0.0f},
                 m.type != kMatEmissive};
  if (m.type == kMatLambertian) {
    s.direction = add(h.normal, on_sphere(ul[0], ul[1]));
    if (fabsf(s.direction.x) < kNearZero && fabsf(s.direction.y) < kNearZero &&
        fabsf(s.direction.z) < kNearZero) {
      s.direction = h.normal;
    }
    s.attenuation = m.albedo;
    if (n_tex > 0 && m.tex_id >= 0) {
      // materials.sample_texture: the nearest texel, v = 0 the bottom row
      // (the lower clamps keep a NaN uv inside the atlas, where the twin's
      // index raises)
      long long x = static_cast<long long>(
          mul(clamp(h.uv0, 0.0f, 1.0f), static_cast<float>(tex_w)));
      long long y = static_cast<long long>(
          mul(1.0f - clamp(h.uv1, 0.0f, 1.0f), static_cast<float>(tex_h)));
      x = x < 0 ? 0 : (x > tex_w - 1 ? tex_w - 1 : x);
      y = y < 0 ? 0 : (y > tex_h - 1 ? tex_h - 1 : y);
      const long long k = m.tex_id > n_tex - 1 ? n_tex - 1 : m.tex_id;
      const float* texel = tex + ((k * tex_h + y) * tex_w + x) * 3;
      s.attenuation = mulv(m.albedo, V3{texel[0], texel[1], texel[2]});
    }
  } else if (m.type != kMatEmissive) {
    const V3 unit_in = normalize(rd);
    if (m.type == kMatMetal) {
      const V3 fuzz_vec = scale(powf(ul[4], kThird), on_sphere(ul[2], ul[3]));
      s.reflected = reflect(unit_in, h.normal);
      s.direction = add(s.reflected, scale(m.fuzz, fuzz_vec));
      s.ok = dot(s.direction, h.normal) > 0.0f;
      s.attenuation = m.albedo;
    } else {
      // the dielectric, and the twin's last branch for any other type
      const float ir = m.type == kMatDielectric ? m.ir : 1.0f;
      const float ratio = h.front_face ? divide(1.0f, ir) : ir;
      const float cos_t = clamp_max(dot(neg(unit_in), h.normal), 1.0f);
      const float sin_t = safe_sqrt(1.0f - mul(cos_t, cos_t));
      const bool cannot_refract = mul(ratio, sin_t) > 1.0f;
      const bool use_reflect =
          cannot_refract || reflectance(cos_t, ratio) > ul[5];
      s.direction = use_reflect ? reflect(unit_in, h.normal)
                                : refract(unit_in, h.normal, ratio);
    }
  }
  return s;
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

  const long long j = idx[i];
  assert(0 <= j && j < n_prims);
  const PrimRow w = load_prim(prims, j, kPrimRow);
  const long long mat = static_cast<long long>(w.r3z);
  assert(0 <= mat && mat < n_mats);
  const Material m = load_material(mats, mat);
  const V3 ro = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const V3 rd = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const Hit h = hit_record(w, ro, rd, t_min, t_max);
  const bool is_emissive = m.type == kMatEmissive;
  const Scattered sc =
      scatter(m, h, rd, u + i * kUniforms, tex, n_tex, tex_h, tex_w);

  // render/integrator.trace's update (without NEE)
  const V3 atten = {a0[ia], a1[ia], a2[ia]};
  V3 emitted_new = add(emitted, V3{0.0f, 0.0f, 0.0f});
  if (is_emissive) {
    emitted_new = add(emitted, mulv(atten, m.emit));
  }
  e0[ie] = emitted_new.x;
  e1[ie] = emitted_new.y;
  e2[ie] = emitted_new.z;
  const int flag_word = flags != nullptr ? flags[i] : 0;
  bool is_absorbed = flags != nullptr ? ((flag_word >> kAbsorbedBit) & 1) != 0
                                      : absorbed[i] != 0;
  is_absorbed = is_absorbed || !sc.ok || is_emissive;
  bool step = sc.ok && !is_emissive;
  V3 bounce_atten = mulv(atten, sc.attenuation);
  if (u_rr != nullptr) {
    const bool killed = step && u_rr[i] >= kRrContinue;
    bounce_atten = scale(step && !killed ? kRrInvContinue : 1.0f,
                         bounce_atten);
    step = step && !killed;
    is_absorbed = is_absorbed || killed;
  }
  if (step) {
    o[3 * i] = h.p.x;
    o[3 * i + 1] = h.p.y;
    o[3 * i + 2] = h.p.z;
    d[3 * i] = sc.direction.x;
    d[3 * i + 1] = sc.direction.y;
    d[3 * i + 2] = sc.direction.z;
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

// render/lights.metal_lobe_pdf: the fuzzy metal's solid-angle density at
// the unit direction w about the unit mirror direction r; t^3 as torch's
// pow(t, 3) computes it, (t * t) * t
__device__ __forceinline__ float cube(float x) { return mul(mul(x, x), x); }

__device__ __forceinline__ float metal_lobe_pdf(V3 w, V3 r, float fuzz) {
  const float f = clamp_min(fuzz, kMinFuzz);
  const float b = dot(w, r);
  const float disc = (mul(b, b) - 1.0f) + mul(f, f);
  const float sq = __fsqrt_rn(clamp_min(disc, 0.0f));
  const bool inside = disc > 0.0f && b + sq > 0.0f;
  const float t1 = clamp_min(b - sq, 0.0f);
  const float t2 = clamp_min(b + sq, 0.0f);
  const float pdf = divide(cube(t2) - cube(t1), mul(kFourPi, cube(f)));
  return inside ? pdf : 0.0f;
}

__device__ __forceinline__ float length(V3 a) { return __fsqrt_rn(dot(a, a)); }

// The bounce under NEE up to its shadow query (render/integrator.nee_bounce,
// twin render/integrator.shade_nee_reference): the hit record and the
// scatter as above, the balance-heuristic weight of a BSDF-sampled emitter
// hit (render/lights.bsdf_hit_light_weight), emission and absorption, the
// light sample (render/lights.sample_lights) with its shadow ray and its
// contribution were it unoccluded, the next bounce's pdf and spec_prev,
// roulette and the next ray. Every lane evaluates its hit record, scatter
// and light sample, as the twin does, so the shadow query gets the twin's
// segments on every lane; the state changes only where the lane is alive
// and hit.
__global__ void __launch_bounds__(kThreads) shade_nee_kernel(
    long long n, const float* __restrict__ prims, long long n_prims,
    const float* __restrict__ mats, long long n_mats,
    const float* __restrict__ tex, int n_tex, int tex_h, int tex_w,
    const float* __restrict__ lights, long long n_lights,
    const long long* __restrict__ idx,
    const unsigned char* __restrict__ hit_valid, float* __restrict__ o,
    float* __restrict__ d, float* a0, float* a1, float* a2,
    long long a_stride, float* e0, float* e1, float* e2, long long e_stride,
    unsigned char* __restrict__ alive, unsigned char* __restrict__ absorbed,
    int* __restrict__ flags, unsigned char* __restrict__ spec_prev,
    float* __restrict__ prev_pdf, const float* __restrict__ u,
    const float* __restrict__ u_nee, const float* __restrict__ u_rr,
    float t_min, float t_max, bool handles_dead,
    float* __restrict__ sh_origin, float* __restrict__ sh_seg,
    float* __restrict__ cand, unsigned char* __restrict__ take) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long ia = i * a_stride;
  const long long ie = i * e_stride;
  const float n_lights_f = static_cast<float>(n_lights);

  const long long j = idx[i];
  assert(0 <= j && j < n_prims);
  const PrimRow w = load_prim(prims, j, kPrimRow);
  const long long mat = static_cast<long long>(w.r3z);
  assert(0 <= mat && mat < n_mats);
  const Material m = load_material(mats, mat);
  const V3 ro = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const V3 rd = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const Hit h = hit_record(w, ro, rd, t_min, t_max);
  const bool is_emissive = m.type == kMatEmissive;
  const bool is_glossy = m.type == kMatMetal && m.fuzz > 0.0f;
  const bool is_specular = m.type == kMatMetal || m.type == kMatDielectric;
  const Scattered sc =
      scatter(m, h, rd, u + i * kUniforms, tex, n_tex, tex_h, tex_w);

  const int flag_word = flags != nullptr ? flags[i] : 0;
  const bool spec = flags != nullptr
                        ? ((flag_word >> (kAbsorbedBit + 1)) & 1) != 0
                        : spec_prev[i] != 0;
  bool is_absorbed = flags != nullptr ? ((flag_word >> kAbsorbedBit) & 1) != 0
                                      : absorbed[i] != 0;
  const float pdf_prev = prev_pdf[i];

  // the balance-heuristic weight of an emitter hit, against sampling it as
  // a light: the hit prim's area and the solid angle of the last step
  const float area = w.is_sphere
                         ? mul(mul(kFourPi, w.radius), w.radius)
                         : mul(0.5f, length(cross(w.e1, w.e2)));
  const float d_len = length(rd);
  const float dist = mul(h.t, d_len);
  const float cos_hit =
      divide(fabsf(dot(h.normal, rd)), clamp_min(d_len, kMin12));
  const float p_hit_light =
      divide(mul(dist, dist),
             mul(mul(clamp_min(cos_hit, kMin8), clamp_min(area, kMin12)),
                 n_lights_f));
  const float emit_w =
      spec ? 1.0f
           : divide(pdf_prev, clamp_min(pdf_prev + p_hit_light, kMin20));

  // emission and absorption
  const bool active = alive[i] != 0 && hit_valid[i] != 0;
  const bool hit_emitter = active && is_emissive;
  const V3 atten = {a0[ia], a1[ia], a2[ia]};
  const V3 emitted = {e0[ie], e1[ie], e2[ie]};
  V3 emitted_new = add(emitted, V3{0.0f, 0.0f, 0.0f});
  if (hit_emitter) {
    emitted_new = add(emitted, scale(emit_w, mulv(atten, m.emit)));
  }
  e0[ie] = emitted_new.x;
  e1[ie] = emitted_new.y;
  e2[ie] = emitted_new.z;
  is_absorbed = is_absorbed || (active && !is_emissive && !sc.ok) ||
                hit_emitter;
  bool step = active && sc.ok && !is_emissive;
  const bool take_direct =
      active && !is_emissive && (m.type == kMatLambertian || is_glossy);

  // the light sample: one light, uniform in the choice, and one point,
  // uniform in its area (a triangle's barycentrics, a sphere's surface)
  const float* ul = u_nee + i * kNeeUniforms;
  long long li = static_cast<long long>(mul(ul[0], n_lights_f));
  li = li < 0 ? 0 : (li > n_lights - 1 ? n_lights - 1 : li);
  const PrimRow lw = load_prim(lights, li, kLightRow);
  const V3 l_emit = {lw.r3z, lw.r3w, lights[li * kLightRow + 16]};
  V3 l_point;
  V3 l_normal;
  float l_area;
  if (lw.is_sphere) {
    const V3 omega = on_sphere(ul[1], ul[2]);
    const float r_abs = fabsf(lw.radius);
    l_point = add(lw.v0, scale(r_abs, omega));
    l_normal = omega;
    l_area = mul(mul(kFourPi, r_abs), r_abs);
  } else {
    const float sq = __fsqrt_rn(ul[1]);
    const float b1 = 1.0f - sq;
    const float b2 = mul(ul[2], sq);
    l_point = add(add(lw.v0, scale(b1, lw.e1)), scale(b2, lw.e2));
    l_normal = lw.tri_n;
    l_area = mul(0.5f, length(cross(lw.e1, lw.e2)));
  }
  const float l_pdf =
      divide(1.0f, mul(clamp_min(l_area, kMin12), n_lights_f));

  // its shadow ray, eps off the surface along the normal, and what it
  // brings should nothing occlude the segment (render/lights.direct_lighting)
  const V3 origin = add(h.p, scale(t_min, h.normal));
  const V3 seg = sub(l_point, origin);
  const float dist2 = dot(seg, seg);
  const float inv_dist = divide(1.0f, __fsqrt_rn(clamp_min(dist2, kMin12)));
  const float cos_s = mul(dot(h.normal, seg), inv_dist);
  const float cos_l = mul(fabsf(dot(l_normal, seg)), inv_dist);
  const float p_lobe =
      is_glossy ? metal_lobe_pdf(scale(inv_dist, seg), sc.reflected, m.fuzz)
                : mul(clamp_min(cos_s, 0.0f), kPiInv);
  V3 direct = {0.0f, 0.0f, 0.0f};
  if (cos_s > 0.0f && cos_l > 0.0f && p_lobe > 0.0f) {
    const float geom =
        divide(mul(p_lobe, cos_l), mul(clamp_min(dist2, kMin12), l_pdf));
    const float p_light = divide(mul(l_pdf, dist2), clamp_min(cos_l, kMin8));
    direct = scale(divide(p_light, p_light + p_lobe),
                   mulv(scale(geom, sc.attenuation), l_emit));
  }
  const V3 c = take_direct ? mulv(atten, direct) : V3{0.0f, 0.0f, 0.0f};
  const V3 seg_q =
      handles_dead && !take_direct ? V3{0.0f, 0.0f, 0.0f} : seg;
  sh_origin[3 * i] = origin.x;
  sh_origin[3 * i + 1] = origin.y;
  sh_origin[3 * i + 2] = origin.z;
  sh_seg[3 * i] = seg_q.x;
  sh_seg[3 * i + 1] = seg_q.y;
  sh_seg[3 * i + 2] = seg_q.z;
  cand[3 * i] = c.x;
  cand[3 * i + 1] = c.y;
  cand[3 * i + 2] = c.z;
  take[i] = take_direct ? 1 : 0;

  // the next bounce's flag and pdf (render/integrator.nee_state): only delta
  // lobes keep the full emissive weight
  const bool spec_new = step ? is_specular && !is_glossy : spec;
  float pdf_new = pdf_prev;
  if (step && take_direct) {
    const float len =
        __fsqrt_rn(clamp_min(dot(sc.direction, sc.direction), kMin20));
    const V3 w_new = {divide(sc.direction.x, len),
                      divide(sc.direction.y, len),
                      divide(sc.direction.z, len)};
    pdf_new = is_glossy
                  ? metal_lobe_pdf(w_new, sc.reflected, m.fuzz)
                  : mul(clamp_min(dot(h.normal, w_new), 0.0f), kPiInv);
  }
  prev_pdf[i] = pdf_new;

  // roulette and the next ray
  V3 bounce_atten = mulv(atten, sc.attenuation);
  if (u_rr != nullptr) {
    const bool killed = step && u_rr[i] >= kRrContinue;
    bounce_atten = scale(step && !killed ? kRrInvContinue : 1.0f,
                         bounce_atten);
    step = step && !killed;
    is_absorbed = is_absorbed || killed;
  }
  if (step) {
    o[3 * i] = h.p.x;
    o[3 * i + 1] = h.p.y;
    o[3 * i + 2] = h.p.z;
    d[3 * i] = sc.direction.x;
    d[3 * i + 1] = sc.direction.y;
    d[3 * i + 2] = sc.direction.z;
    a0[ia] = bounce_atten.x;
    a1[ia] = bounce_atten.y;
    a2[ia] = bounce_atten.z;
  }
  alive[i] = step ? 1 : 0;
  if (flags != nullptr) {
    flags[i] = (flag_word & kRidMask) |
               (static_cast<int>(is_absorbed) << kAbsorbedBit) |
               (static_cast<int>(spec_new) << (kAbsorbedBit + 1));
  } else {
    absorbed[i] = is_absorbed ? 1 : 0;
    spec_prev[i] = spec_new ? 1 : 0;
  }
}

// The bounce under NEE after its shadow query: a lane's light sample counts
// where the query found no occluder short of the light (t < 1 - eps).
__global__ void __launch_bounds__(kThreads) shade_nee_finish_kernel(
    long long n, const float* __restrict__ t_sh,
    const unsigned char* __restrict__ sh_valid,
    const float* __restrict__ cand, float* e0, float* e1, float* e2,
    long long e_stride, float t_far) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool unoccluded = sh_valid[i] == 0 || t_sh[i] >= t_far;
  const long long ie = i * e_stride;
  e0[ie] = e0[ie] + (unoccluded ? cand[3 * i] : 0.0f);
  e1[ie] = e1[ie] + (unoccluded ? cand[3 * i + 1] : 0.0f);
  e2[ie] = e2[ie] + (unoccluded ? cand[3 * i + 2] : 0.0f);
}

// The math library calls of the kernel, one a launch, for the card tests
// that hold them to torch's ops: 0 sinf(a), 1 cosf(a), 2 acosf(a),
// 3 atan2f(a, b), 4 powf(a, 5), 5 powf(a, 1/3), the exponents as the
// kernel passes them, 6 cube(a).
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
    case 5: y = powf(x, kThird); break;
    default: y = cube(x); break;
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

// Shades n lanes under NEE up to the shadow query on `stream`, in place:
// as shade_bounce_launch, with the packed light table `lights` (n_lights,
// 20), the light-sample uniforms `u_nee` (n, 3), the balance heuristic's
// state `prev_pdf` (n floats) and, with `absorbed`, `spec_prev` (a bool a
// lane; with `flags`, bit 30 of the word). Writes the shadow rays'
// origins `sh_origin` and segments `sh_seg` (n, 3), zero for the lanes
// that take no light sample where `handles_dead`, each light sample's
// contribution should it be unoccluded `cand` (n, 3), and `take` (a bool
// a lane: the lanes that take a light sample).
extern "C" int shade_nee_launch(
    long long n, const float* prims, long long n_prims, const float* mats,
    long long n_mats, const float* tex, int n_tex, int tex_h, int tex_w,
    const float* lights, long long n_lights, const long long* idx,
    const unsigned char* hit_valid, float* o, float* d, float* a0, float* a1,
    float* a2, long long a_stride, float* e0, float* e1, float* e2,
    long long e_stride, unsigned char* alive, unsigned char* absorbed,
    int* flags, unsigned char* spec_prev, float* prev_pdf, const float* u,
    const float* u_nee, const float* u_rr, float t_min, float t_max,
    int handles_dead, float* sh_origin, float* sh_seg, float* cand,
    unsigned char* take, void* stream) {
  if (n < 0 || n_prims < 1 || n_mats < 1 || n_lights < 1 || n_tex < 0 ||
      (n_tex > 0 && (tex_h < 1 || tex_w < 1)) ||
      (absorbed == nullptr) == (flags == nullptr) ||
      (absorbed == nullptr) != (spec_prev == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  dim3 grid;
  if (!grid_for(n, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  shade_nee_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, prims, n_prims, mats, n_mats, tex, n_tex, tex_h, tex_w, lights,
      n_lights, idx, hit_valid, o, d, a0, a1, a2, a_stride, e0, e1, e2,
      e_stride, alive, absorbed, flags, spec_prev, prev_pdf, u, u_nee, u_rr,
      t_min, t_max, handles_dead != 0, sh_origin, sh_seg, cand, take);
  return static_cast<int>(cudaGetLastError());
}

// Adds each lane's `cand` (n, 3) to its emitted sum (planes `e0`-`e2`,
// element i at ek[i * e_stride]) where its shadow query (`t_sh`,
// `sh_valid`, n each) found no occluder short of `t_far`, on `stream`.
extern "C" int shade_nee_finish_launch(long long n, const float* t_sh,
                                       const unsigned char* sh_valid,
                                       const float* cand, float* e0,
                                       float* e1, float* e2,
                                       long long e_stride, float t_far,
                                       void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  dim3 grid;
  if (!grid_for(n, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  shade_nee_finish_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      n, t_sh, sh_valid, cand, e0, e1, e2, e_stride, t_far);
  return static_cast<int>(cudaGetLastError());
}

// Launches shade_math_kernel: function `fn` (0-6 as above) of `a` (and
// `b` for atan2f) into `out`, n floats each.
extern "C" int shade_math_launch(int fn, const float* a, const float* b,
                                 long long n, float* out, void* stream) {
  if (n < 0 || fn < 0 || fn > 6 || (fn == 3 && b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  dim3 grid;
  if (!grid_for(n, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  shade_math_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fn, a, b, n, out);
  return static_cast<int>(cudaGetLastError());
}
