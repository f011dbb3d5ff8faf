// The sweep core of the port's three closest-hit kernels: the cluster march
// (cluster_march.cu), the dense sweep (dense_sweep.cu) and the window sweep
// (window_sweep.cu). A tile of rays is swept against runs of primitives
// staged in shared memory.
//
// Every per-(ray, primitive) scalar of the sphere and triangle tests is the
// dot product of the ray's 12 features phi = [d, o, o x d, o.d, |o|^2, 1]
// with one of the primitive's four 12-wide columns (ops/tensor_sweep.py in
// the port). `sweep_records` forms them and the hit tests by the same
// operations in the same order as `contract` and `_epilogue` there (the
// plain twins' definition). Built with --fmad=false and without fast math,
// every product, sum, division and square root rounds like the separate
// PyTorch ops of the twins, so a kernel and its twin agree to the bit.
#pragma once

namespace pt_sweep {

constexpr float kBig = 3.0e38f;
constexpr int kFeat = 12;
constexpr int kOuts = 4;

// A ray's running closest hit: t and the winner's global index (-1: none).
struct Best {
  float t;
  int idx;
};

// ---------------------------------------------------------------------------
// * Records. A run of n primitives (rows [lo, lo + n) of a (kFeat, kOuts *
//   width) column block) is staged as one record per primitive: its 12
//   features x 4 outputs contiguous, feature-major, so that feature f of
//   all four outputs is one 16-byte word (a sphere reads the first 8 bytes).
//   Every lane of a warp reads the same record, so each word is one
//   broadcast load: 12 per primitive, where the column layout of the
//   tables needs 48 scalar loads. Records are kRec = 52 floats apart: the
//   staging loop gives a warp 8 primitives x 4 outputs of one feature
//   (four 32-byte global segments) and the stride of 52 puts their 32
//   shared stores in 32 distinct banks. Only the real rows of a tile or
//   cluster are staged (the caller's range), so no row needs a mask.
// * Types. A primitive's kind comes from its own is_sphere row; the branch
//   is uniform across the warp. A sphere forms its two pair scalars, a
//   triangle three, and the rest of the arithmetic runs only where the
//   result can depend on it (sweep_records).
// * Rays. Each thread carries RT rays in registers, so one record load
//   serves RT pair evaluations.
// * Groups. The block's threads form G groups of `lanes` threads (lanes a
//   multiple of 32, so a warp lies in one group); group g sweeps staged
//   primitives g, g + G, g + 2G, ... in ascending order with a strict `<`,
//   so it holds the first minimum of its own subset. `merge_groups` then
//   takes, per ray, the smallest t over the groups and, on equal t, the
//   smallest global index. This is the only place where the order of the
//   reduction differs from the TPU kernels' (and from the plain twins'
//   single ascending walk), and it cannot change the result: every (ray,
//   primitive) t is formed by the same operations in the same order
//   whatever the split, so the global first minimum is the minimum t with
//   the lowest index among those that reach it, which this rule picks for
//   any partition of the primitives. The march merges its groups the same
//   way once per slot, within one cluster, and folds the result into the
//   running best in slot order (cluster_march.cu).
// ---------------------------------------------------------------------------

constexpr int kRec = 52;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of one staged run of up to `cap` primitives.
struct RunBuf {
  float* rec;  // cap * kRec floats, 16-byte aligned
  int* sph;    // cap
};

// Stages rows [lo, lo + n) of the column block `cols` (feature f of output
// o of row k at cols[(f * kOuts + o) * width + k]) and of is_sphere into
// `buf`, every thread of the block striding; with kAsync through cp.async
// (the caller commits and waits), else with plain loads and stores (the
// caller synchronises before reading). The stride is a signed int:
// striding a staging loop by the unsigned blockDim.x once made ptxas give
// the march 32 registers and a spill instead of 55, and the march ~20%
// slower on an H100.
template <bool kAsync>
__device__ __forceinline__ void stage_records(
    const float* __restrict__ cols, const int* __restrict__ is_sphere,
    int width, int lo, int n, RunBuf buf) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  // i -> (prim block kb, feature f, output o, prim kk in block): 8 prims x
  // 4 outputs per warp step
  const int total = ((n + 7) >> 3) * 8 * kFeat * kOuts;
  for (int i = tid; i < total; i += nthr) {
    const int kk = i & 7;
    const int o = (i >> 3) & 3;
    const int rest = i >> 5;
    const int f = rest % kFeat;
    const int k = (rest / kFeat) * 8 + kk;
    if (k < n) {
      const float* src = cols + (f * kOuts + o) * width + lo + k;
      float* dst = buf.rec + k * kRec + f * kOuts + o;
      if (kAsync) {
        cp_async4(dst, src);
      } else {
        *dst = *src;
      }
    }
  }
  for (int i = tid; i < n; i += nthr) {
    if (kAsync) {
      cp_async4(buf.sph + i, is_sphere + lo + i);
    } else {
      buf.sph[i] = is_sphere[lo + i];
    }
  }
}

// Runs n_runs staged runs through the block: stage(r, b) stages run r into
// buffer b, sweep(r, b) sweeps it. With kAsync the next run is copied
// (cp.async) into the other buffer while the current one is swept; else one
// buffer, staged behind a barrier. Every thread of the block calls this.
template <bool kAsync, class Stage, class Sweep>
__device__ __forceinline__ void run_pipeline(int n_runs, Stage stage,
                                             Sweep sweep) {
  if (kAsync) {
    if (n_runs <= 0) return;
    stage(0, 0);
    cp_async_commit();
    for (int r = 0; r < n_runs; ++r) {
      if (r + 1 < n_runs) {
        stage(r + 1, (r + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      sweep(r, r & 1);
      __syncthreads();  // all reads of buffer r & 1 precede its next copy
    }
  } else {
    for (int r = 0; r < n_runs; ++r) {
      stage(r, 0);
      __syncthreads();
      sweep(r, 0);
      __syncthreads();  // all reads of this run precede the next copy
    }
  }
}

// RT rays of one thread: features, a = |d|^2, 1 / a and the running best.
template <int RT>
struct RayTile {
  float p[RT][kFeat];
  float a[RT];
  float inv_a[RT];
  Best best[RT];
};

// Loads ray i of the tile from phi / a where `live`; a dead slot gets
// zero features and a = 1 (it is swept but never written).
template <int RT>
__device__ __forceinline__ void load_ray(RayTile<RT>& rt, int i,
                                         const float* __restrict__ phi,
                                         const float* __restrict__ a,
                                         long long r, bool live) {
#pragma unroll
  for (int f = 0; f < kFeat; ++f) {
    rt.p[i][f] = live ? phi[r * kFeat + f] : 0.0f;
  }
  rt.a[i] = live ? a[r] : 1.0f;
  rt.inv_a[i] = 1.0f / rt.a[i];
  rt.best[i].t = kBig;
  rt.best[i].idx = -1;
}

// The thread's RT rays against staged primitives k0, k0 + step, ... < n of
// `buf` in ascending order; global index base + k; a hit replaces the
// running best only where strictly nearer.
//
// The hit tests are the twins' `_epilogue` (ops/tensor_sweep.py), whose
// definition this follows. A sphere (pair scalars B = oc.d, C0 = |oc|^2 -
// r^2): disc = B * B - a * C0, the roots (-B -+ sqrt(disc)) / a by 1 / a,
// the near root where it lies in [t_min, t_max], else the far one; a hit
// where disc >= 0 and either root is in range. A triangle (Moller-Trumbore:
// det, t * det, b1 * det, b2 * det): inv_det = 1 / det (1 where det == 0),
// missed where det == 0, b1 <= 0, b2 <= 0, b1 + b2 >= 1 or t is outside
// (t_min, t_max).
//
// Each value is formed only where the result can still depend on it, by
// the same operations in the same order as `_epilogue`, so the result is
// its result for any input (NaN and inf included):
// * a sphere forms B and C0 and its discriminant; the roots and the range
//   tests run only where disc >= 0 (the hit's first condition);
// * a triangle forms det, b1 * det and b2 * det first, and t * det (its
//   fourth pair scalar, from the record's second output) only for a ray
//   that passes every test that does not involve t: det != 0, b1 > 0,
//   b2 > 0, b1 + b2 < 1. On the triangle world's camera
//   rays, under 2% of the warps have such a ray for a given triangle, and
//   under 10% a ray with disc >= 0 for a given sphere.
template <int RT>
__device__ __forceinline__ void sweep_records(RayTile<RT>& rt, RunBuf buf,
                                              int k0, int n, int step,
                                              int base, float t_min,
                                              float t_max) {
  for (int k = k0; k < n; k += step) {
    const float* rec = buf.rec + k * kRec;
    if (buf.sph[k] != 0) {
      float S0[RT], S1[RT];
      {
        const float2 v = *reinterpret_cast<const float2*>(rec);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          S0[i] = rt.p[i][0] * v.x;
          S1[i] = rt.p[i][0] * v.y;
        }
      }
#pragma unroll
      for (int f = 1; f < kFeat; ++f) {
        const float2 v = *reinterpret_cast<const float2*>(rec + f * kOuts);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          S0[i] = S0[i] + rt.p[i][f] * v.x;
          S1[i] = S1[i] + rt.p[i][f] * v.y;
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        // the sphere's hit, with the roots only where disc >= 0
        const float disc = S0[i] * S0[i] - rt.a[i] * S1[i];
        if (disc >= 0.0f) {
          const float sqrt_d = disc > 0.0f ? sqrtf(disc) : 0.0f;
          const float root0 = (-S0[i] - sqrt_d) * rt.inv_a[i];
          const float root1 = (-S0[i] + sqrt_d) * rt.inv_a[i];
          const bool ok0 = !((root0 < t_min) || (t_max < root0));
          const bool ok1 = !((root1 < t_min) || (t_max < root1));
          const float t = ok0 ? root0 : root1;
          if ((ok0 || ok1) && t < rt.best[i].t) {
            rt.best[i].t = t;
            rt.best[i].idx = base + k;
          }
        }
      }
    } else {
      // det, b1 * det, b2 * det: outputs 0, 2, 3 of the record
      float D[RT], B1[RT], B2[RT];
      {
        const float4 v = *reinterpret_cast<const float4*>(rec);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          D[i] = rt.p[i][0] * v.x;
          B1[i] = rt.p[i][0] * v.z;
          B2[i] = rt.p[i][0] * v.w;
        }
      }
#pragma unroll
      for (int f = 1; f < kFeat; ++f) {
        const float4 v = *reinterpret_cast<const float4*>(rec + f * kOuts);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          D[i] = D[i] + rt.p[i][f] * v.x;
          B1[i] = B1[i] + rt.p[i][f] * v.z;
          B2[i] = B2[i] + rt.p[i][f] * v.w;
        }
      }
      float inv_det[RT];
      bool pass[RT];
      bool any = false;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        // the triangle's tests that do not involve t
        inv_det[i] = 1.0f / (D[i] == 0.0f ? 1.0f : D[i]);
        const float b1 = B1[i] * inv_det[i];
        const float b2 = B2[i] * inv_det[i];
        pass[i] = !((D[i] == 0.0f) || (b1 <= 0.0f) || (b2 <= 0.0f) ||
                    (b1 + b2 >= 1.0f));
        any = any || pass[i];
      }
      if (any) {
        // t * det: output 1, summed in the same order
        float T[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) T[i] = rt.p[i][0] * rec[1];
#pragma unroll
        for (int f = 1; f < kFeat; ++f) {
          const float c = rec[f * kOuts + 1];
#pragma unroll
          for (int i = 0; i < RT; ++i) T[i] = T[i] + rt.p[i][f] * c;
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float t = T[i] * inv_det[i];
          if (pass[i] && !((t <= t_min) || (t >= t_max)) &&
              t < rt.best[i].t) {
            rt.best[i].t = t;
            rt.best[i].idx = base + k;
          }
        }
      }
    }
  }
}

// Merges the G groups' partial results for each ray of the tile through
// s_t / s_i (G * lanes * RT each): the smaller t wins, on equal t the
// smaller global index (an index of -1, no hit, loses every tie; it only
// ever comes with t = kBig). Group 0 (g == 0) ends with the result of its
// rays; every thread of the block calls this.
template <int RT>
__device__ __forceinline__ void merge_groups(RayTile<RT>& rt, int G, int g,
                                             int j, int lanes, float* s_t,
                                             int* s_i) {
  const int nr = lanes * RT;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    s_t[g * nr + j + i * lanes] = rt.best[i].t;
    s_i[g * nr + j + i * lanes] = rt.best[i].idx;
  }
  __syncthreads();
  if (g != 0) return;
  for (int h = 1; h < G; ++h) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float t = s_t[h * nr + j + i * lanes];
      const int idx = s_i[h * nr + j + i * lanes];
      if (t < rt.best[i].t ||
          (t == rt.best[i].t && static_cast<unsigned>(idx) <
                                    static_cast<unsigned>(rt.best[i].idx))) {
        rt.best[i].t = t;
        rt.best[i].idx = idx;
      }
    }
  }
}

// Dynamic shared memory of a sweep kernel, in this order: n_buf run
// buffers' records (16-byte aligned at the start), their sphere masks,
// and the merge arrays s_t, s_i of G * lanes * RT entries each where
// G > 1.
constexpr size_t sweep_smem_bytes(int n_buf, int cap, int G, int lanes,
                                  int RT) {
  return static_cast<size_t>(n_buf) * cap * (kRec + 1) * 4 +
         (G > 1 ? static_cast<size_t>(G) * lanes * RT * 8 : 0);
}

__device__ __forceinline__ RunBuf run_buf(float* smem, int n_buf, int cap,
                                          int b) {
  int* masks = reinterpret_cast<int*>(smem + n_buf * cap * kRec);
  return RunBuf{smem + b * cap * kRec, masks + b * cap};
}

// The merge arrays behind the run buffers.
__device__ __forceinline__ float* merge_t(float* smem, int n_buf, int cap) {
  return smem + n_buf * cap * (kRec + 1);
}

// Maximum threads of a sweep-core block (the launchers check it).
constexpr int kMaxThreads = 512;

}  // namespace pt_sweep
