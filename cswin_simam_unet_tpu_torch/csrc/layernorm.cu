// K-LN and K-LN': LayerNorm over the last axis of (M, C) rows, forward and
// backward.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_layernorm.py::_fwd_kernel
// (pallas_call at :111) and _bwd_kernel (:148).  Per row of C <= 512, in
// float32, with the raw-moment statistics of flax's fast variance:
//     mu = E[x]    var = max(0, E[x^2] - mu^2)    rstd = rsqrt(var + eps)
//     y = (x - mu) * (rstd * g) + b                     (flax's op order)
// and the backward, the statistics recomputed from x as the TPU kernel does:
//     xhat = (x - mu) rstd    a = dy g    m1 = mean(a)    m2 = mean(a xhat)
//     dx = rstd (a - m1 - xhat m2)
//     dg = sum over rows of dy xhat      db = sum over rows of dy
// dg and db as per-block float32 partials that the caller sums, as _ln_bwd
// sums dg_part and db_part (:173-174).
//
// What bounds it on the H100: device memory.  The forward reads x and writes
// y once, the backward reads x and dy and writes dx once: at the flagship's
// largest LayerNorm (131072 x 64, bf16) about 10 us each way at 3.35 TB/s.
// Design: one warp per row, each lane holding the columns lane + 32 i in
// registers and the row sums taken by warp shuffles, so nothing but x, dy
// and the outputs crosses device memory.  A backward block owns a fixed run
// of 64 rows; each lane keeps its columns' dg and db sums in registers, the
// warps' sums meet in shared memory in a fixed order and the block writes
// one partial row: no atomics, the same sums on every run.
#include "common.cuh"

namespace csu {

constexpr int kLnWarps = 8;         // rows in flight per block, one a warp
constexpr int kLnRowsPerWarp = 8;   // backward: 64 rows per block
constexpr int kLnMaxC = 512;

// Columns lane + 32 i (i < NPL) of a row, as floats; 0 past C.
template <typename T, int NPL>
__device__ __forceinline__ void ln_load(const T* __restrict__ row, int C, int lane,
                                        float (&v)[NPL]) {
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? to_f(row[c]) : 0.f;
  }
}

// The row's mean and rsqrt(var + eps) from its raw moments (every lane).
template <int NPL>
__device__ __forceinline__ void ln_stats(const float (&x)[NPL], int C, float eps, float& mu,
                                         float& rstd) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    s += x[i];
    ss = fmaf(x[i], x[i], ss);
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mu = s / C;
  rstd = rsqrtf(fmaxf(0.f, ss / C - mu * mu) + eps);
}

template <typename T, int NPL>
__global__ void __launch_bounds__(kLnWarps * 32)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ b, T* __restrict__ y, int64_t M, int C,
                     float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (r >= M) return;  // the whole warp: one row per warp
  float xv[NPL];
  ln_load<T, NPL>(x + r * C, C, lane, xv);
  float mu, rstd;
  ln_stats<NPL>(xv, C, eps, mu, rstd);
  T* yr = y + r * C;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) yr[c] = from_f<T>((xv[i] - mu) * (rstd * g[c]) + b[c]);
  }
}

template <typename T, int NPL>
__global__ void __launch_bounds__(kLnWarps * 32)
layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ dg_part, float* __restrict__ db_part, int64_t M,
                     int C, float eps) {
  __shared__ float red[2][kLnWarps][NPL * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float gv[NPL], sg[NPL], sb[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    gv[i] = c < C ? g[c] : 0.f;
    sg[i] = sb[i] = 0.f;
  }
  const int64_t r0 = ((int64_t)blockIdx.x * kLnWarps + warp) * kLnRowsPerWarp;
  for (int k = 0; k < kLnRowsPerWarp; ++k) {
    const int64_t r = r0 + k;
    if (r >= M) break;  // warp-uniform
    float xv[NPL], dv[NPL];
    ln_load<T, NPL>(x + r * C, C, lane, xv);
    ln_load<T, NPL>(dy + r * C, C, lane, dv);
    float mu, rstd;
    ln_stats<NPL>(xv, C, eps, mu, rstd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      xv[i] = (xv[i] - mu) * rstd;  // xhat (0 past C, where dy is 0 too)
      const float a = dv[i] * gv[i];
      s1 += a;
      s2 = fmaf(a, xv[i], s2);
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    T* dxr = dx + r * C;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      if (c >= C) continue;
      dxr[c] = from_f<T>(rstd * (dv[i] * gv[i] - m1 - xv[i] * m2));
      sg[i] = fmaf(dv[i], xv[i], sg[i]);
      sb[i] += dv[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    red[0][warp][lane + 32 * i] = sg[i];
    red[1][warp][lane + 32 * i] = sb[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int w = 0; w < kLnWarps; ++w) {
      a += red[0][w][c];
      s += red[1][w][c];
    }
    dg_part[(int64_t)blockIdx.x * C + c] = a;
    db_part[(int64_t)blockIdx.x * C + c] = s;
  }
}

// The smallest of 1, 2, 4, 8, 16 columns per lane that covers C (0 if none).
static int ln_columns_per_lane(int C) {
  for (int npl = 1; npl <= kLnMaxC / 32; npl *= 2)
    if (C <= 32 * npl) return npl;
  return 0;
}

template <typename T, int NPL>
static cudaError_t launch_ln(bool bwd, const void* x, const void* g, const void* b,
                             const void* dy, void* out, void* dg_part, void* db_part,
                             int64_t M, int C, float eps, cudaStream_t s) {
  if (bwd) {
    const int64_t rows = (int64_t)kLnWarps * kLnRowsPerWarp;
    layernorm_bwd_kernel<T, NPL><<<(unsigned)((M + rows - 1) / rows), kLnWarps * 32, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const T*>(dy),
        static_cast<T*>(out), static_cast<float*>(dg_part), static_cast<float*>(db_part), M,
        C, eps);
  } else {
    layernorm_fwd_kernel<T, NPL><<<(unsigned)((M + kLnWarps - 1) / kLnWarps), kLnWarps * 32,
                                   0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<T*>(out), M, C, eps);
  }
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_ln(bool bwd, const void* x, const void* g, const void* b,
                               const void* dy, void* out, void* dg_part, void* db_part,
                               int64_t M, int C, float eps, cudaStream_t s) {
  if (M < 1) return cudaErrorInvalidValue;
  switch (ln_columns_per_lane(C)) {
    case 1: return launch_ln<T, 1>(bwd, x, g, b, dy, out, dg_part, db_part, M, C, eps, s);
    case 2: return launch_ln<T, 2>(bwd, x, g, b, dy, out, dg_part, db_part, M, C, eps, s);
    case 4: return launch_ln<T, 4>(bwd, x, g, b, dy, out, dg_part, db_part, M, C, eps, s);
    case 8: return launch_ln<T, 8>(bwd, x, g, b, dy, out, dg_part, db_part, M, C, eps, s);
    case 16: return launch_ln<T, 16>(bwd, x, g, b, dy, out, dg_part, db_part, M, C, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

static cudaError_t ln_entry(int dtype, bool bwd, const void* x, const void* g, const void* b,
                            const void* dy, void* out, void* dg_part, void* db_part,
                            int64_t M, int C, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_ln<float>(bwd, x, g, b, dy, out, dg_part, db_part, M, C, eps, s);
  if (dtype == kBFloat16)
    return dispatch_ln<__nv_bfloat16>(bwd, x, g, b, dy, out, dg_part, db_part, M, C, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace csu

// K-LN: x and y (M, C) contiguous in the compute dtype, g and b (C,)
// float32, C <= 512.
CSU_EXPORT int csu_layernorm_fwd(int dtype, const void* x, const void* g, const void* b,
                                 void* y, int64_t M, int C, float eps, void* stream) {
  return (int)csu::ln_entry(dtype, false, x, g, b, nullptr, y, nullptr, nullptr, M, C, eps,
                            stream);
}

// K-LN': x, dy and dx (M, C) contiguous in the compute dtype, g (C,)
// float32; dg_part and db_part (ceil(M / 64), C) float32 receive each
// block's sums of dy * xhat and of dy over its 64 rows.
CSU_EXPORT int csu_layernorm_bwd(int dtype, const void* x, const void* g, const void* dy,
                                 void* dx, void* dg_part, void* db_part, int64_t M, int C,
                                 float eps, void* stream) {
  return (int)csu::ln_entry(dtype, true, x, g, nullptr, dy, dx, dg_part, db_part, M, C, eps,
                            stream);
}
