// K-H2: SimAM gate + grouped 1x1 head dot over the flat head map, forward.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_simam_head.py::_fwd_kernel
// (pallas_call at :241, through head_fwd_pallas), as the fused CARAFE head
// (ops/pallas_carafe_head.py) calls it: the bias is already in the map.
// For each pixel and sub-pixel g of fb (B, H, W, G*C):
//     y_c = round(x_c * sigmoid((x_c - mu_c)^2 / (4 (v_c + lam)) + 0.5))
//     logits[b, h, w, g*F + f] = sum_c y_c * W[c, f]
// with the float32 gate, y rounded to the compute dtype as the reference
// does, and the dot over the C real channels done here in a loop (F <= 8).
//
// What bounds it on the H100: one read of the 268 MB flat map at the 512^2
// head; the logits are 16x smaller.  Device memory is the bound (about
// 81 us at 3.35 TB/s).  Design: a group of lanes owns one (pixel, g) item,
// each lane one 16-byte channel vector, so a warp reads 512 contiguous bytes
// per load; the gate and the partial dot stay in registers and the group sums
// its partials with warp shuffles.  No gated map is ever written.
#include "common.cuh"

namespace csu {

constexpr int kHeadThreads = 256;
constexpr int kMaxClasses = 8;

template <typename T, int VEC>
__global__ void __launch_bounds__(kHeadThreads)
simam_head_kernel(const T* __restrict__ fb, const float* __restrict__ mu,
                  const float* __restrict__ var, const T* __restrict__ w,
                  T* __restrict__ out, int64_t items, int64_t items_per_image, int C,
                  int F, int lanes, float lam, int gate) {
  const int64_t gt = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t item = gt / lanes;
  const int l = (int)(gt % lanes);
  const bool valid = item < items;
  float acc[kMaxClasses];
#pragma unroll
  for (int f = 0; f < kMaxClasses; ++f) acc[f] = 0.f;
  if (valid) {
    const int64_t b = item / items_per_image;
    const T* xr = fb + item * C;
    const float* mub = mu + b * C;
    const float* vb = var + b * C;
    for (int c = l * VEC; c < C; c += lanes * VEC) {
      float xv[VEC];
      load_vec<T, VEC>(xr + c, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float y = xv[i];
        if (gate) {
          const float xc = y - mub[c + i];
          const float e = xc * xc / (4.f * (vb[c + i] + lam)) + 0.5f;
          y = round_to<T>(y * (1.f / (1.f + expf(-e))));
        }
        const T* wr = w + (int64_t)(c + i) * F;
#pragma unroll
        for (int f = 0; f < kMaxClasses; ++f)
          if (f < F) acc[f] = fmaf(y, to_f(wr[f]), acc[f]);
      }
    }
  }
  // every lane of the warp takes part: the lanes of one item are adjacent
  for (int off = 1; off < lanes; off <<= 1) {
#pragma unroll
    for (int f = 0; f < kMaxClasses; ++f)
      acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], off);
  }
  if (valid && l == 0) {
#pragma unroll
    for (int f = 0; f < kMaxClasses; ++f)
      if (f < F) out[item * F + f] = from_f<T>(acc[f]);
  }
}

template <typename T, int VEC>
static cudaError_t launch_head(const void* fb, const void* mu, const void* var,
                               const void* w, void* out, int64_t items,
                               int64_t items_per_image, int C, int F, int lanes,
                               float lam, int gate, cudaStream_t stream) {
  if (C % VEC || F < 1 || F > kMaxClasses || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)))
    return cudaErrorInvalidValue;
  const int64_t blocks = (items * lanes + kHeadThreads - 1) / kHeadThreads;
  simam_head_kernel<T, VEC><<<(unsigned)blocks, kHeadThreads, 0, stream>>>(
      static_cast<const T*>(fb), static_cast<const float*>(mu),
      static_cast<const float*>(var), static_cast<const T*>(w), static_cast<T*>(out),
      items, items_per_image, C, F, lanes, lam, gate);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K3: the head backward's reduction pass.
//
// Replaces ops/pallas_simam_head.py::_bwd1_kernel (pallas_call at :269,
// through head_bwd1_pallas), as the fused CARAFE head's backward
// (ops/pallas_carafe_head.py:369) calls it: bias already in the map.  For
// each lane l = g*C + c of the biased flat map fb (B, H, W, G*C), with
// dg = sum_f dy[g*F + f] * W[c, f] and the float32 gate terms of the forward,
//     t = dg * x * g (1 - g)
//     A[l] += t (x - mu_c)        B[l] += t (x - mu_c)^2
//     dW[c, f] += round(x * g) * dy[g*F + f]
// summed over the pixels of one image row per block; the caller sums the
// rows and pools A and B per real channel (as head_bwd1_pallas does).
//
// What bounds it on the H100: one read of the 268 MB flat map at the 512^2
// head, so device memory (about 80 us at 3.35 TB/s).  Design: a block owns
// one image row, each thread one (g, 16-byte channel vector) slot of a pixel,
// so each pixel's G*C values are one coalesced block-wide load; a thread
// walks the row's pixels and keeps its A, B and dW sums in registers, and
// writes them once, so no atomics and a fixed summation order.
//
// K3 without the gate (GATE false) replaces ops/pallas_simam_head.py::
// _bwd1_nogate_kernel (launched at pallas_carafe_head.py:382, the fused head
// without SimAM): dW[c, f] = sum over the map of fb * dy[g*F + f], the same
// per-row float32 partials in the same order, and no A, B, mu, var or W.
template <typename T, int VEC, bool GATE>
__global__ void head_bwd1_kernel(const T* __restrict__ fb, const T* __restrict__ dy,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ var, const T* __restrict__ w,
                                 float* __restrict__ a_part, float* __restrict__ b_part,
                                 float* __restrict__ dw_part, int H, int W, int C, int G,
                                 int F, float lam) {
  const int CV = C / VEC, GC = G * C;
  const int g = threadIdx.x / CV, cv = threadIdx.x - g * CV, c = cv * VEC;
  const int row = blockIdx.x, b = row / H;  // row = b*H + y
  float mu_c[VEC], den[VEC], wv[VEC][kMaxClasses];
  float a[VEC], bq[VEC], dw[VEC][kMaxClasses];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu_c[i] = GATE ? mu[(int64_t)b * C + c + i] : 0.f;
    den[i] = GATE ? 4.f * (var[(int64_t)b * C + c + i] + lam) : 1.f;
    a[i] = bq[i] = 0.f;
#pragma unroll
    for (int f = 0; f < kMaxClasses; ++f) {
      wv[i][f] = GATE && f < F ? to_f(w[(int64_t)(c + i) * F + f]) : 0.f;
      dw[i][f] = 0.f;
    }
  }
  for (int xx = 0; xx < W; ++xx) {
    const int64_t pix = (int64_t)row * W + xx;
    float xv[VEC], dyv[kMaxClasses];
    load_vec<T, VEC>(fb + pix * GC + g * C + c, xv);
#pragma unroll
    for (int f = 0; f < kMaxClasses; ++f)
      dyv[f] = f < F ? to_f(dy[pix * G * F + g * F + f]) : 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xf = xv[i];
      if constexpr (!GATE) {
#pragma unroll
        for (int f = 0; f < kMaxClasses; ++f) dw[i][f] = fmaf(xf, dyv[f], dw[i][f]);
        continue;
      }
      const float xc = xf - mu_c[i];
      const float e = xc * xc / den[i] + 0.5f;
      const float gt = 1.f / (1.f + expf(-e));
      float dg = 0.f;
#pragma unroll
      for (int f = 0; f < kMaxClasses; ++f) dg = fmaf(dyv[f], wv[i][f], dg);
      const float t = dg * xf * (gt * (1.f - gt));
      a[i] = fmaf(t, xc, a[i]);
      bq[i] = fmaf(t * xc, xc, bq[i]);
      const float gated = round_to<T>(xf * gt);
#pragma unroll
      for (int f = 0; f < kMaxClasses; ++f) dw[i][f] = fmaf(gated, dyv[f], dw[i][f]);
    }
  }
  const int64_t lane0 = (int64_t)row * GC + g * C + c;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (GATE) {
      a_part[lane0 + i] = a[i];
      b_part[lane0 + i] = bq[i];
    }
    for (int f = 0; f < F; ++f) dw_part[(lane0 + i) * F + f] = dw[i][f];
  }
}

template <typename T, int VEC, bool GATE>
static cudaError_t launch_head_bwd1(const void* fb, const void* dy, const void* mu,
                                    const void* var, const void* w, void* a_part,
                                    void* b_part, void* dw_part, int B, int H, int W,
                                    int C, int G, int F, float lam, cudaStream_t stream) {
  if (C % VEC || F < 1 || F > kMaxClasses) return cudaErrorInvalidValue;
  const int threads = G * (C / VEC);
  if (threads > 1024) return cudaErrorInvalidValue;
  head_bwd1_kernel<T, VEC, GATE><<<(unsigned)(B * H), threads, 0, stream>>>(
      static_cast<const T*>(fb), static_cast<const T*>(dy), static_cast<const float*>(mu),
      static_cast<const float*>(var), static_cast<const T*>(w),
      static_cast<float*>(a_part), static_cast<float*>(b_part),
      static_cast<float*>(dw_part), H, W, C, G, F, lam);
  return cudaGetLastError();
}

template <bool GATE>
static cudaError_t dispatch_head_bwd1(int dtype, int vec, const void* fb, const void* dy,
                                      const void* mu, const void* var, const void* w,
                                      void* a_part, void* b_part, void* dw_part, int B,
                                      int H, int W, int C, int G, int F, float lam,
                                      cudaStream_t s) {
  if (dtype == kFloat32 && vec == 4)
    return launch_head_bwd1<float, 4, GATE>(fb, dy, mu, var, w, a_part, b_part, dw_part, B,
                                            H, W, C, G, F, lam, s);
  if (dtype == kFloat32 && vec == 1)
    return launch_head_bwd1<float, 1, GATE>(fb, dy, mu, var, w, a_part, b_part, dw_part, B,
                                            H, W, C, G, F, lam, s);
  if (dtype == kBFloat16 && vec == 8)
    return launch_head_bwd1<__nv_bfloat16, 8, GATE>(fb, dy, mu, var, w, a_part, b_part,
                                                    dw_part, B, H, W, C, G, F, lam, s);
  if (dtype == kBFloat16 && vec == 1)
    return launch_head_bwd1<__nv_bfloat16, 1, GATE>(fb, dy, mu, var, w, a_part, b_part,
                                                    dw_part, B, H, W, C, G, F, lam, s);
  return cudaErrorInvalidValue;
}


}  // namespace csu

// fb (B, H, W, G*C) as items = B*H*W*G rows of C; mu, var (B, C) float32;
// w (C, F) in the compute dtype; out (B, H, W, G*F).  `lanes` (a power of two
// up to 32) lanes share one item.
CSU_EXPORT int csu_simam_head_fwd(int dtype, const void* fb, const void* mu,
                                  const void* var, const void* w, void* out,
                                  int64_t items, int64_t items_per_image, int C, int F,
                                  int vec, int lanes, float lam, int gate,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csu::kFloat32 && vec == 4)
    return (int)csu::launch_head<float, 4>(fb, mu, var, w, out, items, items_per_image,
                                           C, F, lanes, lam, gate, s);
  if (dtype == csu::kFloat32 && vec == 1)
    return (int)csu::launch_head<float, 1>(fb, mu, var, w, out, items, items_per_image,
                                           C, F, lanes, lam, gate, s);
  if (dtype == csu::kBFloat16 && vec == 8)
    return (int)csu::launch_head<__nv_bfloat16, 8>(fb, mu, var, w, out, items,
                                                   items_per_image, C, F, lanes, lam,
                                                   gate, s);
  if (dtype == csu::kBFloat16 && vec == 1)
    return (int)csu::launch_head<__nv_bfloat16, 1>(fb, mu, var, w, out, items,
                                                   items_per_image, C, F, lanes, lam,
                                                   gate, s);
  return (int)cudaErrorInvalidValue;
}


// K3: fb (B, H, W, G*C) and dy (B, H, W, G*F) in the compute dtype, mu and
// var (B, C) float32, w (C, F) in the compute dtype; a_part and b_part
// (B*H, G*C) and dw_part (B*H, G*C, F) float32 receive each image row's sums.
CSU_EXPORT int csu_head_bwd1(int dtype, const void* fb, const void* dy, const void* mu,
                             const void* var, const void* w, void* a_part, void* b_part,
                             void* dw_part, int B, int H, int W, int C, int G, int F,
                             int vec, float lam, void* stream) {
  return (int)csu::dispatch_head_bwd1<true>(dtype, vec, fb, dy, mu, var, w, a_part, b_part,
                                            dw_part, B, H, W, C, G, F, lam,
                                            static_cast<cudaStream_t>(stream));
}

// K3 without the gate: dw_part (B*H, G*C, F) float32 receives each image
// row's sums of fb * dy for fb (B, H, W, G*C) and dy (B, H, W, G*F).
CSU_EXPORT int csu_head_bwd1_nogate(int dtype, const void* fb, const void* dy,
                                    void* dw_part, int B, int H, int W, int C, int G,
                                    int F, int vec, void* stream) {
  return (int)csu::dispatch_head_bwd1<false>(dtype, vec, fb, dy, nullptr, nullptr, nullptr,
                                             nullptr, nullptr, dw_part, B, H, W, C, G, F,
                                             0.f, static_cast<cudaStream_t>(stream));
}

// The message of a CUDA error code returned by the functions above.
CSU_EXPORT const char* csu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
