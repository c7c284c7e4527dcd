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

// The message of a CUDA error code returned by the functions above.
CSU_EXPORT const char* csu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
