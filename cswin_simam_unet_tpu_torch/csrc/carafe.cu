// K-C and K-H1: CARAFE content-aware reassembly, forward, in the
// pre-pixel-shuffle ("flat") layout out[b, y, x, s*C + c].
//
// K-C replaces cswin_simam_unet_tpu/ops/pallas_carafe.py::_fwd_kernel
// (pallas_call at :320): per pixel and sub-pixel s, softmax over the 9 taps
// of enc[..., k*S^2 + s], then out = sum_k p_k * x[y+dy_k, x+dx_k, :], zero
// padded at the image border.
//
// K-H1 replaces ops/pallas_carafe_head.py::_fwd_moments_kernel (pallas_call at
// :124): the same reassembly at S = 4, plus the out-conv bias added in the
// compute dtype, plus per-block partial sums of the biased map and of its
// square (float32), from which the caller pools SimAM's per-channel mean and
// variance.
//
// What bounds it on the H100: 18 flops per output element against 2 bytes
// written (bf16), so device memory, and mostly the output write: at the head
// (8,128,128,64) x and (8,128,128,144) enc are 55 MB read against 268 MB
// written.  Design: the block's threads own the (s, 16-byte channel vector)
// slots of one pixel, so a pixel's S^2*C outputs are written by one fully
// coalesced block-wide store; the block walks a run of pixels along one row.
// A thread loads its 9 neighbour vectors once per pixel (the S^2 threads that
// share a vector hit L1), computes its sub-pixel's 9-tap softmax in registers
// and accumulates in float32.  The TPU kernel's MXU indicator tricks
// (_expand_s, _fold_sum_s) are lane workarounds with no use here.
#include "common.cuh"

namespace csu {

template <typename T, int VEC, bool HEAD>
__global__ void carafe_kernel(const T* __restrict__ x, const T* __restrict__ enc,
                              const T* __restrict__ bias, T* __restrict__ out,
                              float* __restrict__ s1, float* __restrict__ s2, int H,
                              int W, int C, int S, int px) {
  const int S2 = S * S, CV = C / VEC;
  const int s = threadIdx.x / CV, cv = threadIdx.x - s * CV;
  const int c = cv * VEC;
  const int nch = (W + px - 1) / px;
  const int row = blockIdx.x / nch, chunk = blockIdx.x - row * nch;  // row = b*H + y
  const int y = row % H;
  const int64_t img0 = (int64_t)(row - y) * W;  // first pixel of this image
  const int x0 = chunk * px, x1 = min(W, x0 + px);

  float bv[VEC], a1[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = bv[i] = 0.f;
  if constexpr (HEAD) load_vec<T, VEC>(bias + c, bv);

  for (int xx = x0; xx < x1; ++xx) {
    const int64_t pix = (int64_t)row * W + xx;
    const T* e = enc + pix * (9 * S2) + s;
    float lg[9];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      lg[k] = to_f(e[k * S2]);
      m = fmaxf(m, lg[k]);
    }
    float den = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      lg[k] = expf(lg[k] - m);
      den += lg[k];
    }
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int yy = y + k / 3 - 1, xn = xx + k % 3 - 1;
      if (yy < 0 || yy >= H || xn < 0 || xn >= W) continue;
      const float p = round_to<T>(lg[k] / den);
      float xv[VEC];
      load_vec<T, VEC>(x + (img0 + (int64_t)yy * W + xn) * C + c, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, xv[i], acc[i]);
    }
    if constexpr (HEAD) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float f = round_to<T>(round_to<T>(acc[i]) + bv[i]);
        acc[i] = f;
        a1[i] += f;
        a2[i] = fmaf(f, f, a2[i]);
      }
    }
    store_vec<T, VEC>(out + pix * (S2 * C) + s * C + c, acc);
  }
  if constexpr (HEAD) {
    if (s1 != nullptr) {
      const int64_t base = (int64_t)blockIdx.x * S2 * C + s * C + c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1[base + i] = a1[i];
        s2[base + i] = a2[i];
      }
    }
  }
}

template <typename T, int VEC, bool HEAD>
static cudaError_t launch_carafe(const void* x, const void* enc, const void* bias,
                                 void* out, void* s1, void* s2, int B, int H, int W,
                                 int C, int S, int px, cudaStream_t stream) {
  if (C % VEC || px < 1) return cudaErrorInvalidValue;
  const int threads = S * S * (C / VEC);
  if (threads > 1024) return cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)B * H * ((W + px - 1) / px);
  carafe_kernel<T, VEC, HEAD><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(enc),
      static_cast<const T*>(bias), static_cast<T*>(out), static_cast<float*>(s1),
      static_cast<float*>(s2), H, W, C, S, px);
  return cudaGetLastError();
}

template <bool HEAD>
static cudaError_t dispatch_carafe(int dtype, int vec, const void* x, const void* enc,
                                   const void* bias, void* out, void* s1, void* s2,
                                   int B, int H, int W, int C, int S, int px,
                                   cudaStream_t stream) {
  if (dtype == kFloat32 && vec == 4)
    return launch_carafe<float, 4, HEAD>(x, enc, bias, out, s1, s2, B, H, W, C, S, px,
                                         stream);
  if (dtype == kFloat32 && vec == 1)
    return launch_carafe<float, 1, HEAD>(x, enc, bias, out, s1, s2, B, H, W, C, S, px,
                                         stream);
  if (dtype == kBFloat16 && vec == 8)
    return launch_carafe<__nv_bfloat16, 8, HEAD>(x, enc, bias, out, s1, s2, B, H, W,
                                                 C, S, px, stream);
  if (dtype == kBFloat16 && vec == 1)
    return launch_carafe<__nv_bfloat16, 1, HEAD>(x, enc, bias, out, s1, s2, B, H, W,
                                                 C, S, px, stream);
  return cudaErrorInvalidValue;
}

}  // namespace csu

// x (B, H, W, C), enc (B, H, W, 9*S*S), out (B, H, W, S*S*C), all contiguous;
// vec is the channel vector width (16 bytes of the dtype, or 1); each block
// covers px pixels of one row.
CSU_EXPORT int csu_carafe_fwd(int dtype, const void* x, const void* enc, void* out,
                              int B, int H, int W, int C, int S, int vec, int px,
                              void* stream) {
  return (int)csu::dispatch_carafe<false>(dtype, vec, x, enc, nullptr, out, nullptr,
                                          nullptr, B, H, W, C, S, px,
                                          static_cast<cudaStream_t>(stream));
}

// As csu_carafe_fwd, plus bias (C,) added in the compute dtype; s1 and s2
// (blocks, S*S*C) float32 receive each block's sums of the biased map and of
// its square (both may be null when the caller needs no statistics).
CSU_EXPORT int csu_carafe_head_fwd(int dtype, const void* x, const void* enc,
                                   const void* bias, void* fb, void* s1, void* s2,
                                   int B, int H, int W, int C, int S, int vec, int px,
                                   void* stream) {
  return (int)csu::dispatch_carafe<true>(dtype, vec, x, enc, bias, fb, s1, s2, B, H, W,
                                         C, S, px, static_cast<cudaStream_t>(stream));
}
