// K-A: stripe / global window attention with LePE, forward.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_attention_v2.py::_attn_kernel
// (pallas_call at :359, reached through stripe_attention_pallas_v2).  Per
// window of N = hsp*wsp tokens and per head:
//     out = softmax(round(q*scale) k^T) v + LePE(v)
// where LePE is the window-local, zero-padded depthwise 3x3 conv of v.  The
// get_v bias is added by the caller, after attention.
//
// What bounds it on the H100: at the 512^2 shapes (N = 128 or 256, head dim
// 32) every window is small, so the work is 4*B*L*N*Cb flops over only
// 8*B*L*Cb bytes of q, k, v and out: about 128 flops a byte in stage 3,
// which is below the 295 flop/byte ridge of the bf16 tensor cores, and
// device memory is the bound.  This version does the products on the CUDA
// cores in float32, so in practice it is bound by shared-memory reads and
// FMA issue, not by memory.  Design: one block per (window, head) keeps the
// window's whole K and V for that head in shared memory (float32, K rows
// padded to D+1 so the 32 lanes of a warp read 32 banks), and each warp
// takes whole query rows: lanes split the keys for the scores, the softmax
// runs on one shared-memory row per warp, and lanes split the head dim for
// p.v and LePE.  Nothing of size N x N leaves the SM.  Window tokens are
// addressed from (H, W, hsp, wsp) and a token stride, so vertical stripes are
// read in place (no transpose) and q, k, v may be column slices of one qkv
// tensor.  wgmma tiles are later work.
#include <atomic>

#include "common.cuh"

namespace csu {

constexpr int kAttnThreads = 256;
constexpr int kMaxDevices = 64;

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads)
stripe_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ lepe_w,
                        T* __restrict__ out, int64_t ldq, int64_t ldk, int64_t ldv,
                        int64_t ldo, int H, int W, int hsp, int wsp, float scale) {
  extern __shared__ float smem[];
  constexpr int KS = D + 1;
  const int N = hsp * wsp;
  float* Ks = smem;          // N x (D + 1)
  float* Vs = Ks + N * KS;   // N x D
  float* Ps = Vs + N * D;    // one score row of N per warp

  const int nh = H / hsp, nw = W / wsp;
  const int win = blockIdx.x, head = blockIdx.y;
  const int b = win / (nh * nw);
  const int wy = (win / nw) % nh, wx = win % nw;
  const int64_t row0 = (int64_t)b * H * W;
  const int c0 = head * D;
  // token n of the window (row-major in hsp x wsp) -> row of (B, H*W, C)
  auto tok = [&](int n) -> int64_t {
    const int ty = n / wsp, tx = n - ty * wsp;
    return row0 + (int64_t)(wy * hsp + ty) * W + (wx * wsp + tx);
  };

  for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
    const int n = idx / D, d = idx - n * D;
    const int64_t t = tok(n);
    Ks[n * KS + d] = to_f(k[t * ldk + c0 + d]);
    Vs[n * D + d] = to_f(v[t * ldv + c0 + d]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* P = Ps + warp * N;
  constexpr int G = D >= 32 ? 1 : 32 / D;     // lanes that share one column
  constexpr int CPL = D >= 32 ? D / 32 : 1;   // columns per lane
  const int dcol = D >= 32 ? lane : lane % D;
  const int part = D >= 32 ? 0 : lane / D;

  for (int i = warp; i < N; i += nwarps) {
    const int64_t ti = tok(i);
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = round_to<T>(to_f(q[ti * ldq + c0 + d]) * scale);

    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const float* kr = Ks + j * KS;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      P[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(P[j] - mx);
      P[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) P[j] = round_to<T>(P[j] / sum);
    __syncwarp();

    float acc[CPL];
#pragma unroll
    for (int r = 0; r < CPL; ++r) acc[r] = 0.f;
    for (int j = part; j < N; j += G) {
      const float p = P[j];
      const float* vr = Vs + j * D + dcol;
#pragma unroll
      for (int r = 0; r < CPL; ++r) acc[r] = fmaf(p, vr[32 * r], acc[r]);
    }
    if constexpr (G > 1) {
#pragma unroll
      for (int off = D; off < 32; off <<= 1)
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
    }

    if (part == 0) {
      const int ty = i / wsp, tx = i - ty * wsp;
#pragma unroll
      for (int r = 0; r < CPL; ++r) {
        const int d = dcol + 32 * r;
        const float* w9 = lepe_w + (int64_t)(c0 + d) * 9;
        float lepe = 0.f;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
          const int yy = ty + dy;
          if (yy < 0 || yy >= hsp) continue;
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) {
            const int xx = tx + dx;
            if (xx < 0 || xx >= wsp) continue;
            lepe = fmaf(w9[(dy + 1) * 3 + (dx + 1)], Vs[(yy * wsp + xx) * D + d], lepe);
          }
        }
        out[ti * ldo + c0 + d] = from_f<T>(acc[r] + lepe);
      }
    }
    __syncwarp();  // P is rewritten by the warp's next row
  }
}

template <typename T, int D>
static cudaError_t launch_attention(const void* q, const void* k, const void* v,
                                    const void* lepe_w, void* out, int64_t ldq,
                                    int64_t ldk, int64_t ldv, int64_t ldo, int B,
                                    int H, int W, int hsp, int wsp, int heads,
                                    float scale, cudaStream_t stream) {
  const int N = hsp * wsp;
  const size_t smem = sizeof(float) * ((size_t)N * (D + 1) + (size_t)N * D +
                                       (size_t)(kAttnThreads / 32) * N);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in, once per device
    // the largest size this instantiation has opted in to, per device
    static std::atomic<int> opted[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (opted[dev].load(std::memory_order_relaxed) < (int)smem) {
      e = cudaFuncSetAttribute(stripe_attention_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      int cur = opted[dev].load(std::memory_order_relaxed);
      while (cur < (int)smem && !opted[dev].compare_exchange_weak(cur, (int)smem)) {
      }
    }
  }
  const dim3 grid((unsigned)(B * (H / hsp) * (W / wsp)), (unsigned)heads);
  stripe_attention_kernel<T, D><<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lepe_w), static_cast<T*>(out), ldq, ldk, ldv, ldo,
      H, W, hsp, wsp, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k,
                                     const void* v, const void* lepe_w, void* out,
                                     int64_t ldq, int64_t ldk, int64_t ldv,
                                     int64_t ldo, int B, int H, int W, int hsp,
                                     int wsp, int heads, float scale,
                                     cudaStream_t stream) {
  switch (head_dim) {
    case 8:
      return launch_attention<T, 8>(q, k, v, lepe_w, out, ldq, ldk, ldv, ldo, B, H,
                                    W, hsp, wsp, heads, scale, stream);
    case 16:
      return launch_attention<T, 16>(q, k, v, lepe_w, out, ldq, ldk, ldv, ldo, B, H,
                                     W, hsp, wsp, heads, scale, stream);
    case 32:
      return launch_attention<T, 32>(q, k, v, lepe_w, out, ldq, ldk, ldv, ldo, B, H,
                                     W, hsp, wsp, heads, scale, stream);
    case 64:
      return launch_attention<T, 64>(q, k, v, lepe_w, out, ldq, ldk, ldv, ldo, B, H,
                                     W, hsp, wsp, heads, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace csu

// q, k, v: (B, H*W, *) token tensors whose channel block [0, heads*head_dim)
// of each row is read, rows ldq/ldk/ldv elements apart; lepe_w: (C, 9) float32
// taps, tap (dy+1)*3 + (dx+1) multiplies v at (y+dy, x+dx); out rows ldo apart.
CSU_EXPORT int csu_stripe_attention_fwd(int dtype, const void* q, const void* k,
                                        const void* v, const void* lepe_w, void* out,
                                        int64_t ldq, int64_t ldk, int64_t ldv,
                                        int64_t ldo, int B, int H, int W, int hsp,
                                        int wsp, int heads, int head_dim, float scale,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csu::kFloat32)
    return (int)csu::dispatch_head_dim<float>(head_dim, q, k, v, lepe_w, out, ldq, ldk,
                                              ldv, ldo, B, H, W, hsp, wsp, heads,
                                              scale, s);
  if (dtype == csu::kBFloat16)
    return (int)csu::dispatch_head_dim<__nv_bfloat16>(head_dim, q, k, v, lepe_w, out,
                                                      ldq, ldk, ldv, ldo, B, H, W, hsp,
                                                      wsp, heads, scale, s);
  return (int)cudaErrorInvalidValue;
}
