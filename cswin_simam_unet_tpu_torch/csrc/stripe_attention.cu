// K-A: stripe / global window attention with LePE, forward.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_attention_v2.py::_attn_kernel
// (pallas_call at :359, reached through stripe_attention_pallas_v2).  Per
// window of N = hsp*wsp tokens and per head:
//     out = softmax(round(q*scale) k^T) v + LePE(v)
// where LePE is the window-local, zero-padded depthwise 3x3 conv of v.  The
// get_v bias is added by the caller, after attention.  With attention
// dropout (the DROP instantiation, picked when the threshold is non-zero) the
// float32 probabilities are dropped and rescaled by 1 / (1 - rate) before
// their rounding to the compute dtype (pallas_attention_v2.py:211-213); the
// keep bit of each score is recomputed from the counter hash of
// common.cuh::drop_keep, so no mask is stored and shared memory does not
// grow.
//
// What bounds it on the H100: at the 512^2 shapes (N = 128 or 256, head dim
// 32) every window is small, so the work is 4*B*L*N*Cb flops over only
// 8*B*L*Cb bytes of q, k, v and out: about 128 flops a byte in stage 3,
// which is below the 295 flop/byte ridge of the bf16 tensor cores, and
// device memory is the bound.  Two bodies, picked by dtype and head dim
// (csu_attention_body):
// * bf16 at head dims 16, 32 and 64, the tensor-core body
//   (attention_fwd_mma.cuh, shared with the flash forward): a block takes 64
//   query rows of one window and head and holds the window's whole K and V
//   in shared memory as bf16; it sweeps the keys twice with mma.sync, first
//   for the row's max and sum, then for p = round(drop(exp(s - m) / l)) and
//   P V, and writes each row's L = m + log(l) for the tensor-core K-A'
//   when the caller asks for it.  Grid (windows, heads, ceil(N / 64)).
// * float32 (the exact-f32 route of cswinunet) and head dim 8, the CUDA-core
//   body below: one block per (window, head) keeps the window's whole K and
//   V for that head in shared memory (float32, K rows padded to D+1 so the
//   32 lanes of a warp read 32 banks), and each warp takes whole query rows:
//   lanes split the keys for the scores, the softmax runs on one
//   shared-memory row per warp, and lanes split the head dim for p.v and
//   LePE.
// Nothing of size N x N leaves the SM.  Window tokens are addressed from (H,
// W, hsp, wsp) and a token stride, so vertical stripes are read in place (no
// transpose) and q, k, v may be column slices of one qkv tensor.
#include "attention_fwd_mma.cuh"

namespace csu {

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kAttnThreads)
stripe_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ lepe_w,
                        T* __restrict__ out, int64_t ldq, int64_t ldk, int64_t ldv,
                        int64_t ldo, int H, int W, int hsp, int wsp, float scale,
                        AttnDrop drop) {
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
  const uint32_t hbase =
      DROP ? drop_base(drop.seed, drop_window(drop, win), drop_head(drop, head)) : 0u;
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
    for (int j = lane; j < N; j += 32) {
      float p = P[j] / sum;
      if constexpr (DROP)
        p = drop_keep(hbase, (uint32_t)(i * N + j), drop.threshold) ? p * drop.inv_keep : 0.f;
      P[j] = round_to<T>(p);
    }
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

template <typename T, int D, bool DROP>
static cudaError_t launch_attention(const void* q, const void* k, const void* v,
                                    const void* lepe_w, void* out, int64_t ldq,
                                    int64_t ldk, int64_t ldv, int64_t ldo, int B,
                                    int H, int W, int hsp, int wsp, int heads,
                                    float scale, AttnDrop drop, cudaStream_t stream) {
  const int N = hsp * wsp;
  const size_t smem = sizeof(float) * ((size_t)N * (D + 1) + (size_t)N * D +
                                       (size_t)(kAttnThreads / 32) * N);
  static std::atomic<int> opted[kMaxDevices];
  const cudaError_t e = opt_in_smem(stripe_attention_kernel<T, D, DROP>, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * (H / hsp) * (W / wsp)), (unsigned)heads);
  stripe_attention_kernel<T, D, DROP><<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lepe_w), static_cast<T*>(out), ldq, ldk, ldv, ldo,
      H, W, hsp, wsp, scale, drop);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k,
                                     const void* v, const void* lepe_w, void* out,
                                     int64_t ldq, int64_t ldk, int64_t ldv,
                                     int64_t ldo, int B, int H, int W, int hsp,
                                     int wsp, int heads, float scale, AttnDrop drop,
                                     cudaStream_t stream) {
#define CSU_ATTN_FWD(DIM)                                                                   \
  if constexpr (!mma::serves(dtype_code<T>(), DIM))                                         \
    if (head_dim == DIM)                                                                    \
      return drop.threshold                                                                 \
                 ? launch_attention<T, DIM, true>(q, k, v, lepe_w, out, ldq, ldk, ldv, ldo, \
                                                  B, H, W, hsp, wsp, heads, scale, drop,    \
                                                  stream)                                   \
                 : launch_attention<T, DIM, false>(q, k, v, lepe_w, out, ldq, ldk, ldv,     \
                                                   ldo, B, H, W, hsp, wsp, heads, scale,    \
                                                   drop, stream);
  CSU_FLASH_HEAD_DIMS(CSU_ATTN_FWD)
#undef CSU_ATTN_FWD
  return cudaErrorInvalidValue;
}

// The tensor-core body (bf16, D in 16, 32, 64): the whole window's K and V
// in shared memory, the dropout mask of one N x N tile per window and head.
template <int D, bool DROP>
__global__ void __launch_bounds__(mma::kThreads)
stripe_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ lepe_w, __nv_bfloat16* __restrict__ out,
                            int64_t ldo, float* __restrict__ lse, FlashArgs a) {
  extern __shared__ __align__(16) unsigned char tiles[];  // not the float smem[] above
  mma::attention_fwd<D, DROP, true>(q, k, v, lepe_w, out, ldo, lse, a, tiles);
}

template <int D, bool DROP>
static cudaError_t launch_attention_mma(const void* q, const void* k, const void* v,
                                        const void* lepe_w, void* out, int64_t ldo,
                                        void* lse, int B, const FlashArgs& a,
                                        cudaStream_t stream) {
  const int ntiles = (a.hsp * a.wsp + mma::kTile - 1) / mma::kTile;
  const size_t smem = mma::fwd_smem<D>(ntiles);
  static std::atomic<int> opted[kMaxDevices];
  const cudaError_t e = opt_in_smem(stripe_attention_mma_kernel<D, DROP>, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * (a.H / a.hsp) * (a.W / a.wsp)), (unsigned)a.heads,
                  (unsigned)ntiles);
  using bf = __nv_bfloat16;
  stripe_attention_mma_kernel<D, DROP><<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const float*>(lepe_w), static_cast<bf*>(out), ldo,
      static_cast<float*>(lse), a);
  return cudaGetLastError();
}

static cudaError_t dispatch_attention_mma(int head_dim, const void* q, const void* k,
                                          const void* v, const void* lepe_w, void* out,
                                          int64_t ldo, void* lse, int B, const FlashArgs& a,
                                          cudaStream_t stream) {
#define CSU_ATTN_FWD_MMA(DIM)                                                            \
  if (head_dim == DIM)                                                                   \
    return a.drop.threshold ? launch_attention_mma<DIM, true>(q, k, v, lepe_w, out, ldo, \
                                                              lse, B, a, stream)         \
                            : launch_attention_mma<DIM, false>(q, k, v, lepe_w, out,     \
                                                               ldo, lse, B, a, stream);
  CSU_ATTN_FWD_MMA(16) CSU_ATTN_FWD_MMA(32) CSU_ATTN_FWD_MMA(64)
#undef CSU_ATTN_FWD_MMA
  return cudaErrorInvalidValue;
}

}  // namespace csu

// q, k, v: (B, H*W, *) token tensors whose channel block [0, heads*head_dim)
// of each row is read, rows ldq/ldk/ldv elements apart; lepe_w: (C, 9) float32
// taps, tap (dy+1)*3 + (dx+1) multiplies v at (y+dy, x+dx); out rows ldo apart.
// seed, threshold, inv_keep: the attention dropout (threshold 0: none); win0,
// nwin_global, head0: the windows' and heads' numbering in the mask
// (csu::attn_drop).  The
// tensor-core body reads and writes rows 16 bytes at a time: q, k, v and out
// base and row strides 16-byte aligned; where lse is not null it also writes
// each row's L = m + log(l), (B * windows, hsp*wsp, heads) float32, which
// the tensor-core K-A' reads (the CUDA-core body ignores lse).
CSU_EXPORT int csu_stripe_attention_fwd(int dtype, const void* q, const void* k,
                                        const void* v, const void* lepe_w, void* out,
                                        void* lse, int64_t ldq, int64_t ldk, int64_t ldv,
                                        int64_t ldo, int B, int H, int W, int hsp,
                                        int wsp, int heads, int head_dim, float scale,
                                        uint32_t seed, uint32_t threshold, float inv_keep,
                                        uint32_t win0, uint32_t nwin_global, uint32_t head0,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const csu::AttnDrop drop =
      csu::attn_drop(seed, threshold, inv_keep, H, W, hsp, wsp, win0, nwin_global,
                     head0);
  if (dtype == csu::kFloat32)
    return (int)csu::dispatch_head_dim<float>(head_dim, q, k, v, lepe_w, out, ldq, ldk,
                                              ldv, ldo, B, H, W, hsp, wsp, heads,
                                              scale, drop, s);
  if (csu::mma::serves(dtype, head_dim)) {
    const int N = hsp * wsp;  // the whole-window dropout mask: one N x N tile
    const csu::FlashArgs a{H, W, hsp, wsp, heads, N, scale, drop, ldq, ldk, ldv, 0};
    return (int)csu::dispatch_attention_mma(head_dim, q, k, v, lepe_w, out, ldo, lse, B, a,
                                            s);
  }
  if (dtype == csu::kBFloat16)
    return (int)csu::dispatch_head_dim<__nv_bfloat16>(head_dim, q, k, v, lepe_w, out,
                                                      ldq, ldk, ldv, ldo, B, H, W, hsp,
                                                      wsp, heads, scale, drop, s);
  return (int)cudaErrorInvalidValue;
}
