// K-A': the backward of K-A (csrc/stripe_attention.cu), in a source of its
// own so that the build compiles the two in parallel.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_attention_v2.py::_attn_bwd_kernel
// (pallas_call at :401, reached through _branch_bwd_impl).  Per window and
// head, with s = round(q*scale) k^T, p = softmax(s), dO the output cotangent:
//     dv = round(p)^T dO + LePE^T(dO)       dp = dO v^T
//     ds = round(p * (dp - rowsum(dp * p)))
//     dq = scale * ds k                     dk = scale * ds^T q
//     dw[tap, c] += sum over the window of dO * shift_tap(v)
// rounding where the TPU kernel rounds to the compute dtype.  With dropout
// each score's keep bit is recomputed from the hash, p becomes pd = keep ?
// p / (1 - rate) : 0 for dv, and dp is masked and scaled the same way before
// the softmax VJP, so the row statistic rowsum(dp * p) is taken over the
// masked dp (pallas_attention_v2.py:253-262).  dw crosses windows: each
// block writes its (9, head_dim) partial in float32 and the caller sums the
// partials in a fixed order, so the result is deterministic.
//
// What bounds it on the H100: about 10 N flops per q/k/v/dO element against
// 14 bytes of q, k, v, dO read and dq, dk, dv written (bf16): at the
// windows K-A' takes (N <= 384 at head dim 32) device memory by the
// roofline.  Two bodies, picked by dtype and head dim (csu_attention_body):
// * bf16 at head dims 16, 32 and 64, the tensor-core bodies of the tiled
//   K-A' (flash_attention_dq.cu and flash_attention_dkv.cu, mma.sync
//   m16n8k16), launched one after the other from this entry in window mode
//   with the whole-window mask (one N x N tile): a dq block takes 64 query
//   rows and streams the window's k and v, a dk/dv block 64 key rows and
//   streams q, dO, L and delta, in 64-row tiles double-buffered by cp.async
//   (a variant that loaded the window's other side whole into shared memory
//   once was slower on the flagship's windows: fewer blocks per SM and no
//   overlap of loads with products).  p = exp(s - L) from the L that K-A's
//   tensor-core body writes; dq computes delta = rowsum(dp * p) in a first
//   sweep and writes it for dk/dv, which adds the LePE transpose to dv and
//   writes a dw partial per 64 key rows.  Grid (windows, heads, ceil(N /
//   64)): 512 blocks a kernel at the flagship's stage 3, where one block per
//   (window, head) gave 128 for 132 SMs.  Three exps a score (dq's two
//   sweeps, dk/dv's one), each block's loads of its window and the dk/dv
//   epilogue set the pace, not device memory.
// * float32 (the exact-f32 route) and head dim 8, the CUDA-core body below:
//   one block per (window, head) holds Q, K, V and dO of the window
//   (float32, rows padded to D+1) in shared memory: 154 KB at N = 256,
//   D = 32, so nothing of size N x N leaves the SM.  Two phases, as
//   FlashAttention-2's backward splits them, so that no two warps add into
//   one row: phase 1 gives each warp query rows (recompute the score row,
//   softmax, dp row, ds row; dq of the row; keep the row's max, sum and
//   rowsum(dp*p)); phase 2 gives each warp key rows and recomputes p and ds
//   column-wise from those row statistics (bitwise the same values, the same
//   FMA chains), accumulating dk and dv of its key with lanes over the head
//   dim.
#include "flash_attention_mma.cuh"

namespace csu {

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kAttnThreads)
stripe_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ lepe_w,
                            const T* __restrict__ dout, T* __restrict__ dq,
                            T* __restrict__ dk, T* __restrict__ dv,
                            float* __restrict__ dw_part, int64_t ldq, int64_t ldk,
                            int64_t ldv, int64_t ldg, int64_t ldd, int H, int W,
                            int hsp, int wsp, float scale, AttnDrop drop) {
  extern __shared__ float smem[];
  constexpr int KS = D + 1;
  const int N = hsp * wsp;
  const int nwarps = blockDim.x >> 5;
  float* Qs = smem;             // N x (D + 1), q as given (unscaled)
  float* Ks = Qs + N * KS;
  float* Vs = Ks + N * KS;
  float* Gs = Vs + N * KS;      // dO
  float* row_max = Gs + N * KS;
  float* row_sum = row_max + N;
  float* row_dot = row_sum + N;  // rowsum(dp * p)
  float* bufs = row_dot + N;     // two rows of N per warp

  const int nh = H / hsp, nw = W / wsp;
  const int win = blockIdx.x, head = blockIdx.y;
  const int C = gridDim.y * D;
  const int b = win / (nh * nw);
  const int wy = (win / nw) % nh, wx = win % nw;
  const int64_t row0 = (int64_t)b * H * W;
  const int c0 = head * D;
  const uint32_t hbase =
      DROP ? drop_base(drop.seed, drop_window(drop, win), drop_head(drop, head)) : 0u;
  auto tok = [&](int n) -> int64_t {
    const int ty = n / wsp, tx = n - ty * wsp;
    return row0 + (int64_t)(wy * hsp + ty) * W + (wx * wsp + tx);
  };

  for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
    const int n = idx / D, d = idx - n * D;
    const int64_t t = tok(n);
    Qs[n * KS + d] = to_f(q[t * ldq + c0 + d]);
    Ks[n * KS + d] = to_f(k[t * ldk + c0 + d]);
    Vs[n * KS + d] = to_f(v[t * ldv + c0 + d]);
    Gs[n * KS + d] = to_f(dout[t * ldg + c0 + d]);
  }
  __syncthreads();

  // dw partial of this (window, head): tap (dy+1)*3 + (dx+1) pairs dO at
  // (y, x) with v at (y+dy, x+dx) inside the window
  for (int idx = threadIdx.x; idx < 9 * D; idx += blockDim.x) {
    const int tap = idx / D, d = idx - tap * D;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    float acc = 0.f;
    for (int n = 0; n < N; ++n) {
      const int ty = n / wsp, tx = n - ty * wsp;
      const int yy = ty + dy, xx = tx + dx;
      if (yy < 0 || yy >= hsp || xx < 0 || xx >= wsp) continue;
      acc = fmaf(Gs[n * KS + d], Vs[(yy * wsp + xx) * KS + d], acc);
    }
    dw_part[((int64_t)win * 9 + tap) * C + c0 + d] = acc;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* P = bufs + warp * 2 * N;  // p row, then round(p) column
  float* P2 = P + N;               // dp row, then ds
  constexpr int G = D >= 32 ? 1 : 32 / D;     // lanes that share one column
  constexpr int CPL = D >= 32 ? D / 32 : 1;   // columns per lane
  const int dcol = D >= 32 ? lane : lane % D;
  const int part = D >= 32 ? 0 : lane / D;

  // phase 1: query rows
  for (int i = warp; i < N; i += nwarps) {
    float qr[D], gr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = round_to<T>(Qs[i * KS + d] * scale);
      gr[d] = Gs[i * KS + d];
    }
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
    float dot = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = P[j] / sum;
      const float* vr = Vs + j * KS;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dp = fmaf(gr[d], vr[d], dp);
      if constexpr (DROP)
        dp = drop_keep(hbase, (uint32_t)(i * N + j), drop.threshold) ? dp * drop.inv_keep
                                                                      : 0.f;
      P2[j] = dp;
      P[j] = p;
      dot = fmaf(dp, p, dot);
    }
    dot = warp_sum(dot);
    for (int j = lane; j < N; j += 32) P2[j] = round_to<T>(P[j] * (P2[j] - dot));
    if (lane == 0) {
      row_max[i] = mx;
      row_sum[i] = sum;
      row_dot[i] = dot;
    }
    __syncwarp();

    float acc[CPL];
#pragma unroll
    for (int r = 0; r < CPL; ++r) acc[r] = 0.f;
    for (int j = part; j < N; j += G) {
      const float ds = P2[j];
      const float* kr = Ks + j * KS + dcol;
#pragma unroll
      for (int r = 0; r < CPL; ++r) acc[r] = fmaf(ds, kr[32 * r], acc[r]);
    }
    if constexpr (G > 1) {
#pragma unroll
      for (int off = D; off < 32; off <<= 1)
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
    }
    if (part == 0) {
      const int64_t ti = tok(i);
#pragma unroll
      for (int r = 0; r < CPL; ++r)
        dq[ti * ldd + c0 + dcol + 32 * r] = from_f<T>(acc[r] * scale);
    }
    __syncwarp();  // P and P2 are rewritten by the warp's next row
  }
  __syncthreads();  // the row statistics of every warp

  // phase 2: key rows
  for (int j = warp; j < N; j += nwarps) {
    float kr[D], vr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = Ks[j * KS + d];
      vr[d] = Vs[j * KS + d];
    }
    for (int i = lane; i < N; i += 32) {
      const float* qi = Qs + i * KS;
      const float* gi = Gs + i * KS;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(round_to<T>(qi[d] * scale), kr[d], s);
        dp = fmaf(gi[d], vr[d], dp);
      }
      const float p = expf(s - row_max[i]) / row_sum[i];
      float pd = p;
      if constexpr (DROP) {
        const bool keep = drop_keep(hbase, (uint32_t)(i * N + j), drop.threshold);
        pd = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? dp * drop.inv_keep : 0.f;
      }
      P[i] = round_to<T>(pd);
      P2[i] = round_to<T>(p * (dp - row_dot[i]));
    }
    __syncwarp();

    float av[CPL], ak[CPL];
#pragma unroll
    for (int r = 0; r < CPL; ++r) av[r] = ak[r] = 0.f;
    for (int i = part; i < N; i += G) {
      const float p = P[i], ds = P2[i];
      const float* gi = Gs + i * KS + dcol;
      const float* qi = Qs + i * KS + dcol;
#pragma unroll
      for (int r = 0; r < CPL; ++r) {
        av[r] = fmaf(p, gi[32 * r], av[r]);
        ak[r] = fmaf(ds, qi[32 * r], ak[r]);
      }
    }
    if constexpr (G > 1) {
#pragma unroll
      for (int off = D; off < 32; off <<= 1) {
        av[0] += __shfl_xor_sync(0xffffffffu, av[0], off);
        ak[0] += __shfl_xor_sync(0xffffffffu, ak[0], off);
      }
    }
    if (part == 0) {
      const int64_t tj = tok(j);
      const int ty = j / wsp, tx = j - ty * wsp;
#pragma unroll
      for (int r = 0; r < CPL; ++r) {
        const int d = dcol + 32 * r;
        // LePE transpose: out(y, x) took w[dy, dx] * v(y+dy, x+dx)
        const float* w9 = lepe_w + (int64_t)(c0 + d) * 9;
        float lt = 0.f;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
          const int yy = ty - dy;
          if (yy < 0 || yy >= hsp) continue;
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) {
            const int xx = tx - dx;
            if (xx < 0 || xx >= wsp) continue;
            lt = fmaf(w9[(dy + 1) * 3 + (dx + 1)], Gs[(yy * wsp + xx) * KS + d], lt);
          }
        }
        dk[tj * ldd + c0 + d] = from_f<T>(ak[r] * scale);
        dv[tj * ldd + c0 + d] = from_f<T>(av[r] + lt);
      }
    }
    __syncwarp();
  }
}

template <typename T, int D, bool DROP>
static cudaError_t launch_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* lepe_w, const void* dout, void* dq,
                                        void* dk, void* dv, void* dw_part, int64_t ldq,
                                        int64_t ldk, int64_t ldv, int64_t ldg, int B,
                                        int H, int W, int hsp, int wsp, int heads,
                                        float scale, AttnDrop drop, cudaStream_t stream) {
  const int N = hsp * wsp;
  const size_t smem = sizeof(float) * ((size_t)4 * N * (D + 1) + (size_t)3 * N +
                                       (size_t)2 * (kAttnThreads / 32) * N);
  static std::atomic<int> opted[kMaxDevices];
  const cudaError_t e = opt_in_smem(stripe_attention_bwd_kernel<T, D, DROP>, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * (H / hsp) * (W / wsp)), (unsigned)heads);
  stripe_attention_bwd_kernel<T, D, DROP><<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lepe_w), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dw_part), ldq, ldk, ldv, ldg, (int64_t)heads * D, H, W, hsp,
      wsp, scale, drop);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_bwd_head_dim(int head_dim, const void* q, const void* k,
                                         const void* v, const void* lepe_w,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* dw_part, int64_t ldq, int64_t ldk,
                                         int64_t ldv, int64_t ldg, int B, int H, int W,
                                         int hsp, int wsp, int heads, float scale,
                                         AttnDrop drop, cudaStream_t stream) {
#define CSU_ATTN_BWD(DIM)                                                                 \
  if constexpr (!mma::serves(dtype_code<T>(), DIM))                                       \
    if (head_dim == DIM)                                                                  \
      return drop.threshold                                                               \
                 ? launch_attention_bwd<T, DIM, true>(q, k, v, lepe_w, dout, dq, dk, dv,  \
                                                      dw_part, ldq, ldk, ldv, ldg, B, H,  \
                                                      W, hsp, wsp, heads, scale, drop,    \
                                                      stream)                             \
                 : launch_attention_bwd<T, DIM, false>(q, k, v, lepe_w, dout, dq, dk, dv, \
                                                       dw_part, ldq, ldk, ldv, ldg, B, H, \
                                                       W, hsp, wsp, heads, scale, drop,   \
                                                       stream);
  CSU_FLASH_HEAD_DIMS(CSU_ATTN_BWD)
#undef CSU_ATTN_BWD
  return cudaErrorInvalidValue;
}

}  // namespace csu

// Backward of csu_stripe_attention_fwd.  q, k, v, lepe_w as there; dout the
// output cotangent, rows ldg apart; dq, dk, dv (B, H*W, heads*head_dim)
// contiguous.  The tensor-core body (bf16 at head dims 16, 32, 64) reads
// lse, (B * windows, hsp*wsp, heads) float32, as K-A's tensor-core body
// wrote it, uses delta, of the same shape, as scratch, and writes dw_part
// (B * windows * ceil(hsp*wsp / 64), 9, heads*head_dim) float32; the
// CUDA-core body ignores lse and delta and writes dw_part (B * windows, 9,
// heads*head_dim).  The caller sums dw_part over its first axis.  seed,
// threshold, inv_keep, win0, nwin_global and head0 must be the forward's.  Two
// kernels, one after the other on the stream, in the tensor-core body, one in the CUDA-core body.
CSU_EXPORT int csu_stripe_attention_bwd(int dtype, const void* q, const void* k,
                                        const void* v, const void* lepe_w,
                                        const void* dout, const void* lse, void* delta,
                                        void* dq, void* dk, void* dv, void* dw_part,
                                        int64_t ldq, int64_t ldk, int64_t ldv, int64_t ldg,
                                        int B, int H, int W, int hsp, int wsp, int heads,
                                        int head_dim, float scale, uint32_t seed,
                                        uint32_t threshold, float inv_keep, uint32_t win0,
                                        uint32_t nwin_global, uint32_t head0, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const csu::AttnDrop drop =
      csu::attn_drop(seed, threshold, inv_keep, H, W, hsp, wsp, win0, nwin_global,
                     head0);
  if (dtype == csu::kFloat32)
    return (int)csu::dispatch_bwd_head_dim<float>(head_dim, q, k, v, lepe_w, dout, dq,
                                                  dk, dv, dw_part, ldq, ldk, ldv, ldg, B,
                                                  H, W, hsp, wsp, heads, scale, drop, s);
  if (csu::mma::serves(dtype, head_dim)) {
    const int N = hsp * wsp;  // the whole-window dropout mask: one N x N tile
    const csu::FlashArgs a{H, W, hsp, wsp, heads, N, scale, drop, ldq, ldk, ldv, ldg};
    const cudaError_t e =
        csu::dispatch_flash_dq_mma(head_dim, q, k, v, dout, lse, delta, 0, dq, B, a, s);
    if (e != cudaSuccess) return (int)e;
    return (int)csu::dispatch_flash_dkv_mma(head_dim, q, k, v, lepe_w, dout, lse, delta, dk,
                                            dv, dw_part, B, a, s);
  }
  if (dtype == csu::kBFloat16)
    return (int)csu::dispatch_bwd_head_dim<__nv_bfloat16>(
        head_dim, q, k, v, lepe_w, dout, dq, dk, dv, dw_part, ldq, ldk, ldv, ldg, B, H, W,
        hsp, wsp, heads, scale, drop, s);
  return (int)cudaErrorInvalidValue;
}
