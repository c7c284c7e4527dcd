// dq of the flash-attention family (flash_attention.cuh): per window, head
// and tile of query rows, a sweep over the window's keys.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_attention_flash.py::
// _flash_dq_kernel (pallas_call at :323) in flash mode, and the query-row
// half of pallas_attention_v2.py::_attn_bwd_kernel (:401) in window mode
// (the tiled K-A' and, launched from csu_stripe_attention_bwd, K-A').
// Per query row i, with L_i from the forward and dO the output cotangent:
//     p_j = exp(round(q_i * scale) . k_j - L_i)    dp_j = drop(dO_i . v_j)
//     ds_j = round(p_j * (dp_j - delta_i))          dq_i = scale * sum_j ds_j k_j
// delta_i = rowsum(dO_i * O_i) is given in flash mode (computed outside, as
// the flash kernels take it); in window mode a first sweep computes
// delta_i = sum_j p_j dp_j, as K-A' does, and writes it for the dk/dv
// kernel.
//
// Two bodies, picked by dtype and head dim (csu_attention_body):
// * bf16 at head dims 16, 32 and 64, the tensor-core body
//   (flash_attention_mma.cuh): a block takes 64 query rows, 16 per warp,
//   whose round(q * scale) and dO stay in registers as mma A fragments; key
//   and value tiles of 64 rows stream through shared memory, double-
//   buffered with cp.async.  Per 16 keys a warp computes S = Qs K^T and
//   dP = dO V^T (mma.sync m16n8k16, float32 accumulation), forms p (exp2
//   with log2(e) folded into one FMA), the keep bits and ds in registers,
//   and feeds the rounded ds straight back as the A operand of dq += ds K.
//   At head dim 32 a score costs 6 tensor-core flops per head column but
//   one exp on the SFU, twice in window mode (the delta sweep and the ds
//   sweep), and with dropout a murmur fmix32 on the integer pipes, which the
//   delta sweep leaves in shared memory for the ds sweep (a bit per score,
//   N / 16 bytes per thread): those, not the tensor cores, set the pace.
// * float32 (the exact-f32 route; no configuration runs the family in it)
//   and head dim 8, the CUDA-core body: each thread owns a query row (q,
//   dO and the dq accumulator in registers) and the keys stream through
//   shared-memory tiles of 32.
#include "flash_attention_mma.cuh"

namespace csu {

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kFlashThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta, int delta_given, T* __restrict__ dq,
                FlashArgs a) {
  using RS = RowSplit<D>;
  constexpr int DL = RS::DL, LPR = RS::LPR, TK = kFlashTile;
  __shared__ __align__(16) float Ks[TK * D];
  __shared__ __align__(16) float Vs[TK * D];

  const int N = a.hsp * a.wsp;
  const int win = blockIdx.x, head = blockIdx.y;
  const int i = blockIdx.z * RS::ROWS + threadIdx.x / LPR;
  const int d0 = (threadIdx.x % LPR) * DL;
  const bool live = i < N;
  const WindowRows tok(a, win);
  const int c0 = head * D;
  const int64_t ti = tok(live ? i : 0);
  const int64_t stat = ((int64_t)win * N + (live ? i : 0)) * a.heads + head;

  float qr[DL], gr[DL], acc[DL];
  load_row<T, DL>(qr, q, ti, a.ldq, c0 + d0);
  load_row<T, DL>(gr, dout, ti, a.ldg, c0 + d0);
#pragma unroll
  for (int d = 0; d < DL; ++d) {
    qr[d] = round_to<T>(qr[d] * a.scale);
    acc[d] = 0.f;
  }
  const float L = lse[stat];
  const uint32_t wh = win_head_id(win, head);
  const MaskPos row(live ? i : 0, a.mask_tile);

  // the scores and masked dp of key jj of the staged tile
  auto score = [&](int jj, const MaskPos& col, float& p, float& dp) {
    p = expf(row_sum<LPR>(dot_smem<DL>(qr, Ks + jj * D + d0)) - L);
    dp = row_sum<LPR>(dot_smem<DL>(gr, Vs + jj * D + d0));
    if constexpr (DROP)
      dp = flash_keep(a.drop, wh, row, col, a.mask_tile) ? dp * a.drop.inv_keep : 0.f;
  };

  float dl = 0.f;
  if (delta_given) {
    dl = delta[stat];
  } else {
    for (int j0 = 0; j0 < N; j0 += TK) {
      const int nk = min(TK, N - j0);
      __syncthreads();
      stage_rows<T, D>(Ks, k, a.ldk, tok, j0, nk, c0);
      stage_rows<T, D>(Vs, v, a.ldv, tok, j0, nk, c0);
      __syncthreads();
      MaskPos col(j0, a.mask_tile);
      for (int jj = 0; jj < nk; ++jj) {
        float p, dp;
        score(jj, col, p, dp);
        dl = fmaf(p, dp, dl);
        if constexpr (DROP) col.next(a.mask_tile);
      }
    }
    if (live && d0 == 0) delta[stat] = dl;
  }

  for (int j0 = 0; j0 < N; j0 += TK) {
    const int nk = min(TK, N - j0);
    __syncthreads();
    stage_rows<T, D>(Ks, k, a.ldk, tok, j0, nk, c0);
    stage_rows<T, D>(Vs, v, a.ldv, tok, j0, nk, c0);
    __syncthreads();
    MaskPos col(j0, a.mask_tile);
    for (int jj = 0; jj < nk; ++jj) {
      float p, dp;
      score(jj, col, p, dp);
      axpy_smem<DL>(round_to<T>(p * (dp - dl)), Ks + jj * D + d0, acc);
      if constexpr (DROP) col.next(a.mask_tile);
    }
  }

  if (!live) return;
  const int ldd = a.heads * D;
#pragma unroll
  for (int d = 0; d < DL; ++d) dq[ti * ldd + c0 + d0 + d] = from_f<T>(acc[d] * a.scale);
}

template <typename T, int D, bool DROP>
static cudaError_t launch_flash_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, void* delta,
                                   int delta_given, void* dq, int B, const FlashArgs& a,
                                   cudaStream_t stream) {
  const int N = a.hsp * a.wsp;
  const dim3 grid((unsigned)(B * (a.H / a.hsp) * (a.W / a.wsp)), (unsigned)a.heads,
                  (unsigned)((N + RowSplit<D>::ROWS - 1) / RowSplit<D>::ROWS));
  flash_dq_kernel<T, D, DROP><<<grid, kFlashThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), delta_given, static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_flash_dq(int head_dim, const void* q, const void* k,
                                     const void* v, const void* dout, const void* lse,
                                     void* delta, int delta_given, void* dq, int B,
                                     const FlashArgs& a, cudaStream_t stream) {
#define CSU_FLASH_DQ(DIM)                                                                 \
  if constexpr (!mma::serves(dtype_code<T>(), DIM))                                       \
    if (head_dim == DIM)                                                                  \
      return a.drop.threshold                                                             \
                 ? launch_flash_dq<T, DIM, true>(q, k, v, dout, lse, delta, delta_given,  \
                                                 dq, B, a, stream)                        \
                 : launch_flash_dq<T, DIM, false>(q, k, v, dout, lse, delta, delta_given, \
                                                  dq, B, a, stream);
  CSU_FLASH_HEAD_DIMS(CSU_FLASH_DQ)
#undef CSU_FLASH_DQ
  return cudaErrorInvalidValue;
}

// The tensor-core body (bf16, D in 16, 32, 64); grid (windows, heads,
// ceil(N / 64)), kThreads threads, dynamic shared memory flash_dq_mma_smem:
// q, dO, two stages of k and v and, where the delta sweep runs with dropout,
// each thread's keep bits of each key tile (one 32-bit word: 4 chunks of 8),
// so that the ds sweep reads them instead of hashing again.
template <int D>
size_t flash_dq_mma_smem(int N, bool keep_words) {
  const size_t tiles = 6 * mma::Tile<D>::ELEMS * sizeof(__nv_bfloat16);
  const int ntiles = (N + mma::kTile - 1) / mma::kTile;
  return tiles + (keep_words ? (size_t)ntiles * mma::kThreads * sizeof(uint32_t) : 0);
}

template <int D, bool DROP, bool KEYS>
__global__ void __launch_bounds__(mma::kThreads)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta, int delta_given,
                    __nv_bfloat16* __restrict__ dq, FlashArgs a) {
  using namespace mma;
  using TL = Tile<D>;
  constexpr int KS = D / 16, NT = D / 8, LD = TL::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qt = reinterpret_cast<bf16*>(smem);
  bf16* Gt = Qt + TL::ELEMS;
  bf16* Kt = Gt + TL::ELEMS;      // two stages
  bf16* Vt = Kt + 2 * TL::ELEMS;  // two stages
  uint32_t* keep_words = reinterpret_cast<uint32_t*>(Vt + 2 * TL::ELEMS);  // (ntiles, kThreads)

  // queries [0, N); keys [0, NK), NK = N but with KEYS (v1's n_valid)
  const int N = a.hsp * a.wsp, NK = KEYS ? a.nkeys : N;
  const int win = blockIdx.x, head = blockIdx.y, i0 = blockIdx.z * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const WindowRows tok(a, win);
  const int c0 = head * D;

  load_tile<D>(Qt, q, a.ldq, tok, i0, N, c0);
  load_tile<D>(Gt, dout, a.ldg, tok, i0, N, c0);
  load_tile<D>(Kt, k, a.ldk, tok, 0, NK, c0);
  load_tile<D>(Vt, v, a.ldv, tok, 0, NK, c0);
  cp_async_commit();

  // the thread's two rows of the warp's 16: i0 + 16 warp + lane / 4 (+ 8)
  int row[2];
  int64_t stat[2];
  float nl2[2], dl[2];  // -L * log2(e), delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = i0 + warp * 16 + (lane >> 2) + 8 * r;
    const bool live = row[r] < N;
    stat[r] = ((int64_t)win * N + (live ? row[r] : 0)) * a.heads + head;
    nl2[r] = live ? -lse[stat[r]] * kLog2e : 0.f;
    dl[r] = live && delta_given ? delta[stat[r]] : 0.f;
  }
  const uint32_t wh = win_head_id(win, head);
  const KeepFixed fixed[2] = {KeepFixed(row[0], a.mask_tile), KeepFixed(row[1], a.mask_tile)};

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KS][4], ga[KS][4];  // A fragments of round(q * scale) and dO
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    load_a(qa[ks], Qt + warp * 16 * LD + ks * 16, LD, lane);
    load_a(ga[ks], Gt + warp * 16 * LD + ks * 16, LD, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack(qa[ks][e]);
      qa[ks][e] = pack(f.x * a.scale, f.y * a.scale);
    }
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (NK + kTile - 1) / kTile;
  // pass 0 (window mode only): delta; pass 1: dq
  for (int pass = delta_given ? 1 : 0; pass < 2; ++pass) {
    if (pass == 1 && !delta_given) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the four lanes of a row hold its partial sums
        dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
        dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
        if (t == 0 && row[r] < N) delta[stat[r]] = dl[r];
      }
      // the key stream again from tile 0 (the last __syncthreads freed both stages)
      load_tile<D>(Kt, k, a.ldk, tok, 0, NK, c0);
      load_tile<D>(Vt, v, a.ldv, tok, 0, NK, c0);
      cp_async_commit();
    }
    for (int kt = 0; kt < ntiles; ++kt) {
      const int stage = kt & 1, j0 = kt * kTile;
      if (kt + 1 < ntiles) {
        load_tile<D>(Kt + (stage ^ 1) * TL::ELEMS, k, a.ldk, tok, j0 + kTile, NK, c0);
        load_tile<D>(Vt + (stage ^ 1) * TL::ELEMS, v, a.ldv, tok, j0 + kTile, NK, c0);
      }
      cp_async_commit();  // empty at the last tile, so that wait<1> covers this one
      cp_async_wait<1>();
      __syncthreads();
      const bf16* Ks = Kt + stage * TL::ELEMS;
      const bf16* Vs = Vt + stage * TL::ELEMS;
      const KeepTile keep(a.drop, wh, a.mask_tile, j0, NK);
      uint32_t kbase[2] = {0u, 0u}, kcnt[2] = {0u, 0u}, kstep = 1;
      // the ds sweep after a delta sweep reads the bits that sweep hashed
      const bool reread = DROP && pass == 1 && !delta_given;
      uint32_t word = reread ? keep_words[kt * kThreads + threadIdx.x] : 0u;
      if constexpr (DROP) {
        keep_hoist(keep, fixed[0], true, kbase[0], kcnt[0], kstep);
        keep_hoist(keep, fixed[1], true, kbase[1], kcnt[1], kstep);
      }
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc) {
        if (j0 + kc * 16 >= NK) break;
        float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[4];
          load_b_rows(b, Ks + kc * 16 * LD + ks * 16, LD, lane);
          mma::mma(s[0], qa[ks], b[0], b[1]);
          mma::mma(s[1], qa[ks], b[2], b[3]);
          load_b_rows(b, Vs + kc * 16 * LD + ks * 16, LD, lane);
          mma::mma(dp[0], ga[ks], b[0], b[1]);
          mma::mma(dp[1], ga[ks], b[2], b[3]);
        }
        if (j0 + kc * 16 + 16 > NK) {  // the keys past NK (zero-filled): p = exp2(-inf) = 0
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j0 + kc * 16 + nt * 8 + 2 * t + (e & 1) >= NK) s[nt][e] = -INFINITY;
        }
        uint32_t bits = 0xffu;
        if constexpr (DROP) {
          if (reread) {
            bits = (word >> (kc * 8)) & 0xffu;
          } else {
            bits = keep_bits(keep, fixed, kbase, kcnt, kstep, true, kc * 16, t);
            word |= bits << (kc * 8);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = exp2_sfu(fmaf(s[nt][e], kLog2e, nl2[r]));
            float d = dp[nt][e];
            if constexpr (DROP) d = (bits >> (nt * 4 + e)) & 1u ? d * a.drop.inv_keep : 0.f;
            if (pass == 0)
              dl[r] = fmaf(p, d, dl[r]);
            else
              s[nt][e] = p * (d - dl[r]);
          }
        if (pass == 1) {
          const uint32_t da[4] = {pack(s[0][0], s[0][1]), pack(s[0][2], s[0][3]),
                                  pack(s[1][0], s[1][1]), pack(s[1][2], s[1][3])};
#pragma unroll
          for (int dn = 0; dn < KS; ++dn) {
            uint32_t b[4];
            load_b_cols(b, Ks + kc * 16 * LD + dn * 16, LD, lane);
            mma::mma(acc[2 * dn], da, b[0], b[1]);
            mma::mma(acc[2 * dn + 1], da, b[2], b[3]);
          }
        }
      }
      // a thread's own words: read back by the same thread, no barrier needed
      if (DROP && pass == 0) keep_words[kt * kThreads + threadIdx.x] = word;
      __syncthreads();
    }
  }

  const int ldd = a.heads * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= N) continue;
    bf16* out = dq + tok(row[r]) * ldd + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale);
  }
}

template <int D, bool DROP, bool KEYS>
static cudaError_t launch_flash_dq_mma(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, void* delta,
                                       int delta_given, void* dq, int B, const FlashArgs& a,
                                       cudaStream_t stream) {
  const int N = a.hsp * a.wsp;
  const size_t smem = flash_dq_mma_smem<D>(N, DROP && !delta_given);
  static std::atomic<int> opted[kMaxDevices];
  const cudaError_t e = opt_in_smem(flash_dq_mma_kernel<D, DROP, KEYS>, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(B * (a.H / a.hsp) * (a.W / a.wsp)), (unsigned)a.heads,
                  (unsigned)((N + mma::kRows - 1) / mma::kRows));
  using bf = __nv_bfloat16;
  flash_dq_mma_kernel<D, DROP, KEYS><<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), delta_given, static_cast<bf*>(dq), a);
  return cudaGetLastError();
}

cudaError_t dispatch_flash_dq_mma(int head_dim, const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, void* delta,
                                  int delta_given, void* dq, int B, const FlashArgs& a,
                                  cudaStream_t stream) {
#define CSU_FLASH_DQ_MMA(DIM)                                                                \
  if (head_dim == DIM)                                                                       \
    return a.nkeys ? launch_flash_dq_mma<DIM, false, true>(q, k, v, dout, lse, delta,        \
                                                           delta_given, dq, B, a, stream)    \
           : a.drop.threshold                                                                \
               ? launch_flash_dq_mma<DIM, true, false>(q, k, v, dout, lse, delta, delta_given, \
                                                       dq, B, a, stream)                     \
               : launch_flash_dq_mma<DIM, false, false>(q, k, v, dout, lse, delta,           \
                                                        delta_given, dq, B, a, stream);
  CSU_FLASH_DQ_MMA(16) CSU_FLASH_DQ_MMA(32) CSU_FLASH_DQ_MMA(64)
#undef CSU_FLASH_DQ_MMA
  return cudaErrorInvalidValue;
}

}  // namespace csu

// dq of csu_flash_attention_fwd.  q, k, v, geometry, scale, mask_tile and
// the dropout as there; dout the output cotangent, rows ldg apart; lse the
// forward's; delta (B * windows, hsp*wsp, heads) float32, read when
// delta_given, else computed and written here; dq (B, H*W, heads*head_dim)
// contiguous.
CSU_EXPORT int csu_flash_attention_dq(int dtype, const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, void* delta,
                                      int delta_given, void* dq, int64_t ldq, int64_t ldk,
                                      int64_t ldv, int64_t ldg, int B, int H, int W, int hsp,
                                      int wsp, int heads, int head_dim, float scale,
                                      int mask_tile, uint32_t seed, uint32_t threshold,
                                      float inv_keep, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const csu::FlashArgs a{H, W, hsp, wsp, heads, mask_tile, scale,
                         csu::AttnDrop{seed, threshold, inv_keep}, ldq, ldk, ldv, ldg};
  if (dtype == csu::kFloat32)
    return (int)csu::dispatch_flash_dq<float>(head_dim, q, k, v, dout, lse, delta,
                                              delta_given, dq, B, a, s);
  if (csu::mma::serves(dtype, head_dim))
    return (int)csu::dispatch_flash_dq_mma(head_dim, q, k, v, dout, lse, delta, delta_given,
                                           dq, B, a, s);
  if (dtype == csu::kBFloat16)
    return (int)csu::dispatch_flash_dq<__nv_bfloat16>(head_dim, q, k, v, dout, lse, delta,
                                                      delta_given, dq, B, a, s);
  return (int)cudaErrorInvalidValue;
}
