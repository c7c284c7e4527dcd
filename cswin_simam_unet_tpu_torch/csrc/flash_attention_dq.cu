// dq of the flash-attention family (flash_attention.cuh): per window, head
// and tile of query rows, a sweep over the window's keys in shared-memory
// tiles of 32.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_attention_flash.py::
// _flash_dq_kernel (pallas_call at :323) in flash mode, and the query-row
// half of pallas_attention_v2.py::_attn_bwd_kernel (:401) in window mode.
// Per query row i, with L_i from the forward and dO the output cotangent:
//     p_j = exp(round(q_i * scale) . k_j - L_i)    dp_j = drop(dO_i . v_j)
//     ds_j = round(p_j * (dp_j - delta_i))          dq_i = scale * sum_j ds_j k_j
// delta_i = rowsum(dO_i * O_i) is given in flash mode (computed outside, as
// the flash kernels take it); in window mode a first sweep computes
// delta_i = sum_j p_j dp_j, as K-A' does, and writes it for the dk/dv
// kernel.  Each thread owns a query row: q, dO and the dq accumulator stay
// in registers.
#include "flash_attention.cuh"

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
  if (head_dim == DIM)                                                                    \
    return a.drop.threshold ? launch_flash_dq<T, DIM, true>(q, k, v, dout, lse, delta,    \
                                                            delta_given, dq, B, a, stream) \
                            : launch_flash_dq<T, DIM, false>(q, k, v, dout, lse, delta,   \
                                                             delta_given, dq, B, a,       \
                                                             stream);
  CSU_FLASH_HEAD_DIMS(CSU_FLASH_DQ)
#undef CSU_FLASH_DQ
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
  if (dtype == csu::kBFloat16)
    return (int)csu::dispatch_flash_dq<__nv_bfloat16>(head_dim, q, k, v, dout, lse, delta,
                                                      delta_given, dq, B, a, s);
  return (int)cudaErrorInvalidValue;
}
