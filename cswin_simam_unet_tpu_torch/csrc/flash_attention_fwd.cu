// The forward of the flash-attention family (flash_attention.cuh): per
// window, head and tile of query rows, an online-softmax sweep over the
// window's keys in shared-memory tiles of 32.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_attention_flash.py::
// _flash_fwd_kernel (pallas_call at :291) in flash mode, and
// pallas_attention_v2.py::_attn_kernel (:359) for windows too large for
// K-A in window mode.  Per query row i:
//     s_j = round(q_i * scale) . k_j          m, l: running max and sum
//     acc = alpha * acc + round(drop(exp(s_j - m))) v_j
//     out_i = round(acc / l [+ LePE(v)_i])      L_i = m + log(l)
// Each thread owns a query row; the keys of a tile are scored into
// registers first, so the running max moves once per tile, not per key.
#include "flash_attention.cuh"

namespace csu {

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ lepe_w, T* __restrict__ out,
                 float* __restrict__ lse, FlashArgs a) {
  using RS = RowSplit<D>;
  constexpr int DL = RS::DL, LPR = RS::LPR, TK = kFlashTile;
  __shared__ __align__(16) float Ks[TK * D];
  __shared__ __align__(16) float Vs[TK * D];

  const int N = a.hsp * a.wsp;
  const int win = blockIdx.x, head = blockIdx.y;
  const int i = blockIdx.z * RS::ROWS + threadIdx.x / LPR;
  const int d0 = (threadIdx.x % LPR) * DL;  // this thread's columns c0 + d0 + [0, DL)
  const bool live = i < N;
  const WindowRows tok(a, win);
  const int c0 = head * D;
  const int64_t ti = tok(live ? i : 0);

  float qr[DL], acc[DL];
  load_row<T, DL>(qr, q, ti, a.ldq, c0 + d0);
#pragma unroll
  for (int d = 0; d < DL; ++d) {
    qr[d] = round_to<T>(qr[d] * a.scale);
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const uint32_t wh = win_head_id(win, head);
  const MaskPos row(live ? i : 0, a.mask_tile);

  for (int j0 = 0; j0 < N; j0 += TK) {
    const int nk = min(TK, N - j0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<T, D>(Ks, k, a.ldk, tok, j0, nk, c0);
    stage_rows<T, D>(Vs, v, a.ldv, tok, j0, nk, c0);
    __syncthreads();

    float s[TK];
    float mt = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < TK; ++jj) {
      s[jj] = row_sum<LPR>(dot_smem<DL>(qr, Ks + jj * D + d0));
      if (jj >= nk) s[jj] = -INFINITY;
      mt = fmaxf(mt, s[jj]);
    }
    const float m_new = fmaxf(m, mt);  // finite: key j0 is live
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[d] *= alpha;
    MaskPos col(j0, a.mask_tile);
#pragma unroll
    for (int jj = 0; jj < TK; ++jj) {
      float p = expf(s[jj] - m_new);
      l += p;
      if constexpr (DROP) {
        p = flash_keep(a.drop, wh, row, col, a.mask_tile) ? p * a.drop.inv_keep : 0.f;
        col.next(a.mask_tile);
      }
      axpy_smem<DL>(round_to<T>(p), Vs + jj * D + d0, acc);
    }
    m = m_new;
  }

  if (!live) return;
  const int ldo = a.heads * D;
  const int ty = i / a.wsp, tx = i - ty * a.wsp;
#pragma unroll
  for (int d = 0; d < DL; ++d) {
    const int c = c0 + d0 + d;
    float o = acc[d] / l;
    if (lepe_w != nullptr) o += lepe_at(v, a.ldv, tok, ty, tx, c, lepe_w + (int64_t)c * 9, 1);
    out[ti * ldo + c] = from_f<T>(o);
  }
  if (d0 == 0) lse[((int64_t)win * N + i) * a.heads + head] = m + logf(l);
}

template <typename T, int D, bool DROP>
static cudaError_t launch_flash_fwd(const void* q, const void* k, const void* v,
                                    const void* lepe_w, void* out, void* lse, int B,
                                    const FlashArgs& a, cudaStream_t stream) {
  const int N = a.hsp * a.wsp;
  const dim3 grid((unsigned)(B * (a.H / a.hsp) * (a.W / a.wsp)), (unsigned)a.heads,
                  (unsigned)((N + RowSplit<D>::ROWS - 1) / RowSplit<D>::ROWS));
  flash_fwd_kernel<T, D, DROP><<<grid, kFlashThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lepe_w), static_cast<T*>(out), static_cast<float*>(lse), a);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_flash_fwd(int head_dim, const void* q, const void* k,
                                      const void* v, const void* lepe_w, void* out,
                                      void* lse, int B, const FlashArgs& a,
                                      cudaStream_t stream) {
#define CSU_FLASH_FWD(DIM)                                                               \
  if (head_dim == DIM)                                                                   \
    return a.drop.threshold                                                              \
               ? launch_flash_fwd<T, DIM, true>(q, k, v, lepe_w, out, lse, B, a, stream) \
               : launch_flash_fwd<T, DIM, false>(q, k, v, lepe_w, out, lse, B, a, stream);
  CSU_FLASH_HEAD_DIMS(CSU_FLASH_FWD)
#undef CSU_FLASH_FWD
  return cudaErrorInvalidValue;
}

}  // namespace csu

// q, k, v: (B, H*W, *) token tensors whose channel block [0, heads*head_dim)
// of each row is read, rows ldq/ldk/ldv elements apart; windows hsp x wsp.
// lepe_w: (C, 9) float32 taps (window mode) or null (flash mode).  out:
// (B, H*W, heads*head_dim) contiguous; lse: (B * windows, hsp*wsp, heads)
// float32.  mask_tile: the dropout mask's tile edge; seed, threshold,
// inv_keep: the attention dropout (threshold 0: none).
CSU_EXPORT int csu_flash_attention_fwd(int dtype, const void* q, const void* k,
                                       const void* v, const void* lepe_w, void* out,
                                       void* lse, int64_t ldq, int64_t ldk, int64_t ldv,
                                       int B, int H, int W, int hsp, int wsp, int heads,
                                       int head_dim, float scale, int mask_tile,
                                       uint32_t seed, uint32_t threshold, float inv_keep,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const csu::FlashArgs a{H, W, hsp, wsp, heads, mask_tile, scale,
                         csu::AttnDrop{seed, threshold, inv_keep}, ldq, ldk, ldv, 0};
  if (dtype == csu::kFloat32)
    return (int)csu::dispatch_flash_fwd<float>(head_dim, q, k, v, lepe_w, out, lse, B, a, s);
  if (dtype == csu::kBFloat16)
    return (int)csu::dispatch_flash_fwd<__nv_bfloat16>(head_dim, q, k, v, lepe_w, out, lse,
                                                       B, a, s);
  return (int)cudaErrorInvalidValue;
}
