// dk and dv of the flash-attention family (flash_attention.cuh): per window,
// head and tile of key rows, a sweep over the window's query rows in
// shared-memory tiles of 32.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_attention_flash.py::
// _flash_dkv_kernel (pallas_call at :338) in flash mode, and the key-row
// half of pallas_attention_v2.py::_attn_bwd_kernel (:401) in window mode.
// Per key row j, with L and delta per query row (the forward's and the dq
// kernel's or the caller's):
//     p_ij = exp(round(q_i * scale) . k_j - L_i)   pd_ij = drop(p_ij)
//     dp_ij = drop(dO_i . v_j)                     ds_ij = round(p_ij (dp_ij - delta_i))
//     dv_j = sum_i round(pd_ij) dO_i [+ LePE^T(dO)_j]
//     dk_j = scale * sum_i ds_ij q_i
// In window mode each block also writes its (9, head_dim) partial of the
// LePE weight gradient, dw[tap, c] = sum over its key rows of dO * shift_tap(v),
// which the caller sums over blocks in a fixed order.  Each thread owns a
// key row: k, v and both accumulators stay in registers.
#include "flash_attention.cuh"

namespace csu {

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kFlashThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ lepe_w, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw_part,
                 FlashArgs a) {
  using RS = RowSplit<D>;
  constexpr int DL = RS::DL, LPR = RS::LPR, TQ = kFlashTile;
  __shared__ __align__(16) float Qs[TQ * D];  // round(q * scale)
  __shared__ __align__(16) float Qu[TQ * D];  // q
  __shared__ __align__(16) float Gs[TQ * D];  // dO
  __shared__ float Ls[TQ], Ds[TQ];

  const int N = a.hsp * a.wsp;
  const int win = blockIdx.x, head = blockIdx.y;
  const int j = blockIdx.z * RS::ROWS + threadIdx.x / LPR;
  const int d0 = (threadIdx.x % LPR) * DL;
  const bool live = j < N;
  const WindowRows tok(a, win);
  const int c0 = head * D;
  const int64_t tj = tok(live ? j : 0);

  float kr[DL], vr[DL], ak[DL], av[DL];
  load_row<T, DL>(kr, k, tj, a.ldk, c0 + d0);
  load_row<T, DL>(vr, v, tj, a.ldv, c0 + d0);
#pragma unroll
  for (int d = 0; d < DL; ++d) ak[d] = av[d] = 0.f;
  const uint32_t wh = win_head_id(win, head);
  const MaskPos col(live ? j : 0, a.mask_tile);

  for (int i0 = 0; i0 < N; i0 += TQ) {
    const int nq = min(TQ, N - i0);
    __syncthreads();
    stage_rows<T, D>(Qs, q, a.ldq, tok, i0, nq, c0, a.scale);
    stage_rows<T, D>(Qu, q, a.ldq, tok, i0, nq, c0);
    stage_rows<T, D>(Gs, dout, a.ldg, tok, i0, nq, c0);
    for (int n = threadIdx.x; n < TQ; n += blockDim.x) {
      const int64_t st = ((int64_t)win * N + i0 + n) * a.heads + head;
      Ls[n] = n < nq ? lse[st] : INFINITY;  // p = 0 for the rows past N
      Ds[n] = n < nq ? delta[st] : 0.f;
    }
    __syncthreads();
    MaskPos row(i0, a.mask_tile);
    for (int ii = 0; ii < nq; ++ii) {
      const float p = expf(row_sum<LPR>(dot_smem<DL>(kr, Qs + ii * D + d0)) - Ls[ii]);
      float dp = row_sum<LPR>(dot_smem<DL>(vr, Gs + ii * D + d0));
      float pd = p;
      if constexpr (DROP) {
        const bool keep = flash_keep(a.drop, wh, row, col, a.mask_tile);
        pd = keep ? p * a.drop.inv_keep : 0.f;
        dp = keep ? dp * a.drop.inv_keep : 0.f;
        row.next(a.mask_tile);
      }
      axpy_smem<DL>(round_to<T>(pd), Gs + ii * D + d0, av);
      axpy_smem<DL>(round_to<T>(p * (dp - Ds[ii])), Qu + ii * D + d0, ak);
    }
  }

  const int ldd = a.heads * D;
  if (live) {
    const int ty = j / a.wsp, tx = j - ty * a.wsp;
#pragma unroll
    for (int d = 0; d < DL; ++d) {
      const int c = c0 + d0 + d;
      float o = av[d];
      if (lepe_w != nullptr)
        o += lepe_at(dout, a.ldg, tok, ty, tx, c, lepe_w + (int64_t)c * 9, -1);
      dk[tj * ldd + c] = from_f<T>(ak[d] * a.scale);
      dv[tj * ldd + c] = from_f<T>(o);
    }
  }
  if (lepe_w == nullptr) return;
  // dw partial of this block's key rows: tap (dy+1)*3 + (dx+1) pairs dO at
  // (y, x) with v at (y+dy, x+dx) inside the window
  const int n0 = blockIdx.z * RS::ROWS, n1 = min(N, n0 + RS::ROWS);
  for (int idx = threadIdx.x; idx < 9 * D; idx += blockDim.x) {
    const int tap = idx / D, d = idx - tap * D;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    float acc = 0.f;
    for (int n = n0; n < n1; ++n) {
      const int ty = n / a.wsp, tx = n - ty * a.wsp;
      const int yy = ty + dy, xx = tx + dx;
      if (yy < 0 || yy >= a.hsp || xx < 0 || xx >= a.wsp) continue;
      acc = fmaf(to_f(dout[tok(ty, tx) * a.ldg + c0 + d]), to_f(v[tok(yy, xx) * a.ldv + c0 + d]),
                 acc);
    }
    const int64_t part = ((int64_t)win * gridDim.z + blockIdx.z) * 9 + tap;
    dw_part[part * ldd + c0 + d] = acc;
  }
}

template <typename T, int D, bool DROP>
static cudaError_t launch_flash_dkv(const void* q, const void* k, const void* v,
                                    const void* lepe_w, const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv, void* dw_part,
                                    int B, const FlashArgs& a, cudaStream_t stream) {
  const int N = a.hsp * a.wsp;
  const dim3 grid((unsigned)(B * (a.H / a.hsp) * (a.W / a.wsp)), (unsigned)a.heads,
                  (unsigned)((N + RowSplit<D>::ROWS - 1) / RowSplit<D>::ROWS));
  flash_dkv_kernel<T, D, DROP><<<grid, kFlashThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lepe_w), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dw_part), a);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_flash_dkv(int head_dim, const void* q, const void* k,
                                      const void* v, const void* lepe_w, const void* dout,
                                      const void* lse, const void* delta, void* dk, void* dv,
                                      void* dw_part, int B, const FlashArgs& a,
                                      cudaStream_t stream) {
#define CSU_FLASH_DKV(DIM)                                                                  \
  if (head_dim == DIM)                                                                      \
    return a.drop.threshold                                                                 \
               ? launch_flash_dkv<T, DIM, true>(q, k, v, lepe_w, dout, lse, delta, dk, dv,  \
                                                dw_part, B, a, stream)                      \
               : launch_flash_dkv<T, DIM, false>(q, k, v, lepe_w, dout, lse, delta, dk, dv, \
                                                 dw_part, B, a, stream);
  CSU_FLASH_HEAD_DIMS(CSU_FLASH_DKV)
#undef CSU_FLASH_DKV
  return cudaErrorInvalidValue;
}

}  // namespace csu

// dk and dv of csu_flash_attention_fwd.  q, k, v, lepe_w, geometry, scale,
// mask_tile and the dropout as there; dout as for csu_flash_attention_dq;
// lse and delta (B * windows, hsp*wsp, heads) float32; dk, dv (B, H*W,
// heads*head_dim) contiguous; dw_part (B * windows * ceil(hsp*wsp / rows per
// block), 9, heads*head_dim) float32 with lepe_w (window mode), else unused.
CSU_EXPORT int csu_flash_attention_dkv(int dtype, const void* q, const void* k,
                                       const void* v, const void* lepe_w, const void* dout,
                                       const void* lse, const void* delta, void* dk, void* dv,
                                       void* dw_part, int64_t ldq, int64_t ldk, int64_t ldv,
                                       int64_t ldg, int B, int H, int W, int hsp, int wsp,
                                       int heads, int head_dim, float scale, int mask_tile,
                                       uint32_t seed, uint32_t threshold, float inv_keep,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const csu::FlashArgs a{H, W, hsp, wsp, heads, mask_tile, scale,
                         csu::AttnDrop{seed, threshold, inv_keep}, ldq, ldk, ldv, ldg};
  if (dtype == csu::kFloat32)
    return (int)csu::dispatch_flash_dkv<float>(head_dim, q, k, v, lepe_w, dout, lse, delta,
                                               dk, dv, dw_part, B, a, s);
  if (dtype == csu::kBFloat16)
    return (int)csu::dispatch_flash_dkv<__nv_bfloat16>(head_dim, q, k, v, lepe_w, dout, lse,
                                                       delta, dk, dv, dw_part, B, a, s);
  return (int)cudaErrorInvalidValue;
}
