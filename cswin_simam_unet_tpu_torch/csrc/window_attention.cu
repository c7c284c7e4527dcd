// K-V1 and K-V1': v1 window attention over contiguous (G, Np, D) groups,
// forward and backward, keys at or past n_valid masked.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_attention.py::_fwd_kernel
// (pallas_call at :139) and _bwd_kernel (:165).  Per group and query row i,
// at v1's rounding points (q, k, v and dO widened to float32, q * scale not
// rounded, p into p.v in float32; pallas_attention.py:56-67, :80-103):
//     s_ij = (q_i * scale) . k_j  for j < n_valid      p_i = softmax(s_i)
//     o_i = sum_j p_ij v_j                             (rounded once, at the end)
// and the backward
//     dv_j = sum_i p_ij dO_i          dp_ij = dO_i . v_j
//     ds_ij = p_ij (dp_ij - sum_j' p_ij' dp_ij')
//     dq_i = scale * sum_j ds_ij k_j  dk_j = sum_i ds_ij (q_i * scale)
// A key past n_valid scores -1e30 on the TPU, so its p is exactly 0 in
// float32: the sweeps stop at n_valid and such keys get dk = dv = 0.
// Padded query rows still get outputs and dq, and feed dk and dv like any
// other row.
//
// What bounds it on the H100: 4 Np flops per element of q, k, v and o in the
// forward, about 2.5 times that in the backward; at Np = 256 and head dim 32
// in bf16 that is near the tensor cores' ridge, and on the CUDA cores in
// float32, where these kernels compute, the operations bound them.  Design:
// the flash family's (flash_attention.cuh), without its window geometry,
// LePE, dropout or roundings: a thread owns a row (two lanes at head dim 64)
// and keeps it and its accumulators in registers; the other side streams
// through 32-row float32 tiles of shared memory that the warp reads at one
// address; the softmax is taken online, the forward writes L = m + log(l)
// per row, and the backward recomputes p = exp(s - L): the dq kernel first
// sweeps the keys for delta_i = sum_j p_ij dp_ij (v1's rowsum(dp * p)) and
// writes it for the dk/dv kernel.  Nothing of size Np x Np is stored; the
// wrapper keeps Np <= 2048, the TPU kernel's limit.
#include "flash_attention.cuh"

namespace csu {

constexpr int kV1MaxTokens = 2048;

struct V1Args {
  int Np, nvalid;  // rows per group; keys [0, nvalid) attended
  float scale;
};

// Rows [n0, n0 + nk) of group `base` (its first element) of a contiguous
// (G, Np, D) tensor into a (kFlashTile, D) float32 tile, times `mul`, zeros
// past nk.
template <typename T, int D>
__device__ __forceinline__ void stage_group_rows(float* tile, const T* __restrict__ x,
                                                 int64_t base, int n0, int nk, float mul) {
  const T* src = x + base + (int64_t)n0 * D;
  for (int idx = threadIdx.x; idx < kFlashTile * D; idx += blockDim.x)
    tile[idx] = idx < nk * D ? to_f(src[idx]) * mul : 0.f;
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
v1_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, float* __restrict__ lse, V1Args a) {
  using RS = RowSplit<D>;
  constexpr int DL = RS::DL, LPR = RS::LPR, TK = kFlashTile;
  __shared__ __align__(16) float Ks[TK * D];
  __shared__ __align__(16) float Vs[TK * D];

  const int64_t base = (int64_t)blockIdx.x * a.Np * D;
  const int i = blockIdx.y * RS::ROWS + threadIdx.x / LPR;
  const int d0 = (threadIdx.x % LPR) * DL;
  const bool live = i < a.Np;
  const int64_t ti = base + (int64_t)(live ? i : 0) * D + d0;

  float qr[DL], acc[DL];
#pragma unroll
  for (int d = 0; d < DL; ++d) {
    qr[d] = to_f(q[ti + d]) * a.scale;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < a.nvalid; j0 += TK) {
    const int nk = min(TK, a.nvalid - j0);
    __syncthreads();  // the previous tile is consumed
    stage_group_rows<T, D>(Ks, k, base, j0, nk, 1.f);
    stage_group_rows<T, D>(Vs, v, base, j0, nk, 1.f);
    __syncthreads();
    float s[TK];
    float mt = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < TK; ++jj) {
      s[jj] = jj < nk ? row_sum<LPR>(dot_smem<DL>(qr, Ks + jj * D + d0)) : -INFINITY;
      mt = fmaxf(mt, s[jj]);
    }
    const float m_new = fmaxf(m, mt);  // finite: key j0 is attended
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < TK; ++jj) {
      const float p = expf(s[jj] - m_new);
      l += p;
      axpy_smem<DL>(p, Vs + jj * D + d0, acc);
    }
    m = m_new;
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < DL; ++d) out[ti + d] = from_f<T>(acc[d] / l);
  if (d0 == 0) lse[(int64_t)blockIdx.x * a.Np + i] = m + logf(l);
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
v1_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, T* __restrict__ dq, V1Args a) {
  using RS = RowSplit<D>;
  constexpr int DL = RS::DL, LPR = RS::LPR, TK = kFlashTile;
  __shared__ __align__(16) float Ks[TK * D];
  __shared__ __align__(16) float Vs[TK * D];

  const int64_t base = (int64_t)blockIdx.x * a.Np * D;
  const int i = blockIdx.y * RS::ROWS + threadIdx.x / LPR;
  const int d0 = (threadIdx.x % LPR) * DL;
  const bool live = i < a.Np;
  const int64_t ti = base + (int64_t)(live ? i : 0) * D + d0;
  const int64_t stat = (int64_t)blockIdx.x * a.Np + (live ? i : 0);

  float qr[DL], gr[DL], acc[DL];
#pragma unroll
  for (int d = 0; d < DL; ++d) {
    qr[d] = to_f(q[ti + d]) * a.scale;
    gr[d] = to_f(dout[ti + d]);
    acc[d] = 0.f;
  }
  const float L = lse[stat];

  // sweep 0: delta_i = sum_j p_ij dp_ij; sweep 1: dq
  float dl = 0.f;
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int j0 = 0; j0 < a.nvalid; j0 += TK) {
      const int nk = min(TK, a.nvalid - j0);
      __syncthreads();
      stage_group_rows<T, D>(Ks, k, base, j0, nk, 1.f);
      stage_group_rows<T, D>(Vs, v, base, j0, nk, 1.f);
      __syncthreads();
      for (int jj = 0; jj < nk; ++jj) {
        const float p = expf(row_sum<LPR>(dot_smem<DL>(qr, Ks + jj * D + d0)) - L);
        const float dp = row_sum<LPR>(dot_smem<DL>(gr, Vs + jj * D + d0));
        if (sweep == 0)
          dl = fmaf(p, dp, dl);
        else
          axpy_smem<DL>(p * (dp - dl), Ks + jj * D + d0, acc);
      }
    }
  }
  if (!live) return;
  if (d0 == 0) delta[stat] = dl;
#pragma unroll
  for (int d = 0; d < DL; ++d) dq[ti + d] = from_f<T>(acc[d] * a.scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
v1_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
              V1Args a) {
  using RS = RowSplit<D>;
  constexpr int DL = RS::DL, LPR = RS::LPR, TQ = kFlashTile;
  __shared__ __align__(16) float Qs[TQ * D];  // q * scale
  __shared__ __align__(16) float Gs[TQ * D];  // dO
  __shared__ float Ls[TQ], Ds[TQ];

  const int64_t base = (int64_t)blockIdx.x * a.Np * D;
  const int j = blockIdx.y * RS::ROWS + threadIdx.x / LPR;
  const int d0 = (threadIdx.x % LPR) * DL;
  const bool live = j < a.Np;
  const int64_t tj = base + (int64_t)(live ? j : 0) * D + d0;

  float kr[DL], vr[DL], ak[DL], av[DL];
#pragma unroll
  for (int d = 0; d < DL; ++d) {
    kr[d] = to_f(k[tj + d]);
    vr[d] = to_f(v[tj + d]);
    ak[d] = av[d] = 0.f;
  }
  // a block of masked keys only (uniform over the block) skips the sweep
  if ((int)blockIdx.y * RS::ROWS < a.nvalid) {
    for (int i0 = 0; i0 < a.Np; i0 += TQ) {
      const int nq = min(TQ, a.Np - i0);
      __syncthreads();
      stage_group_rows<T, D>(Qs, q, base, i0, nq, a.scale);
      stage_group_rows<T, D>(Gs, dout, base, i0, nq, 1.f);
      for (int n = threadIdx.x; n < TQ; n += blockDim.x) {
        const int64_t st = (int64_t)blockIdx.x * a.Np + i0 + n;
        Ls[n] = n < nq ? lse[st] : INFINITY;
        Ds[n] = n < nq ? delta[st] : 0.f;
      }
      __syncthreads();
      for (int ii = 0; ii < nq; ++ii) {
        const float p = expf(row_sum<LPR>(dot_smem<DL>(kr, Qs + ii * D + d0)) - Ls[ii]);
        const float dp = row_sum<LPR>(dot_smem<DL>(vr, Gs + ii * D + d0));
        axpy_smem<DL>(p, Gs + ii * D + d0, av);
        axpy_smem<DL>(p * (dp - Ds[ii]), Qs + ii * D + d0, ak);
      }
    }
  }
  if (!live) return;
  const bool masked = j >= a.nvalid;
#pragma unroll
  for (int d = 0; d < DL; ++d) {
    dk[tj + d] = from_f<T>(masked ? 0.f : ak[d]);
    dv[tj + d] = from_f<T>(masked ? 0.f : av[d]);
  }
}

static bool v1_args_ok(int G, const V1Args& a) {
  return G >= 1 && a.Np >= 1 && a.Np <= kV1MaxTokens && a.nvalid >= 1 && a.nvalid <= a.Np;
}

template <int D>
static dim3 v1_grid(int G, const V1Args& a) {
  return dim3((unsigned)G, (unsigned)((a.Np + RowSplit<D>::ROWS - 1) / RowSplit<D>::ROWS));
}

template <typename T, int D>
static cudaError_t launch_v1_fwd(const void* q, const void* k, const void* v, void* out,
                                 void* lse, int G, const V1Args& a, cudaStream_t s) {
  v1_fwd_kernel<T, D><<<v1_grid<D>(G, a), kFlashThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), a);
  return cudaGetLastError();
}

template <typename T, int D>
static cudaError_t launch_v1_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int G, const V1Args& a, cudaStream_t s) {
  v1_dq_kernel<T, D><<<v1_grid<D>(G, a), kFlashThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  v1_dkv_kernel<T, D><<<v1_grid<D>(G, a), kFlashThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), a);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_v1(bool bwd, int head_dim, const void* q, const void* k,
                               const void* v, const void* dout, void* lse, void* delta,
                               void* o_or_dq, void* dk, void* dv, int G, const V1Args& a,
                               cudaStream_t s) {
#define CSU_V1(DIM)                                                                   \
  if (head_dim == DIM)                                                                \
    return bwd ? launch_v1_bwd<T, DIM>(q, k, v, dout, lse, delta, o_or_dq, dk, dv, G, a, \
                                       s)                                             \
               : launch_v1_fwd<T, DIM>(q, k, v, o_or_dq, lse, G, a, s);
  CSU_FLASH_HEAD_DIMS(CSU_V1)
#undef CSU_V1
  return cudaErrorInvalidValue;
}

static cudaError_t v1_entry(int dtype, bool bwd, const void* q, const void* k, const void* v,
                            const void* dout, void* lse, void* delta, void* o_or_dq, void* dk,
                            void* dv, int G, int Np, int head_dim, int n_valid, float scale,
                            void* stream) {
  const V1Args a{Np, n_valid, scale};
  if (!v1_args_ok(G, a)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_v1<float>(bwd, head_dim, q, k, v, dout, lse, delta, o_or_dq, dk, dv, G,
                              a, s);
  if (dtype == kBFloat16)
    return dispatch_v1<__nv_bfloat16>(bwd, head_dim, q, k, v, dout, lse, delta, o_or_dq, dk,
                                      dv, G, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace csu

// K-V1: q, k, v and out (G, Np, head_dim) contiguous in the compute dtype,
// Np <= 2048, keys [0, n_valid) attended; lse (G, Np) float32 receives each
// row's m + log(l) for the backward.
CSU_EXPORT int csu_window_attention_fwd(int dtype, const void* q, const void* k,
                                        const void* v, void* out, void* lse, int G, int Np,
                                        int head_dim, int n_valid, float scale,
                                        void* stream) {
  return (int)csu::v1_entry(dtype, false, q, k, v, nullptr, lse, nullptr, out, nullptr,
                            nullptr, G, Np, head_dim, n_valid, scale, stream);
}

// K-V1': as csu_window_attention_fwd, with dout the output cotangent and lse
// the forward's; delta (G, Np) float32 is scratch; dq, dk, dv like q.  Two
// launches on the stream: the dq sweep (which writes delta), then dk/dv.
CSU_EXPORT int csu_window_attention_bwd(int dtype, const void* q, const void* k,
                                        const void* v, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int G,
                                        int Np, int head_dim, int n_valid, float scale,
                                        void* stream) {
  return (int)csu::v1_entry(dtype, true, q, k, v, dout, const_cast<void*>(lse), delta, dq, dk,
                            dv, G, Np, head_dim, n_valid, scale, stream);
}
