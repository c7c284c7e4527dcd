// K-V1 and K-V1': v1 window attention over contiguous (G, Np, D) groups,
// forward and backward, keys at or past n_valid masked.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_attention.py::_fwd_kernel
// (pallas_call at :139) and _bwd_kernel (:165).  Per group and query row i:
//     s_ij = (q_i * scale) . k_j  for j < n_valid      p_i = softmax(s_i)
//     o_i = sum_j p_ij v_j
// and the backward
//     dv_j = sum_i p_ij dO_i          dp_ij = dO_i . v_j
//     ds_ij = p_ij (dp_ij - delta_i)  delta_i = sum_j p_ij dp_ij
//     dq_i = scale * sum_j ds_ij k_j  dk_j = sum_i ds_ij (q_i * scale)
// A key past n_valid scores -1e30 on the TPU, so its p is exactly 0 in
// float32: such keys get dk = dv = 0.  Padded query rows still get outputs
// and dq, and feed dk and dv like any other row.  Np <= 2048, the TPU
// kernel's limit.  Both directions keep each row's L = m + log(l): the
// forward writes it, the backward recomputes p = exp(s - L).
//
// What bounds it on the H100: at the flagship's windows (Np 128 and 256,
// head dim 32) 4 Np flops per element of q, k, v and o in the forward and
// 10 Np in the backward are below the bf16 tensor cores' ridge, but each
// score also costs an exp on the SFU (453 M scores over the flagship's 50
// branches at batch 8: about 0.11 ms an exp a score); on the CUDA cores in
// float32 the FMAs alone (0.87 and 2.16 ms there) are above the time of
// one SDPA call.  So bf16 runs on the tensor cores.  Three bodies, picked
// in the C entry by dtype, head dim and Np (csu_window_attention_design
// tells the wrapper):
// * K-V1, bf16 at head dims 16, 32, 64: the tensor-core forward of K-A and
//   the flash forward (attention_fwd_mma.cuh) with the group as its window
//   (a (Np x 1) token grid of one head, rows D apart) and the keys cut at
//   n_valid (its KEYS flag): 64 query rows a block, K and V streamed in
//   64-row tiles by cp.async, the softmax taken online (one exp a score).
// * K-V1', bf16 at head dims 16, 32, 64, windows whose q, k, v, dO and the
//   ds^T tile fit one block's shared memory (v1_whole_smem <= 227 KB: Np up
//   to 256 at head dims 16 and 32, 208 at 64): one block a group, a warp
//   per 16 rows (up to 16 warps), three phases over shared memory only:
//     A  a warp's 16 query rows against every key: delta_i = sum_j p_ij
//        dp_ij (S = Qs K^T, dP = dO V^T on mma.sync m16n8k16, exp2 on the
//        SFU), into shared memory;
//     B  a warp's 16 key rows against every query: S^T and dP^T, p, ds,
//        dV += round(p)^T dO and dK += round(ds)^T Qs, and round(ds)^T
//        into shared memory in the A fragments' pairs;
//     C  a warp's 16 query rows: dQ = round(ds) K, ds read back through
//        ldmatrix .trans.
//   One launch, each input read from device memory once, every sum in a
//   fixed order (no atomics: bit-equal from run to run).  Two exps a
//   score: delta is v1's rowsum(dp * p) from phase A's sweep, in float32,
//   which adds no error beyond the bf16 operands (rowsum(dO * O) from a
//   saved O would save an exp but add O's rounding, and the entry's
//   arguments carry no O).  The K-A' record (stripe_attention_bwd.cu) was
//   of four-warp blocks, 128 of them at the flagship's 256-token windows;
//   here a block has Np / 16 warps, so those 128 blocks hold 16 warps an
//   SM.
// * K-V1', bf16, longer windows (up to 2048 tokens): the tiled tensor-core
//   dq and dk/dv bodies of the flash family (flash_attention_{dq,dkv}.cu)
//   with the group layout and the key count, launched one after the other
//   as K-A' launches them; dq sweeps the keys twice (delta, then dq).
// * float32 (the exact-f32 route) and head dim 8: the CUDA-core bodies
//   below, in float32 throughout: a thread owns a row (two lanes at head
//   dim 64) and keeps it and its accumulators in registers; the other side
//   streams through 32-row float32 tiles of shared memory that the warp
//   reads at one address; the dq kernel first sweeps the keys for delta
//   and writes it for the dk/dv kernel.
// Rounding on the tensor cores (bf16): round(q * scale), p and ds become
// bf16 mma operands, and dk sums ds against round(q * scale); v1 keeps
// all of them in float32 (pallas_attention.py:56-67, :80-103), as the
// CUDA-core bodies do.  Nothing of size Np x Np reaches device memory.
#include "attention_fwd_mma.cuh"

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
#define CSU_V1(DIM)                                                                        \
  if constexpr (!mma::serves(dtype_code<T>(), DIM))                                        \
    if (head_dim == DIM)                                                                   \
      return bwd ? launch_v1_bwd<T, DIM>(q, k, v, dout, lse, delta, o_or_dq, dk, dv, G, a, \
                                         s)                                                \
                 : launch_v1_fwd<T, DIM>(q, k, v, o_or_dq, lse, G, a, s);
  CSU_FLASH_HEAD_DIMS(CSU_V1)
#undef CSU_V1
  return cudaErrorInvalidValue;
}

// ---- the tensor-core bodies (bf16 at head dims 16, 32, 64) ----

// The groups as windows of the flash family's geometry: group g is window
// g of a (Np x 1) token grid with one head, rows D apart; keys [0, n_valid).
static FlashArgs v1_window_args(const V1Args& a, int head_dim) {
  FlashArgs f{a.Np, 1, a.Np, 1, 1, a.Np, a.scale, AttnDrop{0u, 0u, 1.f},
              head_dim, head_dim, head_dim, head_dim};
  f.nkeys = a.nvalid;
  return f;
}

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
v1_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse, FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  mma::attention_fwd<D, false, false, true>(q, k, v, nullptr, out, D, lse, a, smem);
}

template <int D>
static cudaError_t launch_v1_fwd_mma(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int G, const V1Args& a, cudaStream_t s) {
  constexpr size_t smem = mma::fwd_smem<D>(2);
  static std::atomic<int> opted[kMaxDevices];
  const cudaError_t e = opt_in_smem(v1_fwd_mma_kernel<D>, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)G, 1u, (unsigned)((a.Np + mma::kRows - 1) / mma::kRows));
  using bf = __nv_bfloat16;
  v1_fwd_mma_kernel<D><<<grid, mma::kThreads, smem, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<bf*>(out), static_cast<float*>(lse), v1_window_args(a, D));
  return cudaGetLastError();
}

constexpr int kV1WholeMaxRows = 256;  // a warp per 16 rows: at most 16 warps

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Dynamic shared memory of the whole-window K-V1' block: round(q * scale),
// k, v and dO (round16(Np) rows of D + 8 bf16 each), L and delta
// (round16(Np) floats each), ds^T (round16(n_valid) rows of round16(Np) +
// 8 bf16).
__host__ __device__ constexpr size_t v1_whole_smem(int D, int Np, int nvalid) {
  return (size_t)4 * round16(Np) * (D + 8) * 2 + (size_t)2 * round16(Np) * 4 +
         (size_t)round16(nvalid) * (round16(Np) + 8) * 2;
}

// The whole-window body takes a window when its block fits at n_valid = Np;
// else the tiled bodies.  Mirrored by ops/window_attention.bwd_design.
__host__ __device__ constexpr bool v1_whole(int D, int Np) {
  return round16(Np) <= kV1WholeMaxRows && v1_whole_smem(D, Np, Np) <= kMaxSmem;
}

// grid G, 2 * round16(Np) threads (a warp per 16 rows), v1_whole_smem bytes
template <int D>
__global__ void __launch_bounds__(2 * kV1WholeMaxRows)
v1_bwd_whole_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, V1Args a) {
  using namespace mma;
  constexpr int LD = D + 8, KS = D / 16, NT = D / 8, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Npad = round16(a.Np), nk = round16(a.nvalid), LDS = Npad + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // round(q * scale)
  bf16* Ks = Qs + Npad * LD;
  bf16* Vs = Ks + Npad * LD;
  bf16* Gs = Vs + Npad * LD;  // dO
  float* Ls = reinterpret_cast<float*>(Gs + Npad * LD);
  float* Ds = Ls + Npad;                            // delta
  bf16* DSt = reinterpret_cast<bf16*>(Ds + Npad);  // ds^T: (key, query), rows LDS apart

  const int64_t base = (int64_t)blockIdx.x * a.Np * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;  // the warp's query rows (A, C) and key rows (B)

  // One copy group (four groups, phase A starting on the first keys while
  // the rest arrive, measured 2 % slower).  q and dO rows past Np, k and v
  // rows past n_valid: zeros; key rows past round16(n_valid) are never read.
  for (int idx = threadIdx.x; idx < Npad * CH; idx += blockDim.x) {
    const int r = idx / CH, off = r * LD + idx % CH * 8;
    const bool qv = r < a.Np, kv = r < a.nvalid;
    const int64_t src = base + (int64_t)r * D + idx % CH * 8;
    cp_async16(Qs + off, q + (qv ? src : base), qv);
    cp_async16(Gs + off, dout + (qv ? src : base), qv);
    if (r < nk) {
      cp_async16(Ks + off, k + (kv ? src : base), kv);
      cp_async16(Vs + off, v + (kv ? src : base), kv);
    }
  }
  cp_async_commit();
  for (int r = threadIdx.x; r < Npad; r += blockDim.x)  // p = 0 for the rows past Np
    Ls[r] = r < a.Np ? lse[(int64_t)blockIdx.x * a.Np + r] : INFINITY;
  cp_async_wait<0>();
  for (int idx = threadIdx.x; idx < Npad * CH; idx += blockDim.x) {  // the own copies
    bf16* x = Qs + idx / CH * LD + idx % CH * 8;
    scale_round8(x, x, a.scale);
  }
  __syncthreads();

  // A: delta of the warp's query rows r0 + g (+ 8)
  {
    uint32_t qa[KS][4], ga[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      load_a(qa[ks], Qs + r0 * LD + ks * 16, LD, lane);
      load_a(ga[ks], Gs + r0 * LD + ks * 16, LD, lane);
    }
    const float nl2[2] = {-Ls[r0 + g] * kLog2e, -Ls[r0 + g + 8] * kLog2e};
    float dl[2] = {0.f, 0.f};
    for (int j0 = 0; j0 < nk; j0 += 16) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        load_b_rows(b, Ks + j0 * LD + ks * 16, LD, lane);
        mma::mma(s[0], qa[ks], b[0], b[1]);
        mma::mma(s[1], qa[ks], b[2], b[3]);
        load_b_rows(b, Vs + j0 * LD + ks * 16, LD, lane);
        mma::mma(dp[0], ga[ks], b[0], b[1]);
        mma::mma(dp[1], ga[ks], b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = j0 + nt * 8 + 2 * t + (e & 1) < a.nvalid;
          const float p = live ? exp2_sfu(fmaf(s[nt][e], kLog2e, nl2[e >> 1])) : 0.f;
          dl[e >> 1] = fmaf(p, dp[nt][e], dl[e >> 1]);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the four lanes of a row hold its partial sums
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
      if (t == 0) Ds[r0 + g + 8 * r] = dl[r];
    }
  }
  // keys past round16(n_valid): no block row, dk = dv = 0
  for (int idx = threadIdx.x; idx < (a.Np - nk) * CH; idx += blockDim.x) {
    const int64_t off = base + (int64_t)(nk + idx / CH) * D + idx % CH * 8;
    *reinterpret_cast<uint4*>(dk + off) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dv + off) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // B: dk and dv of the warp's key rows r0 + g (+ 8), and their ds^T rows
  if (r0 < nk) {
    uint32_t ka[KS][4], va[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      load_a(ka[ks], Ks + r0 * LD + ks * 16, LD, lane);
      load_a(va[ks], Vs + r0 * LD + ks * 16, LD, lane);
    }
    const bool masked[2] = {r0 + g >= a.nvalid, r0 + g + 8 >= a.nvalid};
    float ak[NT][4], av[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;
    for (int i0 = 0; i0 < Npad; i0 += 16) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        load_b_rows(b, Qs + i0 * LD + ks * 16, LD, lane);
        mma::mma(s[0], ka[ks], b[0], b[1]);
        mma::mma(s[1], ka[ks], b[2], b[3]);
        load_b_rows(b, Gs + i0 * LD + ks * 16, LD, lane);
        mma::mma(dp[0], va[ks], b[0], b[1]);
        mma::mma(dp[1], va[ks], b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // the element's query: column 2t + c of n-tile nt
          const int qi = i0 + nt * 8 + 2 * t + c;
          const float nl2 = -Ls[qi] * kLog2e, dl = Ds[qi];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const float p = masked[r] ? 0.f : exp2_sfu(fmaf(s[nt][e], kLog2e, nl2));
            s[nt][e] = p;
            dp[nt][e] = p * (dp[nt][e] - dl);
          }
        }
      const uint32_t pa[4] = {pack(s[0][0], s[0][1]), pack(s[0][2], s[0][3]),
                              pack(s[1][0], s[1][1]), pack(s[1][2], s[1][3])};
      const uint32_t da[4] = {pack(dp[0][0], dp[0][1]), pack(dp[0][2], dp[0][3]),
                              pack(dp[1][0], dp[1][1]), pack(dp[1][2], dp[1][3])};
      // da[0..3]: key rows g, g + 8 at query columns i0 + 2t and i0 + 8 + 2t
      uint32_t* dst = reinterpret_cast<uint32_t*>(DSt + (r0 + g) * LDS + i0 + 2 * t);
      dst[0] = da[0];
      dst[4 * LDS] = da[1];
      dst[4] = da[2];
      dst[4 * LDS + 4] = da[3];
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) {
        uint32_t b[4];
        load_b_cols(b, Gs + i0 * LD + dn * 16, LD, lane);
        mma::mma(av[2 * dn], pa, b[0], b[1]);
        mma::mma(av[2 * dn + 1], pa, b[2], b[3]);
        load_b_cols(b, Qs + i0 * LD + dn * 16, LD, lane);
        mma::mma(ak[2 * dn], da, b[0], b[1]);
        mma::mma(ak[2 * dn + 1], da, b[2], b[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // masked keys: p = 0, so ak = av = 0 exactly
      const int key = r0 + g + 8 * r;
      if (key >= a.Np) continue;
      const int64_t off = base + (int64_t)key * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
            __floats2bfloat162_rn(ak[n][2 * r], ak[n][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
            __floats2bfloat162_rn(av[n][2 * r], av[n][2 * r + 1]);
      }
    }
  }
  __syncthreads();

  // C: dq of the warp's query rows, A fragments of round(ds) from ds^T
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bf16* dsa = DSt + ((lane & 7) + ((lane >> 4) << 3)) * LDS + r0 + ((lane >> 3) & 1) * 8;
  for (int j0 = 0; j0 < nk; j0 += 16) {
    uint32_t da[4];
    ldsm4_t(da, dsa + j0 * LDS);
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) {
      uint32_t b[4];
      load_b_cols(b, Ks + j0 * LD + dn * 16, LD, lane);
      mma::mma(acc[2 * dn], da, b[0], b[1]);
      mma::mma(acc[2 * dn + 1], da, b[2], b[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= a.Np) continue;
    const int64_t off = base + (int64_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale);
  }
}

template <int D>
static cudaError_t launch_v1_bwd_mma(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, void* delta, void* dq,
                                     void* dk, void* dv, int G, const V1Args& a,
                                     cudaStream_t s) {
  if (!v1_whole(D, a.Np)) {  // the tiled bodies, as K-A' launches them
    const FlashArgs f = v1_window_args(a, D);
    const cudaError_t e = dispatch_flash_dq_mma(D, q, k, v, dout, lse, delta, 0, dq, G, f, s);
    if (e != cudaSuccess) return e;
    return dispatch_flash_dkv_mma(D, q, k, v, nullptr, dout, lse, delta, dk, dv, nullptr, G,
                                  f, s);
  }
  const size_t smem = v1_whole_smem(D, a.Np, a.nvalid);
  static std::atomic<int> opted[kMaxDevices];
  const cudaError_t e = opt_in_smem(v1_bwd_whole_kernel<D>, smem, opted);
  if (e != cudaSuccess) return e;
  using bf = __nv_bfloat16;
  v1_bwd_whole_kernel<D><<<(unsigned)G, (unsigned)(2 * round16(a.Np)), smem, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse), static_cast<bf*>(dq),
      static_cast<bf*>(dk), static_cast<bf*>(dv), a);
  return cudaGetLastError();
}

static cudaError_t dispatch_v1_mma(bool bwd, int head_dim, const void* q, const void* k,
                                   const void* v, const void* dout, void* lse, void* delta,
                                   void* o_or_dq, void* dk, void* dv, int G, const V1Args& a,
                                   cudaStream_t s) {
#define CSU_V1_MMA(DIM)                                                                     \
  if (head_dim == DIM)                                                                      \
    return bwd ? launch_v1_bwd_mma<DIM>(q, k, v, dout, lse, delta, o_or_dq, dk, dv, G, a, s) \
               : launch_v1_fwd_mma<DIM>(q, k, v, o_or_dq, lse, G, a, s);
  CSU_V1_MMA(16) CSU_V1_MMA(32) CSU_V1_MMA(64)
#undef CSU_V1_MMA
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
  if (mma::serves(dtype, head_dim))
    return dispatch_v1_mma(bwd, head_dim, q, k, v, dout, lse, delta, o_or_dq, dk, dv, G, a,
                           s);
  if (dtype == kBFloat16)
    return dispatch_v1<__nv_bfloat16>(bwd, head_dim, q, k, v, dout, lse, delta, o_or_dq, dk,
                                      dv, G, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace csu

// Which K-V1' body (dtype, head_dim, Np) takes: 0 the CUDA-core bodies, 1
// the tiled tensor-core dq and dk/dv, 2 the whole-window tensor-core body.
// K-V1 takes the tensor-core forward wherever this is not 0.
CSU_EXPORT int csu_window_attention_design(int dtype, int head_dim, int Np) {
  if (!csu::mma::serves(dtype, head_dim)) return 0;
  return csu::v1_whole(head_dim, Np) ? 2 : 1;
}

// K-V1: q, k, v and out (G, Np, head_dim) contiguous in the compute dtype,
// Np <= 2048, keys [0, n_valid) attended; lse (G, Np) float32 receives each
// row's m + log(l) for the backward.  The tensor-core body reads rows 16
// bytes at a time: q, k, v and out 16-byte aligned.
CSU_EXPORT int csu_window_attention_fwd(int dtype, const void* q, const void* k,
                                        const void* v, void* out, void* lse, int G, int Np,
                                        int head_dim, int n_valid, float scale,
                                        void* stream) {
  return (int)csu::v1_entry(dtype, false, q, k, v, nullptr, lse, nullptr, out, nullptr,
                            nullptr, G, Np, head_dim, n_valid, scale, stream);
}

// K-V1': as csu_window_attention_fwd, with dout the output cotangent and lse
// the forward's; delta (G, Np) float32 is scratch; dq, dk, dv like q.  One
// launch in the whole-window body, two on the stream otherwise (the dq
// sweep, which writes delta, then dk/dv).
CSU_EXPORT int csu_window_attention_bwd(int dtype, const void* q, const void* k,
                                        const void* v, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int G,
                                        int Np, int head_dim, int n_valid, float scale,
                                        void* stream) {
  return (int)csu::v1_entry(dtype, true, q, k, v, dout, const_cast<void*>(lse), delta, dq, dk,
                            dv, G, Np, head_dim, n_valid, scale, stream);
}
