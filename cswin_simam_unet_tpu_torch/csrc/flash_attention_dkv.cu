// dk and dv of the flash-attention family (flash_attention.cuh): per window,
// head and tile of key rows, a sweep over the window's query rows.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_attention_flash.py::
// _flash_dkv_kernel (pallas_call at :338) in flash mode, and the key-row
// half of pallas_attention_v2.py::_attn_bwd_kernel (:401) in window mode
// (the tiled K-A' and, launched from csu_stripe_attention_bwd, K-A').
// Per key row j, with L and delta per query row (the forward's and the dq
// kernel's or the caller's):
//     p_ij = exp(round(q_i * scale) . k_j - L_i)   pd_ij = drop(p_ij)
//     dp_ij = drop(dO_i . v_j)                     ds_ij = round(p_ij (dp_ij - delta_i))
//     dv_j = sum_i round(pd_ij) dO_i [+ LePE^T(dO)_j]
//     dk_j = scale * sum_i ds_ij q_i
// In window mode each block also writes its (9, head_dim) partial of the
// LePE weight gradient, dw[tap, c] = sum over its key rows of dO * shift_tap(v),
// which the caller sums over blocks in a fixed order.
//
// Two bodies, picked by dtype and head dim as dq picks
// (csu_attention_body):
// * bf16 at head dims 16, 32 and 64, the tensor-core body
//   (flash_attention_mma.cuh): a block takes 64 key rows, 16 per warp, whose
//   k and v stay in registers as mma A fragments; tiles of 64 query rows
//   stream through shared memory, double-buffered with cp.async: q, dO, L
//   and delta, and round(q * scale), which each thread makes from the
//   chunks it copied itself.  Per 16 queries a warp computes S^T = K Qs^T
//   and dP^T = V dO^T with the key rows as M, so that the rounded drop(p)^T
//   and ds^T are A fragments already: dV += round(drop(p))^T dO and
//   dK += ds^T Q read dO and q through ldmatrix .trans.  As in dq, exp and
//   the dropout hash, not the tensor cores, set the pace of the sweep; in
//   window mode at the short windows of K-A' (128-256 tokens, 2-4 query
//   tiles a block) the epilogue, which adds the LePE transpose and writes
//   the dw partial, is a large share of a launch, so it reads and writes 16
//   bytes at a time (see there).
// * float32 and head dim 8, the CUDA-core body: each thread owns a key row
//   (k, v and both accumulators in registers) and the queries stream through
//   shared-memory tiles of 32.
#include "flash_attention_mma.cuh"

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
  const uint32_t wh = win_head_id(a.drop, win, head);
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
  if constexpr (!mma::serves(dtype_code<T>(), DIM))                                         \
    if (head_dim == DIM)                                                                    \
      return a.drop.threshold                                                               \
                 ? launch_flash_dkv<T, DIM, true>(q, k, v, lepe_w, dout, lse, delta, dk,    \
                                                  dv, dw_part, B, a, stream)                \
                 : launch_flash_dkv<T, DIM, false>(q, k, v, lepe_w, dout, lse, delta, dk,   \
                                                   dv, dw_part, B, a, stream);
  CSU_FLASH_HEAD_DIMS(CSU_FLASH_DKV)
#undef CSU_FLASH_DKV
  return cudaErrorInvalidValue;
}

// The tensor-core body (bf16, D in 16, 32, 64); grid (windows, heads,
// ceil(N / 64)), kThreads threads, dynamic shared memory flash_dkv_mma_smem.
template <int D>
__host__ __device__ constexpr size_t flash_dkv_mma_smem() {
  // 2 stages x (q, round(q * scale), dO) and 2 stages x (L, delta)
  return 6 * mma::Tile<D>::ELEMS * sizeof(__nv_bfloat16) + 4 * mma::kTile * sizeof(float);
}

template <int D, bool DROP, bool KEYS>
__global__ void __launch_bounds__(mma::kThreads)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ lepe_w,
                     const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, float* __restrict__ dw_part, FlashArgs a) {
  using namespace mma;
  using TL = Tile<D>;
  constexpr int KS = D / 16, NT = D / 8, LD = TL::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qu = reinterpret_cast<bf16*>(smem);  // q, two stages
  bf16* Qs = Qu + 2 * TL::ELEMS;             // round(q * scale), two stages
  bf16* Gt = Qs + 2 * TL::ELEMS;             // dO, two stages
  float* Ls = reinterpret_cast<float*>(Gt + 2 * TL::ELEMS);  // L, two stages
  float* Ds = Ls + 2 * kTile;                                // delta, two stages

  // queries [0, N); keys [0, NK), NK = N but with KEYS (v1's n_valid)
  const int N = a.hsp * a.wsp, NK = KEYS ? a.nkeys : N;
  const int win = blockIdx.x, head = blockIdx.y, j0 = blockIdx.z * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const WindowRows tok(a, win);
  const int c0 = head * D;
  const int64_t stat0 = (int64_t)win * N * a.heads + head;
  const int ldd = a.heads * D;
  if constexpr (KEYS) {
    if (j0 >= NK) {  // masked keys only: dk = dv = 0, 16 bytes a store
      for (int idx = threadIdx.x; idx < kRows * D / 8; idx += kThreads) {
        const int n = j0 + idx / (D / 8);
        if (n >= N) break;
        const int64_t off = tok(n) * ldd + c0 + idx % (D / 8) * 8;
        *reinterpret_cast<uint4*>(dk + off) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dv + off) = make_uint4(0u, 0u, 0u, 0u);
      }
      return;
    }
  }

  // the block's k and v rows, through the first stage, into A fragments
  load_tile<D>(Qu, k, a.ldk, tok, j0, NK, c0);
  load_tile<D>(Gt, v, a.ldv, tok, j0, NK, c0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[KS][4], va[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    load_a(ka[ks], Qu + warp * 16 * LD + ks * 16, LD, lane);
    load_a(va[ks], Gt + warp * 16 * LD + ks * 16, LD, lane);
  }
  __syncthreads();

  // q, dO, L and delta of the query tile at i0 into a stage
  auto load_queries = [&](int stage, int i0) {
    load_tile<D>(Qu + stage * TL::ELEMS, q, a.ldq, tok, i0, N, c0);
    load_tile<D>(Gt + stage * TL::ELEMS, dout, a.ldg, tok, i0, N, c0);
    const int r = threadIdx.x & (kTile - 1), n = i0 + r;
    const bool valid = n < N;  // zeros past N, where q, dO and p are zero too
    const float* src = (threadIdx.x < kTile ? lse : delta) + stat0 +
                       (int64_t)(valid ? n : i0) * a.heads;
    cp_async4((threadIdx.x < kTile ? Ls : Ds) + stage * kTile + r, src, valid);
  };
  static_assert(kThreads == 2 * kTile, "one thread per row of L and of delta");

  int key[2];
  for (int r = 0; r < 2; ++r) key[r] = j0 + warp * 16 + (lane >> 2) + 8 * r;
  const uint32_t wh = win_head_id(a.drop, win, head);
  const KeepFixed fixed[2] = {KeepFixed(key[0], a.mask_tile), KeepFixed(key[1], a.mask_tile)};
  float ak[NT][4], av[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

  const int ntiles = (N + kTile - 1) / kTile;
  load_queries(0, 0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1, i0 = it * kTile;
    if (it + 1 < ntiles) load_queries(stage ^ 1, i0 + kTile);
    cp_async_commit();  // empty at the last tile, so that wait<1> covers this one
    cp_async_wait<1>();
    const bf16* Qus = Qu + stage * TL::ELEMS;
    bf16* Qss = Qs + stage * TL::ELEMS;
    const bf16* Gs = Gt + stage * TL::ELEMS;
    for_own_chunks<D>([&](int off) { scale_round8(Qss + off, Qus + off, a.scale); });
    __syncthreads();
    const float* Lst = Ls + stage * kTile;
    const float* Dst = Ds + stage * kTile;
    const KeepTile keep(a.drop, wh, a.mask_tile, i0, N);
    uint32_t kbase[2] = {0u, 0u}, kcnt[2] = {0u, 0u}, kstep = 1;
    if constexpr (DROP) {
      keep_hoist(keep, fixed[0], false, kbase[0], kcnt[0], kstep);
      keep_hoist(keep, fixed[1], false, kbase[1], kcnt[1], kstep);
    }
#pragma unroll
    for (int qc = 0; qc < kTile / 16; ++qc) {
      if (i0 + qc * 16 >= N) break;
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        load_b_rows(b, Qss + qc * 16 * LD + ks * 16, LD, lane);
        mma::mma(s[0], ka[ks], b[0], b[1]);
        mma::mma(s[1], ka[ks], b[2], b[3]);
        load_b_rows(b, Gs + qc * 16 * LD + ks * 16, LD, lane);
        mma::mma(dp[0], va[ks], b[0], b[1]);
        mma::mma(dp[1], va[ks], b[2], b[3]);
      }
      if (i0 + qc * 16 + 16 > N) {  // the queries past N (zero-filled): p = exp2(-inf) = 0
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (i0 + qc * 16 + nt * 8 + 2 * t + (e & 1) >= N) s[nt][e] = -INFINITY;
      }
      if constexpr (KEYS) {  // the block's keys past NK (zero-filled): p = 0, so dk = dv = 0
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key[e >> 1] >= NK) s[nt][e] = -INFINITY;
      }
      uint32_t bits = 0xffu;
      if constexpr (DROP) bits = keep_bits(keep, fixed, kbase, kcnt, kstep, false, qc * 16, t);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // the element's query: column 2t + c of n-tile nt
          const int qi = qc * 16 + nt * 8 + 2 * t + c;
          const float nl2 = -Lst[qi] * kLog2e, dl = Dst[qi];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const float p = exp2_sfu(fmaf(s[nt][e], kLog2e, nl2));
            float pd = p, d = dp[nt][e];
            if constexpr (DROP) {
              const bool kept = (bits >> (nt * 4 + e)) & 1u;
              pd = kept ? p * a.drop.inv_keep : 0.f;
              d = kept ? d * a.drop.inv_keep : 0.f;
            }
            s[nt][e] = pd;
            dp[nt][e] = p * (d - dl);
          }
        }
      const uint32_t pa[4] = {pack(s[0][0], s[0][1]), pack(s[0][2], s[0][3]),
                              pack(s[1][0], s[1][1]), pack(s[1][2], s[1][3])};
      const uint32_t da[4] = {pack(dp[0][0], dp[0][1]), pack(dp[0][2], dp[0][3]),
                              pack(dp[1][0], dp[1][1]), pack(dp[1][2], dp[1][3])};
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) {
        uint32_t b[4];
        load_b_cols(b, Gs + qc * 16 * LD + dn * 16, LD, lane);
        mma::mma(av[2 * dn], pa, b[0], b[1]);
        mma::mma(av[2 * dn + 1], pa, b[2], b[3]);
        load_b_cols(b, Qus + qc * 16 * LD + dn * 16, LD, lane);
        mma::mma(ak[2 * dn], da, b[0], b[1]);
        mma::mma(ak[2 * dn + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= N) continue;
    const int64_t tj = tok(key[r]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dk + tj * ldd + c0 + n * 8 + 2 * t) =
          __floats2bfloat162_rn(ak[n][2 * r] * a.scale, ak[n][2 * r + 1] * a.scale);
  }
  if (lepe_w == nullptr) {  // flash mode: dv as it is
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= N) continue;
      const int64_t tj = tok(key[r]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dv + tj * ldd + c0 + n * 8 + 2 * t) =
            __floats2bfloat162_rn(av[n][2 * r], av[n][2 * r + 1]);
    }
    return;
  }

  // Window mode: dv += LePE^T(dO) and the block's dw partial.  dv's
  // fragments are staged in float32 through shared memory (the tiles are
  // free now), so that a thread then takes 8 columns of a row, as the
  // forward's epilogue does: dO and v are read and dv written 16 bytes at a
  // time, and each thread's loads of a row issue together (the epilogue
  // waits on L2, not on arithmetic).
  //   dv: a thread per (row, 8 columns), the 9 taps of the transpose;
  //   dw: a thread per (tap row dy, 8 columns, row subset), 3 taps x 8
  //   columns in registers; the subsets are summed in order.
  constexpr int CPR = D / 8, RPP = kThreads / CPR;  // threads per row, rows per pass
  constexpr int OLD = D + 8;                        // floats per staged row
  constexpr int SUB = kThreads / (3 * CPR);         // row subsets of the dw pass
  float* dvs = reinterpret_cast<float*>(smem);      // (kRows, OLD)
  float* red = dvs + kRows * OLD;                   // (SUB, 9, D)
  float* wsm = red + SUB * 9 * D;                   // the taps, (9, D)
  static_assert((kRows * OLD + SUB * 9 * D + 9 * D) * 4 <= flash_dkv_mma_smem<D>(),
                "scratch fits");
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dvs + (warp * 16 + (lane >> 2) + 8 * r) * OLD + n * 8 +
                                 2 * t) = make_float2(av[n][2 * r], av[n][2 * r + 1]);
  for (int idx = threadIdx.x; idx < 9 * D; idx += kThreads)
    wsm[idx] = lepe_w[(int64_t)(c0 + idx % D) * 9 + idx / D];
  __syncthreads();
  const int c = (threadIdx.x % CPR) * 8, ch = c0 + c;
  auto load8 = [](float (&x)[8], const bf16* p) {  // 8 bf16, 16-byte aligned
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = unpack(w4[h]);
      x[2 * h] = f.x;
      x[2 * h + 1] = f.y;
    }
  };
#pragma unroll
  for (int pass = 0; pass < kRows / RPP; ++pass) {
    const int m = pass * RPP + threadIdx.x / CPR, n = j0 + m;
    if (n >= N) break;
    const int ty = n / a.wsp, tx = n - ty * a.wsp;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(dvs + m * OLD + c + e);
      o[e] = f.x, o[e + 1] = f.y, o[e + 2] = f.z, o[e + 3] = f.w;
    }
    // LePE transpose: out(y, x) took w[dy, dx] * v(y+dy, x+dx)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int yy = ty - dy;
      if (yy < 0 || yy >= a.hsp) continue;
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = tx - dx;
        if (xx < 0 || xx >= a.wsp) continue;
        float g[8];
        load8(g, dout + tok(yy, xx) * a.ldg + ch);
        const float* w = wsm + ((dy + 1) * 3 + (dx + 1)) * D + c;
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = fmaf(w[e], g[e], o[e]);
      }
    }
    *reinterpret_cast<uint4*>(dv + tok(ty, tx) * ldd + ch) =
        make_uint4(pack(o[0], o[1]), pack(o[2], o[3]), pack(o[4], o[5]), pack(o[6], o[7]));
  }

  // dw[tap, c] pairs dO at (y, x) with v at (y+dy, x+dx), tap (dy+1)*3 + (dx+1)
  const int item = threadIdx.x / CPR, dy = item % 3 - 1, sub = item / 3;
  if (sub < SUB) {
    float acc[3][8];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
#pragma unroll 2
    for (int m = sub; m < kRows && j0 + m < N; m += SUB) {
      const int n = j0 + m, ty = n / a.wsp, tx = n - ty * a.wsp, yy = ty + dy;
      if (yy < 0 || yy >= a.hsp) continue;
      float g[8];
      load8(g, dout + tok(ty, tx) * a.ldg + ch);
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = tx + dx;
        if (xx < 0 || xx >= a.wsp) continue;
        float x[8];
        load8(x, v + tok(yy, xx) * a.ldv + ch);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[dx + 1][e] = fmaf(g[e], x[e], acc[dx + 1][e]);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float* dst = red + (sub * 9 + (dy + 1) * 3 + k) * D + c;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 9 * D; idx += kThreads) {  // subsets summed in order
    float sum = 0.f;
    for (int si = 0; si < SUB; ++si) sum += red[si * 9 * D + idx];
    const int tap = idx / D, d = idx - tap * D;
    const int64_t part = ((int64_t)win * gridDim.z + blockIdx.z) * 9 + tap;
    dw_part[part * ldd + c0 + d] = sum;
  }
}

template <int D, bool DROP, bool KEYS>
static cudaError_t launch_flash_dkv_mma(const void* q, const void* k, const void* v,
                                        const void* lepe_w, const void* dout, const void* lse,
                                        const void* delta, void* dk, void* dv, void* dw_part,
                                        int B, const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = flash_dkv_mma_smem<D>();
  static std::atomic<int> opted[kMaxDevices];
  const cudaError_t e = opt_in_smem(flash_dkv_mma_kernel<D, DROP, KEYS>, smem, opted);
  if (e != cudaSuccess) return e;
  const int N = a.hsp * a.wsp;
  const dim3 grid((unsigned)(B * (a.H / a.hsp) * (a.W / a.wsp)), (unsigned)a.heads,
                  (unsigned)((N + mma::kRows - 1) / mma::kRows));
  using bf = __nv_bfloat16;
  flash_dkv_mma_kernel<D, DROP, KEYS><<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const float*>(lepe_w), static_cast<const bf*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf*>(dk),
      static_cast<bf*>(dv), static_cast<float*>(dw_part), a);
  return cudaGetLastError();
}

cudaError_t dispatch_flash_dkv_mma(int head_dim, const void* q, const void* k, const void* v,
                                   const void* lepe_w, const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv, void* dw_part, int B,
                                   const FlashArgs& a, cudaStream_t stream) {
#define CSU_FLASH_DKV_MMA(DIM)                                                               \
  if (head_dim == DIM)                                                                       \
    return a.nkeys ? launch_flash_dkv_mma<DIM, false, true>(q, k, v, lepe_w, dout, lse,      \
                                                            delta, dk, dv, dw_part, B, a,    \
                                                            stream)                          \
           : a.drop.threshold                                                                \
               ? launch_flash_dkv_mma<DIM, true, false>(q, k, v, lepe_w, dout, lse, delta,   \
                                                        dk, dv, dw_part, B, a, stream)       \
               : launch_flash_dkv_mma<DIM, false, false>(q, k, v, lepe_w, dout, lse, delta,  \
                                                         dk, dv, dw_part, B, a, stream);
  CSU_FLASH_DKV_MMA(16) CSU_FLASH_DKV_MMA(32) CSU_FLASH_DKV_MMA(64)
#undef CSU_FLASH_DKV_MMA
  return cudaErrorInvalidValue;
}

}  // namespace csu

// dk and dv of csu_flash_attention_fwd.  q, k, v, lepe_w, geometry, scale,
// mask_tile and the dropout as there; dout as for csu_flash_attention_dq;
// lse and delta (B * windows, hsp*wsp, heads) float32; dk, dv (B, H*W,
// heads*head_dim) contiguous; dw_part (B * windows * ceil(hsp*wsp / rows per
// block), 9, heads*head_dim) float32 with lepe_w (window mode), else unused:
// 64 key rows per block in the tensor-core body, 128 (head dim <= 32) or 64
// in the CUDA-core body.
CSU_EXPORT int csu_flash_attention_dkv(int dtype, const void* q, const void* k,
                                       const void* v, const void* lepe_w, const void* dout,
                                       const void* lse, const void* delta, void* dk, void* dv,
                                       void* dw_part, int64_t ldq, int64_t ldk, int64_t ldv,
                                       int64_t ldg, int B, int H, int W, int hsp, int wsp,
                                       int heads, int head_dim, float scale, int mask_tile,
                                       uint32_t seed, uint32_t threshold, float inv_keep,
                                       uint32_t win0, uint32_t nwin_global, uint32_t head0,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const csu::FlashArgs a{H, W, hsp, wsp, heads, mask_tile, scale,
                         csu::attn_drop(seed, threshold, inv_keep, H, W, hsp, wsp, win0,
                                        nwin_global, head0), ldq, ldk, ldv, ldg};
  if (dtype == csu::kFloat32)
    return (int)csu::dispatch_flash_dkv<float>(head_dim, q, k, v, lepe_w, dout, lse, delta,
                                               dk, dv, dw_part, B, a, s);
  if (csu::mma::serves(dtype, head_dim))
    return (int)csu::dispatch_flash_dkv_mma(head_dim, q, k, v, lepe_w, dout, lse, delta, dk,
                                            dv, dw_part, B, a, s);
  if (dtype == csu::kBFloat16)
    return (int)csu::dispatch_flash_dkv<__nv_bfloat16>(head_dim, q, k, v, lepe_w, dout, lse,
                                                       delta, dk, dv, dw_part, B, a, s);
  return (int)cudaErrorInvalidValue;
}
