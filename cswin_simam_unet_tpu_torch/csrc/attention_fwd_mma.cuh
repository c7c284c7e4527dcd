// The bf16 tensor-core forward body shared by the attention forwards: K-A
// (stripe_attention.cu: the whole window, probabilities normalised before
// their rounding), the flash forward (flash_attention_fwd.cu: the tiled K-A
// in window mode and the flash path, online softmax) and K-V1
// (window_attention.cu: online, a group of rows as its window, the keys cut
// at n_valid by the KEYS flag), at head dims 16, 32 and 64.  float32 and
// head dim 8 keep the CUDA-core bodies of those files.
//
// A block takes 64 query rows of one window and head, 16 per warp, whose
// round(q * scale) stay in registers as mma A fragments (the dq body's
// layout, flash_attention_mma.cuh).  Per 64-key tile a warp computes S = Qs
// K^T (mma.sync m16n8k16, float32 accumulation, keys past N at -inf), takes
// the row max over the four lanes that share a row, forms p with exp2 on
// the SFU, drops p by the keep bits of its fragment (query fixed, key
// streamed: the counter i * T + j of hash_keep_mask), rounds it in pairs
// into the A fragment of O += P V and reads V through ldmatrix .trans.  Two
// rounding points, a template flag each:
//   WHOLE (K-A, pallas_attention_v2.py:206-213): p = round(drop(exp(s - m)
//     / l)) needs the row's m and l before P V, so the whole window's K and
//     V sit in shared memory (bf16, rows padded to D + 8) and the keys are
//     swept twice, from shared memory only: m and l online, then p and P V;
//   flash (pallas_attention_flash.py:159-175): one online sweep, K and V
//     streamed in 64-row tiles double-buffered by cp.async; p = round(drop(
//     exp(s - m))) with m the running max, l sums the undropped p, O is
//     rescaled by alpha = exp(m_old - m) and divided by l at the end, and
//     L = m + log(l) (natural log, float32) is written for dq and dk/dv.
// The epilogue stages O in float32 through shared memory, so that each
// thread then owns 8 columns of a row: the LePE (window mode and K-A) reads
// v 16 bytes at a time at the 3 x 3 neighbours, adds in float32 before the
// one rounding, and out is written 16 bytes at a time.
//
// What bounds it on the H100: at the 2048^2 path's windows (512-4096 tokens)
// 4 N flops per q/k/v/out element is past the tensor cores' ridge, but each
// score also costs an exp on the SFU (two in K-A) and, with dropout, a
// murmur fmix32 on the integer pipes: those set the pace, as in dq.  K-A's
// windows (128-384 tokens) sit below the ridge: device memory would bound it.
#pragma once

#include "flash_attention_mma.cuh"

namespace csu {
namespace mma {

// Dynamic shared memory of a forward block: the query tile, then K and V in
// kv_tiles tiles each (the whole window, or the two stages of the stream).
template <int D>
__host__ __device__ constexpr size_t fwd_smem(int kv_tiles) {
  return (size_t)(1 + 2 * kv_tiles) * Tile<D>::ELEMS * sizeof(__nv_bfloat16);
}

// out rows ldo apart; lse (windows, N, heads) float32 or null; lepe_w (C, 9)
// float32 taps or null; grid (windows, heads, ceil(N / 64)), kThreads
// threads, fwd_smem<D>(WHOLE ? ceil(NK / 64) : 2) bytes at smem.  The
// queries are the window's N tokens; the keys too, or with KEYS the first
// NK = a.nkeys of them (v1, window_attention.cu), the rest masked.
template <int D, bool DROP, bool WHOLE, bool KEYS = false>
__device__ __forceinline__ void attention_fwd(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v,
                                              const float* __restrict__ lepe_w,
                                              bf16* __restrict__ out, int64_t ldo,
                                              float* __restrict__ lse, const FlashArgs& a,
                                              unsigned char* smem) {
  using TL = Tile<D>;
  constexpr int KS = D / 16, NT = D / 8, LD = TL::LD, CHUNKS = kTile / 16;
  const int N = a.hsp * a.wsp, NK = KEYS ? a.nkeys : N, ntiles = (NK + kTile - 1) / kTile;
  bf16* Qt = reinterpret_cast<bf16*>(smem);
  bf16* Kt = Qt + TL::ELEMS;                              // WHOLE: ntiles tiles, else 2 stages
  bf16* Vt = Kt + (WHOLE ? ntiles : 2) * TL::ELEMS;

  const int win = blockIdx.x, head = blockIdx.y, i0 = blockIdx.z * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const WindowRows tok(a, win);
  const int c0 = head * D;

  load_tile<D>(Qt, q, a.ldq, tok, i0, N, c0);
  for (int kt = 0; kt < (WHOLE ? ntiles : 1); ++kt) {
    load_tile<D>(Kt + kt * TL::ELEMS, k, a.ldk, tok, kt * kTile, NK, c0);
    load_tile<D>(Vt + kt * TL::ELEMS, v, a.ldv, tok, kt * kTile, NK, c0);
  }
  cp_async_commit();

  // the thread's two rows of the warp's 16: i0 + 16 warp + lane / 4 (+ 8)
  int row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row[r] = i0 + warp * 16 + (lane >> 2) + 8 * r;
  const uint32_t wh = win_head_id(win, head);
  const KeepFixed fixed[2] = {KeepFixed(row[0], a.mask_tile), KeepFixed(row[1], a.mask_tile)};

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KS][4];  // A fragments of round(q * scale)
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    load_a(qa[ks], Qt + warp * 16 * LD + ks * 16, LD, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack(qa[ks][e]);
      qa[ks][e] = pack(f.x * a.scale, f.y * a.scale);
    }
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // per row: the running max m, -m * log2(e), the thread's partial sum of p
  float m[2] = {-INFINITY, -INFINITY}, nm[2] = {0.f, 0.f}, l[2] = {0.f, 0.f};

  // S = Qs K^T of the 64 keys at j0 (tile Ks): s[n-tile][C element], n-tile
  // 2 kc + nt holding keys j0 + 16 kc + 8 nt + 2t (+1); -inf past NK
  auto score = [&](const bf16* Ks, int j0, float (&s)[2 * CHUNKS][4]) {
#pragma unroll
    for (int kc = 0; kc < CHUNKS; ++kc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * kc][e] = s[2 * kc + 1][e] = 0.f;
      if (j0 + kc * 16 < NK) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[4];
          load_b_rows(b, Ks + kc * 16 * LD + ks * 16, LD, lane);
          mma::mma(s[2 * kc], qa[ks], b[0], b[1]);
          mma::mma(s[2 * kc + 1], qa[ks], b[2], b[3]);
        }
      }
      if (j0 + kc * 16 + 16 > NK) {  // the keys past NK (zero-filled)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + kc * 16 + nt * 8 + 2 * t + (e & 1) >= NK) s[2 * kc + nt][e] = -INFINITY;
      }
    }
  };

  // m to the tile's row max, l (and, flash, acc) rescaled by exp(m_old - m),
  // s to p = exp(s - m), and l += p (undropped)
  auto online = [&](float (&s)[2 * CHUNKS][4]) {
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2 * CHUNKS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the four lanes of a row: one max
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);  // finite: key j0 < NK is live
      alpha[r] = exp2_sfu((m[r] - mn) * kLog2e);
      m[r] = mn;
      nm[r] = -mn * kLog2e;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 2 * CHUNKS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_sfu(fmaf(s[n][e], kLog2e, nm[e >> 1]));
        l[e >> 1] += s[n][e];
      }
    if constexpr (!WHOLE) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }
  };

  // acc += round(drop(p)) V over the 64 keys at j0 (tile Vs)
  auto pv = [&](const bf16* Vs, int j0, float (&s)[2 * CHUNKS][4]) {
    const KeepTile keep(a.drop, wh, a.mask_tile, j0, NK);
    uint32_t kbase[2] = {0u, 0u}, kcnt[2] = {0u, 0u}, kstep = 1;
    if constexpr (DROP) {
      keep_hoist(keep, fixed[0], true, kbase[0], kcnt[0], kstep);
      keep_hoist(keep, fixed[1], true, kbase[1], kcnt[1], kstep);
    }
#pragma unroll
    for (int kc = 0; kc < CHUNKS; ++kc) {
      if (j0 + kc * 16 >= NK) break;
      if constexpr (DROP) {
        const uint32_t bits = keep_bits(keep, fixed, kbase, kcnt, kstep, true, kc * 16, t);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& p = s[2 * kc + nt][e];
            p = (bits >> (nt * 4 + e)) & 1u ? p * a.drop.inv_keep : 0.f;
          }
      }
      const uint32_t pa[4] = {pack(s[2 * kc][0], s[2 * kc][1]), pack(s[2 * kc][2], s[2 * kc][3]),
                              pack(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dn = 0; dn < KS; ++dn) {
        uint32_t b[4];
        load_b_cols(b, Vs + kc * 16 * LD + dn * 16, LD, lane);
        mma::mma(acc[2 * dn], pa, b[0], b[1]);
        mma::mma(acc[2 * dn + 1], pa, b[2], b[3]);
      }
    }
  };

  auto row_sums = [&]() {  // l over the four lanes of each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  };

  if constexpr (WHOLE) {
    for (int kt = 0; kt < ntiles; ++kt) {  // sweep 1: m and l
      float s[2 * CHUNKS][4];
      score(Kt + kt * TL::ELEMS, kt * kTile, s);
      online(s);
    }
    row_sums();
    const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
    for (int kt = 0; kt < ntiles; ++kt) {  // sweep 2: p = exp(s - m) / l, then P V
      float s[2 * CHUNKS][4];
      score(Kt + kt * TL::ELEMS, kt * kTile, s);
#pragma unroll
      for (int n = 0; n < 2 * CHUNKS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = exp2_sfu(fmaf(s[n][e], kLog2e, nm[e >> 1])) * inv_l[e >> 1];
      pv(Vt + kt * TL::ELEMS, kt * kTile, s);
    }
    __syncthreads();  // the epilogue reuses the tiles
  } else {
    for (int kt = 0; kt < ntiles; ++kt) {
      const int stage = kt & 1, j0 = kt * kTile;
      if (kt + 1 < ntiles) {
        load_tile<D>(Kt + (stage ^ 1) * TL::ELEMS, k, a.ldk, tok, j0 + kTile, NK, c0);
        load_tile<D>(Vt + (stage ^ 1) * TL::ELEMS, v, a.ldv, tok, j0 + kTile, NK, c0);
      }
      cp_async_commit();  // empty at the last tile, so that wait<1> covers this one
      cp_async_wait<1>();
      __syncthreads();
      float s[2 * CHUNKS][4];
      score(Kt + stage * TL::ELEMS, j0, s);
      online(s);
      pv(Vt + stage * TL::ELEMS, j0, s);
      __syncthreads();
    }
    row_sums();
  }

  // O (flash: acc / l; K-A's p are normalised already) to shared memory in
  // float32, and L = m + log(l)
  constexpr int OLD = D + 8;  // floats per staged row
  static_assert(kRows * OLD * sizeof(float) <= 3 * TL::ELEMS * sizeof(bf16),
                "the staged O fits the query tile and the first key tile");
  float* Os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* orow = Os + (warp * 16 + (lane >> 2) + 8 * r) * OLD + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) =
          WHOLE ? make_float2(acc[n][2 * r], acc[n][2 * r + 1])
                : make_float2(acc[n][2 * r] / l[r], acc[n][2 * r + 1] / l[r]);
    if (lse != nullptr && t == 0 && row[r] < N)
      lse[((int64_t)win * N + row[r]) * a.heads + head] = m[r] + logf(l[r]);
  }
  __syncthreads();

  // each thread: 8 columns [c, c + 8) of rows rr, rr + kThreads / CPR, ...
  constexpr int CPR = D / 8;
  static_assert(kThreads % CPR == 0, "a thread keeps its columns across rows");
  const int c = (threadIdx.x % CPR) * 8, ch = c0 + c;
  float w9[9][8];
  if (lepe_w != nullptr) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) w9[tap][e] = lepe_w[(int64_t)(ch + e) * 9 + tap];
  }
  for (int rr = threadIdx.x / CPR; rr < kRows && i0 + rr < N; rr += kThreads / CPR) {
    const int n = i0 + rr, ty = n / a.wsp, tx = n - ty * a.wsp;
    float o[8];
    const float4 lo = *reinterpret_cast<const float4*>(Os + rr * OLD + c);
    const float4 hi = *reinterpret_cast<const float4*>(Os + rr * OLD + c + 4);
    o[0] = lo.x, o[1] = lo.y, o[2] = lo.z, o[3] = lo.w;
    o[4] = hi.x, o[5] = hi.y, o[6] = hi.z, o[7] = hi.w;
    if (lepe_w != nullptr) {
      float lp[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = ty + dy;
        if (yy < 0 || yy >= a.hsp) continue;
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int xx = tx + dx;
          if (xx < 0 || xx >= a.wsp) continue;
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(v + tok(yy, xx) * a.ldv + ch));
          const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float2 f = unpack(w4[h]);
            const int tap = (dy + 1) * 3 + (dx + 1);
            lp[2 * h] = fmaf(w9[tap][2 * h], f.x, lp[2 * h]);
            lp[2 * h + 1] = fmaf(w9[tap][2 * h + 1], f.y, lp[2 * h + 1]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] += lp[e];
    }
    const uint4 packed = make_uint4(pack(o[0], o[1]), pack(o[2], o[3]), pack(o[4], o[5]),
                                    pack(o[6], o[7]));
    *reinterpret_cast<uint4*>(out + tok(ty, tx) * ldo + ch) = packed;
  }
}

}  // namespace mma
}  // namespace csu
