// Tensor-core building blocks of the attention kernels' bf16 bodies (dq and
// dk/dv in flash_attention_dq.cu and flash_attention_dkv.cu, the forwards of
// K-A and of the flash family in attention_fwd_mma.cuh): mma.sync m16n8k16 bf16
// products with float32 accumulation, operands read from shared memory with
// ldmatrix, tiles streamed in with cp.async, and the dropout keep bits of a
// fragment computed from its (row, column) directly.
//
// The layout (PTX ISA, "Matrix fragments for mma.m16n8k16"): lane l of a
// warp is g = l / 4, t = l % 4.  Of a 16 x 16 A tile it holds rows g and
// g + 8 at columns 2t, 2t+1 and 2t+8, 2t+9; of a 16 x 8 B tile the k rows
// 2t, 2t+1 and 2t+8, 2t+9 of column g; of the 16 x 8 float32 C tile rows g
// and g + 8 at columns 2t, 2t+1 (c[0..3] = (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1)).  Two neighbouring C tiles, rounded to bf16 in pairs, are
// therefore the A fragment of a product over their 16 columns: the score
// tiles feed the next product from registers, with no shared-memory round
// trip (FlashAttention-2's reuse).
//
// Every body keeps one side of the window (64 rows a block, 16 a warp) in
// registers and stream the other through shared memory in tiles of 64 rows,
// double-buffered: rows of D bf16 padded to D + 8, so that each row is 16
// bytes aligned for cp.async and the eight rows an ldmatrix reads fall in
// eight different bank groups.  Rows past the window's end are zero-filled.
#pragma once

#include <type_traits>

#include "flash_attention.cuh"

namespace csu {

// The dtype code (common.cuh) of element type T.
template <typename T> __host__ __device__ constexpr int dtype_code() {
  return std::is_same<T, float>::value ? kFloat32 : kBFloat16;
}

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // the block's own rows, 16 per warp
constexpr int kTile = 64;      // rows of the streamed side per stage
constexpr float kLog2e = 1.4426950408889634f;

// Where the tensor-core bodies serve: bf16 at head dims 16, 32 and 64.
// float32 (the exact-f32 route) and head dim 8 take the CUDA-core bodies,
// whose dispatch leaves these cases out (csu_attention_body tells the
// wrappers).
__host__ __device__ constexpr bool serves(int dtype, int head_dim) {
  return dtype == kBFloat16 && (head_dim == 16 || head_dim == 32 || head_dim == 64);
}

template <int D> struct Tile {
  static constexpr int LD = D + 8;               // bf16 per shared-memory row
  static constexpr int ELEMS = kTile * LD;       // bf16 per tile
  static constexpr int CHUNKS = kTile * D / 8;   // 16-byte copies per tile
  static_assert(CHUNKS % kThreads == 0, "a tile is whole 16-byte copies per thread");
};

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a . b over one 16 x 8 x 16 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16, lo in the low half: the element of the lower column
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// 2^x on the SFU (ex2.approx: 2 ulp; 0 for -inf)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of the 16 x 16 tile whose rows start at p (row stride ld):
// matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p, int ld, int lane) {
  ldsm4(a, p + (lane & 15) * ld + (lane >> 4) * 8);
}

// B fragments of two n-tiles (rows 0-7 and 8-15 of p as the n index, 16
// columns of p as k): (b0, b1) of n-tile 0 in r[0..1], of n-tile 1 in r[2..3].
__device__ __forceinline__ void load_b_rows(uint32_t (&r)[4], const bf16* p, int ld,
                                            int lane) {
  ldsm4(r, p + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles with 16 rows of p as k and columns 0-7, 8-15
// of p as the n index (ldmatrix .trans): n-tile 0 in r[0..1], 1 in r[2..3].
__device__ __forceinline__ void load_b_cols(uint32_t (&r)[4], const bf16* p, int ld,
                                            int lane) {
  ldsm4_t(r, p + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8);
}

// Rows [n0, n0 + kTile) of the window's columns [c0, c0 + D) of x into a
// padded tile, by cp.async; zeros for rows past N.  Thread threadIdx.x
// copies chunks threadIdx.x + i * kThreads (for_own_chunks walks the same).
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* __restrict__ x, int64_t ld,
                                          const WindowRows& tok, int n0, int N, int c0) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < Tile<D>::CHUNKS / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx / CH, c = idx % CH;
    const bool valid = n0 + r < N;
    cp_async16(s + r * Tile<D>::LD + c * 8, x + tok(valid ? n0 + r : n0) * ld + c0 + c * 8,
               valid);
  }
}

// fn(offset in the tile) for each 16-byte chunk this thread copied in load_tile
template <int D, typename Fn>
__device__ __forceinline__ void for_own_chunks(Fn fn) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < Tile<D>::CHUNKS / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    fn((idx / CH) * Tile<D>::LD + (idx % CH) * 8);
  }
}

// dst = round(src * scale) for 8 bf16 (16-byte aligned)
__device__ __forceinline__ void scale_round8(bf16* dst, const bf16* src, float scale) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack(w[i]);
    w[i] = pack(f.x * scale, f.y * scale);
  }
  *reinterpret_cast<uint4*>(dst) = raw;
}

// The dropout keep bits of flash_keep for one fixed index f of the fragment
// (its row: the query in dq and the forwards, the key in dk/dv) against a
// streamed tile of kTile indices starting at s0: hash_keep_mask's tile ((wh
// * 4099 + i / T) * 257 + j / T), counter (i % T) * T + j % T, for query i
// and key j.  Where the tile's valid indices lie in one mask tile (always in
// window mode and in K-A, where T = N, and in flash mode when T is a
// multiple of kTile) the
// tile id and counter base are hoisted out of the elements ("fast"), else
// each element divides.
struct KeepFixed {
  uint32_t tile, off;  // f / T, f % T
  __device__ KeepFixed(int f, uint32_t T) : tile((uint32_t)f / T), off((uint32_t)f % T) {}
};

struct KeepTile {
  uint32_t mix, wh, T, thr;  // seed * 0x9E3779B9, window-head id, mask tile, threshold
  uint32_t s0, st, so;       // first streamed index, s0 / T, s0 % T
  bool fast;
  __device__ KeepTile(const AttnDrop& d, uint32_t wh_, uint32_t T_, int s0_, int N)
      : mix(d.seed * 0x9E3779B9u), wh(wh_), T(T_), thr(d.threshold), s0((uint32_t)s0_) {
    st = s0 / T;
    so = s0 - st * T;
    fast = so + (uint32_t)min(kTile, N - s0_) <= T;
  }
  __device__ __forceinline__ uint32_t base(uint32_t it, uint32_t jt) const {
    return mix ^ (((wh * 4099u + it) * 257u + jt) * 0x85EBCA6Bu);
  }
};

// Fast path: the hoisted hash base and counter base of fixed index f
// against the tile; the element at streamed offset `local` then has counter
// cnt + local * step, step 1 when the key streams (dq), T when the query
// streams (dk/dv).
__device__ __forceinline__ void keep_hoist(const KeepTile& k, const KeepFixed& f,
                                           bool query_fixed, uint32_t& base, uint32_t& cnt,
                                           uint32_t& step) {
  if (query_fixed) {
    base = k.base(f.tile, k.st);
    cnt = f.off * k.T + k.so;
    step = 1;
  } else {
    base = k.base(k.st, f.tile);
    cnt = k.so * k.T + f.off;
    step = k.T;
  }
}

// Slow path: the keep bit of the element at streamed offset `local`.
__device__ __forceinline__ bool keep_slow(const KeepTile& k, const KeepFixed& f,
                                          bool query_fixed, int local) {
  const uint32_t s = k.s0 + (uint32_t)local, stile = s / k.T, soff = s - stile * k.T;
  return query_fixed ? drop_keep(k.base(f.tile, stile), f.off * k.T + soff, k.thr)
                     : drop_keep(k.base(stile, f.tile), soff * k.T + f.off, k.thr);
}

// The keep bits of a thread's 8 elements of a 16-column chunk at streamed
// offset c0 of the tile: bit nt * 4 + e for C-fragment element e of n-tile
// nt (row f[e / 2], column c0 + nt * 8 + 2t + e % 2).
__device__ __forceinline__ uint32_t keep_bits(const KeepTile& k, const KeepFixed (&f)[2],
                                              const uint32_t (&base)[2],
                                              const uint32_t (&cnt)[2], uint32_t step,
                                              bool query_fixed, int c0, int t) {
  uint32_t bits = 0;
  if (k.fast) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t local = (uint32_t)(c0 + nt * 8 + 2 * t + (e & 1));
        bits |= (uint32_t)drop_keep(base[e >> 1], cnt[e >> 1] + local * step, k.thr)
                << (nt * 4 + e);
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bits |= (uint32_t)keep_slow(k, f[e >> 1], query_fixed, c0 + nt * 8 + 2 * t + (e & 1))
                << (nt * 4 + e);
  }
  return bits;
}

}  // namespace mma

// The tensor-core dq and dk/dv bodies (flash_attention_dq.cu and
// flash_attention_dkv.cu), launched by the flash family's entries, in
// window mode at mask tile N by K-A' (stripe_attention_bwd.cu) and, with a
// key count a.nkeys > 0 (no dropout, no LePE), by K-V1' for the windows its
// own body cannot hold (window_attention.cu).
cudaError_t dispatch_flash_dq_mma(int head_dim, const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, void* delta,
                                  int delta_given, void* dq, int B, const FlashArgs& a,
                                  cudaStream_t stream);
cudaError_t dispatch_flash_dkv_mma(int head_dim, const void* q, const void* k, const void* v,
                                   const void* lepe_w, const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv, void* dw_part, int B,
                                   const FlashArgs& a, cudaStream_t stream);

}  // namespace csu
