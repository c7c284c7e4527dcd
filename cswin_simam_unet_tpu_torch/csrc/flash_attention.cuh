// The flash-attention kernel family: KV-tiled attention whose softmax is
// taken online, in three kernel bodies, one source each so that the build
// compiles them in parallel: the forward (flash_attention_fwd.cu), dq
// (flash_attention_dq.cu) and dk/dv (flash_attention_dkv.cu).
//
// Replaces cswin_simam_unet_tpu/ops/pallas_attention_flash.py::
// _flash_fwd_kernel (pallas_call at :291), _flash_dq_kernel (:323) and
// _flash_dkv_kernel (:338), and is the tiled instantiation of
// pallas_attention_v2.py::_attn_kernel (:180) and _attn_bwd_kernel (:219)
// for windows that K-A / K-A' cannot hold whole in one block
// (ops/stripe_attention.py picks).  Two modes, set by the wrapper's
// arguments rather than by templates:
//   window mode (the tiled K-A / K-A'): LePE fused (lepe_w non-null; the
//     forward adds it in float32 before its one rounding, dkv adds its
//     transpose into dv and writes per-block dw partials), the dropout mask
//     of the v2 convention (mask_tile = N: one N x N tile per window and
//     head) and delta = rowsum(dp * p) computed by the dq kernel itself;
//   flash mode: no LePE (the caller adds it outside), mask_tile =
//     _pick_tile(N) as the flash kernels tile, and delta = rowsum(dO * O)
//     given by the caller.
// In both, q * scale is rounded to the compute dtype before the product,
// the unnormalised probabilities exp(s - m) are dropped and rounded to the
// compute dtype before p.v (the flash kernel's rounding points,
// pallas_attention_flash.py:159-175), and the forward writes the row's
// L = m + log(l), (windows, N, heads) float32, from which the backward
// recomputes p = exp(s - L).
//
// What bounds it on the H100: 4 N flops per q/k/v/out element against 8
// bytes of them (bf16), so at N >= 512 the tensor cores' 295 flop/byte
// ridge is crossed and the operations are the bound.  The helpers below
// serve the CUDA-core bodies, which do their products in float32: the
// forward, dq and dk/dv in float32 and at head dim 8 (bf16 at head dims
// 16-64 runs on the tensor cores: flash_attention_mma.cuh and, for the
// forward, attention_fwd_mma.cuh).
// Design: each thread owns one row (a query row in the forward and dq
// kernels, a key row in dkv; at head dim 64 two neighbouring lanes share a
// row, 32 columns each) and keeps that row's operands and accumulators in
// registers; the other side streams through shared memory in tiles of 32
// rows that every lane reads at the same address (a broadcast, 16 bytes a
// load), so one shared-memory load feeds the warp's 32 rows and FMA issue,
// not shared memory, is the limit.  Nothing of size N x N is stored; blocks
// need no dynamic shared memory.
#pragma once

#include "common.cuh"

namespace csu {

constexpr int kFlashThreads = 128;
constexpr int kFlashTile = 32;  // rows of the streamed side per shared-memory tile

struct FlashArgs {
  int H, W, hsp, wsp;  // token grid (H, W); windows hsp x wsp, row-major over it
  int heads;
  int mask_tile;       // edge of the dropout mask's tiles
  float scale;
  AttnDrop drop;
  int64_t ldq, ldk, ldv, ldg;  // row strides of q, k, v and dO
  // keys [0, nkeys) attended, in the tensor-core bodies instantiated with
  // KEYS (v1's n_valid, window_attention.cu); the others attend all N
  int nkeys = 0;
};

// Columns of a row that one thread owns, and threads per row.
template <int D> struct RowSplit {
  static constexpr int DL = D > 32 ? 32 : D;
  static constexpr int LPR = D / DL;
  static constexpr int ROWS = kFlashThreads / LPR;  // rows per block
};

// Window `win` (b * windows per image + w, in img2windows order) of the
// grid: token n of the window (row-major in hsp x wsp) -> row of the
// (B, H*W, *) token tensors, in 64-bit.
struct WindowRows {
  int64_t row0;
  int y0, x0, W, hsp, wsp;
  __device__ WindowRows(const FlashArgs& a, int win) : W(a.W), hsp(a.hsp), wsp(a.wsp) {
    const int nh = a.H / a.hsp, nw = a.W / a.wsp;
    row0 = (int64_t)(win / (nh * nw)) * a.H * a.W;
    y0 = (win / nw) % nh * a.hsp;
    x0 = win % nw * a.wsp;
  }
  __device__ int64_t operator()(int ty, int tx) const {
    return row0 + (int64_t)(y0 + ty) * W + (x0 + tx);
  }
  __device__ int64_t operator()(int n) const {
    const int ty = n / wsp;
    return (*this)(ty, n - ty * wsp);
  }
};

// The dropout keep bit of score (i, j) of `head` in window `win`, with mask
// tiles of edge T: hash_keep_mask's tile id ((win * 1000003 + head) * 4099 +
// i / T) * 257 + j / T and counter (i % T) * T + j % T.  With T = N this is
// common.cuh's drop_base / drop_keep (tile (0, 0) of one N x N tile).
// MaskPos walks i or j one step at a time without a division per element.
struct MaskPos {
  uint32_t tile, off;  // n / T and n % T
  __device__ MaskPos(int n, int T) : tile((uint32_t)n / T), off((uint32_t)n % T) {}
  __device__ void next(int T) {
    if (++off == (uint32_t)T) {
      off = 0;
      ++tile;
    }
  }
};

__device__ __forceinline__ bool flash_keep(const AttnDrop& d, uint32_t win_head,
                                           const MaskPos& row, const MaskPos& col, int T) {
  const uint32_t tile = (win_head * 4099u + row.tile) * 257u + col.tile;
  return drop_keep((d.seed * 0x9E3779B9u) ^ (tile * 0x85EBCA6Bu), row.off * T + col.off,
                   d.threshold);
}

__device__ __forceinline__ uint32_t win_head_id(int win, int head) {
  return (uint32_t)win * 1000003u + (uint32_t)head;
}

// x . y over DL columns, y in shared memory (16-byte aligned, broadcast).
template <int DL>
__device__ __forceinline__ float dot_smem(const float (&x)[DL], const float* y) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int d = 0; d < DL; d += 4) {
    const float4 w = *reinterpret_cast<const float4*>(y + d);
    s0 = fmaf(x[d], w.x, s0);
    s1 = fmaf(x[d + 1], w.y, s1);
    s0 = fmaf(x[d + 2], w.z, s0);
    s1 = fmaf(x[d + 3], w.w, s1);
  }
  return s0 + s1;
}

// acc += p * y over DL columns, y in shared memory.
template <int DL>
__device__ __forceinline__ void axpy_smem(float p, const float* y, float (&acc)[DL]) {
#pragma unroll
  for (int d = 0; d < DL; d += 4) {
    const float4 w = *reinterpret_cast<const float4*>(y + d);
    acc[d] = fmaf(p, w.x, acc[d]);
    acc[d + 1] = fmaf(p, w.y, acc[d + 1]);
    acc[d + 2] = fmaf(p, w.z, acc[d + 2]);
    acc[d + 3] = fmaf(p, w.w, acc[d + 3]);
  }
}

// A sum over the LPR lanes that share a row (neighbouring lanes).
template <int LPR>
__device__ __forceinline__ float row_sum(float x) {
  if constexpr (LPR > 1) x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// Rows [n0, n0 + nk) of the window's columns [c0, c0 + D) of x into a
// (kFlashTile, D) float32 tile, zeros past nk; `scale` > 0 rounds x * scale
// to T first (the scaled query).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* tile, const T* __restrict__ x, int64_t ld,
                                           const WindowRows& tok, int n0, int nk, int c0,
                                           float scale = 0.f) {
  for (int idx = threadIdx.x; idx < kFlashTile * D; idx += blockDim.x) {
    const int n = idx / D, d = idx - n * D;
    float val = 0.f;
    if (n < nk) {
      val = to_f(x[tok(n0 + n) * ld + c0 + d]);
      if (scale > 0.f) val = round_to<T>(val * scale);
    }
    tile[idx] = val;
  }
}

// DL columns [c, c + DL) of token row t of x, as floats.
template <typename T, int DL>
__device__ __forceinline__ void load_row(float (&out)[DL], const T* __restrict__ x,
                                         int64_t t, int64_t ld, int c) {
#pragma unroll
  for (int d = 0; d < DL; ++d) out[d] = to_f(x[t * ld + c + d]);
}

// LePE of channel c at token (ty, tx) of the window: taps w9 (tap
// (dy+1)*3 + (dx+1) multiplies x at (ty+dy, tx+dx)), zero padded at the
// window edge; `sign` -1 gives the transpose (x at (ty-dy, tx-dx)).
template <typename T>
__device__ __forceinline__ float lepe_at(const T* __restrict__ x, int64_t ld,
                                         const WindowRows& tok, int ty, int tx, int c,
                                         const float* __restrict__ w9, int sign) {
  float acc = 0.f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = ty + sign * dy;
    if (yy < 0 || yy >= tok.hsp) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = tx + sign * dx;
      if (xx < 0 || xx >= tok.wsp) continue;
      acc = fmaf(w9[(dy + 1) * 3 + (dx + 1)], to_f(x[tok(yy, xx) * ld + c]), acc);
    }
  }
  return acc;
}

// Head dims of the family (the wrappers refuse others).
#define CSU_FLASH_HEAD_DIMS(X) X(8) X(16) X(32) X(64)

}  // namespace csu
