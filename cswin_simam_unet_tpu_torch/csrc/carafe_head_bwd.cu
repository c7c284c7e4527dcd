// K4: the fused CARAFE head's backward, with and without the SimAM gate;
// and, on the same body with dacc loaded instead of computed, K-C': the
// decoder's CARAFE backward.
//
// K4 replaces cswin_simam_unet_tpu/ops/pallas_carafe_head.py::_fused_bwd_kernel
// (pallas_call at :283, through _fused_bwd_call), both branches.  Per pixel,
// sub-pixel s and channel c of the biased flat map fb (B, H, W, S*S*C):
//     dg   = sum_f dy[s*F + f] * W[c, f]
//     dacc = the closed-form SimAM VJP of dg at fb, with mu, var and K3's
//            pooled A, B, in _fused_bwd_kernel's formula (w4 = 1/(4(v+lam)),
//            the energy xc^2 * w4); without the gate dacc = dg
//     db   = the float32 sum of dacc over the pixels, before dacc is
//            rounded through the compute dtype (where the JAX chain stored it)
// and then the CARAFE backward of the rounded dacc (zero outside the image),
// with p_k the 9-tap softmax of enc rounded as the forward rounds it:
//     dp_k(pix, s) = sum_c dacc(pix, s, c) * x(pix + off_k, c)
//     denc(pix, k*S^2 + s) = p_k * (dp_k - sum_k' p_k' dp_k')
//     dx(pix', c)  = sum_k sum_s p_k(pix' - off_k, s) * dacc(pix' - off_k, s, c)
// dx is the tap scatter written as a gather over the 3x3 neighbours, so no
// two blocks write one element and no atomics are needed.
//
// What bounds it on the H100: the read of fb (268 MB in bf16 at the 512^2
// head, batch 8; 0.11 ms of bytes in all), one sigmoid per fb element on the
// SFU, and instruction issue (dp and dx are 9 FMAs per dacc element each).
// Design, the CUDA form of the JAX kernel's TH-row tile:
// * a block owns a strip of px columns and a run of `rows` rows of one
//   image; it keeps dacc and p of rows y-1, y, y+1 over its px+2 columns in
//   a 3-row ring in shared memory and computes each new row once as it walks
//   down the run, so the head VJP is recomputed (rows+2)/rows x (px+2)/px
//   times, not 3 (px+2)/px times;
// * one warp per own pixel: lane = (sub-pixel group, channel vector), each
//   lane looping over its sub-pixels, so dp's sum over channels is a warp
//   butterfly over the channel lanes, dx's sum over sub-pixels a per-lane
//   loop and a butterfly over the sub-pixel groups, and a sub-pixel's 9 denc
//   values are written by one lane; two __syncthreads() per row step and no
//   serial tails; a lane's nine neighbour loads for dp are predicated, not
//   branched, so they are in flight together;
// * at most 128 registers a thread, so two blocks of 8 warps share an SM;
// * the channel constants (mu, 1/(4(var+lam)), the A and B terms, W) once
//   per block in shared memory, F a compile-time bound (1, 2, 4, 8); the
//   sigmoid's reciprocal is rcp_rn (common.cuh), which rounds as / does
//   without the compiler's slow-path branch;
// * db partials per block (run x strip), summed by the caller in a fixed
//   order: deterministic, no float atomics.
//
// K-C' replaces cswin_simam_unet_tpu/ops/pallas_carafe.py::_bwd_kernel
// (pallas_call at :353, through _carafe_bwd): the CARAFE backward above of
// the cotangent dacc of the flat output, the same ring walk with no head and
// no db.  What a row stages is the kernel's policy: HeadDacc<GATE, FM> (K4)
// or CopyDacc (K-C').  K-C' moves few bytes (50 MB at the 512^2 decoder,
// batch 8) over many short rows, so it is bound by latency: CopyDacc copies
// the row's dacc and x into the ring with cp.async, in flight while the same
// threads compute the row's tap softmax (one round trip to device memory a
// row); dp reads x from the ring; at most 80 registers, three blocks an SM.
#include "common.cuh"

namespace csu {

struct HeadBwd {
  const void* x;       // (B, H, W, C)
  const void* enc;     // (B, H, W, 9*S*S) kernel logits
  const void* fb;      // (B, H, W, S*S*C) biased flat map (gate only)
  const void* dy;      // (B, H, W, S*S*F) cotangent of the flat logits
  const void* dacc;    // (B, H, W, S*S*C) cotangent of the flat output (CopyDacc)
  const void* w;       // (C, F) head weight, compute dtype
  const float* mu;     // (B, C) SimAM mean per real channel (gate only)
  const float* var;    // (B, C) SimAM variance (gate only)
  const float* A;      // (B, C) pooled sum of t (x - mu) (K3, gate only)
  const float* Bq;     // (B, C) pooled sum of t (x - mu)^2 (K3, gate only)
  void* dx;            // like x
  void* denc;          // like enc
  float* db_part;      // (blocks, S*S*C) float32 sums of dacc over each block's pixels
  int H, W, C, S, F, px, rows, strips, runs;
  float lam, inv_count, inv_count_m1;  // 1/(H*W*S*S), 1/(H*W*S*S - 1)
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Byte offsets of one block's shared memory (ops/carafe_head.py::
// k4_smem_bytes mirrors the total):
//   [0, ring)     dacc [3][px+2][S*S*C] then p [3][px+2][9*S*S], compute dtype;
//                 after the last row, the db partials of the staging phases
//   consts        [4][C] float: mu, 1/(4(var+lam)), the A and B terms (gate)
//   wt            [FM][C] float: W transposed
//   dbs           [S*S*C] float db sums, when a thread stages several slots
// CopyDacc has the ring and, at `xr`, x [3][px+2][C] of the same rows.
struct HeadBwdSmem {
  size_t consts, wt, dbs, total, xr;
};

__host__ __device__ inline size_t ring_bytes(int C, int S, int elem, int px) {
  const size_t S2 = (size_t)S * S;
  return align16(3 * ((size_t)px + 2) * (S2 * C + 9 * S2) * elem);
}

__host__ __device__ inline HeadBwdSmem head_bwd_smem(int C, int S, int vec, int elem, int px,
                                                     int fm, bool gate) {
  const size_t SC = (size_t)S * S * C, NT = 32 * (size_t)px;
  const size_t NVEC = SC / vec;
  const bool single = NVEC <= NT;
  const size_t ring = ring_bytes(C, S, elem, px);
  const size_t scratch = single ? (NT / NVEC) * SC * 4 : 0;
  HeadBwdSmem L;
  L.consts = ring > scratch ? ring : scratch;
  L.wt = L.consts + (gate ? 16 * (size_t)C : 0);
  L.dbs = L.wt + align16(4 * (size_t)fm * C);
  L.total = L.dbs + (single ? 0 : 4 * SC);
  L.xr = L.total;
  return L;
}

// VEC consecutive floats of shared memory (16-byte loads where VEC allows).
template <int VEC>
__device__ __forceinline__ void ld_f32(const float* p, float (&o)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x;
      o[i + 1] = v.y;
      o[i + 2] = v.z;
      o[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = p[i];
  }
}

// VEC elements from device memory into shared memory, zeros where !valid:
// one asynchronous 16-byte copy where VEC elements fill 16 bytes (the
// caller commits and waits), else through registers.
template <typename T, int VEC>
__device__ __forceinline__ void copy_vec(T* dst, const T* src, bool valid) {
  if constexpr (VEC * sizeof(T) == 16) {
    cp_async16(dst, src, valid);
  } else {
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    if (valid) load_vec<T, VEC>(src, v);
    store_vec<T, VEC>(dst, v);
  }
}

// The kernel's policy: what dacc a row of the ring holds, and where it comes
// from.  A policy gives its shared memory and the registers it allows
// (kMinBlocks).  HeadDacc computes dacc from the head (kCopy false): the
// block's constants, and per vector slot (sub-pixel s, channels
// c..c+VEC-1) the float32 dacc of one pixel, from `sub` = its sub-pixel
// index pix*S*S + s and `off` = its element pix*S*S*C + s*C + c of the flat
// map, whose own pixels add to the db partials.  CopyDacc (kCopy true)
// copies dacc and x into the ring as they are (asynchronously, while the
// row's tap softmax is computed), and dp then reads x from the ring instead
// of from device memory.
//
// HeadDacc<GATE, FM> (K4): dacc = dy W^T, through the SimAM gate's VJP with
// GATE, from the channel constants the block keeps in shared memory.
template <bool GATE, int FM>
struct HeadDacc {
  static constexpr bool kCopy = false;
  static constexpr int kMinBlocks = 2;  // blocks an SM: at most 128 registers a thread

  __host__ __device__ static HeadBwdSmem smem(int C, int S, int vec, int elem, int px) {
    return head_bwd_smem(C, S, vec, elem, px, FM, GATE);
  }
  static bool takes(const HeadBwd& a) { return a.F >= 1 && a.F <= FM; }

  // mu, 1/(4(var+lam)), the A and B terms of image b (gate) and W^T
  template <typename T>
  __device__ static void constants(const HeadBwd& a, float* Kc, float* Wt, int b, int tid,
                                   int NT) {
    const int C = a.C;
    for (int c = tid; c < C; c += NT) {
      if constexpr (GATE) {
        const int64_t bc = (int64_t)b * C + c;
        const float w4 = 1.f / (4.f * (a.var[bc] + a.lam));
        Kc[c] = a.mu[bc];
        Kc[C + c] = w4;
        Kc[2 * C + c] = (2.f * w4 * a.inv_count) * a.A[bc];
        Kc[3 * C + c] = (8.f * w4 * w4 * a.inv_count_m1) * a.Bq[bc];
      }
      const T* wr = static_cast<const T*>(a.w) + (int64_t)c * a.F;
#pragma unroll
      for (int f = 0; f < FM; ++f) Wt[f * C + c] = f < a.F ? to_f(wr[f]) : 0.f;
    }
  }

  template <typename T, int VEC>
  struct Slot {
    float mu[VEC], w4[VEC], ca[VEC], cb[VEC], wf[FM][VEC];

    __device__ Slot(const float* Kc, const float* Wt, int C, int c) {
      if constexpr (GATE) {
        ld_f32<VEC>(Kc + c, mu);
        ld_f32<VEC>(Kc + C + c, w4);
        ld_f32<VEC>(Kc + 2 * C + c, ca);
        ld_f32<VEC>(Kc + 3 * C + c, cb);
      }
#pragma unroll
      for (int f = 0; f < FM; ++f) ld_f32<VEC>(Wt + f * C + c, wf[f]);
    }

    __device__ void value(const HeadBwd& a, int64_t sub, int64_t off, float (&val)[VEC]) const {
      const int F = a.F;
      float dyv[FM], xv[VEC];
      const T* dr = static_cast<const T*>(a.dy) + sub * F;
#pragma unroll
      for (int f = 0; f < FM; ++f) dyv[f] = f < F ? to_f(dr[f]) : 0.f;
      if constexpr (GATE) load_vec<T, VEC>(static_cast<const T*>(a.fb) + off, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float dg = 0.f;
#pragma unroll
        for (int f = 0; f < FM; ++f) dg = fmaf(dyv[f], wf[f][i], dg);
        if constexpr (GATE) {
          const float xc = xv[i] - mu[i];
          const float g = rcp_rn(1.f + expf(-(xc * xc * w4[i] + 0.5f)));
          const float t = dg * xv[i] * (g * (1.f - g));
          dg = dg * g + 2.f * w4[i] * t * xc - ca[i] - cb[i] * xc;
        }
        val[i] = dg;
      }
    }
  };
};

// CopyDacc (K-C'): dacc is the cotangent a.dacc of the flat output, copied
// into the ring 16 bytes at a time with x beside it; no constants, no W, no
// db.  At most 80 registers a thread: three blocks an SM.
struct CopyDacc {
  static constexpr bool kCopy = true;
  static constexpr int kMinBlocks = 3;

  __host__ __device__ static HeadBwdSmem smem(int C, int S, int vec, int elem, int px) {
    const size_t ring = ring_bytes(C, S, elem, px);
    return HeadBwdSmem{ring, ring, ring, ring + align16(3 * ((size_t)px + 2) * C * elem), ring};
  }
  static bool takes(const HeadBwd&) { return true; }
};

template <typename T, int VEC, class Dacc>
__global__ void __launch_bounds__(256, Dacc::kMinBlocks)
carafe_head_bwd_kernel(const HeadBwd a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, W = a.W, C = a.C, S2 = a.S * a.S;
  const int CV = C / VEC, SC = S2 * C, NVEC = S2 * CV, K2S2 = 9 * S2;
  const int px = a.px, PW = px + 2, NT = blockDim.x;  // NT == 32 * px
  const HeadBwdSmem L = Dacc::smem(C, a.S, VEC, (int)sizeof(T), px);
  T* D = reinterpret_cast<T*>(smem);                     // [3][PW][SC] dacc
  T* P = D + 3 * PW * SC;                                 // [3][PW][9*S2] p
  float* Kc = reinterpret_cast<float*>(smem + L.consts);  // [4][C]
  float* Wt = reinterpret_cast<float*>(smem + L.wt);      // [FM][C]
  float* dbs = reinterpret_cast<float*>(smem + L.dbs);    // [SC]
  T* X = reinterpret_cast<T*>(smem + L.xr);              // [3][PW][C] x (kCopy)

  const T* x = static_cast<const T*>(a.x);
  const T* enc = static_cast<const T*>(a.enc);
  T* dx = static_cast<T*>(a.dx);
  T* denc = static_cast<T*>(a.denc);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strip = blockIdx.x % a.strips, rest = blockIdx.x / a.strips;
  const int run = rest % a.runs, b = rest / a.runs;
  const int x0 = strip * px, y0 = run * a.rows, y1 = min(H, y0 + a.rows);
  const int64_t img0 = (int64_t)b * H * W;  // first pixel of this image

  // staging: thread (q, v0) computes vector slot v0 of pixels q, q+QP, ...
  // when a row's NVEC slots fit the block (single), else slots tid, tid+NT, ...
  const bool single = NVEC <= NT;
  const int QP = single ? NT / NVEC : 1;
  const int q = single ? tid / NVEC : 0;
  const int v0 = single ? tid - q * NVEC : tid;
  const int vstep = single ? NVEC : NT;

  if constexpr (!Dacc::kCopy) {
    Dacc::template constants<T>(a, Kc, Wt, b, tid, NT);
    if (!single)
      for (int e = tid; e < SC; e += NT) dbs[e] = 0.f;
    __syncthreads();
  }

  float dbr[VEC];  // db of this thread's slot over its own pixels (single)
#pragma unroll
  for (int i = 0; i < VEC; ++i) dbr[i] = 0.f;

  // p of row yy (zero outside the image) into its ring slot
  auto probs = [&](int yy) {
    const bool row_in = yy >= 0 && yy < H;
    T* Pr = P + ((yy - y0 + 1) % 3) * PW * K2S2;
    for (int it = tid; it < PW * S2; it += NT) {
      const int jj = it / S2, s = it - jj * S2, xx = x0 + jj - 1;
      T* pr = Pr + jj * K2S2 + s;
      if (!row_in || xx < 0 || xx >= W) {
#pragma unroll
        for (int k = 0; k < 9; ++k) pr[k * S2] = from_f<T>(0.f);
        continue;
      }
      const T* e = enc + (img0 + (int64_t)yy * W + xx) * K2S2 + s;
      float lg[9];
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        lg[k] = to_f(e[k * S2]);
        m = fmaxf(m, lg[k]);
      }
      float den = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        lg[k] = expf(lg[k] - m);
        den += lg[k];
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) pr[k * S2] = from_f<T>(lg[k] / den);
    }
  };

  // (CopyDacc) dacc and x of row yy, zero outside the image, into its ring
  // slot: asynchronous copies, which the caller commits and waits for
  auto copy_row = [&](int yy) {
    const int slot = (yy - y0 + 1) % 3;
    const bool row_in = yy >= 0 && yy < H;
    const int64_t row0 = img0 + (int64_t)(row_in ? yy : 0) * W;
    const T* dacc = static_cast<const T*>(a.dacc);
    T* Dr = D + slot * PW * SC;
    for (int it = tid; it < PW * NVEC; it += NT) {
      const int jj = it / NVEC, v = it - jj * NVEC, xx = x0 + jj - 1;
      const bool in = row_in && xx >= 0 && xx < W;
      copy_vec<T, VEC>(Dr + jj * SC + v * VEC, dacc + (row0 + (in ? xx : 0)) * SC + v * VEC, in);
    }
    T* Xr = X + slot * PW * C;
    for (int it = tid; it < PW * CV; it += NT) {
      const int jj = it / CV, cv = it - jj * CV, xx = x0 + jj - 1;
      const bool in = row_in && xx >= 0 && xx < W;
      copy_vec<T, VEC>(Xr + jj * C + cv * VEC, x + (row0 + (in ? xx : 0)) * C + cv * VEC, in);
    }
  };

  // dacc and p of row yy (zero outside the image) into its ring slot
  auto stage = [&](int yy) {
    if constexpr (Dacc::kCopy) {  // dacc and x in flight while the softmax runs
      copy_row(yy);
      probs(yy);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      const bool row_in = yy >= 0 && yy < H;
      const bool own_row = yy >= y0 && yy < y1;
      T* Dr = D + ((yy - y0 + 1) % 3) * PW * SC;
      probs(yy);
      if (q >= QP) return;
      for (int v = v0; v < NVEC; v += vstep) {
        const int s = v / CV, c = (v - s * CV) * VEC;
        const typename Dacc::template Slot<T, VEC> src(Kc, Wt, C, c);
        float rdb[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) rdb[i] = 0.f;
#pragma unroll 2
        for (int jj = q; jj < PW; jj += QP) {
          const int xx = x0 + jj - 1;
          float val[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) val[i] = 0.f;
          if (row_in && xx >= 0 && xx < W) {
            const int64_t pix = img0 + (int64_t)yy * W + xx;
            src.value(a, pix * S2 + s, pix * SC + s * C + c, val);
            if (jj >= 1 && jj <= px) {
#pragma unroll
              for (int i = 0; i < VEC; ++i) rdb[i] += val[i];
            }
          }
          store_vec<T, VEC>(Dr + jj * SC + s * C + c, val);
        }
        if (own_row) {
          if (single) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) dbr[i] += rdb[i];
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) dbs[v * VEC + i] += rdb[i];
          }
        }
      }
    }
  };

  // the warp's own pixel of row y: lane = (sub-pixel group sg, channel
  // vector cvl); sub-pixels sg, sg+SG, ...; channel vectors cvl, cvl+CVL, ...
  int CVL = 1;
  while (CVL < CV && CVL < 32) CVL <<= 1;
  const int lg_cvl = __ffs(CVL) - 1, SG = 32 >> lg_cvl, NSL = (S2 + SG - 1) / SG;
  const int cvl = lane & (CVL - 1), sg = lane >> lg_cvl;

  auto process = [&](int y) {
    const int jj = warp + 1, xx = x0 + warp;
    if (xx >= W) return;  // the whole warp
    const int64_t pix = img0 + (int64_t)y * W + xx;
    const int sc = (y - y0 + 1) % 3;
    const T* Dc = D + (sc * PW + jj) * SC;
    const T* Pc = P + (sc * PW + jj) * K2S2;
    for (int j = 0; j < NSL; ++j) {
      const int s = sg + j * SG;
      float dp[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) dp[k] = 0.f;
      if (s < S2) {
        for (int cv = cvl; cv < CV; cv += CVL) {
          float da[VEC];
          ld_vec<T, VEC>(Dc + s * C + cv * VEC, da);
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            float xv[VEC], d = 0.f;
            if constexpr (Dacc::kCopy) {  // ring row y + dy, column jj + dx; zero outside
              ld_vec<T, VEC>(X + (((sc + 2 + k / 3) % 3) * PW + jj + k % 3 - 1) * C + cv * VEC,
                             xv);
#pragma unroll
              for (int i = 0; i < VEC; ++i) d = fmaf(da[i], xv[i], d);
              dp[k] += d;
            } else {
              const int yy = y + k / 3 - 1, xn = xx + k % 3 - 1;
              const bool in = yy >= 0 && yy < H && xn >= 0 && xn < W;
              // a tap outside the image reads its own pixel, adds 0
              load_vec<T, VEC>(x + (img0 + (int64_t)(in ? yy : y) * W + (in ? xn : xx)) * C +
                                   cv * VEC, xv);
#pragma unroll
              for (int i = 0; i < VEC; ++i) d = fmaf(da[i], xv[i], d);
              dp[k] += in ? d : 0.f;
            }
          }
        }
      }
      for (int off = 1; off < CVL; off <<= 1) {
#pragma unroll
        for (int k = 0; k < 9; ++k) dp[k] += __shfl_xor_sync(0xffffffffu, dp[k], off);
      }
      if (s < S2 && cvl == 0) {
        float pr[9], inner = 0.f;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          pr[k] = to_f(Pc[k * S2 + s]);
          inner = fmaf(dp[k], pr[k], inner);
        }
        T* de = denc + pix * K2S2 + s;
#pragma unroll
        for (int k = 0; k < 9; ++k) de[k * S2] = from_f<T>(pr[k] * (dp[k] - inner));
      }
    }
    // dx gather: the pixel at (y - dy, x - dx) reached this one through tap
    // (dy, dx); ring row y - dy, column jj - dx
    for (int cb = 0; cb < CV; cb += CVL) {
      const int cv = cb + cvl;
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      if (cv < CV) {
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int r = (sc + 4 - k / 3) % 3, sj = jj + 1 - k % 3;
          const T* Dn = D + (r * PW + sj) * SC + cv * VEC;
          const T* Pn = P + (r * PW + sj) * K2S2 + k * S2;
#pragma unroll 4
          for (int j = 0; j < NSL; ++j) {
            const int s = sg + j * SG;
            if (s >= S2) break;
            const float p = to_f(Pn[s]);
            float dv[VEC];
            ld_vec<T, VEC>(Dn + s * C, dv);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, dv[i], acc[i]);
          }
        }
      }
      for (int off = CVL; off < 32; off <<= 1) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
      }
      if (cv < CV && sg == 0) store_vec<T, VEC>(dx + pix * C + cv * VEC, acc);
    }
  };

  stage(y0 - 1);
  stage(y0);
  for (int y = y0; y < y1; ++y) {
    stage(y + 1);
    __syncthreads();
    process(y);
    __syncthreads();
  }

  // db partials of this block, the phases' sums added in a fixed order
  if constexpr (!Dacc::kCopy) {
    float* dbp = a.db_part + (int64_t)blockIdx.x * SC;
    if (single) {
      float* scr = reinterpret_cast<float*>(smem);  // [QP][SC]; the ring is free
      if (q < QP) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) scr[q * SC + v0 * VEC + i] = dbr[i];
      }
      __syncthreads();
      for (int e = tid; e < SC; e += NT) {
        float sum = 0.f;
        for (int qq = 0; qq < QP; ++qq) sum += scr[qq * SC + e];
        dbp[e] = sum;
      }
    } else {
      for (int e = tid; e < SC; e += NT) dbp[e] = dbs[e];
    }
  }
}

template <typename T, int VEC, class Dacc>
static cudaError_t launch_head_bwd(const HeadBwd& a, int B, cudaStream_t stream) {
  if (a.C % VEC || a.px < 1 || a.px > 8 || a.rows < 1 || !Dacc::takes(a))
    return cudaErrorInvalidValue;
  const HeadBwdSmem L = Dacc::smem(a.C, a.S, VEC, (int)sizeof(T), a.px);
  static std::atomic<int> opted[kMaxDevices];
  const cudaError_t e = opt_in_smem(carafe_head_bwd_kernel<T, VEC, Dacc>, L.total, opted);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)B * a.runs * a.strips;
  carafe_head_bwd_kernel<T, VEC, Dacc><<<(unsigned)blocks, 32 * a.px, L.total, stream>>>(a);
  return cudaGetLastError();
}

// The entries' policies: CopyDacc (K-C'), or HeadDacc with the class bound
// FM that F needs (K4, with and without the gate).
enum class DaccKind { kCopy, kHead, kHeadGate };

template <typename T, int VEC, DaccKind D>
static cudaError_t launch_policy(const HeadBwd& a, int B, cudaStream_t stream) {
  if constexpr (D == DaccKind::kCopy) {
    return launch_head_bwd<T, VEC, CopyDacc>(a, B, stream);
  } else {
    constexpr bool G = D == DaccKind::kHeadGate;
    if (a.F <= 1) return launch_head_bwd<T, VEC, HeadDacc<G, 1>>(a, B, stream);
    if (a.F <= 2) return launch_head_bwd<T, VEC, HeadDacc<G, 2>>(a, B, stream);
    if (a.F <= 4) return launch_head_bwd<T, VEC, HeadDacc<G, 4>>(a, B, stream);
    return launch_head_bwd<T, VEC, HeadDacc<G, 8>>(a, B, stream);
  }
}

template <DaccKind D>
static cudaError_t dispatch_head_bwd(int dtype, int vec, HeadBwd a, int B,
                                     cudaStream_t stream) {
  if (B < 1 || a.H < 1 || a.W < 1 || a.px < 1 || a.rows < 1 || a.S < 1)
    return cudaErrorInvalidValue;
  a.strips = (a.W + a.px - 1) / a.px;
  a.runs = (a.H + a.rows - 1) / a.rows;
  if (dtype == kFloat32 && vec == 4) return launch_policy<float, 4, D>(a, B, stream);
  if (dtype == kFloat32 && vec == 1) return launch_policy<float, 1, D>(a, B, stream);
  if (dtype == kBFloat16 && vec == 8) return launch_policy<__nv_bfloat16, 8, D>(a, B, stream);
  if (dtype == kBFloat16 && vec == 1) return launch_policy<__nv_bfloat16, 1, D>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace csu

// K4, the backward of the fused head (gate on): x (B, H, W, C), enc
// (B, H, W, 9*S*S), fb (B, H, W, S*S*C), dy (B, H, W, S*S*F), w (C, F) in
// the compute dtype, mu, var, A, Bq (B, C) float32, all contiguous; writes
// dx like x, denc like enc and db_part (blocks, S*S*C) float32, one row of
// sums per block.  A block covers px columns (32 px threads) and `rows` rows
// of one image: blocks = B * ceil(H / rows) * ceil(W / px).
CSU_EXPORT int csu_carafe_head_bwd(int dtype, const void* x, const void* enc,
                                   const void* fb, const void* dy, const void* w,
                                   const void* mu, const void* var, const void* A,
                                   const void* Bq, void* dx, void* denc, void* db_part,
                                   int B, int H, int W, int C, int S, int F, int vec,
                                   int px, int rows, float lam, void* stream) {
  const double count = (double)H * W * S * S;
  const csu::HeadBwd a{x, enc, fb, dy, nullptr, w, static_cast<const float*>(mu),
                       static_cast<const float*>(var), static_cast<const float*>(A),
                       static_cast<const float*>(Bq), dx, denc, static_cast<float*>(db_part),
                       H, W, C, S, F, px, rows, 0, 0, lam, (float)(1.0 / count),
                       (float)(1.0 / (count - 1.0))};
  return (int)csu::dispatch_head_bwd<csu::DaccKind::kHeadGate>(dtype, vec, a, B,
                                                           static_cast<cudaStream_t>(stream));
}

// K4 without the gate (the head without SimAM): as csu_carafe_head_bwd with
// dacc = dy W^T, from dy (B, H, W, S*S*F) and w (C, F) alone.
CSU_EXPORT int csu_carafe_head_bwd_nogate(int dtype, const void* x, const void* enc,
                                          const void* dy, const void* w, void* dx,
                                          void* denc, void* db_part, int B, int H, int W,
                                          int C, int S, int F, int vec, int px, int rows,
                                          void* stream) {
  const csu::HeadBwd a{x, enc, nullptr, dy, nullptr, w, nullptr, nullptr, nullptr, nullptr,
                       dx, denc, static_cast<float*>(db_part), H, W, C, S, F, px, rows, 0, 0,
                       0.f, 0.f, 0.f};
  return (int)csu::dispatch_head_bwd<csu::DaccKind::kHead>(dtype, vec, a, B,
                                                       static_cast<cudaStream_t>(stream));
}

// K-C', the decoder's CARAFE backward: K4's body with dacc loaded.  x
// (B, H, W, C), enc (B, H, W, 9*S*S), dacc (B, H, W, S*S*C) the cotangent of
// the flat output, all contiguous; writes dx like x and denc like enc.
// Blocks as K4's (carafe_head.k4_geometry with copy=True: no constants).
CSU_EXPORT int csu_carafe_bwd(int dtype, const void* x, const void* enc, const void* dacc,
                              void* dx, void* denc, int B, int H, int W, int C, int S,
                              int vec, int px, int rows, void* stream) {
  const csu::HeadBwd a{x, enc, nullptr, nullptr, dacc, nullptr, nullptr, nullptr, nullptr,
                       nullptr, dx, denc, nullptr, H, W, C, S, 1, px, rows, 0, 0,
                       0.f, 0.f, 0.f};
  return (int)csu::dispatch_head_bwd<csu::DaccKind::kCopy>(dtype, vec, a, B,
                                                       static_cast<cudaStream_t>(stream));
}
