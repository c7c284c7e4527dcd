// K-H2: SimAM gate + grouped 1x1 head dot over the flat head map, forward.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_simam_head.py::_fwd_kernel
// (pallas_call at :241, through head_fwd_pallas), as the fused CARAFE head
// (ops/pallas_carafe_head.py) calls it: the bias is already in the map.
// For each pixel and sub-pixel g of fb (B, H, W, G*C):
//     y_c = round(x_c * sigmoid((x_c - mu_c)^2 / (4 (v_c + lam)) + 0.5))
//     logits[b, h, w, g*F + f] = sum_c y_c * W[c, f]
// with the float32 gate, y rounded to the compute dtype as the reference
// does, and the dot over the C real channels summed in float32 (F <= 8).
// Without the gate (GATE false), y = x.
//
// What bounds it on the H100: one read of the 268 MB flat map at the 512^2
// head (about 81 us at 3.35 TB/s); the logits are 64x smaller.  Then the
// SFU: one exp and one reciprocal an element.  Design: K3's shape.  A block
// owns a chunk of `pc` consecutive pixels of one image (carafe_head.
// h2_geometry picks pc so that the grid fills the card several times), a
// group of L lanes each (pixel, g) (more groups than a block holds: slices
// of them over blockIdx.y), a lane one 16-byte channel vector (ONE:
// the channel vectors are exactly L, a power of two up to 32) or a stride
// of them; a thread walks the chunk U pixels at a time with their U loads
// issued together.  The channel constants (mu, 4 (v + lam), its rcp_rn) and
// the thread's rows of W sit in registers for the whole chunk; F is a
// compile-time bound (1, 2, 4, 8).  The gate is K3's arithmetic bit for bit
// (div_rn_by and rcp_rn, common.cuh: what / gives without its slow-path
// branch), so round(x * g) is the gated map that K3 and K4 recompute.  Each
// (pixel, g) dot is summed over its group with F * log2(L) shuffles, and
// lane (u*FM + f) mod L of the group writes logit (u, f): each warp writes
// its groups' logits of a pixel as one contiguous run.
#include "common.cuh"

namespace csu {

constexpr int kMaxClasses = 8;
constexpr int kHeadThreads = 256;  // threads of a K-H2 block at most

// K3 and K5 give a thread each (g, channel vector) slot of a pixel; where a
// pixel has more than kSlotThreads slots, blockIdx.y splits them into
// `splits` even slices of `threads` (the last may hold fewer), in the
// kernels' SPLIT instantiation (F bound 8); an unsplit pixel takes the
// instantiations without the slice index.  carafe_head.slot_split mirrors it.
constexpr int kSlotThreads = 256;
struct SlotSplit {
  int threads, splits;
};
static SlotSplit slot_split(int slots) {
  const int splits = (slots + kSlotThreads - 1) / kSlotThreads;
  return {(slots + splits - 1) / splits, splits};
}

template <typename T, int VEC, bool GATE, int FM, bool ONE>
__global__ void __launch_bounds__(kHeadThreads)
simam_head_kernel(const T* __restrict__ fb, const float* __restrict__ mu,
                  const float* __restrict__ var, const T* __restrict__ w,
                  T* __restrict__ out, int HW, int C, int G, int F, int L, float lam,
                  int pc, int chunks) {
  constexpr int U = FM <= 2 ? 4 : 2;  // pixels whose loads are in flight together
  const int CV = C / VEC, GC = G * C, GF = G * F;
  const int gl = threadIdx.x / L, l = threadIdx.x - gl * L;
  const int g = blockIdx.y * (blockDim.x / L) + gl;  // a slice of the G groups
  const int chunk = blockIdx.x % chunks, b = blockIdx.x / chunks;
  const int64_t p0 = (int64_t)b * HW + (int64_t)chunk * pc;
  const int n = min(pc, HW - chunk * pc);
  // the lanes of this warp that exist (a block of G*L threads may end mid-warp)
  const int wl = min(32, (int)blockDim.x - (int)(threadIdx.x & ~31u));
  const unsigned mask = wl == 32 ? 0xffffffffu : (1u << wl) - 1u;
  float mu_c[VEC], den[VEC], rden[VEC], wv[VEC][FM];
  auto constants = [&](int c) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if constexpr (GATE) {
        mu_c[i] = mu[(int64_t)b * C + c + i];
        den[i] = 4.f * (var[(int64_t)b * C + c + i] + lam);
        rden[i] = rcp_rn(den[i]);
      }
#pragma unroll
      for (int f = 0; f < FM; ++f) wv[i][f] = f < F ? to_f(w[(int64_t)(c + i) * F + f]) : 0.f;
    }
  };
  if constexpr (ONE) constants(l * VEC);
  for (int u0 = 0; u0 < n; u0 += U) {
    float acc[U][FM];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int f = 0; f < FM; ++f) acc[u][f] = 0.f;
    for (int cv = l; cv < (ONE ? l + 1 : CV); cv += L) {
      const int c = cv * VEC;
      float xv[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) xv[u][i] = 0.f;
        if (u0 + u < n) load_vec<T, VEC>(fb + (p0 + u0 + u) * GC + g * C + c, xv[u]);
      }
      if constexpr (!ONE) constants(c);
      // a pixel past the chunk has x = 0 and adds zero to its (unwritten) dot
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float y = xv[u][i];
          if constexpr (GATE) {
            const float xc = y - mu_c[i];
            // K3's gate, bit for bit
            const float e = div_rn_by(xc * xc, den[i], rden[i]) + 0.5f;
            y = round_to<T>(y * rcp_rn(1.f + expf(-e)));
          }
#pragma unroll
          for (int f = 0; f < FM; ++f) acc[u][f] = fmaf(y, wv[i][f], acc[u][f]);
        }
      }
    }
    // the lanes of one group are adjacent and aligned: L divides 32
    for (int off = 1; off < L; off <<= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int f = 0; f < FM; ++f) acc[u][f] += __shfl_xor_sync(mask, acc[u][f], off);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int f = 0; f < FM; ++f)
        if (f < F && u0 + u < n && ((u * FM + f) & (L - 1)) == l)
          out[(p0 + u0 + u) * GF + g * F + f] = from_f<T>(acc[u][f]);
  }
}

// The groups of a K-H2 block: all G where G*L threads fit kHeadThreads, else
// the largest divisor of G that does (blockIdx.y walks the G / gpb slices,
// so a warp's groups are all real); carafe_head.h2_geometry mirrors it.
static int head_groups(int G, int L) {
  if (G * L <= kHeadThreads) return G;
  int gpb = kHeadThreads / L;
  while (G % gpb) --gpb;
  return gpb;
}

template <typename T, int VEC, bool GATE, int FM, bool ONE>
static cudaError_t launch_head(const void* fb, const void* mu, const void* var,
                               const void* w, void* out, int B, int HW, int C, int G, int F,
                               int L, float lam, int pc, cudaStream_t stream) {
  const int chunks = (HW + pc - 1) / pc;
  const int gpb = head_groups(G, L);
  simam_head_kernel<T, VEC, GATE, FM, ONE>
      <<<dim3((unsigned)(B * chunks), G / gpb), gpb * L, 0, stream>>>(
      static_cast<const T*>(fb), static_cast<const float*>(mu),
      static_cast<const float*>(var), static_cast<const T*>(w), static_cast<T*>(out), HW, C,
      G, F, L, lam, pc, chunks);
  return cudaGetLastError();
}

// The ONE instantiations for the lane's one channel vector (F bound 1, 2,
// 4 or 8), the strided one (F bound 8) for every other geometry.
template <typename T, int VEC, bool GATE>
static cudaError_t launch_head_f(bool one, const void* fb, const void* mu, const void* var,
                                 const void* w, void* out, int B, int HW, int C, int G,
                                 int F, int L, float lam, int pc, cudaStream_t s) {
  if constexpr (VEC > 1) {
    if (one && F <= 1)
      return launch_head<T, VEC, GATE, 1, true>(fb, mu, var, w, out, B, HW, C, G, F, L, lam,
                                                pc, s);
    if (one && F <= 2)
      return launch_head<T, VEC, GATE, 2, true>(fb, mu, var, w, out, B, HW, C, G, F, L, lam,
                                                pc, s);
    if (one && F <= 4)
      return launch_head<T, VEC, GATE, 4, true>(fb, mu, var, w, out, B, HW, C, G, F, L, lam,
                                                pc, s);
    if (one)
      return launch_head<T, VEC, GATE, 8, true>(fb, mu, var, w, out, B, HW, C, G, F, L, lam,
                                                pc, s);
  }
  return launch_head<T, VEC, GATE, 8, false>(fb, mu, var, w, out, B, HW, C, G, F, L, lam, pc,
                                             s);
}

template <bool GATE>
static cudaError_t dispatch_head(int dtype, int vec, const void* fb, const void* mu,
                                 const void* var, const void* w, void* out, int B, int H,
                                 int W, int C, int G, int F, int L, float lam, int pc,
                                 cudaStream_t s) {
  if (vec < 1 || C % vec || F < 1 || F > kMaxClasses || L < 1 || L > 32 || (L & (L - 1)) ||
      L > C / vec || G < 1 || G / head_groups(G, L) > 65535 || pc < 1 || B < 1 || H < 1 ||
      W < 1)
    return cudaErrorInvalidValue;
  const int HW = H * W;
  const bool one = vec > 1 && C / vec == L;
  if (dtype == kFloat32 && vec == 4)
    return launch_head_f<float, 4, GATE>(one, fb, mu, var, w, out, B, HW, C, G, F, L, lam, pc,
                                         s);
  if (dtype == kFloat32 && vec == 1)
    return launch_head_f<float, 1, GATE>(one, fb, mu, var, w, out, B, HW, C, G, F, L, lam, pc,
                                         s);
  if (dtype == kBFloat16 && vec == 8)
    return launch_head_f<__nv_bfloat16, 8, GATE>(one, fb, mu, var, w, out, B, HW, C, G, F, L,
                                                 lam, pc, s);
  if (dtype == kBFloat16 && vec == 1)
    return launch_head_f<__nv_bfloat16, 1, GATE>(one, fb, mu, var, w, out, B, HW, C, G, F, L,
                                                 lam, pc, s);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// K3: the head backward's reduction pass.
//
// Replaces ops/pallas_simam_head.py::_bwd1_kernel (pallas_call at :269,
// through head_bwd1_pallas), as the fused CARAFE head's backward
// (ops/pallas_carafe_head.py:369) calls it: bias already in the map.  For
// each lane l = g*C + c of the biased flat map fb (B, H, W, G*C), with
// dg = sum_f dy[g*F + f] * W[c, f] and the float32 gate terms of the forward,
//     t = dg * x * g (1 - g)
//     A[l] += t (x - mu_c)        B[l] += t (x - mu_c)^2
//     dW[c, f] += round(x * g) * dy[g*F + f]
// summed over a chunk of pixels of one image per block; the caller sums the
// chunks and pools A and B per real channel (as head_bwd1_pallas does).
//
// What bounds it on the H100: one read of the 268 MB flat map at the 512^2
// head, so device memory (about 80 us at 3.35 TB/s), then the SFU (one
// sigmoid an element).  Design: a block owns a chunk of `pc` consecutive
// pixels of one image (the wrapper picks pc so that the grid fills the card
// several times, 2048^2 included), each thread one (g, 16-byte channel
// vector) slot of a pixel, so each pixel's G*C values are one coalesced
// block-wide load (a pixel of more than kSlotThreads slots is split over
// blockIdx.y, so no G*C refuses a block); a thread walks the chunk U pixels
// at a time with their U loads issued together, keeps its A, B and dW sums
// in registers and writes them once: no atomics and a fixed summation order.  F is a compile-time
// bound (1, 2, 4, 8), so one class costs two FMAs an element for dg and dW,
// not sixteen.  The gate is K-H2's arithmetic, so round(x * g) rounds as in
// the forward; its two divisions are rcp_rn and div_rn_by (common.cuh), which
// give what / gives without the compiler's check-and-call slow path, whose
// branches cost K3 about a third of its time.
//
// K3 without the gate (GATE false) replaces ops/pallas_simam_head.py::
// _bwd1_nogate_kernel (launched at pallas_carafe_head.py:382, the fused head
// without SimAM): dW[c, f] = sum over the map of fb * dy[g*F + f], the same
// per-chunk float32 partials in the same order, and no A, B, mu, var or W.
template <typename T, int VEC, bool GATE, int FM, bool SPLIT>
__global__ void head_bwd1_kernel(const T* __restrict__ fb, const T* __restrict__ dy,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ var, const T* __restrict__ w,
                                 float* __restrict__ part, int HW, int C, int G, int F,
                                 float lam, int pc, int chunks) {
  constexpr int U = FM <= 2 ? 4 : 2;  // pixels whose loads are in flight together
  const int CV = C / VEC, GC = G * C;
  int g, cv;
  if constexpr (SPLIT) {
    const int slot = blockIdx.y * blockDim.x + threadIdx.x;
    if (slot >= G * CV) return;  // the last slice of a split pixel
    g = slot / CV;
    cv = slot - g * CV;
  } else {
    g = threadIdx.x / CV;
    cv = threadIdx.x - g * CV;
  }
  const int c = cv * VEC;
  const int chunk = blockIdx.x % chunks, b = blockIdx.x / chunks;
  const int64_t p0 = (int64_t)b * HW + (int64_t)chunk * pc;
  const int n = min(pc, HW - chunk * pc);
  float mu_c[VEC], den[VEC], rden[VEC], wv[VEC][FM];
  float a[VEC], bq[VEC], dw[VEC][FM];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu_c[i] = GATE ? mu[(int64_t)b * C + c + i] : 0.f;
    den[i] = GATE ? 4.f * (var[(int64_t)b * C + c + i] + lam) : 1.f;
    rden[i] = rcp_rn(den[i]);
    a[i] = bq[i] = 0.f;
#pragma unroll
    for (int f = 0; f < FM; ++f) {
      wv[i][f] = GATE && f < F ? to_f(w[(int64_t)(c + i) * F + f]) : 0.f;
      dw[i][f] = 0.f;
    }
  }
  for (int u0 = 0; u0 < n; u0 += U) {
    float xv[U][VEC], dyv[U][FM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t pix = p0 + u0 + u;
      const bool in = u0 + u < n;
#pragma unroll
      for (int i = 0; i < VEC; ++i) xv[u][i] = 0.f;
      if (in) load_vec<T, VEC>(fb + pix * GC + g * C + c, xv[u]);
#pragma unroll
      for (int f = 0; f < FM; ++f)
        dyv[u][f] = in && f < F ? to_f(dy[(pix * G + g) * F + f]) : 0.f;
    }
    // a pixel past the chunk has x = dy = 0 and adds zero to every sum
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xf = xv[u][i];
        if constexpr (!GATE) {
#pragma unroll
          for (int f = 0; f < FM; ++f) dw[i][f] = fmaf(xf, dyv[u][f], dw[i][f]);
          continue;
        }
        const float xc = xf - mu_c[i];
        // K-H2's gate, bit for bit: div_rn_by and rcp_rn round as / does
        const float e = div_rn_by(xc * xc, den[i], rden[i]) + 0.5f;
        const float gt = rcp_rn(1.f + expf(-e));
        float dg = 0.f;
#pragma unroll
        for (int f = 0; f < FM; ++f) dg = fmaf(dyv[u][f], wv[i][f], dg);
        const float t = dg * xf * (gt * (1.f - gt));
        a[i] = fmaf(t, xc, a[i]);
        bq[i] = fmaf(t * xc, xc, bq[i]);
        const float gated = round_to<T>(xf * gt);
#pragma unroll
        for (int f = 0; f < FM; ++f) dw[i][f] = fmaf(gated, dyv[u][f], dw[i][f]);
      }
    }
  }
  // this block's row of part: [A (G*C), B (G*C)] with the gate, then dW (F, G*C)
  const int lane = g * C + c;
  float* row = part + (int64_t)blockIdx.x * (GATE ? 2 + F : F) * GC;
  float* dwr = row + (GATE ? 2 * GC : 0);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (GATE) {
      row[lane + i] = a[i];
      row[GC + lane + i] = bq[i];
    }
#pragma unroll
    for (int f = 0; f < FM; ++f)
      if (f < F) dwr[f * GC + lane + i] = dw[i][f];
  }
}

template <typename T, int VEC, bool GATE, int FM, bool SPLIT>
static cudaError_t launch_head_bwd1(const void* fb, const void* dy, const void* mu,
                                    const void* var, const void* w, void* part, int B, int HW,
                                    int C, int G, int F, float lam, int pc,
                                    cudaStream_t stream) {
  const int chunks = (HW + pc - 1) / pc;
  const SlotSplit sp = slot_split(G * (C / VEC));
  head_bwd1_kernel<T, VEC, GATE, FM, SPLIT>
      <<<dim3((unsigned)(B * chunks), sp.splits), sp.threads, 0, stream>>>(
      static_cast<const T*>(fb), static_cast<const T*>(dy), static_cast<const float*>(mu),
      static_cast<const float*>(var), static_cast<const T*>(w), static_cast<float*>(part),
      HW, C, G, F, lam, pc, chunks);
  return cudaGetLastError();
}

template <typename T, int VEC, bool GATE>
static cudaError_t launch_head_bwd1_f(const void* fb, const void* dy, const void* mu,
                                      const void* var, const void* w, void* part, int B,
                                      int HW, int C, int G, int F, float lam, int pc,
                                      cudaStream_t s) {
  if (slot_split(G * (C / VEC)).splits > 1)  // a wide pixel: one instantiation, F <= 8
    return launch_head_bwd1<T, VEC, GATE, 8, true>(fb, dy, mu, var, w, part, B, HW, C, G, F,
                                                   lam, pc, s);
  if (F <= 1)
    return launch_head_bwd1<T, VEC, GATE, 1, false>(fb, dy, mu, var, w, part, B, HW, C, G, F,
                                                    lam, pc, s);
  if (F <= 2)
    return launch_head_bwd1<T, VEC, GATE, 2, false>(fb, dy, mu, var, w, part, B, HW, C, G, F,
                                                    lam, pc, s);
  if (F <= 4)
    return launch_head_bwd1<T, VEC, GATE, 4, false>(fb, dy, mu, var, w, part, B, HW, C, G, F,
                                                    lam, pc, s);
  return launch_head_bwd1<T, VEC, GATE, 8, false>(fb, dy, mu, var, w, part, B, HW, C, G, F,
                                                  lam, pc, s);
}

template <bool GATE>
static cudaError_t dispatch_head_bwd1(int dtype, int vec, const void* fb, const void* dy,
                                      const void* mu, const void* var, const void* w,
                                      void* part, int B, int H, int W, int C, int G, int F,
                                      float lam, int pc, cudaStream_t s) {
  if (vec < 1 || C % vec || F < 1 || F > kMaxClasses || G < 1 || pc < 1 || B < 1 || H < 1 ||
      W < 1 || slot_split(G * (C / vec)).splits > 65535)
    return cudaErrorInvalidValue;
  const int HW = H * W;
  if (dtype == kFloat32 && vec == 4)
    return launch_head_bwd1_f<float, 4, GATE>(fb, dy, mu, var, w, part, B, HW, C, G, F, lam,
                                              pc, s);
  if (dtype == kFloat32 && vec == 1)
    return launch_head_bwd1_f<float, 1, GATE>(fb, dy, mu, var, w, part, B, HW, C, G, F, lam,
                                              pc, s);
  if (dtype == kBFloat16 && vec == 8)
    return launch_head_bwd1_f<__nv_bfloat16, 8, GATE>(fb, dy, mu, var, w, part, B, HW, C, G,
                                                      F, lam, pc, s);
  if (dtype == kBFloat16 && vec == 1)
    return launch_head_bwd1_f<__nv_bfloat16, 1, GATE>(fb, dy, mu, var, w, part, B, HW, C, G,
                                                      F, lam, pc, s);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// K5: the standalone head backward's elementwise pass, dx and db.
//
// Replaces ops/pallas_simam_head.py::_bwd2_kernel (pallas_call at :334) and,
// with GATE false, _bwd2_nogate_kernel (:364): the second pass of
// simam_head's backward, after K3 has given the pooled A, B (and dW).  For
// each lane l = g*C + c of the biased flat map fb (B, H, W, G*C), with the
// N = H*W*G values each channel's statistics pool over and n = max(N-1, 1),
// in float32, in this order (_bwd2_kernel's, pallas_simam_head.py:150-166,
// and _gate_terms' at :79), each step rounded, but a*b + c in one FMA:
//     dg = sum_f dy[g*F + f] * W[c, f]                     (f ascending, FMAs)
//     w4 = 1 / (4 (v_c + lam))                             (rcp_rn, exact)
//     xc = x - mu_c
//     e  = xc^2 / (4 (v_c + lam)) + 0.5                    (div_rn_by, exact)
//     g  = 1 / (1 + exp(-e))                               (rcp_rn)
//     t  = (dg * x) * (g * (1 - g))
//     ca = (2 w4 / N) * A_c,  cb = (8 (w4 w4) / n) * B_c   (once per block)
//     dx = ((dg*g + ((2 w4) * t) * xc) - ca) - cb*xc       (two FMAs)
//     db[l] += dx  in float32, before dx is rounded to the compute dtype
// Without the gate dx = dg: fb, mu, v, A and B are not read.  The gate is
// K3's and K-H2's bit for bit; the caller sums the (blocks, G*C) db rows and
// the G slots of each channel into db (C,) (pallas_simam_head.py:376-377).
//
// What bounds it on the H100: device memory, a read of the 268 MB flat map
// and a write of dx at the 512^2 head (about 160 us at 3.35 TB/s; without
// the gate only the write of dx, about 80 us).  Design: K3's.  A block owns
// a chunk of `pc` consecutive pixels of one image (carafe_head.k5_geometry
// picks pc so that the grid fills the card several times), each thread one
// (g, 16-byte channel vector) slot of a pixel, so each pixel's G*C values
// are one coalesced block-wide load and store; where the G*C/VEC slots of a
// pixel exceed kSlotThreads they are split over blockIdx.y.  A thread walks
// its chunk U pixels at a time with their fb and dy loads issued together
// before any arithmetic; its channel constants, its FM rows of W (F is a
// compile-time bound, 1, 2, 4 or 8) and its db sums sit in registers, and the
// sums are written once per block: no atomics, a fixed summation order.
template <typename T, int VEC, bool GATE, int FM, bool SPLIT>
__global__ void head_bwd2_kernel(const T* __restrict__ fb, const T* __restrict__ dy,
                                 const float* __restrict__ mu, const float* __restrict__ var,
                                 const float* __restrict__ A, const float* __restrict__ Bq,
                                 const T* __restrict__ w, T* __restrict__ dx,
                                 float* __restrict__ db_part, int HW, int C, int G, int F,
                                 float lam, float count, float count_m1, int pc, int chunks) {
  constexpr int U = FM <= 2 ? 4 : 2;  // pixels whose loads are in flight together
  const int CV = C / VEC, GC = G * C;
  int g, c;
  if constexpr (SPLIT) {
    const int slot = blockIdx.y * blockDim.x + threadIdx.x;
    if (slot >= G * CV) return;  // the last slice of a split pixel
    g = slot / CV;
    c = (slot - g * CV) * VEC;
  } else {
    g = threadIdx.x / CV;
    c = (threadIdx.x - g * CV) * VEC;
  }
  const int chunk = blockIdx.x % chunks, b = blockIdx.x / chunks;
  const int64_t p0 = (int64_t)b * HW + (int64_t)chunk * pc;
  const int n = min(pc, HW - chunk * pc);
  float mu_c[VEC], den[VEC], w4[VEC], ca[VEC], cb[VEC], wv[VEC][FM], db[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (GATE) {
      const int64_t bc = (int64_t)b * C + c + i;
      mu_c[i] = mu[bc];
      den[i] = 4.f * (var[bc] + lam);
      w4[i] = rcp_rn(den[i]);
      ca[i] = (2.f * w4[i] / count) * A[bc];
      cb[i] = (8.f * (w4[i] * w4[i]) / count_m1) * Bq[bc];
    }
    db[i] = 0.f;
#pragma unroll
    for (int f = 0; f < FM; ++f) wv[i][f] = f < F ? to_f(w[(int64_t)(c + i) * F + f]) : 0.f;
  }
  for (int u0 = 0; u0 < n; u0 += U) {
    float xv[U][VEC], dyv[U][FM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t pix = p0 + u0 + u;
      const bool in = u0 + u < n;
      if constexpr (GATE) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) xv[u][i] = 0.f;
        if (in) load_vec<T, VEC>(fb + pix * GC + g * C + c, xv[u]);
      }
#pragma unroll
      for (int f = 0; f < FM; ++f)
        dyv[u][f] = in && f < F ? to_f(dy[(pix * G + g) * F + f]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u0 + u >= n) break;  // n is the block's: no divergence
      float out[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float dg = 0.f;
#pragma unroll
        for (int f = 0; f < FM; ++f) dg = fmaf(dyv[u][f], wv[i][f], dg);
        if constexpr (GATE) {
          const float xf = xv[u][i], xc = xf - mu_c[i];
          // K3's gate, bit for bit: div_rn_by and rcp_rn round as / does
          const float e = div_rn_by(xc * xc, den[i], w4[i]) + 0.5f;
          const float gv = rcp_rn(1.f + expf(-e));
          const float t = dg * xf * (gv * (1.f - gv));
          // ((dg*g + ((2 w4) t) xc) - ca) - cb*xc, each a*b + c one FMA
          dg = fmaf(-cb[i], xc, fmaf(dg, gv, 2.f * w4[i] * t * xc) - ca[i]);
        }
        out[i] = dg;
        db[i] += dg;
      }
      store_vec_cs<T, VEC>(dx + (p0 + u0 + u) * GC + g * C + c, out);
    }
  }
  float* dbp = db_part + (int64_t)blockIdx.x * GC + g * C + c;
#pragma unroll
  for (int i = 0; i < VEC; ++i) dbp[i] = db[i];
}

template <typename T, int VEC, bool GATE, int FM, bool SPLIT>
static cudaError_t launch_head_bwd2(const void* fb, const void* dy, const void* mu,
                                    const void* var, const void* A, const void* Bq,
                                    const void* w, void* dx, void* db_part, int B, int HW,
                                    int C, int G, int F, float lam, int pc,
                                    cudaStream_t stream) {
  const int chunks = (HW + pc - 1) / pc;
  const SlotSplit sp = slot_split(G * (C / VEC));
  const double count = (double)HW * G;
  head_bwd2_kernel<T, VEC, GATE, FM, SPLIT>
      <<<dim3((unsigned)(B * chunks), sp.splits), sp.threads, 0, stream>>>(
      static_cast<const T*>(fb), static_cast<const T*>(dy), static_cast<const float*>(mu),
      static_cast<const float*>(var), static_cast<const float*>(A),
      static_cast<const float*>(Bq), static_cast<const T*>(w), static_cast<T*>(dx),
      static_cast<float*>(db_part), HW, C, G, F, lam, (float)count,
      (float)(count > 1.0 ? count - 1.0 : 1.0), pc, chunks);
  return cudaGetLastError();
}

template <typename T, int VEC, bool GATE>
static cudaError_t launch_head_bwd2_f(const void* fb, const void* dy, const void* mu,
                                      const void* var, const void* A, const void* Bq,
                                      const void* w, void* dx, void* db_part, int B, int HW,
                                      int C, int G, int F, float lam, int pc,
                                      cudaStream_t s) {
  if (slot_split(G * (C / VEC)).splits > 1)  // a wide pixel: one instantiation, F <= 8
    return launch_head_bwd2<T, VEC, GATE, 8, true>(fb, dy, mu, var, A, Bq, w, dx, db_part, B,
                                                   HW, C, G, F, lam, pc, s);
  if (F <= 1)
    return launch_head_bwd2<T, VEC, GATE, 1, false>(fb, dy, mu, var, A, Bq, w, dx, db_part, B,
                                                    HW, C, G, F, lam, pc, s);
  if (F <= 2)
    return launch_head_bwd2<T, VEC, GATE, 2, false>(fb, dy, mu, var, A, Bq, w, dx, db_part, B,
                                                    HW, C, G, F, lam, pc, s);
  if (F <= 4)
    return launch_head_bwd2<T, VEC, GATE, 4, false>(fb, dy, mu, var, A, Bq, w, dx, db_part, B,
                                                    HW, C, G, F, lam, pc, s);
  return launch_head_bwd2<T, VEC, GATE, 8, false>(fb, dy, mu, var, A, Bq, w, dx, db_part, B,
                                                  HW, C, G, F, lam, pc, s);
}

template <bool GATE>
static cudaError_t dispatch_head_bwd2(int dtype, int vec, const void* fb, const void* dy,
                                      const void* mu, const void* var, const void* A,
                                      const void* Bq, const void* w, void* dx, void* db_part,
                                      int B, int H, int W, int C, int G, int F, float lam,
                                      int pc, cudaStream_t s) {
  if (vec < 1 || C % vec || F < 1 || F > kMaxClasses || G < 1 || pc < 1 || B < 1 || H < 1 ||
      W < 1 || slot_split(G * (C / vec)).splits > 65535)
    return cudaErrorInvalidValue;
  const int HW = H * W;
  if (dtype == kFloat32 && vec == 4)
    return launch_head_bwd2_f<float, 4, GATE>(fb, dy, mu, var, A, Bq, w, dx, db_part, B, HW,
                                              C, G, F, lam, pc, s);
  if (dtype == kFloat32 && vec == 1)
    return launch_head_bwd2_f<float, 1, GATE>(fb, dy, mu, var, A, Bq, w, dx, db_part, B, HW,
                                              C, G, F, lam, pc, s);
  if (dtype == kBFloat16 && vec == 8)
    return launch_head_bwd2_f<__nv_bfloat16, 8, GATE>(fb, dy, mu, var, A, Bq, w, dx, db_part,
                                                      B, HW, C, G, F, lam, pc, s);
  if (dtype == kBFloat16 && vec == 1)
    return launch_head_bwd2_f<__nv_bfloat16, 1, GATE>(fb, dy, mu, var, A, Bq, w, dx, db_part,
                                                      B, HW, C, G, F, lam, pc, s);
  return cudaErrorInvalidValue;
}


}  // namespace csu

// fb (B, H, W, G*C) in the compute dtype; mu, var (B, C) float32 (null
// without the gate); w (C, F) in the compute dtype; out (B, H, W, G*F).  A
// block per chunk of pc pixels of one image (blocks = B * ceil(H*W / pc),
// image-major), L lanes (a power of two up to min(32, C/vec), G*L <= 256
// where G <= 256) per (pixel, g), head_groups' slices of the G groups a
// block.
CSU_EXPORT int csu_simam_head_fwd(int dtype, const void* fb, const void* mu,
                                  const void* var, const void* w, void* out, int B, int H,
                                  int W, int C, int G, int F, int vec, int lanes, float lam,
                                  int gate, int pc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gate)
    return (int)csu::dispatch_head<true>(dtype, vec, fb, mu, var, w, out, B, H, W, C, G, F,
                                         lanes, lam, pc, s);
  return (int)csu::dispatch_head<false>(dtype, vec, fb, nullptr, nullptr, w, out, B, H, W, C,
                                        G, F, lanes, lam, pc, s);
}


// K3: fb (B, H, W, G*C) and dy (B, H, W, G*F) in the compute dtype, mu and
// var (B, C) float32, w (C, F) in the compute dtype; part (blocks,
// (2 + F)*G*C) float32 receives each block's sums, A (G*C), B (G*C) and
// dW (F, G*C) in a row, a block per chunk of pc pixels of one image:
// blocks = B * ceil(H*W / pc), image-major, each pixel's G*C/vec slots
// split over slot_split's blockIdx.y.
CSU_EXPORT int csu_head_bwd1(int dtype, const void* fb, const void* dy, const void* mu,
                             const void* var, const void* w, void* part, int B, int H, int W,
                             int C, int G, int F, int vec, float lam, int pc, void* stream) {
  return (int)csu::dispatch_head_bwd1<true>(dtype, vec, fb, dy, mu, var, w, part, B, H, W, C,
                                            G, F, lam, pc, static_cast<cudaStream_t>(stream));
}

// K3 without the gate: part (blocks, F*G*C) float32 receives each block's
// sums of fb * dy for fb (B, H, W, G*C) and dy (B, H, W, G*F), the blocks as
// for csu_head_bwd1.
CSU_EXPORT int csu_head_bwd1_nogate(int dtype, const void* fb, const void* dy, void* part,
                                    int B, int H, int W, int C, int G, int F, int vec,
                                    int pc, void* stream) {
  return (int)csu::dispatch_head_bwd1<false>(dtype, vec, fb, dy, nullptr, nullptr, nullptr,
                                             part, B, H, W, C, G, F, 0.f, pc,
                                             static_cast<cudaStream_t>(stream));
}

// K5: fb (B, H, W, G*C) and dy (B, H, W, G*F) in the compute dtype, mu,
// var, A and Bq (B, C) float32 (A and Bq pooled per real channel, as K3's
// caller gives them), w (C, F) in the compute dtype; dx like fb, db_part
// (blocks, G*C) float32 receives each block's sums of the unrounded dx, a
// block per chunk of pc pixels of one image (blocks = B * ceil(H*W / pc),
// image-major), its G*C/vec slots split over slot_split's blockIdx.y.
CSU_EXPORT int csu_head_bwd2(int dtype, const void* fb, const void* dy, const void* mu,
                             const void* var, const void* A, const void* Bq, const void* w,
                             void* dx, void* db_part, int B, int H, int W, int C, int G,
                             int F, int vec, float lam, int pc, void* stream) {
  return (int)csu::dispatch_head_bwd2<true>(dtype, vec, fb, dy, mu, var, A, Bq, w, dx,
                                            db_part, B, H, W, C, G, F, lam, pc,
                                            static_cast<cudaStream_t>(stream));
}

// K5 without the gate: dx = dy kron(I_G, W^T) like a (B, H, W, G*C) map, from
// dy (B, H, W, G*F) and w (C, F); db_part and the blocks as for csu_head_bwd2.
CSU_EXPORT int csu_head_bwd2_nogate(int dtype, const void* dy, const void* w, void* dx,
                                    void* db_part, int B, int H, int W, int C, int G, int F,
                                    int vec, int pc, void* stream) {
  return (int)csu::dispatch_head_bwd2<false>(dtype, vec, nullptr, dy, nullptr, nullptr,
                                             nullptr, nullptr, w, dx, db_part, B, H, W, C, G,
                                             F, 0.f, pc, static_cast<cudaStream_t>(stream));
}

// The message of a CUDA error code returned by the functions above.
CSU_EXPORT const char* csu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
