// K-LN and K-LN': LayerNorm over the last axis of (M, C) rows, forward and
// backward.
//
// Replaces cswin_simam_unet_tpu/ops/pallas_layernorm.py::_fwd_kernel
// (pallas_call at :111) and _bwd_kernel (:148).  Per row of C <= 512, in
// float32, with the raw-moment statistics of flax's fast variance:
//     mu = E[x]    var = max(0, E[x^2] - mu^2)    rstd = rsqrt(var + eps)
//     y = (x - mu) * (rstd * g) + b                     (flax's op order)
// and the backward, the statistics recomputed from x as the TPU kernel does:
//     xhat = (x - mu) rstd    a = dy g    m1 = mean(a)    m2 = mean(a xhat)
//     dx = rstd (a - m1 - xhat m2)
//     dg = sum over rows of dy xhat      db = sum over rows of dy
// where _ln_bwd sums the kernel's dg_part and db_part (:173-174).
//
// What bounds it on the H100: device memory.  The forward reads x and writes
// y once, the backward reads x and dy and writes dx once: at the flagship's
// largest LayerNorm (131072 x 64, bf16) 10 us and 15 us at 3.35 TB/s, at
// its smallest (2048 x 512) 1.3 and 1.9 us, which is less than a launch.
//
// K-LN (the forward): one warp per row, each lane holding the columns
// lane + 32 i in registers and the row sums taken by warp shuffles, 8 rows
// a block.
//
// K-LN' (the backward) is shaped by what the card needs to stream at every
// LayerNorm shape, from 131072 rows of 64 to 392 rows of 512
// (ln_bwd_geometry, mirrored by ops/layernorm.py::bwd_geometry):
// * Rows read as 16-byte vectors (8 bf16 or 4 float32 a lane): a row of
//   nv = C / vec vectors is spread over a group of `lanes` lanes, the power
//   of 2 at or above nv up to 32, each lane holding vectors l + lanes j
//   (j < vpl); the row's sums are shuffles within the group.  At C = 64 in
//   bf16 that is 8 lanes a row, 4 rows a warp.  A C that is not a multiple
//   of the vector width, or rows not 16-byte aligned, take the same body
//   with scalar loads (vec = 1: the parent's lane + 32 i layout at C > 16),
//   counted apart as the "scalar" body.
// * Rows in flight: a pass of a lane group is kLnBwdLoads / vpl rows (two
//   at C <= 256 in bf16, one at 512), held in registers as loaded (16-byte
//   vectors, unconverted), and the group holds two passes: the next pass's
//   x and dy loads are issued before this pass's shuffles and arithmetic,
//   so they are in flight while it computes.  (A pass too large to hold
//   twice, a 512-column float32 or scalar row, is loaded and computed in
//   turn.)
// * A launch shape chosen from (M, C): about kLnBwdBlocksPerSm blocks an SM
//   (2 x 132 on the H100), each owning a run of ceil(M / blocks) rows
//   rounded up to a warp's rows, with up to 8 warps a block; a block's
//   warps walk its run in stripes of (warps x rows a warp), slot-major, so
//   a short run still has every warp busy.  The launch bounds cap the
//   registers at 128, so every block of the launch is resident at once.
// * dg and db without atomics: each lane sums dy xhat and dy over its rows
//   in registers, the groups of a warp meet by a fixed butterfly, the warps
//   in shared memory in warp order, and the block writes one row of
//   partials (blocks, 2C); a second kernel sums the partials' columns in
//   block order (32 row slices, then a butterfly over them), launched as a
//   programmatic dependent so that its launch overlaps the first kernel.
//   Two runs give the same bits.
// On the H100 (80GB HBM3, 700 W) the backward's first kernel alone streams
// the 131072 x 64 shape at 72 % of the card's memory rate, and the second
// adds about 2 us a call (PERF.md; layernorm_variants.py measures both).
#include <type_traits>

#include "common.cuh"

namespace csu {

constexpr int kLnWarps = 8;         // forward: rows in flight per block, one a warp
constexpr int kLnMaxC = 512;

// Columns lane + 32 i (i < NPL) of a row, as floats; 0 past C.
template <typename T, int NPL>
__device__ __forceinline__ void ln_load(const T* __restrict__ row, int C, int lane,
                                        float (&v)[NPL]) {
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? to_f(row[c]) : 0.f;
  }
}

// The row's mean and rsqrt(var + eps) from its raw moments (every lane).
template <int NPL>
__device__ __forceinline__ void ln_stats(const float (&x)[NPL], int C, float eps, float& mu,
                                         float& rstd) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    s += x[i];
    ss = fmaf(x[i], x[i], ss);
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  mu = s / C;
  rstd = rsqrtf(fmaxf(0.f, ss / C - mu * mu) + eps);
}

template <typename T, int NPL>
__global__ void __launch_bounds__(kLnWarps * 32)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ b, T* __restrict__ y, int64_t M, int C,
                     float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (r >= M) return;  // the whole warp: one row per warp
  float xv[NPL];
  ln_load<T, NPL>(x + r * C, C, lane, xv);
  float mu, rstd;
  ln_stats<NPL>(xv, C, eps, mu, rstd);
  T* yr = y + r * C;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    if (c < C) yr[c] = from_f<T>((xv[i] - mu) * (rstd * g[c]) + b[c]);
  }
}

// ---- K-LN' ----

constexpr int kLnBwdMaxWarps = 8;     // warps a block, at most
constexpr int kLnBwdBlocksPerSm = 2;  // blocks an SM the launch aims at (and the launch bounds)
constexpr int kLnBwdLoads = 2;        // x vectors a lane loads for one pass of its rows
constexpr int kLnBwdPipeBytes = 64;   // a lane's x and dy of a pass, at most, to hold two passes
constexpr int kLnSumCols = 32, kLnSumSlices = 32;  // the partials' sum: a block's columns, rows
constexpr bool kLnSumEarly = true;    // launch the sum as a programmatic dependent

struct LnBwdGeometry {
  int vec;         // elements a load: 16 bytes' worth (the vector body) or 1 (scalar)
  int lanes;       // lanes a row
  int vpl;         // vectors a lane
  int in_flight;   // rows of a lane group's pass
  int warps;       // warps a block
  int64_t rows;    // rows a block owns (the last block: what is left)
  int64_t blocks;  // blocks, and rows of the partials
};

static LnBwdGeometry ln_bwd_geometry(int dtype, int64_t M, int C, bool aligned, int sms) {
  LnBwdGeometry g{};
  const int per16 = dtype == kFloat32 ? 4 : 8;
  g.vec = aligned && C % per16 == 0 ? per16 : 1;
  const int nv = C / g.vec;
  g.lanes = 1;
  while (g.lanes < nv && g.lanes < 32) g.lanes *= 2;
  g.vpl = 1;
  while (g.vpl * g.lanes < nv) g.vpl *= 2;
  g.in_flight = kLnBwdLoads / g.vpl > 1 ? kLnBwdLoads / g.vpl : 1;
  const int64_t gpw = 32 / g.lanes;  // rows a warp holds at once
  const int64_t target = (int64_t)sms * kLnBwdBlocksPerSm;
  g.rows = ((M + target - 1) / target + gpw - 1) / gpw * gpw;
  g.blocks = (M + g.rows - 1) / g.rows;
  g.warps = (int)(g.rows / gpw < kLnBwdMaxWarps ? g.rows / gpw : kLnBwdMaxWarps);
  return g;
}

// The R rows' sums a and b over each group of LANES lanes, the rows'
// shuffles interleaved.
template <int LANES, int R>
__device__ __forceinline__ void group_sums(float (&a)[R], float (&b)[R]) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
      b[i] += __shfl_xor_sync(0xffffffffu, b[i], off);
    }
  }
}

// VEC elements of T as one load leaves them in registers, unconverted: a
// 16-byte vector, or one element.
template <typename T, int VEC>
using LnRaw = std::conditional_t<VEC * sizeof(T) == 16, uint4, T>;

template <typename T, int VEC>
__device__ __forceinline__ void ln_unpack(const LnRaw<T, VEC>& raw, float (&out)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]);
}

// One pass of a lane group: R rows s0 + i stripe (those below r1), each row
// as vpl loads of vectors l + LANES j (those below nv) of x and of dy.
template <typename T, int VEC, int LANES, int VPL, int R>
struct LnPass {
  using Raw = LnRaw<T, VEC>;
  // the registers x and dy take: a 16-bit element takes a 32-bit register
  static constexpr int kRegBytes = 2 * R * VPL * (sizeof(Raw) < 4 ? 4 : (int)sizeof(Raw));
  Raw x[R][VPL], dy[R][VPL];

  __device__ __forceinline__ void load(const T* __restrict__ xp, const T* __restrict__ dyp,
                                       int64_t s0, int64_t stripe, int64_t r1, int C, int nv,
                                       int l) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t r = s0 + i * stripe;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int v = l + LANES * j;
        if (r < r1 && v < nv) {
          x[i][j] = __ldg(reinterpret_cast<const Raw*>(xp + r * C + v * VEC));
          dy[i][j] = __ldg(reinterpret_cast<const Raw*>(dyp + r * C + v * VEC));
        } else {
          x[i][j] = dy[i][j] = Raw{};
        }
      }
    }
  }

  // dx of the pass's rows, and their dy xhat and dy into sg and sb
  __device__ __forceinline__ void rows(T* __restrict__ dx, const float (&gv)[VPL * VEC],
                                       float (&sg)[VPL * VEC], float (&sb)[VPL * VEC],
                                       int64_t s0, int64_t stripe, int64_t r1, int C, int nv,
                                       int l, float eps) const {
    float mu[R], rstd[R], m1[R], m2[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float xe[VEC];
        ln_unpack<T, VEC>(x[i][j], xe);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          s += xe[e];
          ss = fmaf(xe[e], xe[e], ss);
        }
      }
      mu[i] = s;
      rstd[i] = ss;
    }
    group_sums<LANES, R>(mu, rstd);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      mu[i] = mu[i] / C;
      rstd[i] = rsqrtf(fmaxf(0.f, rstd[i] / C - mu[i] * mu[i]) + eps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        float xe[VEC], de[VEC];
        ln_unpack<T, VEC>(x[i][j], xe);
        ln_unpack<T, VEC>(dy[i][j], de);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {  // xhat where dy is 0 is unused
          const float a = de[e] * gv[j * VEC + e];
          s1 += a;
          s2 = fmaf(a, (xe[e] - mu[i]) * rstd[i], s2);
        }
      }
      m1[i] = s1;
      m2[i] = s2;
    }
    group_sums<LANES, R>(m1, m2);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t r = s0 + i * stripe;
      if (r >= r1) continue;
      m1[i] = m1[i] / C;
      m2[i] = m2[i] / C;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int v = l + LANES * j;
        if (v >= nv) continue;
        float xe[VEC], de[VEC], o[VEC];
        ln_unpack<T, VEC>(x[i][j], xe);
        ln_unpack<T, VEC>(dy[i][j], de);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int k = j * VEC + e;
          const float xh = (xe[e] - mu[i]) * rstd[i];
          o[e] = rstd[i] * (de[e] * gv[k] - m1[i] - xh * m2[i]);
          sg[k] = fmaf(de[e], xh, sg[k]);
          sb[k] += de[e];
        }
        store_vec<T, VEC>(dx + r * C + v * VEC, o);
      }
    }
  }
};

template <typename T, int VEC, int LANES, int VPL>
__global__ void __launch_bounds__(kLnBwdMaxWarps * 32, kLnBwdBlocksPerSm)
layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                     const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                     int64_t M, int C, float eps, int64_t rows) {
  constexpr int R = kLnBwdLoads / VPL > 1 ? kLnBwdLoads / VPL : 1;  // rows in flight
  constexpr int GPW = 32 / LANES;                                   // rows a warp holds
  constexpr int N = VPL * VEC;                                      // elements a lane holds
  __shared__ __align__(16) float red[kLnBwdMaxWarps][2][kLnMaxC];
  if constexpr (kLnSumEarly) asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int q = lane / LANES, l = lane % LANES;  // the lane's row in the warp, place in it
  const int nv = C / VEC;
  float gv[N], sg[N], sb[N];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int v = l + LANES * j;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      gv[j * VEC + e] = v < nv ? g[v * VEC + e] : 0.f;
      sg[j * VEC + e] = sb[j * VEC + e] = 0.f;
    }
  }
  const int64_t r0 = (int64_t)blockIdx.x * rows;
  const int64_t r1 = r0 + rows < M ? r0 + rows : M;
  const int64_t stripe = (int64_t)warps * GPW;  // rows of one slot of every warp
  const int64_t step = R * stripe;              // rows of one pass of every warp
  const int64_t s0 = r0 + warp * GPW + q;       // the group's row in slot 0
  using Pass = LnPass<T, VEC, LANES, VPL, R>;
  if constexpr (Pass::kRegBytes <= kLnBwdPipeBytes) {
    // two passes' registers: the next pass's loads are in flight while this one computes
    Pass a, b;
    a.load(x, dy, s0, stripe, r1, C, nv, l);
    for (int64_t p0 = 0; r0 + p0 < r1; p0 += 2 * step) {  // block-uniform
      b.load(x, dy, s0 + p0 + step, stripe, r1, C, nv, l);
      a.rows(dx, gv, sg, sb, s0 + p0, stripe, r1, C, nv, l, eps);
      if (r0 + p0 + step >= r1) break;
      a.load(x, dy, s0 + p0 + 2 * step, stripe, r1, C, nv, l);
      b.rows(dx, gv, sg, sb, s0 + p0 + step, stripe, r1, C, nv, l, eps);
    }
  } else {  // a pass too large to hold twice (a 512-column float32 or scalar row)
    Pass a;
    for (int64_t p0 = 0; r0 + p0 < r1; p0 += step) {
      a.load(x, dy, s0 + p0, stripe, r1, C, nv, l);
      a.rows(dx, gv, sg, sb, s0 + p0, stripe, r1, C, nv, l, eps);
    }
  }
  // the warp's rows, then the block's, in a fixed order
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      sg[k] += __shfl_xor_sync(0xffffffffu, sg[k], off);
      sb[k] += __shfl_xor_sync(0xffffffffu, sb[k], off);
    }
  }
  if (q == 0) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int v = l + LANES * j;
      if (v >= nv) continue;
      if constexpr (VEC % 4 == 0) {  // 16-byte stores: 2-way bank conflicts, not VEC-way
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const int k = j * VEC + e;
          *reinterpret_cast<float4*>(&red[warp][0][v * VEC + e]) =
              make_float4(sg[k], sg[k + 1], sg[k + 2], sg[k + 3]);
          *reinterpret_cast<float4*>(&red[warp][1][v * VEC + e]) =
              make_float4(sb[k], sb[k + 1], sb[k + 2], sb[k + 3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          red[warp][0][v * VEC + e] = sg[j * VEC + e];
          red[warp][1][v * VEC + e] = sb[j * VEC + e];
        }
      }
    }
  }
  __syncthreads();
  float* out = part + (int64_t)blockIdx.x * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sa = 0.f, sd = 0.f;
    for (int w = 0; w < warps; ++w) {
      sa += red[w][0][c];
      sd += red[w][1][c];
    }
    out[c] = sa;
    out[C + c] = sd;
  }
}

// dg and db: the columns of the (P, n) partials summed in row order, n = 2C.
// A block takes 32 columns; each of its warps sums every kLnSumSlices-th
// row from its own, and warp w then sums column w over the slices by a
// butterfly, whose lane 0 writes it: the same order on every run.
__global__ void __launch_bounds__(kLnSumCols * kLnSumSlices)
layernorm_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int64_t P,
                         int n) {
  static_assert(kLnSumSlices == 32 && kLnSumCols == 32, "a warp per column, a lane per slice");
  __shared__ float red[kLnSumSlices][kLnSumCols + 1];
  if constexpr (kLnSumEarly) asm volatile("griddepcontrol.wait;" ::: "memory");
  const int tx = threadIdx.x % kLnSumCols, ty = threadIdx.x / kLnSumCols;
  const int j = blockIdx.x * kLnSumCols + tx;
  float s = 0.f;
  if (j < n) {
#pragma unroll 8
    for (int64_t p = ty; p < P; p += kLnSumSlices) s += __ldcg(part + p * n + j);
  }
  red[ty][tx] = s;
  __syncthreads();
  const float t = warp_sum(red[tx][ty]);  // column ty, slice tx
  const int jt = blockIdx.x * kLnSumCols + ty;
  if (tx == 0 && jt < n) out[jt] = t;
}

// The smallest of 1, 2, 4, 8, 16 columns per lane that covers C (0 if none).
static int ln_columns_per_lane(int C) {
  for (int npl = 1; npl <= kLnMaxC / 32; npl *= 2)
    if (C <= 32 * npl) return npl;
  return 0;
}

template <typename T, int NPL>
static cudaError_t launch_ln_fwd(const void* x, const void* g, const void* b, void* out,
                                 int64_t M, int C, float eps, cudaStream_t s) {
  layernorm_fwd_kernel<T, NPL><<<(unsigned)((M + kLnWarps - 1) / kLnWarps), kLnWarps * 32, 0,
                                 s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<T*>(out), M, C, eps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_ln_fwd(const void* x, const void* g, const void* b, void* out,
                                   int64_t M, int C, float eps, cudaStream_t s) {
  if (M < 1) return cudaErrorInvalidValue;
  switch (ln_columns_per_lane(C)) {
    case 1: return launch_ln_fwd<T, 1>(x, g, b, out, M, C, eps, s);
    case 2: return launch_ln_fwd<T, 2>(x, g, b, out, M, C, eps, s);
    case 4: return launch_ln_fwd<T, 4>(x, g, b, out, M, C, eps, s);
    case 8: return launch_ln_fwd<T, 8>(x, g, b, out, M, C, eps, s);
    case 16: return launch_ln_fwd<T, 16>(x, g, b, out, M, C, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

struct LnBwdArgs {
  const void *x, *g, *dy;
  void *dx, *part, *out;
  int64_t M;
  int C;
  float eps;
};

template <typename T, int VEC, int LANES, int VPL>
static cudaError_t launch_ln_bwd(const LnBwdGeometry& geo, const LnBwdArgs& a,
                                 cudaStream_t s) {
  layernorm_bwd_kernel<T, VEC, LANES, VPL><<<(unsigned)geo.blocks, geo.warps * 32, 0, s>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.g),
      static_cast<const T*>(a.dy), static_cast<T*>(a.dx), static_cast<float*>(a.part), a.M,
      a.C, a.eps, geo.rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = 2 * a.C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + kLnSumCols - 1) / kLnSumCols));
  cfg.blockDim = dim3(kLnSumCols * kLnSumSlices);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kLnSumEarly ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, layernorm_bwd_sum_kernel, static_cast<const float*>(a.part),
                         static_cast<float*>(a.out), geo.blocks, n);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The body of (vec, lanes, vpl): vpl 1 at any lanes, or 32 lanes and vpl up
// to the most a 512-column row needs.
template <typename T, int VEC>
static cudaError_t dispatch_ln_bwd_body(const LnBwdGeometry& geo, const LnBwdArgs& a,
                                        cudaStream_t s) {
  constexpr int kMaxVpl = kLnMaxC / VEC / 32;
  if (geo.vpl == 1) {
    switch (geo.lanes) {
      case 1: return launch_ln_bwd<T, VEC, 1, 1>(geo, a, s);
      case 2: return launch_ln_bwd<T, VEC, 2, 1>(geo, a, s);
      case 4: return launch_ln_bwd<T, VEC, 4, 1>(geo, a, s);
      case 8: return launch_ln_bwd<T, VEC, 8, 1>(geo, a, s);
      case 16: return launch_ln_bwd<T, VEC, 16, 1>(geo, a, s);
      case 32: return launch_ln_bwd<T, VEC, 32, 1>(geo, a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (geo.lanes != 32 || geo.vpl > kMaxVpl) return cudaErrorInvalidValue;
  switch (geo.vpl) {
    case 2: return launch_ln_bwd<T, VEC, 32, 2>(geo, a, s);
    case 4:
      if constexpr (kMaxVpl >= 4) return launch_ln_bwd<T, VEC, 32, 4>(geo, a, s);
      break;
    case 8:
      if constexpr (kMaxVpl >= 8) return launch_ln_bwd<T, VEC, 32, 8>(geo, a, s);
      break;
    case 16:
      if constexpr (kMaxVpl >= 16) return launch_ln_bwd<T, VEC, 32, 16>(geo, a, s);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
static cudaError_t dispatch_ln_bwd(const LnBwdGeometry& geo, const LnBwdArgs& a,
                                   cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  return geo.vec == kVec ? dispatch_ln_bwd_body<T, kVec>(geo, a, s)
                         : dispatch_ln_bwd_body<T, 1>(geo, a, s);
}

static bool ln_bwd_shape_ok(int dtype, int64_t M, int C, int sms) {
  return (dtype == kFloat32 || dtype == kBFloat16) && M >= 1 && C >= 1 && C <= kLnMaxC &&
         sms >= 1;
}

}  // namespace csu

// K-LN: x and y (M, C) contiguous in the compute dtype, g and b (C,)
// float32, C <= 512.
CSU_EXPORT int csu_layernorm_fwd(int dtype, const void* x, const void* g, const void* b,
                                 void* y, int64_t M, int C, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csu::kFloat32) return (int)csu::dispatch_ln_fwd<float>(x, g, b, y, M, C, eps, s);
  if (dtype == csu::kBFloat16)
    return (int)csu::dispatch_ln_fwd<__nv_bfloat16>(x, g, b, y, M, C, eps, s);
  return (int)cudaErrorInvalidValue;
}

// K-LN''s launch shape for (dtype, M, C) on a card of `sms` SMs, rows
// 16-byte aligned or not: out[0..6] = vec (elements a load; 1 is the scalar
// body), lanes a row, vectors a lane, rows in flight, warps a block, rows a
// block, blocks.  Returns 0, or cudaErrorInvalidValue for a shape it refuses.
CSU_EXPORT int csu_layernorm_bwd_design(int dtype, int64_t M, int C, int aligned, int sms,
                                        int64_t* out) {
  if (!csu::ln_bwd_shape_ok(dtype, M, C, sms)) return (int)cudaErrorInvalidValue;
  const csu::LnBwdGeometry g = csu::ln_bwd_geometry(dtype, M, C, aligned != 0, sms);
  const int64_t v[7] = {g.vec, g.lanes, g.vpl, g.in_flight, g.warps, g.rows, g.blocks};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// K-LN': x, dy and dx (M, C) contiguous in the compute dtype, g (C,)
// float32, C <= 512; part (blocks, 2C) float32 scratch, which must be the
// block count of csu_layernorm_bwd_design on this card (`sms` SMs); out
// (2, C) float32 receives dg and db.  Two launches on the stream: the rows,
// then the partials' sum.
CSU_EXPORT int csu_layernorm_bwd(int dtype, const void* x, const void* g, const void* dy,
                                 void* dx, void* part, void* out, int64_t M, int C, float eps,
                                 int sms, int64_t blocks, void* stream) {
  if (!csu::ln_bwd_shape_ok(dtype, M, C, sms)) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  const csu::LnBwdGeometry geo = csu::ln_bwd_geometry(dtype, M, C, aligned, sms);
  if (geo.blocks != blocks) return (int)cudaErrorInvalidValue;
  const csu::LnBwdArgs a{x, g, dy, dx, part, out, M, C, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csu::kFloat32) return (int)csu::dispatch_ln_bwd<float>(geo, a, s);
  return (int)csu::dispatch_ln_bwd<__nv_bfloat16>(geo, a, s);
}
