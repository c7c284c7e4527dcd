// K-C and K-H1: CARAFE content-aware reassembly, forward, in the
// pre-pixel-shuffle ("flat") layout out[b, y, x, s*C + c].
//
// K-C replaces cswin_simam_unet_tpu/ops/pallas_carafe.py::_fwd_kernel
// (pallas_call at :320): per pixel and sub-pixel s, softmax over the 9 taps
// of enc[..., k*S^2 + s], then out = sum_k p_k * x[y+dy_k, x+dx_k, :], zero
// padded at the image border.
//
// K-H1 replaces ops/pallas_carafe_head.py::_fwd_moments_kernel (pallas_call at
// :124): the same reassembly at S = 4, plus the out-conv bias added in the
// compute dtype, plus per-block partial sums of the biased map and of its
// square (float32), from which the caller pools SimAM's per-channel mean and
// variance.
//
// What bounds it on the H100: 18 flops per output element against 2 bytes
// written (bf16), so device memory, and mostly the output write: at the head
// (8,128,128,64) x and (8,128,128,144) enc are 55 MB read against 268 MB
// written.  Design: the block's threads own the (s, 16-byte channel vector)
// slots of one pixel, so a pixel's S^2*C outputs are written by one fully
// coalesced block-wide store; the block walks a run of pixels along one row.
// A thread loads its 9 neighbour vectors once per pixel (the S^2 threads that
// share a vector hit L1), computes its sub-pixel's 9-tap softmax in registers
// and accumulates in float32.  The TPU kernel's MXU indicator tricks
// (_expand_s, _fold_sum_s) are lane workarounds with no use here.
#include "common.cuh"

namespace csu {

template <typename T, int VEC, bool HEAD>
__global__ void carafe_kernel(const T* __restrict__ x, const T* __restrict__ enc,
                              const T* __restrict__ bias, T* __restrict__ out,
                              float* __restrict__ s1, float* __restrict__ s2, int H,
                              int W, int C, int S, int px) {
  const int S2 = S * S, CV = C / VEC;
  const int s = threadIdx.x / CV, cv = threadIdx.x - s * CV;
  const int c = cv * VEC;
  const int nch = (W + px - 1) / px;
  const int row = blockIdx.x / nch, chunk = blockIdx.x - row * nch;  // row = b*H + y
  const int y = row % H;
  const int64_t img0 = (int64_t)(row - y) * W;  // first pixel of this image
  const int x0 = chunk * px, x1 = min(W, x0 + px);

  float bv[VEC], a1[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = bv[i] = 0.f;
  if constexpr (HEAD) load_vec<T, VEC>(bias + c, bv);

  for (int xx = x0; xx < x1; ++xx) {
    const int64_t pix = (int64_t)row * W + xx;
    const T* e = enc + pix * (9 * S2) + s;
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
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int yy = y + k / 3 - 1, xn = xx + k % 3 - 1;
      if (yy < 0 || yy >= H || xn < 0 || xn >= W) continue;
      const float p = round_to<T>(lg[k] / den);
      float xv[VEC];
      load_vec<T, VEC>(x + (img0 + (int64_t)yy * W + xn) * C + c, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, xv[i], acc[i]);
    }
    if constexpr (HEAD) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float f = round_to<T>(round_to<T>(acc[i]) + bv[i]);
        acc[i] = f;
        a1[i] += f;
        a2[i] = fmaf(f, f, a2[i]);
      }
    }
    store_vec<T, VEC>(out + pix * (S2 * C) + s * C + c, acc);
  }
  if constexpr (HEAD) {
    if (s1 != nullptr) {
      const int64_t base = (int64_t)blockIdx.x * S2 * C + s * C + c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1[base + i] = a1[i];
        s2[base + i] = a2[i];
      }
    }
  }
}

template <typename T, int VEC, bool HEAD>
static cudaError_t launch_carafe(const void* x, const void* enc, const void* bias,
                                 void* out, void* s1, void* s2, int B, int H, int W,
                                 int C, int S, int px, cudaStream_t stream) {
  if (C % VEC || px < 1) return cudaErrorInvalidValue;
  const int threads = S * S * (C / VEC);
  if (threads > 1024) return cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)B * H * ((W + px - 1) / px);
  carafe_kernel<T, VEC, HEAD><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(enc),
      static_cast<const T*>(bias), static_cast<T*>(out), static_cast<float*>(s1),
      static_cast<float*>(s2), H, W, C, S, px);
  return cudaGetLastError();
}

template <bool HEAD>
static cudaError_t dispatch_carafe(int dtype, int vec, const void* x, const void* enc,
                                   const void* bias, void* out, void* s1, void* s2,
                                   int B, int H, int W, int C, int S, int px,
                                   cudaStream_t stream) {
  if (dtype == kFloat32 && vec == 4)
    return launch_carafe<float, 4, HEAD>(x, enc, bias, out, s1, s2, B, H, W, C, S, px,
                                         stream);
  if (dtype == kFloat32 && vec == 1)
    return launch_carafe<float, 1, HEAD>(x, enc, bias, out, s1, s2, B, H, W, C, S, px,
                                         stream);
  if (dtype == kBFloat16 && vec == 8)
    return launch_carafe<__nv_bfloat16, 8, HEAD>(x, enc, bias, out, s1, s2, B, H, W,
                                                 C, S, px, stream);
  if (dtype == kBFloat16 && vec == 1)
    return launch_carafe<__nv_bfloat16, 1, HEAD>(x, enc, bias, out, s1, s2, B, H, W,
                                                 C, S, px, stream);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// K-C' and K4: the CARAFE backward, plain and fused with the head's VJP.
//
// K-C' replaces ops/pallas_carafe.py::_bwd_kernel (pallas_call at :353,
// through _carafe_bwd).  With p_k(pix, s) the rounded tap softmax of the
// forward and dacc the cotangent of the flat output (lane s*C + c):
//     dp_k(pix, s)  = sum_c dacc(pix, s, c) * x(pix + off_k, c)
//     denc(pix, k*S^2 + s) = p_k * (dp_k - sum_k' p_k' dp_k')
//     dx(pix', c)   = sum_k sum_s p_k(pix' - off_k, s) * dacc(pix' - off_k, s, c)
// dx is the tap scatter written as a gather over the 3x3 neighbours, so no
// two blocks write one element and no atomics are needed.
//
// K4 replaces ops/pallas_carafe_head.py::_fused_bwd_kernel (pallas_call at
// :283, through _fused_bwd_call): dacc is not read but recomputed from the
// stored biased map fb, the head's cotangent dy, the SimAM statistics and
// the pooled reductions A, B of K3 (the closed-form SimAM VJP of
// ops/pallas_simam_head.py::_bwd2_kernel), for the block's pixels and their
// one-pixel halo; it is rounded through the compute dtype where the JAX
// chain stored it, and its float32 sums over the block's own pixels are the
// out-conv bias gradient's partials.  The (8, 128, 128, 1024) dacc of the
// 512^2 head never reaches device memory.
//
// What bounds it on the H100: device memory.  K-C' reads x, enc and dacc
// once and writes dx and denc; K4 reads fb (268 MB in bf16 at 512^2) instead
// of dacc.  Design: a block owns a run of px pixels of one image row, and its
// threads the (s, 16-byte channel vector) slots of a pixel, as in the
// forward.  It first stages, for rows y-1..y+1 and columns x0-1..x0+px, the
// rounded tap probabilities (float32) and dacc (compute dtype) in shared
// memory, so every halo value is computed or read once per block; then per
// pixel the dp partials of each thread meet in shared memory and are summed
// in a fixed order (deterministic), and the dx gather reads the staged
// neighbours.  The halo costs (px+2)/px x 3 recomputations of dacc in K4.
//
// K4 without the gate replaces the gate=False branch of the same
// _fused_bwd_kernel (pallas_carafe_head.py:370-397, the head without SimAM):
// dacc is the head dot's cotangent dy W^T alone, so fb, the statistics and A,
// B are not read; everything else is K4.
struct HeadGrad {
  const void* fb;     // (B, H, W, S*S*C) biased flat map, compute dtype
  const void* dy;     // (B, H, W, S*S*F) cotangent of the flat logits
  const void* w;      // (C, F) head weight, compute dtype
  const float* mu;    // (B, C) SimAM mean per real channel
  const float* var;   // (B, C) SimAM variance
  const float* A;     // (B, C) pooled sum of t * (x - mu) (K3)
  const float* Bq;    // (B, C) pooled sum of t * (x - mu)^2 (K3)
  float* db_part;     // (blocks, S*S*C) float32 partial sums of dacc
  int F;
  int gate;           // 0: dacc = dy W^T (fb, mu, var, A, Bq unused)
  float lam, inv_count, inv_count_m1;  // 1/(H*W*S*S), 1/(H*W*S*S - 1)
};

template <typename T, int VEC, bool HEAD>
__global__ void carafe_bwd_kernel(const T* __restrict__ x, const T* __restrict__ enc,
                                  const T* __restrict__ dacc, HeadGrad hg,
                                  T* __restrict__ dx, T* __restrict__ denc, int H, int W,
                                  int C, int S, int px) {
  extern __shared__ __align__(16) float smem[];
  const int S2 = S * S, K2S2 = 9 * S2, CV = C / VEC, SC = S2 * C;
  const int NT = blockDim.x;  // == S2 * CV
  const int PW = px + 2;
  float* Pc = smem;                   // [3][PW][9*S2] rounded tap probabilities
  float* part = Pc + 3 * PW * K2S2;   // [9][NT] dp partials of one pixel
  float* dxp = part + 9 * NT;         // [S2][CV][VEC] dx partials of one pixel
  float* dpS = dxp + NT * VEC;        // [9*S2] dp of one pixel
  const int nfloat = (3 * PW * K2S2 + 9 * NT + NT * VEC + K2S2 + 3) & ~3;
  T* Dc = reinterpret_cast<T*>(smem + nfloat);  // [3][PW][S2*C] dacc, compute dtype

  const int tid = threadIdx.x;
  const int s = tid / CV, cv = tid - s * CV, c = cv * VEC;
  const int nch = (W + px - 1) / px;
  const int row = blockIdx.x / nch, chunk = blockIdx.x - row * nch;  // row = b*H + y
  const int y = row % H, b = row / H;
  const int64_t img0 = (int64_t)(row - y) * W;  // first pixel of this image
  const int x0 = chunk * px;

  // 1a. tap probabilities of the staged pixels, as the forward rounds them
  for (int it = tid; it < 3 * PW * S2; it += NT) {
    const int ss = it % S2, jj = (it / S2) % PW, r = it / (S2 * PW);
    const int yy = y + r - 1, xx = x0 + jj - 1;
    float* pr = Pc + (r * PW + jj) * K2S2 + ss;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) {
#pragma unroll
      for (int k = 0; k < 9; ++k) pr[k * S2] = 0.f;
      continue;
    }
    const T* e = enc + (img0 + (int64_t)yy * W + xx) * K2S2 + ss;
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
    for (int k = 0; k < 9; ++k) pr[k * S2] = round_to<T>(lg[k] / den);
  }

  // 1b. dacc of the staged pixels (this thread's slot of each), zero outside
  // the image; K4 recomputes it and sums it over the block's own pixels
  float db[VEC];
  float mu_c[VEC], w4[VEC], a_c[VEC], b_c[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) db[i] = mu_c[i] = w4[i] = a_c[i] = b_c[i] = 0.f;
  if (HEAD && hg.gate) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int64_t bc = (int64_t)b * C + c + i;
      mu_c[i] = hg.mu[bc];
      w4[i] = 1.f / (4.f * (hg.var[bc] + hg.lam));
      a_c[i] = hg.A[bc];
      b_c[i] = hg.Bq[bc];
    }
  }
  for (int pj = 0; pj < 3 * PW; ++pj) {
    const int r = pj / PW, jj = pj - r * PW;
    const int yy = y + r - 1, xx = x0 + jj - 1;
    float val[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) val[i] = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const int64_t pix = img0 + (int64_t)yy * W + xx;
      if constexpr (HEAD) {
        const T* fb = static_cast<const T*>(hg.fb);
        const T* dy = static_cast<const T*>(hg.dy) + pix * S2 * hg.F + s * hg.F;
        const T* w = static_cast<const T*>(hg.w);
        float xv[VEC];
        if (hg.gate) load_vec<T, VEC>(fb + pix * SC + s * C + c, xv);
        const bool local = r == 1 && jj >= 1 && jj <= px;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float dg = 0.f;
          for (int f = 0; f < hg.F; ++f)
            dg = fmaf(to_f(dy[f]), to_f(w[(int64_t)(c + i) * hg.F + f]), dg);
          if (!hg.gate) {
            val[i] = dg;
            if (local) db[i] += dg;
            continue;
          }
          val[i] = simam_vjp(dg, xv[i], mu_c[i], w4[i], a_c[i], b_c[i], hg.inv_count,
                             hg.inv_count_m1);
          if (local) db[i] += val[i];
        }
      } else {
        load_vec<T, VEC>(dacc + pix * SC + s * C + c, val);
      }
    }
    store_vec<T, VEC>(Dc + (int64_t)pj * SC + s * C + c, val);
  }
  __syncthreads();

  // 2. the block's own pixels
  for (int jj = 1; jj <= px; ++jj) {
    const int xx = x0 + jj - 1;
    if (xx >= W) break;
    const int64_t pix = img0 + (int64_t)y * W + xx;
    float da[VEC];
    ld_vec<T, VEC>(Dc + (int64_t)(PW + jj) * SC + s * C + c, da);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int yy = y + k / 3 - 1, xn = xx + k % 3 - 1;
      float acc = 0.f;
      if (yy >= 0 && yy < H && xn >= 0 && xn < W) {
        float xv[VEC];
        load_vec<T, VEC>(x + (img0 + (int64_t)yy * W + xn) * C + c, xv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc = fmaf(da[i], xv[i], acc);
      }
      part[k * NT + tid] = acc;
    }
    // dx gather: the pixel at (y - dy, x - dx) reached this one through tap
    // (dy, dx); staged row 1 - dy, column jj - dx
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int r = 1 - (k / 3 - 1), sj = jj - (k % 3 - 1);
      const float p = Pc[(r * PW + sj) * K2S2 + k * S2 + s];
      float dv[VEC];
      ld_vec<T, VEC>(Dc + (int64_t)(r * PW + sj) * SC + s * C + c, dv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, dv[i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dxp[tid * VEC + i] = acc[i];
    __syncthreads();

    for (int t = tid; t < K2S2; t += NT) {
      const int k = t / S2, ss = t - k * S2;
      const float* pp = part + k * NT + ss * CV;
      float sum = 0.f;
      for (int u = 0; u < CV; ++u) sum += pp[u];
      dpS[t] = sum;
    }
    for (int t = tid; t < CV; t += NT) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = 0.f;
      for (int ss = 0; ss < S2; ++ss) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) o[i] += dxp[(ss * CV + t) * VEC + i];
      }
      store_vec<T, VEC>(dx + pix * C + t * VEC, o);
    }
    __syncthreads();

    for (int t = tid; t < S2; t += NT) {
      const float* pr = Pc + (PW + jj) * K2S2 + t;
      float inner = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) inner = fmaf(dpS[k * S2 + t], pr[k * S2], inner);
#pragma unroll
      for (int k = 0; k < 9; ++k)
        denc[pix * K2S2 + k * S2 + t] = from_f<T>(pr[k * S2] * (dpS[k * S2 + t] - inner));
    }
  }
  if constexpr (HEAD) {
    float* dbp = hg.db_part + (int64_t)blockIdx.x * SC + s * C + c;
#pragma unroll
    for (int i = 0; i < VEC; ++i) dbp[i] = db[i];
  }
}

// Shared memory of one carafe_bwd_kernel block (bytes); _build's wrappers
// pick px with the same formula.
static size_t carafe_bwd_smem(int C, int S, int vec, int elem, int px) {
  const size_t S2 = (size_t)S * S, NT = S2 * (C / vec), PW = (size_t)px + 2;
  const size_t nfloat = (3 * PW * 9 * S2 + 9 * NT + NT * vec + 9 * S2 + 3) & ~(size_t)3;
  return 4 * nfloat + (size_t)elem * 3 * PW * S2 * C;
}

template <typename T, int VEC, bool HEAD>
static cudaError_t launch_carafe_bwd(const void* x, const void* enc, const void* dacc,
                                     const HeadGrad& hg, void* dx, void* denc, int B,
                                     int H, int W, int C, int S, int px,
                                     cudaStream_t stream) {
  if (C % VEC || px < 1) return cudaErrorInvalidValue;
  const int threads = S * S * (C / VEC);
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = carafe_bwd_smem(C, S, VEC, (int)sizeof(T), px);
  static std::atomic<int> opted[kMaxDevices];
  const cudaError_t e = opt_in_smem(carafe_bwd_kernel<T, VEC, HEAD>, smem, opted);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)B * H * ((W + px - 1) / px);
  carafe_bwd_kernel<T, VEC, HEAD><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(enc), static_cast<const T*>(dacc),
      hg, static_cast<T*>(dx), static_cast<T*>(denc), H, W, C, S, px);
  return cudaGetLastError();
}

template <bool HEAD>
static cudaError_t dispatch_carafe_bwd(int dtype, int vec, const void* x, const void* enc,
                                       const void* dacc, const HeadGrad& hg, void* dx,
                                       void* denc, int B, int H, int W, int C, int S,
                                       int px, cudaStream_t stream) {
  if (dtype == kFloat32 && vec == 4)
    return launch_carafe_bwd<float, 4, HEAD>(x, enc, dacc, hg, dx, denc, B, H, W, C, S,
                                             px, stream);
  if (dtype == kFloat32 && vec == 1)
    return launch_carafe_bwd<float, 1, HEAD>(x, enc, dacc, hg, dx, denc, B, H, W, C, S,
                                             px, stream);
  if (dtype == kBFloat16 && vec == 8)
    return launch_carafe_bwd<__nv_bfloat16, 8, HEAD>(x, enc, dacc, hg, dx, denc, B, H, W,
                                                     C, S, px, stream);
  if (dtype == kBFloat16 && vec == 1)
    return launch_carafe_bwd<__nv_bfloat16, 1, HEAD>(x, enc, dacc, hg, dx, denc, B, H, W,
                                                     C, S, px, stream);
  return cudaErrorInvalidValue;
}

}  // namespace csu

// x (B, H, W, C), enc (B, H, W, 9*S*S), out (B, H, W, S*S*C), all contiguous;
// vec is the channel vector width (16 bytes of the dtype, or 1); each block
// covers px pixels of one row.
CSU_EXPORT int csu_carafe_fwd(int dtype, const void* x, const void* enc, void* out,
                              int B, int H, int W, int C, int S, int vec, int px,
                              void* stream) {
  return (int)csu::dispatch_carafe<false>(dtype, vec, x, enc, nullptr, out, nullptr,
                                          nullptr, B, H, W, C, S, px,
                                          static_cast<cudaStream_t>(stream));
}

// As csu_carafe_fwd, plus bias (C,) added in the compute dtype; s1 and s2
// (blocks, S*S*C) float32 receive each block's sums of the biased map and of
// its square (both may be null when the caller needs no statistics).
CSU_EXPORT int csu_carafe_head_fwd(int dtype, const void* x, const void* enc,
                                   const void* bias, void* fb, void* s1, void* s2,
                                   int B, int H, int W, int C, int S, int vec, int px,
                                   void* stream) {
  return (int)csu::dispatch_carafe<true>(dtype, vec, x, enc, bias, fb, s1, s2, B, H, W,
                                         C, S, px, static_cast<cudaStream_t>(stream));
}

// Backward of csu_carafe_fwd: x (B, H, W, C), enc (B, H, W, 9*S*S), dacc
// (B, H, W, S*S*C) the cotangent of the flat output, all contiguous; writes
// dx like x and denc like enc.  Each block covers px pixels of one row.
CSU_EXPORT int csu_carafe_bwd(int dtype, const void* x, const void* enc, const void* dacc,
                              void* dx, void* denc, int B, int H, int W, int C, int S,
                              int vec, int px, void* stream) {
  const csu::HeadGrad hg{};
  return (int)csu::dispatch_carafe_bwd<false>(dtype, vec, x, enc, dacc, hg, dx, denc, B, H,
                                              W, C, S, px,
                                              static_cast<cudaStream_t>(stream));
}

// K4, the backward of the fused head (gate on): as csu_carafe_bwd with dacc
// recomputed from fb (B, H, W, S*S*C), dy (B, H, W, S*S*F), w (C, F) and the
// float32 (B, C) mu, var, A, Bq; db_part (blocks, S*S*C) float32 receives
// each block's sums of dacc over its own pixels.
CSU_EXPORT int csu_carafe_head_bwd(int dtype, const void* x, const void* enc,
                                   const void* fb, const void* dy, const void* w,
                                   const void* mu, const void* var, const void* A,
                                   const void* Bq, void* dx, void* denc, void* db_part,
                                   int B, int H, int W, int C, int S, int F, int vec,
                                   int px, float lam, void* stream) {
  const double count = (double)H * W * S * S;
  const csu::HeadGrad hg{fb, dy, w, static_cast<const float*>(mu),
                         static_cast<const float*>(var), static_cast<const float*>(A),
                         static_cast<const float*>(Bq), static_cast<float*>(db_part), F, 1,
                         lam, (float)(1.0 / count), (float)(1.0 / (count - 1.0))};
  return (int)csu::dispatch_carafe_bwd<true>(dtype, vec, x, enc, nullptr, hg, dx, denc, B,
                                             H, W, C, S, px,
                                             static_cast<cudaStream_t>(stream));
}

// K4 without the gate (the head without SimAM): as csu_carafe_head_bwd with
// dacc = dy W^T, from dy (B, H, W, S*S*F) and w (C, F) alone.
CSU_EXPORT int csu_carafe_head_bwd_nogate(int dtype, const void* x, const void* enc,
                                          const void* dy, const void* w, void* dx,
                                          void* denc, void* db_part, int B, int H, int W,
                                          int C, int S, int F, int vec, int px,
                                          void* stream) {
  const csu::HeadGrad hg{nullptr, dy, w, nullptr, nullptr, nullptr, nullptr,
                         static_cast<float*>(db_part), F, 0, 0.f, 0.f, 0.f};
  return (int)csu::dispatch_carafe_bwd<true>(dtype, vec, x, enc, nullptr, hg, dx, denc, B,
                                             H, W, C, S, px,
                                             static_cast<cudaStream_t>(stream));
}
