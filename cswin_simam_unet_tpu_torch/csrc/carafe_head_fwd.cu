// K-H1: the fused head's forward first pass: CARAFE 4x reassembly, the
// out-conv bias, and the moments of the biased map; and, on the same body
// without the bias and the moments, K-C: the decoder's CARAFE reassembly.
//
// K-H1 replaces cswin_simam_unet_tpu/ops/pallas_carafe_head.py::
// _fwd_moments_kernel (pallas_call at :124).  For each pixel of x (B, H, W, C) and sub-pixel s
// of the S x S up-sampling, with enc (B, H, W, 9*S^2) the kernel logits:
//     p_k(pix, s) = round(softmax_k(enc[pix, k*S^2 + s]))
//     fb[pix, s*C + c] = round(round(sum_k p_k * x[pix + off_k, c]) + bias_c)
// zero padded at the image border, in the pre-pixel-shuffle ("flat")
// layout; and (STATS) float32 per-block sums of fb and fb^2 per real channel
// (over the block's pixels and every sub-pixel), from which the caller
// pools SimAM's per-channel mean and variance.
//
// K-C (BIAS and STATS false) replaces cswin_simam_unet_tpu/ops/
// pallas_carafe.py::_fwd_kernel (pallas_call at :320):
//     out[pix, s*C + c] = round(sum_k p_k * x[pix + off_k, c])
// with the same p_k, rounded once from the float32 sum.  Its three
// launches a decoder forward write 25 MB at 512^2 (batch 8, bf16).
//
// What bounds it on the H100: device memory, mostly the output write: at the
// 512^2 head x (8,128,128,64) and enc (8,128,128,144) are 55 MB read against
// the 268 MB of fb written (about 96 us at 3.35 TB/s).  Design: a block owns
// a chunk of `pc` consecutive pixels of one image (carafe_head.h1_geometry
// picks it so that the grid fills the card several times) and walks it P
// pixels a pass (where a pixel has more channel vectors than a block has
// threads, P = 1 and blockIdx.y splits them into slices: K-C, and K-H1
// without the moments, so no C refuses a block).  Each pass, (a) a thread
// that owns a (pixel, 16-byte channel vector) issues the loads of its 9
// neighbour vectors, once per (pixel, channel vector) and not once per
// sub-pixel; (b) meanwhile the
// block computes the pass's P*S^2 tap softmaxes, one (pixel, sub-pixel) a
// thread, each once, into a ring of two pass buffers in shared memory (one
// barrier a pass); (c) the owner loops over the S^2 sub-pixels: nine FMAs a
// channel from registers, the rounding and the bias, one 16-byte store (a
// warp writes whole 128-byte lines), and its moment sums in registers.  The
// block sums its threads' moments in shared memory in a fixed order and
// writes them once: no atomics.  The softmax divides with div_rn_by
// (common.cuh), which gives what / gives without its slow-path branch
// wherever the quotient is a normal float (a tap probability above 2^-126,
// far below what bf16 or the tolerances resolve).
#include "common.cuh"

namespace csu {

constexpr int kH1Threads = 256;
constexpr size_t kH1Smem = 48 * 1024;

// floats of one pixel's taps in a pass buffer: 9*S^2, padded so that the
// pixels of a warp read distinct banks
__host__ __device__ inline int h1_pixel_floats(int S) { return 9 * S * S + 1; }

// Shared memory of one block (bytes): the two pass buffers, which the
// moment sums (STATS) reuse; carafe_head.h1_smem_bytes mirrors it.
static size_t h1_smem(int C, int S, int pp, bool stats) {
  const size_t ring = 2 * (size_t)pp * h1_pixel_floats(S), sums = 2 * (size_t)pp * C;
  return 4 * (stats && sums > ring ? sums : ring);
}

// The channel vectors of a pixel that one block covers: all CV where a pass
// of pp pixels fits kH1Threads, else (pp = 1) even slices of at most
// kH1Threads, one a blockIdx.y; carafe_head.h1_geometry mirrors it.
__host__ __device__ inline int h1_slice(int CV, int pp) {
  if (pp * CV <= kH1Threads) return CV;
  const int slices = (CV + kH1Threads - 1) / kH1Threads;
  return (CV + slices - 1) / slices;
}

template <typename T, int VEC, bool BIAS, bool STATS>
__global__ void __launch_bounds__(kH1Threads, 2)
carafe_head_fwd_kernel(const T* __restrict__ x, const T* __restrict__ enc,
                       const T* __restrict__ bias, T* __restrict__ fb,
                       float* __restrict__ s1, float* __restrict__ s2, int H, int W, int C,
                       int S, int pp, int pc, int chunks) {
  static_assert(BIAS || !STATS, "the moments are those of the biased map");
  extern __shared__ __align__(16) float smem[];
  const int S2 = S * S, K9 = 9 * S2, CV = C / VEC, HW = H * W;
  // the block's slice of the vectors: all of them with the moments
  const int CVB = STATS ? CV : h1_slice(CV, pp), NT = pp * CVB;
  const int PS = h1_pixel_floats(S);
  const int tid = threadIdx.x, pl = tid / CVB;
  const int cv = (STATS ? 0 : blockIdx.y * CVB) + tid - pl * CVB, c = cv * VEC;
  const bool real = STATS || cv < CV;  // the last slice may hold fewer vectors
  const int chunk = blockIdx.x % chunks, b = blockIdx.x / chunks;
  const int q0 = chunk * pc, q1 = min(HW, q0 + pc);
  const int64_t img0 = (int64_t)b * HW;  // first pixel of this image

  float bv[VEC], a1[VEC], a2[VEC];
  if constexpr (BIAS) {
    if (real) load_vec<T, VEC>(bias + c, bv);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = 0.f;

  int ring = 0;
  for (int qp = q0; qp < q1; qp += pp, ring ^= 1) {
    // (a) this thread's 9 neighbour vectors; zero outside the image
    const int q = qp + pl;
    const bool own = q < q1 && real;
    const int y = q / W, xx = q - y * W;
    float xv[9][VEC];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int yy = y + k / 3 - 1, xn = xx + k % 3 - 1;
#pragma unroll
      for (int i = 0; i < VEC; ++i) xv[k][i] = 0.f;
      if (own && yy >= 0 && yy < H && xn >= 0 && xn < W)
        load_vec<T, VEC>(x + (img0 + (int64_t)yy * W + xn) * C + c, xv[k]);
    }
    // (b) the pass's tap probabilities, rounded as the reference rounds them
    float* pb = smem + ring * pp * PS;
    for (int it = tid; it < pp * S2; it += NT) {
      const int ql = it / S2, s = it - ql * S2;
      if (qp + ql >= q1) break;
      const T* e = enc + (img0 + qp + ql) * K9 + s;
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
      const float rden = rcp_rn(den);
      float* pr = pb + ql * PS + s * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k) pr[k] = round_to<T>(div_rn_by(lg[k], den, rden));
    }
    __syncthreads();  // the other ring buffer was last read before this barrier
    // (c) the owner's S^2 output vectors
    if (own) {
      const float* pr = pb + pl * PS;
      T* o = fb + (img0 + q) * (int64_t)(S2 * C) + c;
      for (int s = 0; s < S2; ++s) {
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const float p = pr[s * 9 + k];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, xv[k][i], acc[i]);
        }
        if constexpr (BIAS) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float f = round_to<T>(round_to<T>(acc[i]) + bv[i]);
            acc[i] = f;
            if constexpr (STATS) {
              a1[i] += f;
              a2[i] = fmaf(f, f, a2[i]);
            }
          }
        }
        store_vec<T, VEC>(o + s * C, acc);
      }
    }
  }
  if constexpr (STATS) {
    // the block's sums per channel: its pp pixel slots in order
    __syncthreads();  // the ring is free
    float* r1 = smem;
    float* r2 = smem + pp * C;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      r1[pl * C + c + i] = a1[i];
      r2[pl * C + c + i] = a2[i];
    }
    __syncthreads();
    for (int t = tid; t < C; t += NT) {
      float u1 = 0.f, u2 = 0.f;
      for (int j = 0; j < pp; ++j) {
        u1 += r1[j * C + t];
        u2 += r2[j * C + t];
      }
      s1[(int64_t)blockIdx.x * C + t] = u1;
      s2[(int64_t)blockIdx.x * C + t] = u2;
    }
  }
}

template <typename T, int VEC, bool BIAS, bool STATS>
static cudaError_t launch_carafe_head_fwd(const void* x, const void* enc, const void* bias,
                                          void* fb, void* s1, void* s2, int B, int H, int W,
                                          int C, int S, int pp, int pc, cudaStream_t stream) {
  const int chunks = (H * W + pc - 1) / pc, CV = C / VEC, CVB = h1_slice(CV, pp);
  carafe_head_fwd_kernel<T, VEC, BIAS, STATS>
      <<<dim3((unsigned)(B * chunks), (CV + CVB - 1) / CVB), pp * CVB,
         h1_smem(C, S, pp, STATS), stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(enc), static_cast<const T*>(bias),
          static_cast<T*>(fb), static_cast<float*>(s1), static_cast<float*>(s2), H, W, C, S,
          pp, pc, chunks);
  return cudaGetLastError();
}

template <bool BIAS, bool STATS>
static cudaError_t dispatch_carafe_head_fwd(int dtype, int vec, const void* x, const void* enc,
                                            const void* bias, void* fb, void* s1, void* s2,
                                            int B, int H, int W, int C, int S, int pp, int pc,
                                            cudaStream_t s) {
  if (vec < 1 || C % vec || S < 1 || pp < 1 || pc < 1 || B < 1 || H < 1 || W < 1)
    return cudaErrorInvalidValue;
  const int CV = C / vec, CVB = h1_slice(CV, pp);
  // the moments are summed per block over all C: STATS takes no slices
  if (pp * CVB > kH1Threads || (STATS && CVB != CV) || h1_smem(C, S, pp, STATS) > kH1Smem)
    return cudaErrorInvalidValue;
  if (dtype == kFloat32 && vec == 4)
    return launch_carafe_head_fwd<float, 4, BIAS, STATS>(x, enc, bias, fb, s1, s2, B, H, W,
                                                    C, S, pp, pc, s);
  if (dtype == kFloat32 && vec == 1)
    return launch_carafe_head_fwd<float, 1, BIAS, STATS>(x, enc, bias, fb, s1, s2, B, H, W,
                                                    C, S, pp, pc, s);
  if (dtype == kBFloat16 && vec == 8)
    return launch_carafe_head_fwd<__nv_bfloat16, 8, BIAS, STATS>(x, enc, bias, fb, s1, s2,
                                                                  B, H, W, C, S, pp, pc, s);
  if (dtype == kBFloat16 && vec == 1)
    return launch_carafe_head_fwd<__nv_bfloat16, 1, BIAS, STATS>(x, enc, bias, fb, s1, s2,
                                                                  B, H, W, C, S, pp, pc, s);
  return cudaErrorInvalidValue;
}

}  // namespace csu

// x (B, H, W, C), enc (B, H, W, 9*S*S), bias (C,), fb (B, H, W, S*S*C), all
// contiguous in the compute dtype; vec is the channel vector width (16 bytes
// of the dtype, or 1).  A block per chunk of pc pixels of one image (blocks
// = B * ceil(H*W / pc), image-major), walked pp pixels a pass by pp *
// h1_slice(C/vec, pp) threads, a blockIdx.y a slice of the channel vectors
// (one slice where pp*C/vec <= 256, always with the moments).  s1 and s2
// (blocks, C) float32 receive each block's sums of fb and of fb^2 per real
// channel; both null when the caller needs no statistics.
CSU_EXPORT int csu_carafe_head_fwd(int dtype, const void* x, const void* enc,
                                   const void* bias, void* fb, void* s1, void* s2, int B,
                                   int H, int W, int C, int S, int vec, int pp, int pc,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((s1 == nullptr) != (s2 == nullptr)) return (int)cudaErrorInvalidValue;
  if (s1 != nullptr)
    return (int)csu::dispatch_carafe_head_fwd<true, true>(dtype, vec, x, enc, bias, fb, s1, s2,
                                                          B, H, W, C, S, pp, pc, s);
  return (int)csu::dispatch_carafe_head_fwd<true, false>(dtype, vec, x, enc, bias, fb, nullptr,
                                                         nullptr, B, H, W, C, S, pp, pc, s);
}

// K-C, the decoder's CARAFE: K-H1's body without the bias and the moments.
// x (B, H, W, C), enc (B, H, W, 9*S*S), out (B, H, W, S*S*C), all contiguous
// in the compute dtype; vec, pp and pc as csu_carafe_head_fwd takes them
// (carafe_head.h1_geometry picks them).
CSU_EXPORT int csu_carafe_fwd(int dtype, const void* x, const void* enc, void* out, int B,
                              int H, int W, int C, int S, int vec, int pp, int pc,
                              void* stream) {
  return (int)csu::dispatch_carafe_head_fwd<false, false>(
      dtype, vec, x, enc, nullptr, out, nullptr, nullptr, B, H, W, C, S, pp, pc,
      static_cast<cudaStream_t>(stream));
}
