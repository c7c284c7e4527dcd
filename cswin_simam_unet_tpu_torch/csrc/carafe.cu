// K-C: CARAFE content-aware reassembly, forward, in the pre-pixel-shuffle
// ("flat") layout out[b, y, x, s*C + c].
//
// Replaces cswin_simam_unet_tpu/ops/pallas_carafe.py::_fwd_kernel
// (pallas_call at :320): per pixel and sub-pixel s, softmax over the 9 taps
// of enc[..., k*S^2 + s], then out = sum_k p_k * x[y+dy_k, x+dx_k, :], zero
// padded at the image border.  (K-H1, the fused head's reassembly with the
// bias and the moments, has a kernel of its own: carafe_head_fwd.cu.)
//
// What bounds it on the H100: 18 flops per output element against 2 bytes
// written (bf16), so device memory, and mostly the output write.  Design:
// the block's threads own the (s, 16-byte channel vector)
// slots of one pixel, so a pixel's S^2*C outputs are written by one fully
// coalesced block-wide store; the block walks a run of pixels along one row.
// A thread loads its 9 neighbour vectors once per pixel (the S^2 threads that
// share a vector hit L1), computes its sub-pixel's 9-tap softmax in registers
// and accumulates in float32.  The TPU kernel's MXU indicator tricks
// (_expand_s, _fold_sum_s) are lane workarounds with no use here.
#include "common.cuh"

namespace csu {

template <typename T, int VEC>
__global__ void carafe_kernel(const T* __restrict__ x, const T* __restrict__ enc,
                              T* __restrict__ out, int H, int W, int C, int S, int px) {
  const int S2 = S * S, CV = C / VEC;
  const int s = threadIdx.x / CV, cv = threadIdx.x - s * CV;
  const int c = cv * VEC;
  const int nch = (W + px - 1) / px;
  const int row = blockIdx.x / nch, chunk = blockIdx.x - row * nch;  // row = b*H + y
  const int y = row % H;
  const int64_t img0 = (int64_t)(row - y) * W;  // first pixel of this image
  const int x0 = chunk * px, x1 = min(W, x0 + px);

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
    store_vec<T, VEC>(out + pix * (S2 * C) + s * C + c, acc);
  }
}

template <typename T, int VEC>
static cudaError_t launch_carafe(const void* x, const void* enc, void* out, int B, int H,
                                 int W, int C, int S, int px, cudaStream_t stream) {
  if (C % VEC || px < 1) return cudaErrorInvalidValue;
  const int threads = S * S * (C / VEC);
  if (threads > 1024) return cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)B * H * ((W + px - 1) / px);
  carafe_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(enc), static_cast<T*>(out), H, W, C,
      S, px);
  return cudaGetLastError();
}

static cudaError_t dispatch_carafe(int dtype, int vec, const void* x, const void* enc,
                                   void* out, int B, int H, int W, int C, int S, int px,
                                   cudaStream_t stream) {
  if (dtype == kFloat32 && vec == 4)
    return launch_carafe<float, 4>(x, enc, out, B, H, W, C, S, px, stream);
  if (dtype == kFloat32 && vec == 1)
    return launch_carafe<float, 1>(x, enc, out, B, H, W, C, S, px, stream);
  if (dtype == kBFloat16 && vec == 8)
    return launch_carafe<__nv_bfloat16, 8>(x, enc, out, B, H, W, C, S, px, stream);
  if (dtype == kBFloat16 && vec == 1)
    return launch_carafe<__nv_bfloat16, 1>(x, enc, out, B, H, W, C, S, px, stream);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// K-C': the CARAFE backward.
//
// Replaces ops/pallas_carafe.py::_bwd_kernel (pallas_call at :353, through
// _carafe_bwd).  With p_k(pix, s) the rounded tap softmax of the forward and
// dacc the cotangent of the flat output (lane s*C + c):
//     dp_k(pix, s)  = sum_c dacc(pix, s, c) * x(pix + off_k, c)
//     denc(pix, k*S^2 + s) = p_k * (dp_k - sum_k' p_k' dp_k')
//     dx(pix', c)   = sum_k sum_s p_k(pix' - off_k, s) * dacc(pix' - off_k, s, c)
// dx is the tap scatter written as a gather over the 3x3 neighbours, so no
// two blocks write one element and no atomics are needed.  (K4, the fused
// head's backward, has a kernel of its own: carafe_head_bwd.cu.)
//
// What bounds it on the H100: device memory: it reads x, enc and dacc once
// and writes dx and denc.  Design: a block owns a run of px pixels of one
// image row, and its threads the (s, 16-byte channel vector) slots of a
// pixel, as in the forward.  It first stages, for rows y-1..y+1 and columns
// x0-1..x0+px, the rounded tap probabilities (float32) and dacc (compute
// dtype) in shared memory, so every halo value is read once per block; then
// per pixel the dp partials of each thread meet in shared memory and are
// summed in a fixed order (deterministic), and the dx gather reads the
// staged neighbours.
template <typename T, int VEC>
__global__ void carafe_bwd_kernel(const T* __restrict__ x, const T* __restrict__ enc,
                                  const T* __restrict__ dacc, T* __restrict__ dx,
                                  T* __restrict__ denc, int H, int W, int C, int S, int px) {
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
  const int y = row % H;
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
  // the image
  for (int pj = 0; pj < 3 * PW; ++pj) {
    const int r = pj / PW, jj = pj - r * PW;
    const int yy = y + r - 1, xx = x0 + jj - 1;
    float val[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) val[i] = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      load_vec<T, VEC>(dacc + (img0 + (int64_t)yy * W + xx) * SC + s * C + c, val);
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
}

// Shared memory of one carafe_bwd_kernel block (bytes); _build's wrappers
// pick px with the same formula.
static size_t carafe_bwd_smem(int C, int S, int vec, int elem, int px) {
  const size_t S2 = (size_t)S * S, NT = S2 * (C / vec), PW = (size_t)px + 2;
  const size_t nfloat = (3 * PW * 9 * S2 + 9 * NT + NT * vec + 9 * S2 + 3) & ~(size_t)3;
  return 4 * nfloat + (size_t)elem * 3 * PW * S2 * C;
}

template <typename T, int VEC>
static cudaError_t launch_carafe_bwd(const void* x, const void* enc, const void* dacc,
                                     void* dx, void* denc, int B, int H, int W, int C, int S,
                                     int px, cudaStream_t stream) {
  if (C % VEC || px < 1) return cudaErrorInvalidValue;
  const int threads = S * S * (C / VEC);
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = carafe_bwd_smem(C, S, VEC, (int)sizeof(T), px);
  static std::atomic<int> opted[kMaxDevices];
  const cudaError_t e = opt_in_smem(carafe_bwd_kernel<T, VEC>, smem, opted);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)B * H * ((W + px - 1) / px);
  carafe_bwd_kernel<T, VEC><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(enc), static_cast<const T*>(dacc),
      static_cast<T*>(dx), static_cast<T*>(denc), H, W, C, S, px);
  return cudaGetLastError();
}

static cudaError_t dispatch_carafe_bwd(int dtype, int vec, const void* x, const void* enc,
                                       const void* dacc, void* dx, void* denc, int B, int H,
                                       int W, int C, int S, int px, cudaStream_t stream) {
  if (dtype == kFloat32 && vec == 4)
    return launch_carafe_bwd<float, 4>(x, enc, dacc, dx, denc, B, H, W, C, S, px, stream);
  if (dtype == kFloat32 && vec == 1)
    return launch_carafe_bwd<float, 1>(x, enc, dacc, dx, denc, B, H, W, C, S, px, stream);
  if (dtype == kBFloat16 && vec == 8)
    return launch_carafe_bwd<__nv_bfloat16, 8>(x, enc, dacc, dx, denc, B, H, W, C, S, px,
                                               stream);
  if (dtype == kBFloat16 && vec == 1)
    return launch_carafe_bwd<__nv_bfloat16, 1>(x, enc, dacc, dx, denc, B, H, W, C, S, px,
                                               stream);
  return cudaErrorInvalidValue;
}

}  // namespace csu

// x (B, H, W, C), enc (B, H, W, 9*S*S), out (B, H, W, S*S*C), all contiguous;
// vec is the channel vector width (16 bytes of the dtype, or 1); each block
// covers px pixels of one row.
CSU_EXPORT int csu_carafe_fwd(int dtype, const void* x, const void* enc, void* out,
                              int B, int H, int W, int C, int S, int vec, int px,
                              void* stream) {
  return (int)csu::dispatch_carafe(dtype, vec, x, enc, out, B, H, W, C, S, px,
                                   static_cast<cudaStream_t>(stream));
}

// Backward of csu_carafe_fwd: x (B, H, W, C), enc (B, H, W, 9*S*S), dacc
// (B, H, W, S*S*C) the cotangent of the flat output, all contiguous; writes
// dx like x and denc like enc.  Each block covers px pixels of one row.
CSU_EXPORT int csu_carafe_bwd(int dtype, const void* x, const void* enc, const void* dacc,
                              void* dx, void* denc, int B, int H, int W, int C, int S,
                              int vec, int px, void* stream) {
  return (int)csu::dispatch_carafe_bwd(dtype, vec, x, enc, dacc, dx, denc, B, H, W, C, S, px,
                                       static_cast<cudaStream_t>(stream));
}
