// K3: fused stem for sm_90a: uint8 frame -> 3x3 stride-2 convolution ->
// ReLU -> requant to the stem activation grid.
//
// Replaces spef_tpu/ops/pallas/fused_block.py::fused_stem (Pallas TPU
// kernel; bodies _stem_kernel and its width-packed form _stem_pm_kernel,
// which give the same bits).  The TPU kernel space-to-depths the frame by 2
// and runs four shifted K=128 matmuls to feed its matrix unit; what it
// computes is
//
//   acc = sum over (dy, dx, ci) of pixel[2r-1+dy, 2c-1+dx, ci] * w[dy, dx, ci, co]
//         integer pixels 0..255, int8 weights, zero padding: exact in int32
//   y   = relu(acc * mult + bias)        mult = mult_core / 255, no FMA
//   q   = clip(rint(y * inv_step), 0, qmax)
//   out = q as int8, or as uint8 bits (q - 256 where q > 127) when qmax > 127
//
// with Ho = (H - 1) / 2 + 1, so odd sizes work too.  Rounding is rintf (half
// to even); the epilogue uses __fmul_rn/__fadd_rn and the file is built
// with -fmad=false.
//
// Bound on an H100 SXM: the bytes B*H*W*3 in + B*Ho*Wo*Cout out at
// 3.35 TB/s (the output is 2.7x the input at Cout = 32); its 54*Cout
// integer operations an output pixel are far below the int8 tensor rate.
// Design: one thread per output pixel and group of 8 output channels,
// channel group fastest, so a warp writes 256 contiguous bytes with one
// 8-byte store a thread; the 27 input bytes a thread needs come through
// L1 (neighbouring pixels share them), the weights from shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CG = 8;  // output channels a thread

__global__ void __launch_bounds__(THREADS)
stem_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ mult, const float* __restrict__ bias,
            int8_t* __restrict__ out, int B, int H, int W, int Cout, int Ho, int Wo,
            int groups, float inv_step, float qmax) {
  extern __shared__ int32_t ws[];  // [27][groups * CG], zero beyond Cout
  const int wstride = groups * CG;
  for (int e = threadIdx.x; e < 27 * wstride; e += THREADS) {
    const int t = e / wstride, c = e % wstride;
    ws[e] = c < Cout ? static_cast<int32_t>(w[t * Cout + c]) : 0;
  }
  __syncthreads();

  const bool bits = qmax > 127.0f;
  const bool vec_store = (Cout % CG) == 0;
  const int64_t total = static_cast<int64_t>(B) * Ho * Wo * groups;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * THREADS) {
    const int g = static_cast<int>(idx % groups);
    int64_t pix = idx / groups;  // (b * Ho + oh) * Wo + ow
    const int ow = static_cast<int>(pix % Wo);
    int64_t rest = pix / Wo;
    const int oh = static_cast<int>(rest % Ho);
    const int64_t b = rest / Ho;

    int32_t acc[CG];
#pragma unroll
    for (int i = 0; i < CG; ++i) acc[i] = 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int ih = 2 * oh + dy - 1;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int iw = 2 * ow + dx - 1;
        if (ih < 0 || ih >= H || iw < 0 || iw >= W) continue;
        const uint8_t* px = x + ((b * H + ih) * W + iw) * 3;
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
          const int32_t v = px[ci];
          const int32_t* wr = ws + ((dy * 3 + dx) * 3 + ci) * wstride + g * CG;
#pragma unroll
          for (int i = 0; i < CG; ++i) acc[i] += v * wr[i];
        }
      }
    }

    uint64_t packed = 0;
#pragma unroll
    for (int i = 0; i < CG; ++i) {
      const int c = g * CG + i;
      if (c >= Cout) break;
      float y = __fadd_rn(__fmul_rn(static_cast<float>(acc[i]), mult[c]), bias[c]);
      y = fmaxf(y, 0.0f);
      float q = fminf(fmaxf(rintf(__fmul_rn(y, inv_step)), 0.0f), qmax);
      if (bits && q > 127.0f) q -= 256.0f;
      const int8_t v = static_cast<int8_t>(static_cast<int>(q));
      if (vec_store) {
        packed |= static_cast<uint64_t>(static_cast<uint8_t>(v)) << (8 * i);
      } else {
        out[pix * Cout + c] = v;
      }
    }
    if (vec_store) *reinterpret_cast<uint64_t*>(out + pix * Cout + g * CG) = packed;
  }
}

}  // namespace

extern "C" int spef_fused_stem(const uint8_t* x, const int8_t* w, const float* mult,
                               const float* bias, int8_t* out, int B, int H, int W, int Cout,
                               float inv_step, float qmax, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / 2 + 1;
  const int Wo = (W - 1) / 2 + 1;
  const int groups = (Cout + CG - 1) / CG;
  const size_t smem = static_cast<size_t>(27) * groups * CG * sizeof(int32_t);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(B) * Ho * Wo * groups;
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  stem_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, mult, bias, out, B, H, W, Cout, Ho, Wo, groups, inv_step, qmax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
