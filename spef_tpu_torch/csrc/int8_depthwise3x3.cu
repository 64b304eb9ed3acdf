// K2: 3x3 SAME depthwise convolution + requant epilogue for sm_90a.
//
// Replaces spef_tpu/ops/pallas/int8_ops.py::int8_depthwise3x3 (Pallas TPU
// kernel, body _dw_kernel) and the two cases the TPU sent to XLA instead
// (xla_depthwise3x3, quant/int8_pallas.py:192-214): stride 2, and the
// boundary recipe's real-valued output.  One kernel covers
//
//   input   int8 values | uint8 bits in int8 (decode x & 255) |
//           f32 real values rounded to bf16 on load (the float handoff
//           after an expand without an activation grid)
//   stride  1 or 2, one pixel of zero padding each side
//   acc     sum over the 9 taps in (dy, dx) order of x * w, in f32
//   y       relu(acc * (in_step * mult) + bias)   no FMA
//   output  clip(rint(y * inv), 0, qmax) as int8 or as uint8 bits |
//           bf16 y (no activation grid: out_inv_step=None)
//
// Every product is exact in f32 (8-bit significands), and integer inputs
// sum exactly; the plain PyTorch version sums the taps in the same order,
// so real-valued inputs agree with it bit for bit too.  Rounding is rintf
// (half to even); the epilogue uses __fmul_rn/__fadd_rn and the file is
// built with -fmad=false.
//
// Bound on an H100 SXM: the bytes in + out (B*H*W*C in at 1 or 4 bytes,
// B*Ho*Wo*C out at 1 or 2 bytes, 9*C weights) at 3.35 TB/s; its 18
// operations an output are far below the compute roofline.  Design: one
// thread per output element, channel fastest, so a warp reads 32
// neighbouring channels of one pixel per tap (coalesced NHWC); the 3x3
// halo is re-read from L1/L2 rather than staged in shared memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum XMode { X_INT8 = 0, X_BITS = 1, X_F32 = 2 };
enum OutMode { OUT_INT8 = 0, OUT_BITS = 1, OUT_BF16 = 2 };

constexpr int THREADS = 256;

template <int MODE>
__device__ __forceinline__ float load_x(const void* x, int64_t i) {
  if constexpr (MODE == X_F32) {
    // The consumer's bf16 operand cast (xla_depthwise3x3: x.astype(bf16)).
    return __bfloat162float(__float2bfloat16_rn(static_cast<const float*>(x)[i]));
  } else if constexpr (MODE == X_BITS) {
    return static_cast<float>(static_cast<const uint8_t*>(x)[i]);
  } else {
    return static_cast<float>(static_cast<const int8_t*>(x)[i]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
dw3x3_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ mult, const float* __restrict__ bias,
             void* __restrict__ out, int out_mode, int B, int H, int W, int C, int Ho,
             int Wo, int stride, float in_step, float inv, float qmax) {
  const int64_t total = static_cast<int64_t>(B) * Ho * Wo * C;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * THREADS) {
    const int c = static_cast<int>(idx % C);
    int64_t rest = idx / C;
    const int ow = static_cast<int>(rest % Wo);
    rest /= Wo;
    const int oh = static_cast<int>(rest % Ho);
    const int64_t b = rest / Ho;

    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int ih = oh * stride + dy - 1;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int iw = ow * stride + dx - 1;
        float v = 0.0f;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
          v = load_x<MODE>(x, ((b * H + ih) * W + iw) * C + c);
        }
        const float wv = static_cast<float>(w[(dy * 3 + dx) * C + c]);
        acc = __fadd_rn(acc, __fmul_rn(v, wv));
      }
    }
    float y = __fadd_rn(__fmul_rn(acc, __fmul_rn(in_step, mult[c])), bias[c]);
    y = fmaxf(y, 0.0f);
    if (out_mode == OUT_BF16) {
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
    } else {
      float q = fminf(fmaxf(rintf(__fmul_rn(y, inv)), 0.0f), qmax);
      if (out_mode == OUT_BITS && q > 127.0f) q -= 256.0f;
      static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(static_cast<int>(q));
    }
  }
}

}  // namespace

extern "C" int spef_int8_depthwise3x3(const void* x, int x_mode, const int8_t* w,
                                      const float* mult, const float* bias, void* out,
                                      int out_mode, int B, int H, int W, int C, int stride,
                                      float in_step, float out_inv_step, float out_qmax,
                                      void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const int64_t total = static_cast<int64_t>(B) * Ho * Wo * C;
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < (1 << 30) ? want : (1 << 30));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_mode) {
    case X_INT8:
      dw3x3_kernel<X_INT8><<<blocks, THREADS, 0, s>>>(x, w, mult, bias, out, out_mode, B, H,
                                                     W, C, Ho, Wo, stride, in_step,
                                                     out_inv_step, out_qmax);
      break;
    case X_BITS:
      dw3x3_kernel<X_BITS><<<blocks, THREADS, 0, s>>>(x, w, mult, bias, out, out_mode, B, H,
                                                     W, C, Ho, Wo, stride, in_step,
                                                     out_inv_step, out_qmax);
      break;
    case X_F32:
      dw3x3_kernel<X_F32><<<blocks, THREADS, 0, s>>>(x, w, mult, bias, out, out_mode, B, H,
                                                    W, C, Ho, Wo, stride, in_step,
                                                    out_inv_step, out_qmax);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
