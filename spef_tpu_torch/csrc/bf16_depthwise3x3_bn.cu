// 3x3 depthwise convolution of bf16 activations (stride 1 or 2, one pixel of
// zero padding each side) with eval-mode BatchNorm and ReLU in its epilogue,
// for sm_90a.
//
// Replaces no TPU kernel: on the TPU, XLA fused the float forward's conv
// epilogue into the conv itself.  On the card, cuDNN's bf16 depthwise conv
// writes its output, and the BatchNorm (float32), the casts and the ReLU
// each pass over it again (spef_tpu_torch/models/layers.py::ConvBnAct,
// train mode and the stem still do).  Every eval-mode depthwise conv of the
// float MobileNetV2 is one call of this kernel instead:
//
//   acc = sum over the 9 taps in (dy, dx) order of x * w, in f32
//   c   = bf16(acc)                the conv's bf16 output
//   y   = bf16(c * scale + shift)  the BatchNorm from the running statistics,
//                                  per channel in f32, no FMA
//   [y  = relu(y)]
//   out = y                        bf16, stored once
//
// scale = weight / sqrt(var + eps) and shift = bias - mean * scale come
// precomputed in float32 (ops/bf16_conv_bn.py::bn_terms).  Each product of
// two bf16 values is exact in f32, and the plain PyTorch version
// (bf16_depthwise3x3_bn_plain) sums the taps in the same order with the same
// roundings, so the two agree bit for bit.  Rounding is to nearest even
// (__float2bfloat16_rn) after __fmul_rn/__fadd_rn, and the file is built
// with -fmad=false.
//
// Bound on an H100 SXM: the bytes in + out (B*H*W*C + B*Ho*Wo*C bf16, 9*C
// weights) at 3.35 TB/s; its 18 operations an output are far below the
// compute roofline.  The design is K2's (int8_depthwise3x3.cu) for bf16:
//
//   * a thread owns 8 neighbouring channels, one 16-byte load of a pixel,
//     and a strip of output pixels along W.  It slides a 3-column window of
//     the three input rows through registers, so an input element is loaded
//     once a row it feeds (at most three times), not nine times.  Pixels
//     stay packed, two bf16 a register, and are widened where used (a shift
//     or a mask): widened at load, the window would not fit in registers;
//   * its nine weights sit in registers, packed the same way, for the whole
//     strip; the BatchNorm terms are read at each output (they stay in L1);
//   * neighbouring threads take neighbouring channel groups of one pixel,
//     so a warp's loads and stores are contiguous in NHWC; then come the
//     rows of a tile of rows, so that the rows neighbouring strips share
//     are found in L1;
//   * the columns the next output adds are loaded one output ahead, so that
//     their loads fly while this one is summed.
//
// C is a multiple of 8 and every operand 16-byte aligned, as at every
// MobileNetV2 shape (ops/bf16_conv_bn.py checks it; a ConvBnAct with other
// widths runs the unfused path).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int STRIP = 8;  // output pixels a thread walks (the launcher balances it)
constexpr int ROWS = 8;   // output rows whose threads are neighbours in a block

struct Params {
  const uint16_t* x;     // (B, H, W, C) bf16
  const uint16_t* w;     // (3, 3, C) bf16
  const float* scale;    // (C,)
  const float* shift;    // (C,)
  uint16_t* out;         // (B, Ho, Wo, C) bf16
  int relu, H, W, C, Ho, Wo;
  uint32_t groups, rows, strips, row_tiles, strip_len, total;
};

// 8 channels of one pixel (or of one tap's weights), two bf16 a word.
constexpr int VEC = 8;
struct Pixel {
  uint32_t q[VEC / 2];

  __device__ __forceinline__ float get(int i) const {
    const uint32_t word = q[i / 2];
    return __uint_as_float(i % 2 ? word & 0xFFFF0000u : word << 16);
  }
  __device__ __forceinline__ void load(const uint16_t* p) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    q[0] = t.x; q[1] = t.y; q[2] = t.z; q[3] = t.w;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) q[i] = 0u;
  }
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int STRIDE>
__global__ void __launch_bounds__(THREADS, 2) dw3x3_bn_kernel(const Params p) {
  uint32_t t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= p.total) return;
  // Channel group fastest, then the row of a row tile, the strip, the row
  // tile, the image.
  const uint32_t cg = t % p.groups;
  t /= p.groups;
  const uint32_t rr = t % p.rows;
  t /= p.rows;
  const uint32_t sp = t % p.strips;
  t /= p.strips;
  const uint32_t rt = t % p.row_tiles;
  const int64_t b = t / p.row_tiles;
  const int oh = static_cast<int>(rt * p.rows + rr);
  if (oh >= p.Ho) return;
  const int c = static_cast<int>(cg) * VEC;
  const int ow0 = static_cast<int>(sp * p.strip_len);
  const int n = min(static_cast<int>(p.strip_len), p.Wo - ow0);

  Pixel wt[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wt[k].load(p.w + k * p.C + c);

  // The three input rows of this output row; a row outside the image reads
  // as zeros.
  const uint16_t* row[3];
  bool row_ok[3];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int ih = oh * STRIDE + dy - 1;
    row_ok[dy] = ih >= 0 && ih < p.H;
    row[dy] = p.x + ((b * p.H + (row_ok[dy] ? ih : 0)) * p.W) * p.C + c;
  }
  auto load_col = [&](Pixel (&col)[3], int iw) {
    const bool col_ok = iw >= 0 && iw < p.W;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      if (col_ok && row_ok[dy]) {
        col[dy].load(row[dy] + static_cast<int64_t>(iw) * p.C);
      } else {
        col[dy].zero();
      }
    }
  };

  // The window, and the columns the next output adds to it.
  Pixel win[3][3];  // [column dx][row dy]
  Pixel ahead[STRIDE][3];
  if constexpr (STRIDE == 1) {
    load_col(win[0], ow0 - 1);
    load_col(win[1], ow0);
    load_col(ahead[0], ow0 + 1);
  } else {
    load_col(win[0], 2 * ow0 - 1);
    load_col(ahead[0], 2 * ow0);
    load_col(ahead[1], 2 * ow0 + 1);
  }
  const int64_t out_row = ((b * p.Ho + oh) * p.Wo) * p.C + c;
  for (int j = 0; j < n; ++j) {
    const int ow = ow0 + j;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      if constexpr (STRIDE == 1) {
        win[2][dy] = ahead[0][dy];
      } else {
        win[1][dy] = ahead[0][dy];
        win[2][dy] = ahead[1][dy];
      }
    }
    if (j + 1 < n) {
      if constexpr (STRIDE == 1) {
        load_col(ahead[0], ow + 2);
      } else {
        load_col(ahead[0], 2 * ow + 2);
        load_col(ahead[1], 2 * ow + 3);
      }
    }
    uint32_t o[VEC / 2] = {};
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = __fadd_rn(acc, __fmul_rn(win[dx][dy].get(i), wt[dy * 3 + dx].get(i)));
      float y = bf16_round(__fadd_rn(__fmul_rn(bf16_round(acc), __ldg(p.scale + c + i)),
                                     __ldg(p.shift + c + i)));
      if (p.relu) y = fmaxf(y, 0.0f);
      o[i / 2] |= bf16_bits(y) << (16 * (i % 2));
    }
    uint16_t* dst = p.out + out_row + static_cast<int64_t>(ow) * p.C;
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    if constexpr (STRIDE == 1) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        win[0][dy] = win[1][dy];
        win[1][dy] = win[2][dy];
      }
    } else {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) win[0][dy] = win[2][dy];
    }
  }
}

inline bool aligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// x (B, H, W, C) bf16, w (3, 3, C) bf16, scale and shift (C,) f32, out
// (B, Ho, Wo, C) bf16 with Ho = (H - 1) / stride + 1, Wo likewise.
extern "C" int spef_bf16_depthwise3x3_bn(const void* x, const void* w, const float* scale,
                                         const float* shift, void* out, int B, int H, int W,
                                         int C, int stride, int relu, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % VEC != 0 || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(x) || !aligned(w) || !aligned(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Params p{};
  p.x = static_cast<const uint16_t*>(x);
  p.w = static_cast<const uint16_t*>(w);
  p.scale = scale;
  p.shift = shift;
  p.out = static_cast<uint16_t*>(out);
  p.relu = relu;
  p.H = H; p.W = W; p.C = C;
  p.Ho = (H - 1) / stride + 1;
  p.Wo = (W - 1) / stride + 1;

  p.groups = static_cast<uint32_t>(C / VEC);
  p.rows = static_cast<uint32_t>(p.Ho < ROWS ? p.Ho : ROWS);
  p.row_tiles = (static_cast<uint32_t>(p.Ho) + p.rows - 1) / p.rows;
  // Strips of equal length, STRIP at most: a row of 12 is two strips of 6.
  const uint32_t strips = (static_cast<uint32_t>(p.Wo) + STRIP - 1) / STRIP;
  p.strip_len = (static_cast<uint32_t>(p.Wo) + strips - 1) / strips;
  p.strips = (static_cast<uint32_t>(p.Wo) + p.strip_len - 1) / p.strip_len;
  const uint64_t total = static_cast<uint64_t>(B) * p.row_tiles * p.strips * p.rows * p.groups;
  if (total > 0xffffff00ull) return static_cast<int>(cudaErrorInvalidValue);
  p.total = static_cast<uint32_t>(total);
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (stride == 1) {
    dw3x3_bn_kernel<1><<<blocks, THREADS, 0, s>>>(p);
  } else {
    dw3x3_bn_kernel<2><<<blocks, THREADS, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
