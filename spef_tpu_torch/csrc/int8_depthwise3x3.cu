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
// and the int8-carry executor's conventions (spef_tpu/quant/int8_carry.py)
// as launch options: `div` rounds y / step, an IEEE division (__fdiv_rn), in
// place of y * inv; `zp` (0 or 128) emits q - zp, an unsigned grid shifted
// into int8; `halo` is what a tap outside the image reads (int8 input: -zp
// of a shifted input, the shifted form of a real 0; else 0).
//
// Every product is exact in f32 (8-bit significands), and integer inputs
// sum exactly; the plain PyTorch version sums the taps in the same order,
// so real-valued inputs agree with it bit for bit too.  Rounding is rintf
// (half to even); the epilogue uses __fmul_rn/__fadd_rn and the file is
// built with -fmad=false.
//
// Bound on an H100 SXM: the bytes in + out (B*H*W*C in at 1 or 4 bytes,
// B*Ho*Wo*C out at 1 or 2 bytes, 9*C weights) at 3.35 TB/s; its 18
// operations an output are far below the compute roofline.  So the design
// moves each byte as few times as it can, 16 at a time:
//
//   * a thread owns VEC neighbouring channels, the group one 16-byte load
//     covers (4 float32, 16 int8; 8 int8 where only 8-byte access is
//     possible), and a strip of output pixels along W.  It slides a
//     3-column window of the three input rows through registers, so an
//     input element is loaded once a row it feeds (at most three times),
//     not nine times;
//   * its nine weights, folded multiplier and bias sit in registers for the
//     whole strip;
//   * neighbouring threads take neighbouring channel groups of one pixel,
//     so a warp's loads and stores are contiguous in NHWC; then come the
//     rows of a tile of rows, so that the rows neighbouring strips share
//     are found in L1;
//   * a thread finds its place with a few 32-bit divisions a strip; only
//     the row base offsets are 64-bit;
//   * shapes or pointers that do not allow vector access run the same
//     kernel with VEC = 1, chosen by the launcher;
//   * int8 values and uint8 bits share their instantiations: a byte is
//     decoded as (byte ^ flip) - flip, flip = 128 for values and 0 for bits,
//     a launch parameter.  Ten instantiations in all (float32 by 4 and 1,
//     bytes by 16, 8 and 1; stride 1 and 2).

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum XMode { X_INT8 = 0, X_BITS = 1, X_F32 = 2 };  // of the C interface
enum ElemKind { E_BYTE = 0, E_F32 = 1 };           // of the instantiations
constexpr uint32_t FLIP_SIGNED = 128u;             // the weights are int8 values
enum OutMode { OUT_INT8 = 0, OUT_BITS = 1, OUT_BF16 = 2 };

constexpr int THREADS = 256;
constexpr int STRIP = 8;  // output pixels a thread walks (the launcher balances it)
constexpr int ROWS = 8;   // output rows whose threads are neighbours in a block

struct Params {
  const void* x;
  const int8_t* w;
  const float* mult;
  const float* bias;
  void* out;
  int out_mode, H, W, C, Ho, Wo;
  uint32_t groups, rows, strips, row_tiles, strip_len, total;
  uint32_t flip;  // 128: the input bytes are int8 values; 0: uint8 bits
  uint32_t zp;    // an int8 output is q - zp
  uint32_t halo_word;  // four bytes of the halo value (packed integer paths)
  int div;        // requant by y / inv (inv holds the step) in place of y * inv
  float in_step, inv, qmax;
  float halo;     // the halo value, decoded
};

__device__ __forceinline__ float decode_byte(uint32_t byte, uint32_t flip) {
  return static_cast<float>(static_cast<int>(byte ^ flip) - static_cast<int>(flip));
}

// VEC channels of one pixel (or of one tap's weights).  Integer inputs of a
// vector path stay packed, four a register, and are decoded where used.
template <bool PACKED, int VEC>
struct Px;

template <int VEC>
struct Px<false, VEC> {
  float v[VEC];
  __device__ __forceinline__ float get(int i, uint32_t) const { return v[i]; }
  __device__ __forceinline__ void fill(uint32_t, float f) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = f;
  }
};

template <int VEC>
struct Px<true, VEC> {
  uint32_t q[VEC / 4];
  __device__ __forceinline__ float get(int i, uint32_t flip) const {
    return decode_byte((q[i / 4] >> (8 * (i % 4))) & 255u, flip);
  }
  __device__ __forceinline__ void fill(uint32_t word, float) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) q[i] = word;
  }
};

__device__ __forceinline__ float bf16_round(float v) {
  // The consumer's bf16 operand cast (xla_depthwise3x3: x.astype(bf16)).
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC bytes at p into packed words, with the widest load VEC allows.
template <int VEC>
__device__ __forceinline__ void load_bytes(const int8_t* p, uint32_t* q) {
  if constexpr (VEC == 16) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    q[0] = t.x; q[1] = t.y; q[2] = t.z; q[3] = t.w;
  } else if constexpr (VEC == 8) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    q[0] = t.x; q[1] = t.y;
  } else {
    static_assert(VEC == 4, "packed loads are 4, 8 or 16 bytes");
    q[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

template <int ELEM, int VEC>
struct Input {
  static constexpr bool PACKED = ELEM == E_BYTE && VEC >= 4;
  using Pixel = Px<PACKED, VEC>;
  using Elem = typename std::conditional<ELEM == E_F32, float, int8_t>::type;

  static __device__ __forceinline__ void load(const Elem* p, Pixel& px, uint32_t flip) {
    if constexpr (ELEM == E_F32) {
      if constexpr (VEC == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        px.v[0] = bf16_round(t.x); px.v[1] = bf16_round(t.y);
        px.v[2] = bf16_round(t.z); px.v[3] = bf16_round(t.w);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) px.v[i] = bf16_round(__ldg(p + i));
      }
    } else if constexpr (PACKED) {
      load_bytes<VEC>(p, px.q);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        px.v[i] = decode_byte(static_cast<uint8_t>(__ldg(p + i)), flip);
    }
  }
};

// NW 32-bit words to p with the widest stores NW allows.
template <int NW>
__device__ __forceinline__ void store_words(void* p, const uint32_t* wds) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(wds[4 * i], wds[4 * i + 1], wds[4 * i + 2], wds[4 * i + 3]);
  } else if constexpr (NW == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(wds[0], wds[1]);
  } else {
    static_assert(NW == 1, "1, 2 or a multiple of 4 words");
    *reinterpret_cast<uint32_t*>(p) = wds[0];
  }
}

// Two blocks an SM at least (128 registers a thread) but for the 16-channel
// integer path, whose window and weights alone need more.
template <int ELEM, int VEC, int STRIDE>
__global__ void __launch_bounds__(THREADS, VEC > 8 ? 1 : 2) dw3x3_kernel(const Params p) {
  using In = Input<ELEM, VEC>;
  using Pixel = typename In::Pixel;
  using Elem = typename In::Elem;
  // Weights of a wide integer path stay packed too (144 floats otherwise).
  using Weight = Px<(VEC > 4), VEC>;
  const uint32_t flip = p.flip;

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

  // The multiplier and bias of a wide path are read again at each output
  // (they stay in L1) rather than held in 2 * VEC registers.
  constexpr bool HOLD = VEC <= 4;
  Weight wt[9];
  float m[HOLD ? VEC : 1], bs[HOLD ? VEC : 1];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if constexpr (VEC > 4) {
      load_bytes<VEC>(p.w + k * p.C + c, wt[k].q);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) wt[k].v[i] = static_cast<float>(__ldg(p.w + k * p.C + c + i));
    }
  }
  if constexpr (HOLD) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      m[i] = __fmul_rn(p.in_step, __ldg(p.mult + c + i));
      bs[i] = __ldg(p.bias + c + i);
    }
  }

  // The three input rows of this output row; a row outside the image reads
  // as the halo.
  const Elem* row[3];
  bool row_ok[3];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int ih = oh * STRIDE + dy - 1;
    row_ok[dy] = ih >= 0 && ih < p.H;
    row[dy] = static_cast<const Elem*>(p.x) +
              ((b * p.H + (row_ok[dy] ? ih : 0)) * p.W) * p.C + c;
  }
  auto load_col = [&](Pixel (&col)[3], int iw) {
    const bool col_ok = iw >= 0 && iw < p.W;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      if (col_ok && row_ok[dy]) {
        In::load(row[dy] + iw * p.C, col[dy], flip);
      } else {
        col[dy].fill(p.halo_word, p.halo);
      }
    }
  };

  constexpr int OUT_WORDS_BF16 = VEC / 2, OUT_WORDS_INT8 = VEC / 4;
  // The window, and the columns the next output adds to it: they are asked
  // for one output ahead, so that their loads fly while this one is summed.
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
    float y[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = __fadd_rn(acc, __fmul_rn(win[dx][dy].get(i, flip),
                                         wt[dy * 3 + dx].get(i, FLIP_SIGNED)));
      float mi, bi;
      if constexpr (HOLD) {
        mi = m[i];
        bi = bs[i];
      } else {
        mi = __fmul_rn(p.in_step, __ldg(p.mult + c + i));
        bi = __ldg(p.bias + c + i);
      }
      y[i] = fmaxf(__fadd_rn(__fmul_rn(acc, mi), bi), 0.0f);
    }
    const int64_t o = out_row + static_cast<int64_t>(ow) * p.C;
    if (p.out_mode == OUT_BF16) {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) + o;
      if constexpr (VEC >= 4) {
        uint32_t wds[OUT_WORDS_BF16];
#pragma unroll
        for (int i = 0; i < VEC / 2; ++i) {
          const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(y[2 * i]));
          const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(y[2 * i + 1]));
          wds[i] = lo | (hi << 16);
        }
        store_words<OUT_WORDS_BF16>(dst, wds);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[i] = __float2bfloat16_rn(y[i]);
      }
    } else {
      int8_t* dst = static_cast<int8_t*>(p.out) + o;
      uint32_t wds[VEC >= 4 ? OUT_WORDS_INT8 : 1] = {};
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        // uint8 bits above 127 wrap to the int8 of the same bits; q - zp
        // of a shifted grid is an int8 value.
        const float v = p.div ? __fdiv_rn(y[i], p.inv) : __fmul_rn(y[i], p.inv);
        const float q = fminf(fmaxf(rintf(v), 0.0f), p.qmax);
        const uint32_t byte = (static_cast<uint32_t>(static_cast<int>(q)) - p.zp) & 255u;
        if constexpr (VEC >= 4) {
          wds[i / 4] |= byte << (8 * (i % 4));
        } else {
          dst[i] = static_cast<int8_t>(byte);
        }
      }
      if constexpr (VEC >= 4) store_words<OUT_WORDS_INT8>(dst, wds);
    }
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

template <int ELEM, int VEC>
void launch(const Params& p, int stride, unsigned blocks, cudaStream_t s) {
  if (stride == 1) {
    dw3x3_kernel<ELEM, VEC, 1><<<blocks, THREADS, 0, s>>>(p);
  } else {
    dw3x3_kernel<ELEM, VEC, 2><<<blocks, THREADS, 0, s>>>(p);
  }
}

inline bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// div: out_inv_step is the step, and the requant divides by it; zp: an int8
// output is q - zp; halo: the value of the taps outside the image (int8
// values in only).
extern "C" int spef_int8_depthwise3x3(const void* x, int x_mode, const int8_t* w,
                                      const float* mult, const float* bias, void* out,
                                      int out_mode, int B, int H, int W, int C, int stride,
                                      float in_step, float out_inv_step, float out_qmax,
                                      int div, int zp, int halo, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || (stride != 1 && stride != 2) ||
      x_mode < X_INT8 || x_mode > X_F32 || out_mode < OUT_INT8 || out_mode > OUT_BF16 ||
      (zp != 0 && zp != 128) || (zp != 0 && out_mode != OUT_INT8) || halo < -128 ||
      halo > 127 || (halo != 0 && x_mode != X_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = x; p.w = w; p.mult = mult; p.bias = bias; p.out = out;
  p.out_mode = out_mode; p.H = H; p.W = W; p.C = C;
  p.Ho = (H - 1) / stride + 1;
  p.Wo = (W - 1) / stride + 1;
  p.in_step = in_step; p.inv = out_inv_step; p.qmax = out_qmax;
  p.flip = x_mode == X_BITS ? 0u : FLIP_SIGNED;
  p.zp = static_cast<uint32_t>(zp);
  p.div = div != 0;
  p.halo = static_cast<float>(halo);
  p.halo_word = (static_cast<uint32_t>(halo) & 255u) * 0x01010101u;

  // The widest channel group whose loads and stores are aligned.
  const int in_bytes = x_mode == X_F32 ? 4 : 1, out_bytes = out_mode == OUT_BF16 ? 2 : 1;
  auto fits = [&](int vec) {
    return C % vec == 0 && aligned(x, vec * in_bytes) && aligned(out, vec * out_bytes) &&
           (vec <= 4 || aligned(w, vec));
  };
  int vec = 1;
  if (x_mode == X_F32) {
    if (fits(4)) vec = 4;
  } else if (fits(16)) {
    vec = 16;
  } else if (fits(8)) {
    vec = 8;
  }

  p.groups = static_cast<uint32_t>(C / vec);
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

  if (x_mode == X_F32) {
    if (vec == 4) launch<E_F32, 4>(p, stride, blocks, s);
    else launch<E_F32, 1>(p, stride, blocks, s);
  } else {
    if (vec == 16) launch<E_BYTE, 16>(p, stride, blocks, s);
    else if (vec == 8) launch<E_BYTE, 8>(p, stride, blocks, s);
    else launch<E_BYTE, 1>(p, stride, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
