// K3: fused stem for sm_90a: uint8 frame -> 3x3 stride-2 convolution ->
// ReLU -> requant to the stem activation grid, the products on the tensor
// cores.
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
// with Ho = (H - 1) / 2 + 1, so odd sizes work too.  Rounding is half to
// even, as rintf; the epilogue uses __fmul_rn/__fadd_rn and the file is
// built with -fmad=false.  The sums are exact, so the output equals the plain
// PyTorch version's bit for bit.
//
// Bound on an H100 SXM: the bytes B*H*W*3 in + B*Ho*Wo*Cout out at
// 3.35 TB/s (the output is 2.7x the input at Cout = 32); its 54*Cout
// integer operations an output pixel are far below the int8 tensor rate.
// Design:
//
//   * the grid is (bands of R output rows, images): a block reads its
//     band's 2R+1 input rows once, by 16-byte cp.async where a row's bytes
//     allow, into shared memory rows that carry the zero halo (column -1,
//     column W for odd widths, rows outside the frame);
//   * the 27-tap product is one mma.sync.m16n8k32 u8.s8 -> s32 an 8-channel
//     tile: k = (dy, dx, ci) in that order, padded to 32 with zeros.  For
//     one output pixel and one dy the 9 bytes of input columns 2c-1..2c+1
//     are contiguous in shared memory, so a lane gathers its A fragment
//     (8 k of 2 pixels) from three 9-byte runs, and one fragment of 16
//     pixels serves every channel tile.  The weights come packed once as
//     (Cout padded to 8, 32) int8 (ops/fused_block.py::pack_stem_weights),
//     the B layout;
//   * the epilogue runs on the accumulators into the warp's staging rows,
//     with no conversion instruction (those run at an eighth of the float32
//     rate, and there are two an output): an integer becomes a float and a
//     float is rounded to an integer by exact float additions (MAGIC);
//     the warp's 16 output pixels of one row are 16*Cout contiguous bytes of
//     the output, which leave in 16-byte stores where Cout allows.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int K_DEPTH = 32;   // 27 taps x channels, padded to the int8 mma depth
constexpr int LEAD = 16;      // bytes before column 0 of a shared row (column -1 ends there)
constexpr int SMEM_MAX = 232448;
// 1.5 * 2^23.  The floats from 2^23 to 2^24 are the integers, so for
// |v| <= 2^22 the sum v + MAGIC is v rounded to an integer, half to even as
// rintf (MAGIC is even), plus MAGIC, and its bits are MAGIC_BITS + rint(v).
// Conversely the bits MAGIC_BITS + i, for |i| <= 2^22, are the float
// MAGIC + i.
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

struct Params {
  const uint8_t* x;
  const int8_t* w;     // (coutp, 32) packed
  const float* mult;
  const float* bias;
  int8_t* out;
  int B, H, W, Cout, coutp, Ho, Wo;
  int R;               // output rows a band
  int rs;              // bytes a shared input row
  int x_piece;         // bytes a cp.async of an input row moves (1: byte copies)
  int o_piece;         // bytes a store of a warp's output run moves
  int off_w, off_aux, off_stage, stage_stride;
  float inv_step;
  float qmax;          // floor of the grid's qmax: 127, or 255 for uint8 bits
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES) : "memory");
  }
}

__device__ __forceinline__ void mma_u8s8(uint32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int PIECE>
__device__ __forceinline__ void load_row_async(uint8_t* dst, const uint8_t* src, int bytes) {
  const uint32_t d = smem_u32(dst);
  for (int e = threadIdx.x * PIECE; e < bytes; e += THREADS * PIECE) cp_async<PIECE>(d + e, src + e);
}

// relu, then clip(rint(y * inv_step), 0, qmax), in the low byte of the
// result: the int8 value, or the uint8 bits above 127.  A negative y rounds
// to at most 0, which the clip takes to 0, so the relu is the clip; and
// clip(rint(v), 0, qmax) = rint(clip(v, 0, qmax)) for an integer qmax, which
// is at most 255, so the rounding is MAGIC's.  |acc| <= 27 * 255 * 128 <
// 2^22 becomes its float by MAGIC too.
__device__ __forceinline__ uint32_t requant(const Params& p, int32_t acc, float mult,
                                            float bias) {
  const float a = __fsub_rn(__int_as_float(acc + MAGIC_BITS), MAGIC);
  const float y = __fadd_rn(__fmul_rn(a, mult), bias);
  const float v = fminf(fmaxf(__fmul_rn(y, p.inv_step), 0.0f), p.qmax);
  return __float_as_uint(__fadd_rn(v, MAGIC));
}

template <int PIECE>
__device__ __forceinline__ void store_run(const uint8_t* stage, int8_t* dst, int bytes,
                                          int lane) {
  for (int e = lane * PIECE; e < bytes; e += 32 * PIECE) {
    if constexpr (PIECE == 16) {
      *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(stage + e);
    } else if constexpr (PIECE == 8) {
      *reinterpret_cast<uint2*>(dst + e) = *reinterpret_cast<const uint2*>(stage + e);
    } else if constexpr (PIECE == 4) {
      *reinterpret_cast<uint32_t*>(dst + e) = *reinterpret_cast<const uint32_t*>(stage + e);
    } else {
      dst[e] = static_cast<int8_t>(stage[e]);
    }
  }
}

// One 8-channel tile of a 16-pixel m-tile: the product, the epilogue, and
// the int8 results into the warp's staging rows.
__device__ __forceinline__ void channel_tile(const Params& p, const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1, float2 m, float2 bias, uint8_t* stage,
                                             int co, int g) {
  uint32_t c[4] = {0u, 0u, 0u, 0u};
  mma_u8s8(c, a, b0, b1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t lo = requant(p, static_cast<int32_t>(c[2 * half]), m.x, bias.x);
    const uint32_t hi = requant(p, static_cast<int32_t>(c[2 * half + 1]), m.y, bias.y);
    *reinterpret_cast<uint16_t*>(stage + (g + 8 * half) * p.stage_stride + co) =
        static_cast<uint16_t>(__byte_perm(lo, hi, 0x40));  // the two low bytes
  }
}

// NT: 8-channel tiles, with their B fragments, multipliers and biases held
// in registers for the block's whole life; 0 for any Cout, read from shared
// memory tile by tile.
template <int NT>
__global__ void __launch_bounds__(THREADS)
stem_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.y;
  const int oh0 = blockIdx.x * p.R;
  const int rows_out = min(p.R, p.Ho - oh0);
  const int rows_in = 2 * rows_out + 1;
  const int ih0 = 2 * oh0 - 1;
  const int row_bytes = 3 * p.W;

  // Input rows of the band, each at LEAD with zeros at columns -1 and W.
  for (int j = 0; j < rows_in; ++j) {
    uint8_t* dst = smem + j * p.rs;
    const int ih = ih0 + j;
    if (ih < 0 || ih >= p.H) {
      for (int e = threadIdx.x; e < p.rs; e += THREADS) dst[e] = 0;
      continue;
    }
    const uint8_t* src = p.x + (static_cast<int64_t>(b) * p.H + ih) * row_bytes;
    if (p.x_piece == 16) {
      load_row_async<16>(dst + LEAD, src, row_bytes);
    } else if (p.x_piece == 4) {
      load_row_async<4>(dst + LEAD, src, row_bytes);
    } else {
      for (int e = threadIdx.x; e < row_bytes; e += THREADS) dst[LEAD + e] = src[e];
    }
    if (threadIdx.x < 6) {
      const int at = threadIdx.x < 3 ? LEAD - 3 + threadIdx.x : LEAD + row_bytes + threadIdx.x - 3;
      dst[at] = 0;
    }
  }
  // Packed weights and the small operands (zeros past Cout).
  int8_t* ws = reinterpret_cast<int8_t*>(smem + p.off_w);
  for (int e = threadIdx.x * 4; e < p.coutp * K_DEPTH; e += THREADS * 4)
    *reinterpret_cast<uint32_t*>(ws + e) = *reinterpret_cast<const uint32_t*>(p.w + e);
  float* mult_s = reinterpret_cast<float*>(smem + p.off_aux);
  float* bias_s = mult_s + p.coutp;
  for (int c = threadIdx.x; c < p.coutp; c += THREADS) {
    mult_s[c] = c < p.Cout ? p.mult[c] : 0.0f;
    bias_s[c] = c < p.Cout ? p.bias[c] : 0.0f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // Where this lane's 8 k (4t..4t+3 and 16+4t..16+4t+3) lie in a pixel's
  // patch: dy rows down, then the byte of the 9-byte run; -1 past k = 26.
  int koff[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = (i < 4 ? 4 * t : 12 + 4 * t) + i;
    koff[i] = k < 27 ? (k / 9) * p.rs + k % 9 : -1;
  }
  // The B fragment of channel tile nt: row g of the packed weights, bytes
  // 4t.. and 16 + 4t..; the lane's two channels' multipliers and biases.
  auto b_frag = [&](int nt, int half) {
    return *reinterpret_cast<const uint32_t*>(ws + (nt * 8 + g) * K_DEPTH + 16 * half + 4 * t);
  };
  auto pair = [&](const float* v, int nt) {
    return *reinterpret_cast<const float2*>(v + nt * 8 + 2 * t);
  };
  uint32_t bq[NT ? NT : 1][2];
  float2 mq[NT ? NT : 1], cq[NT ? NT : 1];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    bq[nt][0] = b_frag(nt, 0);
    bq[nt][1] = b_frag(nt, 1);
    mq[nt] = pair(mult_s, nt);
    cq[nt] = pair(bias_s, nt);
  }
  const int groups = (p.Wo + 15) / 16;
  uint8_t* stage = smem + p.off_stage + warp * 16 * p.stage_stride;

  for (int mt = warp; mt < rows_out * groups; mt += WARPS) {
    const int rl = mt / groups, c0 = (mt - rl * groups) * 16;
    // Byte 0 of pixel c's patch: row 2*rl, column 2c-1.
    const uint8_t* base0 = smem + 2 * rl * p.rs + LEAD + 3 * (2 * (c0 + g) - 1);
    const uint8_t* base1 = base0 + 48;  // pixel c + 8
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        const uint8_t* base = px ? base1 : base0;
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int off = koff[4 * h + i];
          if (off >= 0) word |= static_cast<uint32_t>(base[off]) << (8 * i);
        }
        a[2 * h + px] = word;
      }
    }
    if constexpr (NT > 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        channel_tile(p, a, bq[nt][0], bq[nt][1], mq[nt], cq[nt], stage, nt * 8 + 2 * t, g);
    } else {
      for (int nt = 0; nt < p.coutp / 8; ++nt)
        channel_tile(p, a, b_frag(nt, 0), b_frag(nt, 1), pair(mult_s, nt), pair(bias_s, nt),
                     stage, nt * 8 + 2 * t, g);
    }
    __syncwarp();
    // The tile's pixels are contiguous in the output: one run of bytes.
    const int npix = min(16, p.Wo - c0);
    int8_t* dst = p.out + ((static_cast<int64_t>(b) * p.Ho + oh0 + rl) * p.Wo + c0) * p.Cout;
    if (p.Cout == p.coutp) {
      const int bytes = npix * p.Cout;
      switch (p.o_piece) {
        case 16: store_run<16>(stage, dst, bytes, lane); break;
        case 8: store_run<8>(stage, dst, bytes, lane); break;
        case 4: store_run<4>(stage, dst, bytes, lane); break;
        default: store_run<1>(stage, dst, bytes, lane); break;
      }
    } else {
      for (int e = lane; e < npix * p.Cout; e += 32) {
        const int px = e / p.Cout, co = e - px * p.Cout;
        dst[e] = static_cast<int8_t>(stage[px * p.stage_stride + co]);
      }
    }
    __syncwarp();
  }
}

}  // namespace

// w_packed: (Cout padded to 8, 32) int8 (ops/fused_block.py::pack_stem_weights).
extern "C" int spef_fused_stem(const uint8_t* x, const int8_t* w_packed, const float* mult,
                               const float* bias, int8_t* out, int B, int H, int W, int Cout,
                               float inv_step, float qmax, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0 || B > 65535 ||
      !(qmax >= 0.0f && qmax <= 255.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = x;
  p.w = w_packed;
  p.mult = mult;
  p.bias = bias;
  p.out = out;
  p.B = B;
  p.H = H;
  p.W = W;
  p.Cout = Cout;
  p.coutp = (Cout + 7) / 8 * 8;
  p.Ho = (H - 1) / 2 + 1;
  p.Wo = (W - 1) / 2 + 1;
  p.inv_step = inv_step;
  p.qmax = floorf(qmax);
  // A shared row holds column -1..W and every byte a 16-pixel tile past Wo reads.
  const int last_c = (p.Wo + 15) / 16 * 16 - 1;
  const int need = LEAD + 3 * W + 3 > 6 * last_c + 22 ? LEAD + 3 * W + 3 : 6 * last_c + 22;
  p.rs = (need + 15) / 16 * 16;
  const int64_t row_bytes = 3 * static_cast<int64_t>(W);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  p.x_piece = (row_bytes % 16 == 0 && xa % 16 == 0) ? 16 : (row_bytes % 4 == 0 && xa % 4 == 0 ? 4 : 1);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  p.o_piece = 16;
  while (p.o_piece > 1 && ((Cout % p.o_piece) || (oa % p.o_piece))) p.o_piece /= 2;
  p.stage_stride = p.coutp;  // staging rows as the output lays them out (Cout == coutp)
  size_t smem = 0;
  for (p.R = 4; p.R >= 1; --p.R) {
    p.off_w = (2 * p.R + 1) * p.rs;
    p.off_aux = p.off_w + p.coutp * K_DEPTH;
    p.off_stage = p.off_aux + 2 * p.coutp * 4;
    smem = static_cast<size_t>(p.off_stage) + WARPS * 16 * p.stage_stride;
    if (smem <= SMEM_MAX) break;
  }
  if (p.R < 1) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const Params) = stem_kernel<0>;
  switch (p.coutp / 8) {
    case 1: kernel = stem_kernel<1>; break;
    case 2: kernel = stem_kernel<2>; break;
    case 3: kernel = stem_kernel<3>; break;
    case 4: kernel = stem_kernel<4>; break;
    default: break;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.Ho + p.R - 1) / p.R, B);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
