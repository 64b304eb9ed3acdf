// K4: one inverted-residual block in one launch, for sm_90a:
// expand 1x1 -> depthwise 3x3 -> project 1x1 -> residual -> requant.
//
// Replaces spef_tpu/ops/pallas/fused_block.py::fused_mbconv (Pallas TPU
// kernel; bodies _mbconv_kernel and its width-packed form _mbconv_pm_body,
// which give the same bits).  Input (B, H, W, Cin) int8 values or uint8 bits
// (in_unsigned), output (B, Ho, Wo, Cout) int8, plain NHWC, Ho = (H-1)/s + 1:
//
//   hidden  with an expand: acc = x . w1 (exact, int32);
//           h = relu(acc * m1 + b1); on a hidden grid
//           h = clip(rint(h * inv_h), 0, qmax_h), else h stays float32.
//           Without an expand h is the decoded input.
//   dw      acc = sum over (dy, dx), in that order, of h[s*r-1+dy, s*c-1+dx] * w2
//           in float32, zeros of the HIDDEN tensor outside the image, each
//           product rounded before the add (inexact on a float32 h);
//           y = relu(acc * m2 + b2); on a depthwise grid
//           y = clip(rint(y * inv_d), 0, qmax_d).
//   project on a depthwise grid: p = sum over k of y[k] * w3[k], exact in
//           int32.  Otherwise y is rounded to bf16 and p is the float32 sum
//           of the exact products y[k] * w3[k] in the tensor core's order
//           (what jnp.dot(..., preferred_element_type=float32) promises);
//           pf = p * m3 + b3.
//   out     no residual: clip(rint(pf * ratio_out), qmin_o, qmax_o);
//           residual: q = clip(rint(pf * inv_sh), -qmax_sh-1, qmax_sh),
//           s = q + x (exact, never clamped to int8 in between), then
//           clip(rint(s * ratio_out), qmin_o, qmax_o), or clip(s, -128, 127)
//           when the consumer shares the step.
//
// Rounding is rintf (half to even); acc*mult then +bias with
// __fmul_rn/__fadd_rn, and the file is built with -fmad=false.  The hidden
// tensor and the depthwise output equal the plain PyTorch version's bit for
// bit; so does the output on a depthwise grid.  With a real-valued depthwise
// output the projection's sum may round otherwise than the plain version's
// k-ordered sum, which can move an output by one step where the value to be
// rounded sits on a tie (q of a residual block: the step is then one of the
// shared grid, up to ceil(ratio_out) output steps where ratio_out is above
// 1; ops/fused_block.py::fused_mbconv_rounding_input states the rule the
// checks apply).
//
// Bound on an H100 SXM: the bytes B*H*W*Cin in + B*Ho*Wo*Cout out (+ the
// weights) at 3.35 TB/s against the operations: the two products at the
// tensor rates and the nine taps at the float32 rate, which set the bound at
// most MobileNetV2 shapes.  In practice the kernel is held by the CUDA
// cores' operation rate (the expand's epilogue and the nine taps, neither of
// which may use a fused multiply-add), so the design spends its effort on
// the count of operations an element.  One block of 256 threads (8 warps)
// walks output tiles of one image each, as many blocks as the card holds:
//
//   * the int8 input tile with its halo comes in once by cp.async, 16 bytes
//     a piece where Cin allows (8 or 4 otherwise), zero-filled outside the
//     image and up to the mma depth; it stays for the residual, and the next
//     tile's arrives in a second buffer while this tile's last chunk runs;
//   * the hidden channels are walked in chunks of 32.  The weights of a
//     chunk (w1 as int8 with K = Cin innermost, w3 as bf16 or int8 with the
//     chunk's k innermost, the chunk's multipliers, biases and taps) are one
//     run of bytes laid out as shared memory holds them, packed once by
//     ops/fused_block.py::pack_mbconv_weights, and double-buffered: the next
//     chunk's arrive by cp.async, 16 bytes a piece, while this chunk's
//     depthwise runs;
//   * expand: mma.sync.m16n8k32 (s8.s8, or u8.s8 for uint8 bits), A = 16 halo
//     pixels x Cin by ldmatrix from the input tile, B = the w1 chunk; the
//     epilogue runs on the accumulator registers and writes the float32
//     chunk of the hidden tile to shared memory (zeros outside the image:
//     which pixels those are is worked out once a tile, not once a chunk);
//   * depthwise: a lane owns a channel, a warp a piece of four output rows
//     (two at stride 2, where four would leave warps idle, and beside more
//     than eight accumulator tiles, whose registers the larger patch needs),
//     two columns at a time from one patch held in registers: three loads
//     from shared memory an output at stride 1 with four rows, four with
//     two, not nine; it writes bf16 (uint8 on a grid) rows padded so that
//     ldmatrix reads them without bank conflicts;
//   * project: mma.sync.m16n8k16 bf16 x bf16 -> float32 (m16n8k32 u8.s8 ->
//     int32 on a grid), accumulated in registers across the chunks, so only
//     one chunk of the depthwise output is ever in shared memory.  The 8
//     warps form a wm x wn grid over (16-pixel tiles, 8-channel tiles); a
//     warp holds MI x NI accumulator tiles, and the launcher picks the
//     smallest of four instantiations that covers the tile.  The fragments
//     of four channel tiles are loaded before their products start;
//   * the projection of chunk n-1 runs together with the expand of
//     chunk n (they touch different buffers): two barriers a chunk;
//   * the epilogue runs on the accumulator registers (one formula for the
//     three output cases: the launcher folds them into two scale-and-clip
//     steps), writes int8 to staging rows over the hidden chunk, and the
//     block stores them to the output in whole 16-byte pieces where Cout
//     allows.
//
// The hidden tensor never reaches device memory.  mma.sync is used for both
// products; wgmma and TMA are not (the M of a tile, at most 96-256 pixels
// in 16-pixel pieces spread over 8 warps, and its boxes with a halo do not
// fill them).  The tile (th, tw) is chosen by
// ops/fused_block.py::choose_mbconv_tile and checked here.

#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CK = 32;        // hidden channels a chunk: one a lane, one mma k-step of int8
constexpr int HS = CK + 8;    // floats a row of the hidden chunk (conflict-free float2 stores)
constexpr int ROW_PAD = 16;   // bytes added to a row that ldmatrix reads: stride = 16 mod 32
constexpr int AUX_ROWS = 13;  // m1, b1, m2, b2 and the nine taps of w2, CK floats each, a chunk
constexpr int AUX_BYTES = AUX_ROWS * CK * 4;
constexpr size_t SMEM_MAX = 232448;  // 227 KB: the most a block may use
constexpr int DW4_ACC_TILES = 8;     // the four-row depthwise runs beside at most this many
                                     // accumulator tiles a warp

enum OutMode { OUT_PLAIN = 0, OUT_RES_RATIO = 1, OUT_RES_SAME = 2 };  // of the C interface
enum AuxRow { AUX_M1 = 0, AUX_B1 = 1, AUX_M2 = 2, AUX_B2 = 3, AUX_W2 = 4 };

struct Params {
  const int8_t* x;
  // [chunk][blob_bytes]: a chunk's w1 rows ([CK][kpad + ROW_PAD] int8), w3 rows
  // ([coutp][CK bf16, or int8 on a depthwise grid, + ROW_PAD]) and small
  // operands ([AUX_ROWS][CK] float32), as they lie in shared memory.
  const uint8_t* wblob;
  const float* aux3;   // [2][coutp] float32: m3, b3
  int8_t* out;
  int B, H, W, Cin, Ch, Cout, stride, Ho, Wo;
  int th, tw, ih, iw, nty, ntx;  // output tile, its input tile with halo, tiles an image
  int tiles;                     // B * nty * ntx: the blocks walk them, gridDim.x apart
  int kpad, xs_stride;           // Cin padded to the mma depth; bytes a row of the input tile
  int xs_bytes, xs_bufs;         // bytes of an input tile; two of them with a residual
  uint32_t iw_magic, tw_magic, xp_magic, op_magic;  // fast_div by iw, tw, pieces a pixel in, out
  int nchunks, coutp;
  int wm, wn, mtiles, ntiles;    // warp grid of the projection; 16-pixel and 8-channel tiles
  int dw_rows, seg, nseg;        // depthwise: rows and columns a warp walks, pieces a row
  int dws, w3s_stride;           // bytes a row of the depthwise chunk / of the w3 chunk
  int x_piece;                   // bytes a cp.async of the input may move (0: byte loads)
  int o_piece;                   // bytes a store of the output may move
  int off_wb, blob_bytes, w1s_bytes, w3s_bytes;  // weight buffers; w3 and aux follow w1 in one
  int off_hid, off_dwo, off_aux3;
  int in_unsigned, expand, hidden_grid, dw_grid, residual;
  float inv_h, qmax_h, inv_d, qmax_d;
  // out = clip(rint(pf * scale1), lo1, hi1); with a residual the input is
  // added to it and the sum goes through clip(rint(. * scale2), lo2, hi2).
  float scale1, lo1, hi1, scale2, lo2, hi2;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// D (16x8 int32) += A (16x32 int8 or uint8, rows) x B (32x8 int8, columns).
__device__ __forceinline__ void mma_s8(uint32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1, bool a_unsigned) {
  if (a_unsigned) {
    asm(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// D (16x8 float32, kept as bits) += A (16x16 bf16, rows) x B (16x8 bf16, columns).
__device__ __forceinline__ void mma_bf16(uint32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BYTES from global to shared memory, asynchronously; src_bytes 0 writes zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, uint32_t src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// n / d for n * d < 2^32, with magic = 2^32 / d + 1 (0 stands for d = 1).
__device__ __forceinline__ int fast_div(int n, uint32_t magic) {
  return magic == 0 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), magic));
}

// Where a tile lies: the image, the first output pixel, the first halo pixel.
struct Tile {
  int64_t b;
  int oh0, ow0, ih0, iw0;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  Tile tl;
  const int tx = t % p.ntx;
  t /= p.ntx;
  tl.b = t / p.nty;
  tl.oh0 = (t % p.nty) * p.th;
  tl.ow0 = tx * p.tw;
  tl.ih0 = tl.oh0 * p.stride - 1;
  tl.iw0 = tl.ow0 * p.stride - 1;
  return tl;
}

// The input tile with its halo: kpad bytes a pixel, zeros outside the image
// and from Cin up to kpad.
template <int PIECE>
__device__ __forceinline__ void load_tile_async(const Params& p, uint32_t xs, const Tile& tl,
                                                int PH) {
  const int pieces = p.kpad / PIECE;
  for (int e = threadIdx.x; e < PH * pieces; e += THREADS) {
    const int pix = fast_div(e, p.xp_magic), k = (e - pix * pieces) * PIECE;
    const int row = fast_div(pix, p.iw_magic);
    const int r = tl.ih0 + row, c = tl.iw0 + pix - row * p.iw;
    const bool ok = k < p.Cin && r >= 0 && r < p.H && c >= 0 && c < p.W;
    const int8_t* src = ok ? p.x + ((tl.b * p.H + r) * p.W + c) * p.Cin + k : p.x;
    cp_async<PIECE>(xs + pix * p.xs_stride + k, src, ok ? PIECE : 0);
  }
}

__device__ __forceinline__ void load_tile(const Params& p, int8_t* xs, const Tile& tl, int PH) {
  const uint32_t xs_a = smem_u32(xs);
  if (p.x_piece == 16) {
    load_tile_async<16>(p, xs_a, tl, PH);
  } else if (p.x_piece == 8) {
    load_tile_async<8>(p, xs_a, tl, PH);
  } else if (p.x_piece == 4) {
    load_tile_async<4>(p, xs_a, tl, PH);
  } else {
    for (int e = threadIdx.x; e < PH * p.kpad; e += THREADS) {
      const int pix = e / p.kpad, k = e % p.kpad;
      const int r = tl.ih0 + pix / p.iw, c = tl.iw0 + pix % p.iw;
      int8_t v = 0;
      if (k < p.Cin && r >= 0 && r < p.H && c >= 0 && c < p.W)
        v = p.x[((tl.b * p.H + r) * p.W + c) * p.Cin + k];
      xs[pix * p.xs_stride + k] = v;
    }
  }
}

// The weights of hidden chunk n into weight buffer buf: one blob, laid out
// as shared memory holds it, 16 bytes a piece.
__device__ __forceinline__ void prefetch_weights(const Params& p, unsigned char* smem, int n,
                                                 int buf) {
  const uint8_t* src = p.wblob + static_cast<int64_t>(n) * p.blob_bytes;
  const uint32_t dst = smem_u32(smem + p.off_wb + buf * p.blob_bytes);
  for (int e = threadIdx.x * 16; e < p.blob_bytes; e += THREADS * 16)
    cp_async<16>(dst + e, src + e, 16);
}

// The projection of one chunk, accumulated into acc: A from the depthwise
// chunk at dwo_a, B from the w3 chunk at w3_a (shared-memory addresses).
// The B fragments of four channel tiles are loaded before their products
// start, so that a warp does not wait load by load.
template <int MI, int NI>
__device__ __forceinline__ void project_chunk(const Params& p, uint32_t (&acc)[MI][NI][4],
                                              uint32_t dwo_a, uint32_t w3_a, int wm_i, int wn_i,
                                              int lane) {
  constexpr int JB = 4;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int mt = wm_i + p.wm * i;
    if (mt >= p.mtiles) continue;
    const uint32_t a_addr = dwo_a + (mt * 16 + (lane & 15)) * p.dws + (lane >> 4) * 16;
    if (p.dw_grid) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr);
      const uint32_t b_addr = w3_a + (lane & 7) * p.w3s_stride + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int j0 = 0; j0 < NI; j0 += JB) {
        uint32_t bq[JB][2];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          const int nt = wn_i * NI + j0 + jj;
          if (j0 + jj < NI && nt < p.ntiles) ldmatrix_x2(bq[jj], b_addr + nt * 8 * p.w3s_stride);
        }
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          if (j0 + jj < NI && wn_i * NI + j0 + jj < p.ntiles)
            mma_s8(acc[i][j0 + jj], a, bq[jj][0], bq[jj][1], true);
        }
      }
    } else {
      uint32_t a0[4], a1[4];
      ldmatrix_x4(a0, a_addr);
      ldmatrix_x4(a1, a_addr + 32);
      const uint32_t b_addr = w3_a + (lane & 7) * p.w3s_stride + (lane >> 3) * 16;
#pragma unroll
      for (int j0 = 0; j0 < NI; j0 += JB) {
        uint32_t bq[JB][4];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          const int nt = wn_i * NI + j0 + jj;
          if (j0 + jj < NI && nt < p.ntiles) ldmatrix_x4(bq[jj], b_addr + nt * 8 * p.w3s_stride);
        }
        // Every sum takes its k = 0..15 product before its k = 16..31 product.
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          if (j0 + jj < NI && wn_i * NI + j0 + jj < p.ntiles)
            mma_bf16(acc[i][j0 + jj], a0, bq[jj][0], bq[jj][1]);
        }
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          if (j0 + jj < NI && wn_i * NI + j0 + jj < p.ntiles)
            mma_bf16(acc[i][j0 + jj], a1, bq[jj][2], bq[jj][3]);
        }
      }
    }
  }
}

// The finished tile from its staging rows to the output, PIECE bytes a store.
template <int PIECE>
__device__ __forceinline__ void store_tile(const Params& p, const unsigned char* stage,
                                           const Tile& tl, int PO) {
  const int pieces = p.Cout / PIECE;
  for (int e = threadIdx.x; e < PO * pieces; e += THREADS) {
    const int op = fast_div(e, p.op_magic), k = (e - op * pieces) * PIECE;
    const int r = fast_div(op, p.tw_magic), c = op - r * p.tw;
    const int oh = tl.oh0 + r, ow = tl.ow0 + c;
    if (oh >= p.Ho || ow >= p.Wo) continue;
    const unsigned char* src = stage + op * p.coutp + k;
    int8_t* dst = p.out + ((tl.b * p.Ho + oh) * p.Wo + ow) * p.Cout + k;
    if constexpr (PIECE == 16) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else if constexpr (PIECE == 8) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    } else if constexpr (PIECE == 4) {
      *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
    } else if constexpr (PIECE == 2) {
      *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
    } else {
      *dst = static_cast<int8_t>(*src);
    }
  }
}

// Which of a thread's halo pixels lie inside the image: bit 2 * k + half for
// the k-th 16-pixel tile of its warp in the expand, rows g and g + 8.  The
// same for every chunk of a tile, so it is worked out once a tile.
__device__ __forceinline__ uint32_t inside_bits(const Params& p, const Tile& tl, int PH, int warp,
                                                int lane) {
  uint32_t bits = 0;
  int k = 0;
  for (int mt = warp; mt * 16 < PH; mt += WARPS, ++k) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pix = mt * 16 + (lane >> 2) + half * 8;
      const int row = fast_div(pix, p.iw_magic);
      const int r = tl.ih0 + row, c = tl.iw0 + pix - row * p.iw;
      if (pix < PH && r >= 0 && r < p.H && c >= 0 && c < p.W) bits |= 1u << (2 * k + half);
    }
  }
  return bits;
}

// The expand of one hidden chunk on the int8 tensor cores: every halo pixel
// of the tile x CK hidden channels, 16 pixels a warp at a time; the epilogue
// runs on the accumulators and writes float32 to hid.
template <bool UNSIGNED, bool GRID>
__device__ __forceinline__ void expand_chunk(const Params& p, uint32_t inside, uint32_t xs_a,
                                             uint32_t w1_a, const float* __restrict__ aux,
                                             float* __restrict__ hid, int PH, int warp,
                                             int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int ksteps = p.kpad / 32;
  float2 m1v[4], b1v[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    m1v[nt] = *reinterpret_cast<const float2*>(aux + AUX_M1 * CK + nt * 8 + tig * 2);
    b1v[nt] = *reinterpret_cast<const float2*>(aux + AUX_B1 * CK + nt * 8 + tig * 2);
  }
  // One x4 gives two channel tiles: (tile, k low), (tile, k high), twice.
  const uint32_t b_addr =
      w1_a + ((lane >> 4) * 8 + (lane & 7)) * p.xs_stride + ((lane >> 3) & 1) * 16;
  for (int mt = warp; mt * 16 < PH; mt += WARPS, inside >>= 2) {
    uint32_t hacc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[nt][e] = 0u;
    // Rows past the tile read its last pixel; their sums are dropped.
    const uint32_t a_addr =
        xs_a + min(mt * 16 + (lane & 15), PH - 1) * p.xs_stride + (lane >> 4) * 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[4], b01[4], b23[4];
      ldmatrix_x4(a, a_addr + ks * 32);
      ldmatrix_x4(b01, b_addr + ks * 32);
      ldmatrix_x4(b23, b_addr + 16 * p.xs_stride + ks * 32);
      mma_s8(hacc[0], a, b01[0], b01[1], UNSIGNED);
      mma_s8(hacc[1], a, b01[2], b01[3], UNSIGNED);
      mma_s8(hacc[2], a, b23[0], b23[1], UNSIGNED);
      mma_s8(hacc[3], a, b23[2], b23[3], UNSIGNED);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pix = mt * 16 + g + half * 8;
      if (pix >= PH) continue;
      float* dst = hid + pix * HS + tig * 2;
      if (!((inside >> half) & 1u)) {
        // The halo is zeros of the hidden tensor, not relu(b1).
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(dst + nt * 8) = make_float2(0.0f, 0.0f);
        continue;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float a0 = static_cast<float>(static_cast<int32_t>(hacc[nt][half * 2]));
        const float a1 = static_cast<float>(static_cast<int32_t>(hacc[nt][half * 2 + 1]));
        float2 h;
        h.x = fmaxf(__fadd_rn(__fmul_rn(a0, m1v[nt].x), b1v[nt].x), 0.0f);
        h.y = fmaxf(__fadd_rn(__fmul_rn(a1, m1v[nt].y), b1v[nt].y), 0.0f);
        if constexpr (GRID) {
          h.x = clampf(rintf(__fmul_rn(h.x, p.inv_h)), 0.0f, p.qmax_h);
          h.y = clampf(rintf(__fmul_rn(h.y, p.inv_h)), 0.0f, p.qmax_h);
        }
        *reinterpret_cast<float2*>(dst + nt * 8) = h;
      }
    }
  }
}

template <bool UNSIGNED>
__device__ __forceinline__ void expand_chunk(const Params& p, uint32_t inside, uint32_t xs_a,
                                             uint32_t w1_a, const float* aux, float* hid, int PH,
                                             int warp, int lane) {
  if (p.hidden_grid) {
    expand_chunk<UNSIGNED, true>(p, inside, xs_a, w1_a, aux, hid, PH, warp, lane);
  } else {
    expand_chunk<UNSIGNED, false>(p, inside, xs_a, w1_a, aux, hid, PH, warp, lane);
  }
}

// Without an expand the hidden chunk is the decoded input: four channels a
// thread, a word read and a float4 written.
__device__ __forceinline__ void decode_chunk(const Params& p, const int8_t* xs, float* hid,
                                             int c0, int PH) {
  for (int e = threadIdx.x; e < PH * (CK / 4); e += THREADS) {
    const int pix = e >> 3, q = (e & 7) * 4;
    const uint32_t wd = *reinterpret_cast<const uint32_t*>(xs + pix * p.xs_stride + c0 + q);
    float4 v;
    if (p.in_unsigned) {
      v = make_float4(static_cast<float>(wd & 255u), static_cast<float>((wd >> 8) & 255u),
                      static_cast<float>((wd >> 16) & 255u), static_cast<float>(wd >> 24));
    } else {
      v = make_float4(static_cast<float>(static_cast<int8_t>(wd)),
                      static_cast<float>(static_cast<int8_t>(wd >> 8)),
                      static_cast<float>(static_cast<int8_t>(wd >> 16)),
                      static_cast<float>(static_cast<int8_t>(wd >> 24)));
    }
    *reinterpret_cast<float4*>(hid + pix * HS + q) = v;
  }
}

// The depthwise of one hidden chunk: a lane owns a channel, a warp a piece
// of ROWS output rows, ROWS x 2 outputs at a time from one patch of the
// hidden tile, ((ROWS - 1) * S + 3) x (S + 3): that many sums in flight, four
// shared-memory loads an output at stride 1 with two rows and three with
// four.  Each sum keeps the (dy, dx) order, every product rounded before
// its add.  GRID: the output goes to the depthwise grid as uint8, else it
// is rounded to bf16.
template <int S, int ROWS, bool GRID>
__device__ __forceinline__ void depthwise_chunk(const Params& p, const float* __restrict__ aux,
                                                const float* __restrict__ hid,
                                                unsigned char* __restrict__ dwo, int warp,
                                                int lane) {
  constexpr int NPR = (ROWS - 1) * S + 3, NPC = S + 3;  // rows and columns of the patch
  constexpr int OB = GRID ? 1 : 2;                      // bytes an output
  float wv[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) wv[i] = aux[(AUX_W2 + i) * CK + lane];
  const float m2 = aux[AUX_M2 * CK + lane], b2 = aux[AUX_B2 * CK + lane];
  const int row_f = p.iw * HS;  // floats a row of the hidden tile
  const int out_row = p.tw * p.dws;  // bytes a row of outputs
  const int groups = (p.th + ROWS - 1) / ROWS;
  for (int u = warp; u < groups * p.nseg; u += WARPS) {
    const int rp = u / p.nseg, cs = (u - rp * p.nseg) * p.seg;
    const int r0 = ROWS * rp;
    const int cols = min(p.seg, p.tw - cs);
    // The patch rows; the rows of a missing output row read the last row again.
    const float* src[NPR];
#pragma unroll
    for (int d = 0; d < NPR; ++d)
      src[d] = hid + min(r0 * S + d, p.ih - 1) * row_f + cs * S * HS + lane;
    unsigned char* dst = dwo + (r0 * p.tw + cs) * p.dws + lane * OB;  // output (r0, cs)
    bool row_ok[ROWS];
#pragma unroll
    for (int orow = 0; orow < ROWS; ++orow) row_ok[orow] = r0 + orow < p.th;
    for (int j0 = 0; j0 < cols; j0 += 2, dst += 2 * p.dws) {
      // A second output column past the piece reads on into the tile (or,
      // at its last column, two pixels past the row: still this block's
      // shared memory); its sums are dropped.
      float k[NPR][NPC];
#pragma unroll
      for (int d = 0; d < NPR; ++d) {
#pragma unroll
        for (int q = 0; q < NPC; ++q) k[d][q] = src[d][q * HS];
        src[d] += 2 * S * HS;
      }
      float a[ROWS][2];
#pragma unroll
      for (int orow = 0; orow < ROWS; ++orow) a[orow][0] = a[orow][1] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int orow = 0; orow < ROWS; ++orow)
#pragma unroll
            for (int ocol = 0; ocol < 2; ++ocol)
              a[orow][ocol] = __fadd_rn(
                  a[orow][ocol], __fmul_rn(k[orow * S + dy][ocol * S + dx], wv[dy * 3 + dx]));
      const bool col1_ok = j0 + 1 < cols;
#pragma unroll
      for (int orow = 0; orow < ROWS; ++orow) {
#pragma unroll
        for (int ocol = 0; ocol < 2; ++ocol) {
          float y = fmaxf(__fadd_rn(__fmul_rn(a[orow][ocol], m2), b2), 0.0f);
          unsigned char* o = dst + orow * out_row + ocol * p.dws;
          const bool ok = row_ok[orow] && (ocol == 0 || col1_ok);
          if constexpr (GRID) {
            y = clampf(rintf(__fmul_rn(y, p.inv_d)), 0.0f, p.qmax_d);
            if (ok) *o = static_cast<unsigned char>(static_cast<int>(y));
          } else {
            if (ok) *reinterpret_cast<__nv_bfloat16*>(o) = __float2bfloat16_rn(y);
          }
        }
      }
    }
  }
}

template <int S, int ROWS>
__device__ __forceinline__ void depthwise_chunk(const Params& p, const float* aux,
                                                const float* hid, unsigned char* dwo, int warp,
                                                int lane) {
  if (p.dw_grid) {
    depthwise_chunk<S, ROWS, true>(p, aux, hid, dwo, warp, lane);
  } else {
    depthwise_chunk<S, ROWS, false>(p, aux, hid, dwo, warp, lane);
  }
}

// Blocks an SM the registers must allow: two (128 registers a thread: the
// tiles that pay take about half an SM's shared memory), one of the largest
// instantiation.
template <int MI, int NI>
__global__ void __launch_bounds__(THREADS, MI == 3 ? 1 : 2)
mbconv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hid = reinterpret_cast<float*>(smem + p.off_hid);      // [PH][HS]
  unsigned char* stage = smem + p.off_hid;                      // [PO][coutp], after the chunks
  unsigned char* dwo = smem + p.off_dwo;                        // [mtiles * 16][dws]
  const float* m3s = reinterpret_cast<const float*>(smem + p.off_aux3);
  const float* b3s = m3s + p.coutp;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int PH = p.ih * p.iw, PO = p.th * p.tw;
  const uint32_t dwo_a = smem_u32(dwo);
  const uint32_t wb_a = smem_u32(smem + p.off_wb);  // w1 rows; w3 rows and aux follow
  const int wm_i = warp / p.wn, wn_i = warp % p.wn;
  // One chunk of weights never changes: it is loaded once.  Otherwise the
  // chunks alternate between two buffers, across tiles too.
  const bool rotate = p.nchunks > 1;

  // ---- the first tile's input, the first chunk's weights, m3 and b3.
  int t = blockIdx.x;
  load_tile(p, reinterpret_cast<int8_t*>(smem), tile_at(p, t), PH);
  prefetch_weights(p, smem, 0, 0);
  for (int e = tid; e < p.coutp / 2; e += THREADS)
    cp_async<16>(smem_u32(smem + p.off_aux3) + e * 16,
                 reinterpret_cast<const unsigned char*>(p.aux3) + e * 16, 16);
  cp_async_commit();

  int wbuf = 0;  // the weight buffer of the chunk at hand
  int xbuf = 0;  // the input buffer of the tile at hand (two only with a residual)
  for (; t < p.tiles; t += gridDim.x) {
    const Tile tl = tile_at(p, t);
    int8_t* xs = reinterpret_cast<int8_t*>(smem) + xbuf * p.xs_bytes;  // [PH][xs_stride]
    const uint32_t xs_a = smem_u32(xs);
    cp_async_wait_all();
    __syncthreads();  // this tile's input is whole; the tile before has left its staging rows

    const uint32_t inside = p.expand ? inside_bits(p, tl, PH, warp, lane) : 0u;
    uint32_t acc[MI][NI][4];  // float32 bits, or int32 on a depthwise grid
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0u;

    // ---- hidden channels in chunks of CK: expand -> depthwise -> project.
    for (int n = 0; n < p.nchunks; ++n) {
      const int wb_off = wbuf * p.blob_bytes;
      const float* aux = reinterpret_cast<const float*>(smem + p.off_wb + wb_off + p.w1s_bytes +
                                                        p.w3s_bytes);
      if (p.expand && p.in_unsigned) {
        expand_chunk<true>(p, inside, xs_a, wb_a + wb_off, aux, hid, PH, warp, lane);
      } else if (p.expand) {
        expand_chunk<false>(p, inside, xs_a, wb_a + wb_off, aux, hid, PH, warp, lane);
      } else {
        decode_chunk(p, xs, hid, n * CK, PH);
      }
      if (n > 0)
        project_chunk<MI, NI>(p, acc, dwo_a, wb_a + (wbuf ^ 1) * p.blob_bytes + p.w1s_bytes, wm_i,
                              wn_i, lane);
      __syncthreads();  // the hidden chunk is whole; the chunk before is projected

      // While the depthwise runs: the next chunk's weights, and after the
      // last expand of this tile the next tile's input (into the other
      // buffer where the epilogue still reads this one for the residual).
      const bool last = n + 1 == p.nchunks;
      const bool more = !last || t + static_cast<int>(gridDim.x) < p.tiles;
      if (rotate && more) prefetch_weights(p, smem, last ? 0 : n + 1, wbuf ^ 1);
      cp_async_commit();
      if (last && more) {
        xbuf ^= p.xs_bufs - 1;
        load_tile(p, reinterpret_cast<int8_t*>(smem) + xbuf * p.xs_bytes,
                  tile_at(p, t + gridDim.x), PH);
      }
      cp_async_commit();
      if (p.stride == 2) {
        depthwise_chunk<2, 2>(p, aux, hid, dwo, warp, lane);
      } else if (p.dw_rows == 2) {
        depthwise_chunk<1, 2>(p, aux, hid, dwo, warp, lane);
      } else if constexpr (MI * NI <= DW4_ACC_TILES) {
        depthwise_chunk<1, 4>(p, aux, hid, dwo, warp, lane);
      }
      // The weights must be whole; the next tile's input may still fly.
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();  // the depthwise chunk and the next chunk's weights are whole
      if (rotate) wbuf ^= 1;
    }
    // After the flip the last chunk's w3 is in the other buffer when the
    // buffers rotate, else in the only one.
    project_chunk<MI, NI>(p, acc, dwo_a,
                          wb_a + (rotate ? wbuf ^ 1 : 0) * p.blob_bytes + p.w1s_bytes, wm_i, wn_i,
                          lane);

    // ---- epilogue on the accumulator registers, residual from the input
    // tile; the int8 results go to staging rows over the hidden chunk (its
    // last reader, the depthwise, is past a barrier) and from there to the
    // output in whole pieces.
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int mt = wm_i + p.wm * i;
      if (mt >= p.mtiles) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int op = mt * 16 + g + half * 8;
        if (op >= PO) continue;
        const int r = fast_div(op, p.tw_magic), c = op - r * p.tw;
        // Residual blocks have stride 1: the input pixel sits one halo in.
        // Its row has kpad >= coutp bytes, so a padded channel reads inside it.
        const int8_t* res = xs + ((r + 1) * p.iw + (c + 1)) * p.xs_stride;
        unsigned char* row = stage + op * p.coutp;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int nt = wn_i * NI + j;
          if (nt >= p.ntiles) continue;
          const int co = nt * 8 + tig * 2;  // below coutp: m3s, b3s are padded with zeros
          uint32_t v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t bits = acc[i][j][half * 2 + e];
            const float sum = p.dw_grid ? static_cast<float>(static_cast<int32_t>(bits))
                                        : __uint_as_float(bits);
            const float pf = __fadd_rn(__fmul_rn(sum, m3s[co + e]), b3s[co + e]);
            float o = clampf(rintf(__fmul_rn(pf, p.scale1)), p.lo1, p.hi1);
            if (p.residual) {
              // An exact sum on the shared grid, never clamped to int8 in between.
              const float s = __fadd_rn(o, static_cast<float>(res[co + e]));
              o = clampf(rintf(__fmul_rn(s, p.scale2)), p.lo2, p.hi2);
            }
            v[e] = static_cast<uint32_t>(static_cast<int>(o)) & 255u;
          }
          *reinterpret_cast<uint16_t*>(row + co) = static_cast<uint16_t>(v[0] | v[1] << 8);
        }
      }
    }
    __syncthreads();  // the staging rows are whole
    if (p.o_piece == 16) {
      store_tile<16>(p, stage, tl, PO);
    } else if (p.o_piece == 8) {
      store_tile<8>(p, stage, tl, PO);
    } else if (p.o_piece == 4) {
      store_tile<4>(p, stage, tl, PO);
    } else if (p.o_piece == 2) {
      store_tile<2>(p, stage, tl, PO);
    } else {
      store_tile<1>(p, stage, tl, PO);
    }
  }
}

inline int align16(int n) { return (n + 15) / 16 * 16; }

inline uint32_t magic_of(int d) {
  return d < 2 ? 0u : static_cast<uint32_t>((1ull << 32) / static_cast<unsigned>(d) + 1);
}

// The warp grid and accumulator tiles of the projection for `pixels` output
// pixels a tile: the first of the four instantiations whose wm x wn warps,
// MI x NI tiles each, cover (pixels / 16, Cout / 8).  Returns false if none.
bool warp_grid(int pixels, int coutp, int& mi, int& ni, int& wm, int& wn) {
  static const int variants[4][2] = {{1, 4}, {2, 4}, {2, 6}, {3, 10}};
  const int mtiles = (pixels + 15) / 16, ntiles = coutp / 8;
  for (const auto& v : variants) {
    int n = 1;
    while (n * v[1] < ntiles) n *= 2;
    if (n > WARPS) continue;
    if (mtiles <= (WARPS / n) * v[0]) {
      mi = v[0]; ni = v[1]; wn = n; wm = WARPS / n;
      return true;
    }
  }
  return false;
}

// Fills the tile fields of p; returns the shared memory one block needs.
// acc_tiles: the accumulator tiles a warp holds (MI x NI of the instantiation).
size_t layout(Params& p, int acc_tiles) {
  p.ih = (p.th - 1) * p.stride + 3;
  p.iw = (p.tw - 1) * p.stride + 3;
  p.nty = (p.Ho + p.th - 1) / p.th;
  p.ntx = (p.Wo + p.tw - 1) / p.tw;
  const int PH = p.ih * p.iw;
  p.kpad = (p.Cin + 31) / 32 * 32;
  p.xs_stride = p.kpad + ROW_PAD;
  p.nchunks = (p.Ch + CK - 1) / CK;
  p.coutp = (p.Cout + 7) / 8 * 8;
  p.mtiles = (p.th * p.tw + 15) / 16;
  p.ntiles = p.coutp / 8;
  // The depthwise walks groups of rows, four at stride 1 where that still
  // gives every warp a piece and the accumulators leave the registers for
  // the larger patch, else two; a row is cut so that every warp has one.
  for (const int rows : {4, 2}) {
    const int groups = (p.th + rows - 1) / rows;
    p.dw_rows = rows;
    p.nseg = groups >= WARPS ? 1 : (WARPS + groups - 1) / groups;
    if (p.nseg > (p.tw + 1) / 2) p.nseg = (p.tw + 1) / 2;
    p.seg = ((p.tw + p.nseg - 1) / p.nseg + 1) / 2 * 2;  // even: outputs go two columns at a time
    p.nseg = (p.tw + p.seg - 1) / p.seg;
    if (p.stride == 1 && acc_tiles <= DW4_ACC_TILES && groups * p.nseg >= WARPS) break;
  }
  const int row_bytes = p.dw_grid ? CK : 2 * CK;
  p.dws = row_bytes + ROW_PAD;
  p.w3s_stride = row_bytes + ROW_PAD;
  p.w1s_bytes = p.expand ? CK * p.xs_stride : 0;
  p.w3s_bytes = p.coutp * p.w3s_stride;
  p.blob_bytes = p.w1s_bytes + p.w3s_bytes + AUX_BYTES;
  p.iw_magic = magic_of(p.iw);
  p.tw_magic = magic_of(p.tw);
  p.xp_magic = magic_of(p.x_piece ? p.kpad / p.x_piece : 1);
  p.op_magic = magic_of(p.Cout / p.o_piece);
  p.xs_bytes = align16(PH * p.xs_stride);
  p.xs_bufs = p.residual ? 2 : 1;
  p.off_wb = p.xs_bufs * p.xs_bytes;
  p.off_hid = p.off_wb + 2 * p.blob_bytes;
  // Two pixels past the last row may be read by the depthwise (never used);
  // the finished tile's staging rows lie over the hidden chunk.
  const int hid_bytes = align16(PH * HS * 4 + 2 * HS * 4);
  const int stage_bytes = align16(p.th * p.tw * p.coutp);
  p.off_dwo = p.off_hid + (hid_bytes > stage_bytes ? hid_bytes : stage_bytes);
  p.off_aux3 = p.off_dwo + p.mtiles * 16 * p.dws;
  return static_cast<size_t>(p.off_aux3) + p.coutp * 8;
}

template <int MI, int NI>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(mbconv_kernel<MI, NI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_MAX));
  if (err != cudaSuccess) return err;
  // As many blocks as the card holds at once; each walks tiles gridDim.x apart.
  int dev = 0, sms = 0, resident = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, mbconv_kernel<MI, NI>, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidValue;
  const int64_t slots = static_cast<int64_t>(sms) * resident;
  const unsigned blocks = static_cast<unsigned>(p.tiles < slots ? p.tiles : slots);
  mbconv_kernel<MI, NI><<<blocks, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// wblob, aux3: the packed operands of ops/fused_block.py::pack_mbconv_weights
// (wblob holds w1 rows only with an expand, and w3 as int8 when dw_grid, else
// bf16).  th, tw: the output tile of ops/fused_block.py::choose_mbconv_tile.
extern "C" int spef_fused_mbconv(
    const int8_t* x, int in_unsigned, const void* wblob, const float* aux3, int8_t* out, int B,
    int H, int W, int Cin, int Ch, int Cout, int stride, int expand, int hidden_grid, float inv_h,
    float qmax_h, int dw_grid, float inv_d, float qmax_d, int out_mode, float inv_sh,
    float qmax_sh, float ratio_out, float qmin_o, float qmax_o, int th, int tw, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ch <= 0 || Cout <= 0 ||
      (stride != 1 && stride != 2) || out_mode < OUT_PLAIN || out_mode > OUT_RES_SAME)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!expand && Ch != Cin) return static_cast<int>(cudaErrorInvalidValue);
  if (out_mode != OUT_PLAIN && (stride != 1 || Cin != Cout || in_unsigned))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {wblob, static_cast<const void*>(aux3)})
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);

  Params p{};
  p.x = x; p.wblob = static_cast<const uint8_t*>(wblob); p.aux3 = aux3; p.out = out;
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Ch = Ch; p.Cout = Cout; p.stride = stride;
  p.Ho = (H - 1) / stride + 1;
  p.Wo = (W - 1) / stride + 1;
  p.in_unsigned = in_unsigned; p.expand = expand != 0;
  p.hidden_grid = hidden_grid; p.dw_grid = dw_grid; p.residual = out_mode != OUT_PLAIN;
  p.inv_h = inv_h; p.qmax_h = qmax_h; p.inv_d = inv_d; p.qmax_d = qmax_d;
  if (out_mode == OUT_PLAIN) {
    p.scale1 = ratio_out; p.lo1 = qmin_o; p.hi1 = qmax_o;
    p.scale2 = 1.0f; p.lo2 = qmin_o; p.hi2 = qmax_o;
  } else {
    p.scale1 = inv_sh; p.lo1 = -qmax_sh - 1.0f; p.hi1 = qmax_sh;
    // The same step: the sum is an integer, so rint(sum * 1) only clips it.
    const bool same = out_mode == OUT_RES_SAME;
    p.scale2 = same ? 1.0f : ratio_out;
    p.lo2 = same ? -128.0f : qmin_o;
    p.hi2 = same ? 127.0f : qmax_o;
  }
  if (th < 1 || tw < 1 || th > p.Ho || tw > p.Wo) return static_cast<int>(cudaErrorInvalidValue);
  p.th = th;
  p.tw = tw;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), oa = reinterpret_cast<uintptr_t>(out);
  p.x_piece = 0;
  for (const int piece : {16, 8, 4}) {
    if (Cin % piece == 0 && xa % piece == 0) {
      p.x_piece = piece;
      break;
    }
  }
  p.o_piece = 1;
  for (const int piece : {16, 8, 4, 2}) {
    if (Cout % piece == 0 && oa % piece == 0) {
      p.o_piece = piece;
      break;
    }
  }

  int mi = 0, ni = 0;
  if (!warp_grid(th * tw, (Cout + 7) / 8 * 8, mi, ni, p.wm, p.wn))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layout(p, mi * ni);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = static_cast<int64_t>(B) * p.nty * p.ntx;
  if (tiles > 0x3fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mi == 1) {
    err = launch<1, 4>(p, smem, s);
  } else if (mi == 2 && ni == 4) {
    err = launch<2, 4>(p, smem, s);
  } else if (mi == 2) {
    err = launch<2, 6>(p, smem, s);
  } else {
    err = launch<3, 10>(p, smem, s);
  }
  return static_cast<int>(err);
}

// What the launcher would do with a th x tw output tile: returns the shared
// memory a block needs (-1 if no instantiation covers the tile) and writes
// the projection's accumulator tiles a warp and warp grid, {mi, ni, wm, wn},
// to grid4.  Launches nothing; for checking the mirrors of warp_grid and
// layout in ops/fused_block.py (mbconv_warp_grid, mbconv_smem_bytes).
extern "C" long long spef_fused_mbconv_layout(int th, int tw, int Cin, int Cout, int stride,
                                              int expand, int dw_grid, int residual,
                                              int* grid4) {
  if (th < 1 || tw < 1 || Cin < 1 || Cout < 1 || (stride != 1 && stride != 2)) return -1;
  Params p{};
  p.th = th; p.tw = tw; p.Ho = th; p.Wo = tw;
  p.Cin = Cin; p.Ch = CK; p.Cout = Cout; p.stride = stride;
  p.expand = expand != 0; p.dw_grid = dw_grid != 0; p.residual = residual != 0;
  p.x_piece = 0; p.o_piece = 1;
  int mi = 0, ni = 0;
  if (!warp_grid(th * tw, (Cout + 7) / 8 * 8, mi, ni, p.wm, p.wn)) return -1;
  const size_t smem = layout(p, mi * ni);
  grid4[0] = mi; grid4[1] = ni; grid4[2] = p.wm; grid4[3] = p.wn;
  return static_cast<long long>(smem);
}

extern "C" const char* spef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
