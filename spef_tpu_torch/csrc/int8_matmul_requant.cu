// K1: fused integer matmul + requant epilogue for sm_90a, on the tensor cores.
//
// Replaces spef_tpu/ops/pallas/int8_ops.py::int8_matmul_requant (Pallas TPU
// kernel; bodies _mm_kernel, _mm_res_kernel, _mm_f32out_kernel, _dot_exact,
// _encode_bits).  Every 1x1 convolution of the int8 MobileNetV2 (expand,
// project, head conv) is one call:
//
//   acc = x . w                          (M,K) x (K,N)
//   y   = acc * mult + bias              per output channel, no FMA
//   [relu]
//   out = f32 y                          (OUT_F32)
//       | clip(rint(y * inv), qmin, qmax) as int8 or as uint8 bits
//       | residual: q on the shared grid, s = q + res (exact),
//         clip(rint(s * res_ratio), rqmin, rqmax)      (OUT_RES)
//
// The int8-carry executor's conventions (spef_tpu/quant/int8_carry.py) are
// two launch options of the same epilogue: `div` rounds y / step, an IEEE
// division (__fdiv_rn), in place of y * inv (the two differ by an ulp, and
// so by a step at a tie); `zp` (0 or 128) emits q - zp, an unsigned grid
// shifted into int8.
//
// Input modes: int8 values, uint8 bits carried in int8 (the bits are the
// unsigned value, so the u8 form of the mma reads them as they are), or
// bf16 real values (the boundary recipe's depthwise output).  Integer
// inputs run mma.sync.m16n8k32 s8.s8 / u8.s8 with int32 sums: exact, so the
// output equals the plain PyTorch version's bit for bit.  bf16 inputs run
// mma.sync.m16n8k16 bf16 x bf16 -> f32 with the int8 weights as bf16
// (exact); the tensor core sums the exact products in its own order, as the
// JAX kernel's jnp.dot(..., preferred_element_type=float32) does, so an
// int8 output may differ from the plain version's k-ordered sum by one step
// where the value rounded last sits on a tie
// (ops/int8_ops.py::int8_matmul_requant_rounding_input states the rule).
// The epilogue rounds half to even (__float2int_rn, which is rintf then a
// conversion) after __fmul_rn/__fadd_rn, and the file is built with
// -fmad=false.
//
// Bound on an H100 SXM: the bytes M*K*(1 or 2) + K*N + M*N*(1 or 4) at
// 3.35 TB/s, against 2*M*N*K operations at the int8 or bf16 tensor rate; at
// every MobileNetV2 shape the bytes bound it, most of them the float32
// output of the ungridded expands.  The design moves each byte once:
//
//   * one block of 8 warps (4 along M, 2 along N) owns a column slice of
//     BN = 16*NT outputs (blockIdx.y) and walks row tiles of M (16, 32 or
//     64 rows a warp, by slice width), gridDim.x apart, as many blocks as
//     the card holds at once (a persistent grid).  Where N is at most 192
//     one slice covers all of N, so x is read once; wider N is cut into
//     slices of 160 or 192, whose blocks run side by side over the same
//     rows of x (L2);
//   * the weights come packed once as (N, K padded to 32) int8 or bf16
//     (ops/int8_ops.py::pack_mm_weights), the mma's B layout.  Where the
//     slice's weights fit (every flagship call with K <= 576) they stay in
//     shared memory for the block's whole walk; else they stream by k-slab
//     beside x;
//   * x arrives by 16-byte cp.async (8 or 4 where a row's bytes demand it)
//     into a ring of k-slabs (32, 64 or 128 bytes of a row a stage),
//     zero-filled past K and past M: K = 16 and 24 are padded to the mma
//     depth in shared memory only.  The ring is 3 to 8 stages deep, enough
//     to keep about 32 KB of x on its way a block where two blocks an SM
//     still fit, and runs across tile boundaries, so the next tile's rows
//     load while this tile computes and stores.  Fragments are read with
//     ldmatrix from rows padded by 16 bytes (no bank conflicts);
//   * the epilogue runs on the accumulators in the plain version's
//     arithmetic, one code path an output mode, and writes 16 rows at a
//     time to the warp's staging rows in shared memory, from where the warp
//     stores whole rows in 16-byte pieces (and reads a residual the same
//     way).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum XMode { X_INT8 = 0, X_BITS = 1, X_BF16 = 2 };
enum OutMode { OUT_INT8 = 0, OUT_BITS = 1, OUT_F32 = 2, OUT_RES = 3 };

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WM = 4;              // warps along M
constexpr int WN = 2;              // warps along N
constexpr int MIN_STAGES = 3;      // ring of k-slabs: 3 to 8 stages
constexpr int MAX_STAGES = 8;
constexpr int IN_FLIGHT = 32 * 1024;  // bytes of x a block wants on their way
constexpr int PAD = 16;            // bytes added to a row that ldmatrix reads
constexpr int W_RESIDENT_MAX = 120 * 1024;
constexpr int SMEM_MAX = 232448;   // 227 KB: the most a block may use
constexpr int SMEM_HALF = 115712;  // the most each of two blocks an SM may use

struct Params {
  const uint8_t* x;       // (M, K) int8 or bf16, row-major
  const uint8_t* w;       // (N, kpad) int8 or bf16: packed, k innermost
  const float* mult;
  const float* bias;
  const int8_t* residual;
  uint8_t* out;
  int M, N;
  int xb, wb;             // bytes a row of x / of the packed weights
  int slab, nslab;        // bytes of a row a k-slab; slabs a tile
  int x_piece;            // bytes a cp.async of x moves (0: byte copies)
  int o_piece;            // bytes a store of the output (or load of the residual) moves
  int ob;                 // bytes an output element
  int resident;           // the slice's weights stay in shared memory
  int stages;             // of the ring
  int mtiles;
  int rs, wrs;            // bytes a ring row / a weight row in shared memory
  int off_w, off_x, off_stage;
  int w_stage_bytes, x_stage_bytes, stage_stride;
  int out_mode, relu;
  int div;                // requant by y / inv (inv holds the step) in place of y * inv
  int zp;                 // an int8 output is q - zp
  float inv, res_ratio;
  int qmin, qmax, rqmin, rqmax;  // the grids' bounds (integers: ceil of lo, floor of hi)
};

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

// One 32-byte k-step: D (16x8) += A (16 rows x 32 bytes) x B (32 bytes x 8
// columns): int8 x int8 (k32), uint8 x int8 (k32) or bf16 x bf16 (k16).
template <int MODE>
__device__ __forceinline__ void mma(uint32_t (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  if constexpr (MODE == X_BF16) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else if constexpr (MODE == X_BITS) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Wait until at most n groups are pending (n from 1 to MAX_STAGES - 2).
__device__ __forceinline__ void cp_async_wait_ahead(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// ROWS rows of a k-slab: row r of the destination is source row row0 + r
// (zeros at or past nrows), bytes kb0.. of it (zeros at or past rowb).
template <int PIECE>
__device__ __forceinline__ void load_rows_async(uint32_t dst, int stride, const uint8_t* src,
                                                int64_t row0, int nrows, int rowb, int kb0,
                                                int slab, int rows) {
  const int pieces = slab / PIECE;
  const int shift = (pieces & (pieces - 1)) == 0 ? __ffs(pieces) - 1 : -1;  // a power of two?
  for (int e = threadIdx.x; e < rows * pieces; e += THREADS) {
    const int r = shift >= 0 ? e >> shift : e / pieces, k = (e - r * pieces) * PIECE;
    const int64_t row = row0 + r;
    const bool ok = row < nrows && kb0 + k < rowb;
    const uint8_t* s = ok ? src + row * rowb + kb0 + k : src;
    cp_async<PIECE>(dst + r * stride + k, s, ok ? PIECE : 0);
  }
}

__device__ __forceinline__ void load_rows(uint8_t* dst, int stride, const uint8_t* src,
                                          int64_t row0, int nrows, int rowb, int kb0, int slab,
                                          int rows, int piece) {
  const uint32_t d = smem_u32(dst);
  if (piece == 16) {
    load_rows_async<16>(d, stride, src, row0, nrows, rowb, kb0, slab, rows);
  } else if (piece == 8) {
    load_rows_async<8>(d, stride, src, row0, nrows, rowb, kb0, slab, rows);
  } else if (piece == 4) {
    load_rows_async<4>(d, stride, src, row0, nrows, rowb, kb0, slab, rows);
  } else {
    for (int e = threadIdx.x; e < rows * slab; e += THREADS) {
      const int r = e / slab, k = e - r * slab;
      const int64_t row = row0 + r;
      dst[r * stride + k] = (row < nrows && kb0 + k < rowb) ? src[row * rowb + kb0 + k] : 0;
    }
  }
}

// Copy `rows` rows of `rowb` bytes between a warp's staging rows and
// device memory, PIECE bytes a lane at a time.
template <int PIECE, bool TO_GLOBAL>
__device__ __forceinline__ void warp_copy(uint8_t* stage, int stride, uint8_t* g, int64_t gstride,
                                          int rows, int rowb, int lane) {
  const int pieces = rowb / PIECE;
  const uint32_t magic = pieces == 1 ? 0u : 0xFFFFFFFFu / pieces + 1;  // e / pieces, e < 2^16
  for (int e = lane; e < rows * pieces; e += 32) {
    const int r = magic ? static_cast<int>(__umulhi(static_cast<uint32_t>(e), magic)) : e;
    const int k = (e - r * pieces) * PIECE;
    uint8_t* s = stage + r * stride + k;
    uint8_t* d = g + r * gstride + k;
    if constexpr (!TO_GLOBAL) {
      uint8_t* t = s;
      s = d;
      d = t;
    }
    if constexpr (PIECE == 16) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else if constexpr (PIECE == 8) {
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
    } else if constexpr (PIECE == 4) {
      *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
    } else if constexpr (PIECE == 2) {
      *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
    } else {
      *d = *s;
    }
  }
}

template <bool TO_GLOBAL>
__device__ __forceinline__ void warp_copy_rows(uint8_t* stage, int stride, uint8_t* g,
                                               int64_t gstride, int rows, int rowb, int piece,
                                               int lane) {
  switch (piece) {
    case 16: warp_copy<16, TO_GLOBAL>(stage, stride, g, gstride, rows, rowb, lane); break;
    case 8: warp_copy<8, TO_GLOBAL>(stage, stride, g, gstride, rows, rowb, lane); break;
    case 4: warp_copy<4, TO_GLOBAL>(stage, stride, g, gstride, rows, rowb, lane); break;
    case 2: warp_copy<2, TO_GLOBAL>(stage, stride, g, gstride, rows, rowb, lane); break;
    default: warp_copy<1, TO_GLOBAL>(stage, stride, g, gstride, rows, rowb, lane); break;
  }
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// clip(rint(v), lo, hi) for integer bounds: __float2int_rn rounds half to
// even as rintf does (and saturates where a float would be clipped anyway).
__device__ __forceinline__ int requant(float v, int lo, int hi) {
  return clampi(__float2int_rn(v), lo, hi);
}

template <int MODE>
__device__ __forceinline__ float acc_value(uint32_t a) {
  return MODE == X_BF16 ? __uint_as_float(a) : __int2float_rn(static_cast<int32_t>(a));
}

// The epilogue of two neighbouring outputs of a row (columns c and c + 1)
// on their accumulators (int32 sums, or float32 bits for bf16 input), into
// the staging row at dst.  An int8 output leaves as the low byte of its
// integer, which is also the uint8 bits of an unsigned grid.  OUT is
// OUT_INT8 (for both int8 and bits), OUT_F32 or OUT_RES.
// The value the requant rounds: y * inv, or y / step (inv holds the step).
__device__ __forceinline__ float scaled(const Params& p, float y) {
  return p.div ? __fdiv_rn(y, p.inv) : __fmul_rn(y, p.inv);
}

template <int MODE, int OUT>
__device__ __forceinline__ void finish_pair(const Params& p, uint32_t a0, uint32_t a1, float2 m,
                                            float2 b, uint8_t* dst) {
  float y0 = __fadd_rn(__fmul_rn(acc_value<MODE>(a0), m.x), b.x);
  float y1 = __fadd_rn(__fmul_rn(acc_value<MODE>(a1), m.y), b.y);
  int q0, q1;
  if constexpr (OUT == OUT_RES) {
    // Exact shared-grid sum, requantized straight to the consumer grid;
    // never clamped to int8 in between (it spans twice the shared grid).
    // The residual was staged in the bytes these outputs go to.
    const char2 res = *reinterpret_cast<const char2*>(dst);
    const int s0 = requant(scaled(p, y0), p.qmin, p.qmax) + res.x;
    const int s1 = requant(scaled(p, y1), p.qmin, p.qmax) + res.y;
    q0 = requant(__fmul_rn(__int2float_rn(s0), p.res_ratio), p.rqmin, p.rqmax);
    q1 = requant(__fmul_rn(__int2float_rn(s1), p.res_ratio), p.rqmin, p.rqmax);
  } else {
    if (p.relu) {
      y0 = fmaxf(y0, 0.0f);
      y1 = fmaxf(y1, 0.0f);
    }
    if constexpr (OUT == OUT_F32) {
      *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
      return;
    }
    q0 = requant(scaled(p, y0), p.qmin, p.qmax) - p.zp;
    q1 = requant(scaled(p, y1), p.qmin, p.qmax) - p.zp;
  }
  *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
}

// The epilogue of a warp's 16 rows x NT*8 columns into its staging rows;
// the accumulators are zeroed for the next tile.
template <int MODE, int OUT, int NT>
__device__ __forceinline__ void finish_rows(const Params& p, uint32_t (&acc)[NT][4],
                                            const float* mult, const float* bias, uint8_t* stage,
                                            int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + 2 * t;
    const float2 m = *reinterpret_cast<const float2*>(mult + c);
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      finish_pair<MODE, OUT>(p, acc[nt][2 * half], acc[nt][2 * half + 1], m, b,
                             stage + (g + 8 * half) * p.stage_stride + c * p.ob);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0u;
  }
}

// 16-row mma tiles a warp, as measured best at the flagship's calls: four at
// 16-column slices (N 17..32), two at 8-column (N <= 16) and medium ones, one
// for the widest, whose accumulators would not leave registers for two
// blocks an SM.
__host__ __device__ constexpr int mi_of(int nt) { return nt == 2 ? 4 : (nt <= 6 ? 2 : 1); }

template <int MODE, int NT>
__global__ void __launch_bounds__(THREADS, 2)
mm_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int BN = WN * NT * 8;
  constexpr int MI = mi_of(NT);
  constexpr int BM = WM * MI * 16;
  float* mult_s = reinterpret_cast<float*>(smem);
  float* bias_s = mult_s + BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm_i = warp / WN, wn_i = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * BN;

  for (int c = threadIdx.x; c < BN; c += THREADS) {
    const int n = n0 + c;
    mult_s[c] = n < p.N ? p.mult[n] : 0.0f;
    bias_s[c] = n < p.N ? p.bias[n] : 0.0f;
  }
  uint8_t* wsm = smem + p.off_w;
  uint8_t* xsm = smem + p.off_x;
  if (p.resident) {
    // The slice's weights, whole rows padded to a whole number of slabs.
    load_rows(wsm, p.wrs, p.w, n0, p.N, p.wb, 0, p.wrs - PAD, BN, 16);
  }

  const int my_tiles = (p.mtiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int iters = my_tiles * p.nslab;
  auto load = [&](int i) {
    const int j = i / p.nslab, s = i - j * p.nslab;
    const int st = i % p.stages;
    const int64_t m0 = static_cast<int64_t>(blockIdx.x + j * gridDim.x) * BM;
    load_rows(xsm + st * p.x_stage_bytes, p.rs, p.x, m0, p.M, p.xb, s * p.slab, p.slab, BM,
              p.x_piece);
    if (!p.resident)
      load_rows(wsm + st * p.w_stage_bytes, p.rs, p.w, n0, p.N, p.wb, s * p.slab, p.slab, BN, 16);
  };
#pragma unroll
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < iters) load(s);
    cp_async_commit();
  }

  uint32_t acc[MI][NT][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0u;  // 0 and 0.0f share their bits

  uint8_t* stage = smem + p.off_stage + warp * 16 * p.stage_stride;
  const int wcol = wn_i * NT * 8;              // the warp's first column in the slice
  const int width = min(NT * 8, p.N - n0 - wcol);  // its columns inside N

  for (int i = 0; i < iters; ++i) {
    cp_async_wait_ahead(p.stages - 2);
    __syncthreads();
    if (i + p.stages - 1 < iters) load(i + p.stages - 1);
    cp_async_commit();

    const int j = i / p.nslab, s = i - j * p.nslab;
    const int st = i % p.stages;
    const uint32_t xa = smem_u32(xsm + st * p.x_stage_bytes) +
                        (wm_i * MI * 16 + (lane & 15)) * p.rs + (lane >> 4) * 16;
    const uint32_t wa = (p.resident ? smem_u32(wsm) + s * p.slab
                                    : smem_u32(wsm + st * p.w_stage_bytes)) +
                        (wcol + (lane & 7)) * p.wrs + ((lane >> 3) & 1) * 16;
    for (int kk = 0; kk < p.slab; kk += 32) {
      uint32_t a[MI][4], b[NT][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(a[mi], xa + mi * 16 * p.rs + kk);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) ldmatrix_x2(b[nt], wa + nt * 8 * p.wrs + kk);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma<MODE>(acc[mi][nt], a[mi], b[nt]);
    }
    if (s != p.nslab - 1) continue;
    if (width <= 0) {  // a warp past N: nothing to store
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0u;
      continue;
    }

    // The tile's last slab: the warp's rows leave 16 at a time through its
    // staging rows.  Every staging row is written whole (rows past M and
    // columns past N too: they are not copied out).
    const int64_t m0 = static_cast<int64_t>(blockIdx.x + j * gridDim.x) * BM + wm_i * MI * 16;
    const int64_t gstride = static_cast<int64_t>(p.N) * p.ob;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int64_t r0 = m0 + mi * 16;
      const int rows = static_cast<int>(min(static_cast<int64_t>(16), p.M - r0));
      const int64_t goff = r0 * p.N + n0 + wcol;
      if (rows > 0 && p.out_mode == OUT_RES) {
        warp_copy_rows<false>(stage, p.stage_stride,
                              const_cast<uint8_t*>(reinterpret_cast<const uint8_t*>(p.residual)) +
                                  goff,
                              p.N, rows, width, p.o_piece, lane);
        __syncwarp();
      }
      // One path an output mode (the switch is the same for every thread).
      switch (p.out_mode) {
        case OUT_F32:
          finish_rows<MODE, OUT_F32, NT>(p, acc[mi], mult_s + wcol, bias_s + wcol, stage, g, t);
          break;
        case OUT_RES:
          finish_rows<MODE, OUT_RES, NT>(p, acc[mi], mult_s + wcol, bias_s + wcol, stage, g, t);
          break;
        default:
          finish_rows<MODE, OUT_INT8, NT>(p, acc[mi], mult_s + wcol, bias_s + wcol, stage, g, t);
          break;
      }
      __syncwarp();
      if (rows > 0)
        warp_copy_rows<true>(stage, p.stage_stride, p.out + goff * p.ob, gstride, rows,
                             width * p.ob, p.o_piece, lane);
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

template <int MODE, int NT>
int launch(Params p, cudaStream_t stream) {
  constexpr int BN = WN * NT * 8;
  constexpr int BM = WM * mi_of(NT) * 16;
  p.mtiles = static_cast<int>((static_cast<int64_t>(p.M) + BM - 1) / BM);
  p.off_w = BN * 8;  // mult and bias of the slice
  p.w_stage_bytes = BN * p.rs;
  p.x_stage_bytes = BM * p.rs;
  // The slice's weights stay where they fit beside the ring, else they
  // stream with it.  The ring is as deep as IN_FLIGHT bytes of x ahead
  // want, within what leaves room for two blocks an SM where that is
  // possible at all.
  const int w_res = BN * p.wrs;
  const int stage_area = WARPS * 16 * p.stage_stride;
  p.resident = w_res <= W_RESIDENT_MAX &&
               p.off_w + w_res + stage_area + MIN_STAGES * p.x_stage_bytes <= SMEM_MAX;
  if (!p.resident) p.wrs = p.rs;
  const int fixed = p.off_w + (p.resident ? w_res : 0) + stage_area;
  const int per_stage = p.x_stage_bytes + (p.resident ? 0 : p.w_stage_bytes);
  const int budget = fixed + MIN_STAGES * per_stage <= SMEM_HALF ? SMEM_HALF : SMEM_MAX;
  const int want = 1 + (IN_FLIGHT + BM * p.slab - 1) / (BM * p.slab);
  p.stages = std::max(MIN_STAGES, std::min({MAX_STAGES, want, (budget - fixed) / per_stage}));
  p.off_x = p.off_w + (p.resident ? w_res : p.stages * p.w_stage_bytes);
  p.off_stage = p.off_x + p.stages * p.x_stage_bytes;
  const int smem = p.off_stage + stage_area;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mm_kernel<MODE, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mm_kernel<MODE, NT>, THREADS,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int slices = (p.N + BN - 1) / BN;
  int walkers = per_sm * sms / slices;
  walkers = walkers < 1 ? 1 : (walkers > p.mtiles ? p.mtiles : walkers);
  mm_kernel<MODE, NT><<<dim3(walkers, slices), THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 8-column mma tiles a warp: one slice covers N up to 192; wider N takes
// slices of 160 or 192, whichever pads N less (the larger on a tie).
int choose_nt(int N) {
  for (int nt : {1, 2, 4, 6, 10, 12})
    if (N <= WN * 8 * nt) return nt;
  const int pad10 = (N + 159) / 160 * 160, pad12 = (N + 191) / 192 * 192;
  return pad10 < pad12 ? 10 : 12;
}

template <int MODE>
int dispatch(int nt, const Params& p, cudaStream_t s) {
  switch (nt) {
    case 1: return launch<MODE, 1>(p, s);
    case 2: return launch<MODE, 2>(p, s);
    case 4: return launch<MODE, 4>(p, s);
    case 6: return launch<MODE, 6>(p, s);
    case 10: return launch<MODE, 10>(p, s);
    default: return launch<MODE, 12>(p, s);
  }
}

int largest_piece(int64_t a, int64_t b, uintptr_t p, uintptr_t q) {
  int piece = 16;
  while (piece > 1 && ((a % piece) || (b % piece) || (p % piece) || (q % piece))) piece /= 2;
  return piece;
}

}  // namespace

// x (M, K) as x_mode says; w_packed (N, kpad) int8, or bf16 for bf16 x
// (ops/int8_ops.py::pack_mm_weights), kpad a multiple of 32 at least K.
// div: out_inv_step is the step, and the requant divides by it; zp: an
// int8 output (OUT_INT8) is q - zp.
extern "C" int spef_int8_matmul_requant(
    const void* x, int x_mode, const void* w_packed, int kpad, const float* mult,
    const float* bias, const int8_t* residual, void* out, int out_mode, int M, int N, int K,
    int relu, float out_inv_step, float out_qmin, float out_qmax, float res_ratio,
    float res_qmin, float res_qmax, int div, int zp, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || kpad < K || kpad % 32 != 0 || x_mode < 0 || x_mode > 2 ||
      out_mode < 0 || out_mode > 3 || (zp != 0 && zp != 128) ||
      (zp != 0 && out_mode != OUT_INT8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = x_mode == X_BF16 ? 2 : 1;
  Params p{};
  p.x = static_cast<const uint8_t*>(x);
  p.w = static_cast<const uint8_t*>(w_packed);
  p.mult = mult;
  p.bias = bias;
  p.residual = residual;
  p.out = static_cast<uint8_t*>(out);
  p.M = M;
  p.N = N;
  p.xb = K * esize;
  p.wb = kpad * esize;
  // Long rows (K of 256 bf16 or more) take 128 bytes a slab: half the
  // barriers; shorter ones 64 or 32, which pad less.
  p.slab = p.xb >= 512 ? 128 : (p.xb > 32 ? 64 : 32);
  p.nslab = (p.xb + p.slab - 1) / p.slab;
  p.rs = p.slab + PAD;
  p.wrs = (p.wb + p.slab - 1) / p.slab * p.slab + PAD;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x);
  const int xpiece = largest_piece(p.xb, 16, xp, 0);
  p.x_piece = xpiece >= 4 ? xpiece : 0;
  p.ob = out_mode == OUT_F32 ? 4 : 1;
  const int nt = choose_nt(N);
  p.o_piece = largest_piece(static_cast<int64_t>(N) * p.ob, static_cast<int64_t>(nt) * 8 * p.ob,
                            reinterpret_cast<uintptr_t>(out),
                            out_mode == OUT_RES ? reinterpret_cast<uintptr_t>(residual) : 0);
  p.stage_stride = (nt * 8 * p.ob + 15) / 16 * 16 + 16;
  p.out_mode = out_mode;
  p.relu = relu;
  p.div = div != 0;
  p.zp = zp;
  p.inv = out_inv_step;
  p.res_ratio = res_ratio;
  // clip(q, lo, hi) of an integer q is clip(q, ceil(lo), floor(hi)).
  p.qmin = static_cast<int>(ceilf(fmaxf(out_qmin, -1e9f)));
  p.qmax = static_cast<int>(floorf(fminf(out_qmax, 1e9f)));
  p.rqmin = static_cast<int>(ceilf(fmaxf(res_qmin, -1e9f)));
  p.rqmax = static_cast<int>(floorf(fminf(res_qmax, 1e9f)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_mode) {
    case X_INT8: return dispatch<X_INT8>(nt, p, s);
    case X_BITS: return dispatch<X_BITS>(nt, p, s);
    default: return dispatch<X_BF16>(nt, p, s);
  }
}

extern "C" const char* spef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
