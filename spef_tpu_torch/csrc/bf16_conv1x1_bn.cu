// 1x1 convolution of bf16 activations with eval-mode BatchNorm, ReLU and the
// residual add in its epilogue, for sm_90a, on the bf16 tensor cores.
//
// Replaces no TPU kernel: on the TPU, XLA fused the float forward's conv
// epilogue into the conv itself.  On the card, cuDNN's bf16 conv writes its
// output, and the BatchNorm (float32), the casts and the ReLU each pass over
// it again (spef_tpu_torch/models/layers.py::ConvBnAct, train mode and the
// stem still do).  Every eval-mode 1x1 of the float MobileNetV2 (expand,
// project, head conv) is one call of this kernel instead:
//
//   acc = x . w                  (M,K) x (K,N), f32 sums of exact products
//   c   = bf16(acc)              the conv's bf16 output, as cuDNN's and flax's
//   y   = bf16(c * scale + shift)   the BatchNorm from the running statistics,
//                                 per output channel in f32, no FMA
//   [y  = relu(y)]
//   [y  = bf16(residual + y)]    the identity skip of a projection, in f32
//   out = y                      bf16, stored once
//
// scale = weight / sqrt(var + eps) and shift = bias - mean * scale come
// precomputed in float32 (ops/bf16_conv_bn.py::bn_terms).  Rounding is to
// nearest even (__float2bfloat16_rn) after __fmul_rn/__fadd_rn, and the file
// is built with -fmad=false.  The only departure from the unfused path is
// the order of the conv's sum: the tensor core sums the exact products in
// its own order, as cuDNN's bf16 conv does in another.
//
// Bound on an H100 SXM: the bytes M*K*2 + N*K*2 + M*N*2 (+ M*N*2 of a
// residual) at 3.35 TB/s against 2*M*N*K operations at 989 TFLOP/s; at
// every MobileNetV2 shape (about 20 operations a byte) the bytes bound it.
// The design is K1's (int8_matmul_requant.cu) in its bf16 mode, and moves
// each byte once:
//
//   * one block of 8 warps (4 along M, 2 along N) owns a column slice of
//     BN = 16*NT outputs (blockIdx.y) and walks row tiles of M (16, 32 or
//     64 rows a warp, by slice width), gridDim.x apart, as many blocks as
//     the card holds at once (a persistent grid).  Where N is at most 192
//     one slice covers all of N, so x is read once; wider N is cut into
//     slices of 160 or 192, whose blocks run side by side over the same
//     rows of x (L2);
//   * the weights come packed once as (N, K padded to 32) bf16
//     (ops/bf16_conv_bn.py::pack_conv1x1_weights), the mma's B layout.
//     Where the slice's weights fit in 120 KB (every flagship call but the
//     projections from 576 and 960 channels to 160 and 320) they stay in
//     shared memory for the block's whole walk; else they stream by k-slab
//     beside x;
//   * x arrives by 16-byte cp.async into a ring of k-slabs (a whole row of
//     up to 320 bytes where three stages fit in 96 KB, else 32, 64 or 128
//     bytes of a row, a stage), zero-filled past K and past M: K = 16 and 24
//     are padded to the mma depth in shared memory only.
//     The ring runs across tile boundaries, so the next tile's rows load
//     while this tile computes and stores.  Fragments are read with ldmatrix from rows
//     padded by 16 bytes (no bank conflicts);
//   * the epilogue runs on the accumulators in registers and writes 16 rows
//     at a time to the warp's staging rows in shared memory, from where the
//     warp stores whole rows in 16-byte pieces (and reads a residual the
//     same way, into the bytes its outputs then replace).
//
// K and N are multiples of 8 and every operand is 16-byte aligned, as at
// every MobileNetV2 shape (ops/bf16_conv_bn.py checks it; a ConvBnAct with
// other widths runs the unfused path), so every copy moves 16 bytes.

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
constexpr int OB = 2;              // bytes an output element (bf16)

struct Params {
  const uint8_t* x;       // (M, K) bf16, row-major
  const uint8_t* w;       // (N, kpad) bf16: packed, k innermost
  const float* scale;
  const float* shift;
  const uint8_t* residual;  // (M, N) bf16 or null
  uint8_t* out;           // (M, N) bf16
  int M, N;
  int xb, wb;             // bytes a row of x / of the packed weights
  int slab, nslab;        // bytes of a row a k-slab; slabs a tile
  int resident;           // the slice's weights stay in shared memory
  int stages;             // of the ring
  int mtiles;
  int rs, wrs;            // bytes a ring row / a weight row in shared memory
  int off_w, off_x, off_stage;
  int w_stage_bytes, x_stage_bytes, stage_stride;
  int relu;
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

// One 32-byte k-step: D (16x8) += A (16 rows x 16 bf16) x B (16 bf16 x 8 columns).
__device__ __forceinline__ void mma(uint32_t (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
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
__device__ __forceinline__ void load_rows(uint8_t* dst, int stride, const uint8_t* src,
                                          int64_t row0, int nrows, int rowb, int kb0, int slab,
                                          int rows) {
  const uint32_t d = smem_u32(dst);
  const int pieces = slab / 16;
  const int shift = (pieces & (pieces - 1)) == 0 ? __ffs(pieces) - 1 : -1;  // a power of two?
  for (int e = threadIdx.x; e < rows * pieces; e += THREADS) {
    const int r = shift >= 0 ? e >> shift : e / pieces, k = (e - r * pieces) * 16;
    const int64_t row = row0 + r;
    const bool ok = row < nrows && kb0 + k < rowb;
    const uint8_t* s = ok ? src + row * rowb + kb0 + k : src;
    cp_async16(d + r * stride + k, s, ok ? 16 : 0);
  }
}

// Copy `rows` rows of `rowb` bytes between a warp's staging rows and
// device memory, 16 bytes a lane at a time.
template <bool TO_GLOBAL>
__device__ __forceinline__ void warp_copy(uint8_t* stage, int stride, uint8_t* g, int64_t gstride,
                                          int rows, int rowb, int lane) {
  const int pieces = rowb / 16;
  const uint32_t magic = pieces == 1 ? 0u : 0xFFFFFFFFu / pieces + 1;  // e / pieces, e < 2^16
  for (int e = lane; e < rows * pieces; e += 32) {
    const int r = magic ? static_cast<int>(__umulhi(static_cast<uint32_t>(e), magic)) : e;
    const int k = (e - r * pieces) * 16;
    uint8_t* s = stage + r * stride + k;
    uint8_t* d = g + r * gstride + k;
    if constexpr (!TO_GLOBAL) {
      uint8_t* t = s;
      s = d;
      d = t;
    }
    *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
  }
}

// Two neighbouring outputs of a row (columns c and c + 1) from their f32
// sums into the staging row at dst, where a residual, if any, was staged:
// the conv's bf16 rounding, the BatchNorm in f32, the bf16 rounding, the
// ReLU, the residual add, two values an instruction where the rounding
// allows (cvt.rn.bf16x2.f32 rounds each half to nearest even).
template <bool RES>
__device__ __forceinline__ void finish_pair(const Params& p, uint32_t a0, uint32_t a1,
                                            float2 s, float2 t, uint8_t* dst) {
  const float2 c = __bfloat1622float2(
      __float22bfloat162_rn(make_float2(__uint_as_float(a0), __uint_as_float(a1))));
  __nv_bfloat162 y = __float22bfloat162_rn(make_float2(__fadd_rn(__fmul_rn(c.x, s.x), t.x),
                                                       __fadd_rn(__fmul_rn(c.y, s.y), t.y)));
  if (p.relu) y = __hmax2(y, __float2bfloat162_rn(0.0f));
  if constexpr (RES) {
    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dst));
    const float2 v = __bfloat1622float2(y);
    y = __float22bfloat162_rn(make_float2(__fadd_rn(r.x, v.x), __fadd_rn(r.y, v.y)));
  }
  *reinterpret_cast<__nv_bfloat162*>(dst) = y;
}

// The epilogue of a warp's 16 rows x NT*8 columns into its staging rows;
// the accumulators are zeroed for the next tile.
template <bool RES, int NT>
__device__ __forceinline__ void finish_rows(const Params& p, uint32_t (&acc)[NT][4],
                                            const float* scale, const float* shift,
                                            uint8_t* stage, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + 2 * t;
    const float2 s = *reinterpret_cast<const float2*>(scale + c);
    const float2 b = *reinterpret_cast<const float2*>(shift + c);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      finish_pair<RES>(p, acc[nt][2 * half], acc[nt][2 * half + 1], s, b,
                       stage + (g + 8 * half) * p.stage_stride + c * OB);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0u;
  }
}

// 16-row mma tiles a warp, as K1 measured best: four at 16-column slices,
// two at 8-column and medium ones, one for the widest.  The widest slices
// over rows of 512 bytes or more (K >= 256) take two, with one block an SM
// for the registers: their tiles are long, and the two share each slab of
// weights (1.1-1.6x faster at the flagship's K of 320 to 960).
constexpr int choose_mi(int nt, int xb) { return nt == 2 ? 4 : (nt <= 6 || xb >= 512 ? 2 : 1); }

template <int NT, int MI>
__global__ void __launch_bounds__(THREADS, NT >= 10 && MI == 2 ? 1 : 2)
conv1x1_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int BN = WN * NT * 8;
  constexpr int BM = WM * MI * 16;
  float* scale_s = reinterpret_cast<float*>(smem);
  float* shift_s = scale_s + BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm_i = warp / WN, wn_i = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * BN;

  for (int c = threadIdx.x; c < BN; c += THREADS) {
    const int n = n0 + c;
    scale_s[c] = n < p.N ? p.scale[n] : 0.0f;
    shift_s[c] = n < p.N ? p.shift[n] : 0.0f;
  }
  uint8_t* wsm = smem + p.off_w;
  uint8_t* xsm = smem + p.off_x;
  if (p.resident) {
    // The slice's weights, whole rows padded to a whole number of slabs.
    load_rows(wsm, p.wrs, p.w, n0, p.N, p.wb, 0, p.wrs - PAD, BN);
  }

  const int my_tiles = (p.mtiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int iters = my_tiles * p.nslab;
  auto load = [&](int i) {
    const int j = i / p.nslab, s = i - j * p.nslab;
    const int st = i % p.stages;
    const int64_t m0 = static_cast<int64_t>(blockIdx.x + j * gridDim.x) * BM;
    load_rows(xsm + st * p.x_stage_bytes, p.rs, p.x, m0, p.M, p.xb, s * p.slab, p.slab, BM);
    if (!p.resident)
      load_rows(wsm + st * p.w_stage_bytes, p.rs, p.w, n0, p.N, p.wb, s * p.slab, p.slab, BN);
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
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0u;  // 0.0f's bits

  uint8_t* stage = smem + p.off_stage + warp * 16 * p.stage_stride;
  const int wcol = wn_i * NT * 8;                  // the warp's first column in the slice
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
        for (int nt = 0; nt < NT; ++nt) mma(acc[mi][nt], a[mi], b[nt]);
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
    const int64_t gstride = static_cast<int64_t>(p.N) * OB;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int64_t r0 = m0 + mi * 16;
      const int rows = static_cast<int>(min(static_cast<int64_t>(16), p.M - r0));
      const int64_t goff = (r0 * p.N + n0 + wcol) * OB;
      if (p.residual != nullptr) {
        if (rows > 0)
          warp_copy<false>(stage, p.stage_stride, const_cast<uint8_t*>(p.residual) + goff,
                           gstride, rows, width * OB, lane);
        __syncwarp();
        finish_rows<true, NT>(p, acc[mi], scale_s + wcol, shift_s + wcol, stage, g, t);
      } else {
        finish_rows<false, NT>(p, acc[mi], scale_s + wcol, shift_s + wcol, stage, g, t);
      }
      __syncwarp();
      if (rows > 0)
        warp_copy<true>(stage, p.stage_stride, p.out + goff, gstride, rows, width * OB, lane);
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

template <int NT, int MI>
int launch(Params p, cudaStream_t stream) {
  constexpr int BN = WN * NT * 8;
  constexpr int BM = WM * MI * 16;
  p.mtiles = static_cast<int>((static_cast<int64_t>(p.M) + BM - 1) / BM);
  p.off_w = BN * 8;  // scale and shift of the slice
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
  cudaError_t err = cudaFuncSetAttribute(conv1x1_kernel<NT, MI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv1x1_kernel<NT, MI>, THREADS,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int slices = (p.N + BN - 1) / BN;
  int walkers = per_sm * sms / slices;
  walkers = walkers < 1 ? 1 : (walkers > p.mtiles ? p.mtiles : walkers);
  conv1x1_kernel<NT, MI><<<dim3(walkers, slices), THREADS, smem, stream>>>(p);
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

bool misaligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 != 0; }

}  // namespace

// x (M, K) bf16; w_packed (N, kpad) bf16 (ops/bf16_conv_bn.py::
// pack_conv1x1_weights), kpad a multiple of 32 at least K; scale and shift
// (N,) f32; residual (M, N) bf16 or null; out (M, N) bf16.
extern "C" int spef_bf16_conv1x1_bn(const void* x, const void* w_packed, int kpad,
                                    const float* scale, const float* shift, const void* residual,
                                    void* out, int M, int N, int K, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || kpad < K || kpad % 32 != 0 || K % 8 != 0 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(x) || misaligned(w_packed) || misaligned(out) ||
      (residual != nullptr && misaligned(residual)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Params p{};
  p.x = static_cast<const uint8_t*>(x);
  p.w = static_cast<const uint8_t*>(w_packed);
  p.scale = scale;
  p.shift = shift;
  p.residual = static_cast<const uint8_t*>(residual);
  p.out = static_cast<uint8_t*>(out);
  p.M = M;
  p.N = N;
  p.xb = K * 2;
  p.wb = kpad * 2;
  const int nt = choose_nt(N);
  // A row of up to 320 bytes (K <= 160) is one slab, so a tile takes one
  // barrier, where a ring of three such stages takes at most 96 KB.  Else
  // long rows (K of 256 or more) take 128 bytes a slab, shorter ones 64 or
  // 32, which pad less.
  const int mi = choose_mi(nt, p.xb);
  const int row = (p.xb + 31) / 32 * 32, bm = WM * mi * 16;
  if (row <= 320 && MIN_STAGES * bm * (row + PAD) <= 96 * 1024) {
    p.slab = row;
  } else {
    p.slab = p.xb >= 512 ? 128 : (p.xb > 32 ? 64 : 32);
  }
  p.nslab = (p.xb + p.slab - 1) / p.slab;
  p.rs = p.slab + PAD;
  p.wrs = (p.wb + p.slab - 1) / p.slab * p.slab + PAD;
  p.stage_stride = (nt * 8 * OB + 15) / 16 * 16 + 16;
  p.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1: return launch<1, 2>(p, s);
    case 2: return launch<2, 4>(p, s);
    case 4: return launch<4, 2>(p, s);
    case 6: return launch<6, 2>(p, s);
    case 10: return mi == 2 ? launch<10, 2>(p, s) : launch<10, 1>(p, s);
    default: return mi == 2 ? launch<12, 2>(p, s) : launch<12, 1>(p, s);
  }
}

extern "C" const char* spef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
