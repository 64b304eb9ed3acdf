// K1: fused integer matmul + requant epilogue for sm_90a.
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
// Input modes: int8 values, uint8 bits carried in int8 (decode x & 255), or
// bf16 real values (the boundary recipe's depthwise output).  Integer inputs
// accumulate in int32, which is exact (the TPU's f32 sum of bf16 products
// can round past 2^24).  bf16 inputs accumulate their exact products in f32
// in k order 0..K-1, the order the plain PyTorch version uses, so the two
// agree bit for bit.  Rounding is rintf (half to even, like torch.round and
// jnp.round); roundf would round ties away from zero.  The epilogue uses
// __fmul_rn/__fadd_rn and the file is built with -fmad=false: a fused
// multiply-add moves acc*mult+bias by an ulp and flips .5 ties.
//
// Bound on an H100 SXM: the bytes M*K + K*N + M*N (1 byte each for int8,
// 2 for bf16 x, 4 for f32 out) at 3.35 TB/s against 2*M*N*K operations at
// the int8 tensor rate (1,979 TOP/s).  At the MobileNetV2 shapes
// (K, N <= 1280) the bytes bound it.  This first kernel is a plain
// shared-memory tiled GEMM on the CUDA cores (64x64 tile, 4x4 outputs a
// thread); tensor cores (mma/wgmma) and TMA are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum XMode { X_INT8 = 0, X_BITS = 1, X_BF16 = 2 };
enum OutMode { OUT_INT8 = 0, OUT_BITS = 1, OUT_F32 = 2, OUT_RES = 3 };

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

struct Epilogue {
  const float* mult;
  const float* bias;
  const int8_t* residual;
  void* out;
  int out_mode;
  int relu;
  float inv, qmin, qmax;
  float res_ratio, rqmin, rqmax;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ void store(const Epilogue& ep, float acc, int64_t m, int n,
                                      int N) {
  const int64_t idx = m * N + n;
  float y = __fadd_rn(__fmul_rn(acc, ep.mult[n]), ep.bias[n]);
  if (ep.out_mode == OUT_RES) {
    // Exact shared-grid sum, requantized straight to the consumer grid;
    // never clamped to int8 in between (it spans twice the shared grid).
    float q = clampf(rintf(__fmul_rn(y, ep.inv)), ep.qmin, ep.qmax);
    float s = __fadd_rn(q, static_cast<float>(ep.residual[idx]));
    float r = clampf(rintf(__fmul_rn(s, ep.res_ratio)), ep.rqmin, ep.rqmax);
    static_cast<int8_t*>(ep.out)[idx] = static_cast<int8_t>(static_cast<int>(r));
    return;
  }
  if (ep.relu) y = fmaxf(y, 0.0f);
  if (ep.out_mode == OUT_F32) {
    static_cast<float*>(ep.out)[idx] = y;
    return;
  }
  float q = clampf(rintf(__fmul_rn(y, ep.inv)), ep.qmin, ep.qmax);
  if (ep.out_mode == OUT_BITS && q > 127.0f) q -= 256.0f;
  static_cast<int8_t*>(ep.out)[idx] = static_cast<int8_t>(static_cast<int>(q));
}

template <int MODE>
__device__ __forceinline__ auto load_x(const void* x, int64_t i) {
  if constexpr (MODE == X_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  } else if constexpr (MODE == X_BITS) {
    return static_cast<int32_t>(static_cast<const uint8_t*>(x)[i]);
  } else {
    return static_cast<int32_t>(static_cast<const int8_t*>(x)[i]);
  }
}

// One 64x64 output tile per block; each thread owns a 4x4 patch and sums
// its products in k order.  The k loop walks BK-wide slabs staged in
// shared memory, A stored k-major so that each k step reads one row of A
// and one row of B from shared memory.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
mm_requant_kernel(const void* __restrict__ x, const int8_t* __restrict__ w, Epilogue ep,
                  int M, int N, int K) {
  using Acc = decltype(load_x<MODE>(nullptr, 0));
  __shared__ __align__(16) Acc As[BK][BM];
  __shared__ __align__(16) Acc Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // row group
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage A (BM x BK): consecutive threads walk k, the contiguous axis.
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int64_t m = m0 + r;
      const int k = k0 + c;
      As[c][r] = (m < M && k < K) ? load_x<MODE>(x, m * K + k) : Acc(0);
    }
    // Stage B (BK x BN): consecutive threads walk n, the contiguous axis.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int k = k0 + r;
      const int n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? static_cast<Acc>(w[static_cast<int64_t>(k) * N + n])
                                  : Acc(0);
    }
    __syncthreads();
    const int kk_end = min(BK, K - k0);
    for (int kk = 0; kk < kk_end; ++kk) {
      Acc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if constexpr (MODE == X_BF16) {
            // bf16 x int8 is exact in f32, so the rounded add is the only
            // rounding: the same sum as the plain version's addcmul chain.
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
          } else {
            acc[i][j] += a[i] * b[j];
          }
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) store(ep, static_cast<float>(acc[i][j]), m, n, N);
    }
  }
}

}  // namespace

extern "C" int spef_int8_matmul_requant(
    const void* x, int x_mode, const int8_t* w, const float* mult, const float* bias,
    const int8_t* residual, void* out, int out_mode, int M, int N, int K, int relu,
    float out_inv_step, float out_qmin, float out_qmax, float res_ratio, float res_qmin,
    float res_qmax, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Epilogue ep{mult, bias, residual, out, out_mode, relu, out_inv_step, out_qmin,
              out_qmax, res_ratio, res_qmin, res_qmax};
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_mode) {
    case X_INT8: mm_requant_kernel<X_INT8><<<grid, THREADS, 0, s>>>(x, w, ep, M, N, K); break;
    case X_BITS: mm_requant_kernel<X_BITS><<<grid, THREADS, 0, s>>>(x, w, ep, M, N, K); break;
    case X_BF16: mm_requant_kernel<X_BF16><<<grid, THREADS, 0, s>>>(x, w, ep, M, N, K); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
