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
//   project y rounded to bf16 (exact on a grid); p = sum over k = 0..Ch-1 of
//           y[k] * w3[k] in float32 (the products are exact, so an fma is
//           the same rounded add); pf = p * m3 + b3.
//   out     no residual: clip(rint(pf * ratio_out), qmin_o, qmax_o);
//           residual: q = clip(rint(pf * inv_sh), -qmax_sh-1, qmax_sh),
//           s = q + x (exact, never clamped to int8 in between), then
//           clip(rint(s * ratio_out), qmin_o, qmax_o), or clip(s, -128, 127)
//           when the consumer shares the step.
//
// Rounding is rintf (half to even); acc*mult then +bias with
// __fmul_rn/__fadd_rn, and the file is built with -fmad=false.  The plain
// PyTorch version sums in the same orders, so the two agree bit for bit.
//
// Bound on an H100 SXM: the bytes B*H*W*Cin in + B*Ho*Wo*Cout out (+ the
// weights) at 3.35 TB/s against 2*MACs of the two products at the tensor
// rate; with the hidden tensor kept on the SM the bytes bound it at every
// MobileNetV2 shape.  Design: one block of 256 threads per output tile of
// one image.  The int8 input tile with its halo goes to shared memory once.
// The hidden channels are walked in chunks of 32 (one a lane): a chunk of
// w1 is staged as packed words, each warp expands 8 halo pixels at a time
// with dp4a (4 exact int8 products an instruction) into a float32 chunk of
// the hidden tile, the depthwise reads its nine taps from that chunk and
// writes its output, already rounded to bf16, into a (pixels, Ch) tile.
// Then the projection stages w3 in float32 slabs of k and gives each thread
// a 4-pixel x 4-channel register tile, summing k in order across slabs, and
// its epilogue reads the residual from the input tile.  The hidden tensor
// never reaches device memory.  The launcher picks the tile that needs the
// fewest operations among those whose shared memory lets two blocks share an
// SM (else any that fits the 227 KB a block may use).  This first kernel
// uses the CUDA cores only; wgmma, TMA and cp.async pipelining are later
// work.

#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CK = 32;  // hidden channels a chunk: one a lane
constexpr int NP = 8;   // halo pixels a warp expands together
constexpr int TP = 4;   // project register tile: pixels
constexpr int TC = 4;   // project register tile: output channels
constexpr int W3_SLAB_FLOATS = 8192;
constexpr size_t SMEM_MAX = 232448;      // 227 KB: the most a block may use
constexpr size_t SMEM_TWO = 113 * 1024;  // two blocks an SM (1 KB reserved each)

enum OutMode { OUT_PLAIN = 0, OUT_RES_RATIO = 1, OUT_RES_SAME = 2 };

struct Params {
  const int8_t* x;
  const int8_t* w1;
  const float* m1;
  const float* b1;
  const int8_t* w2;
  const float* m2;
  const float* b2;
  const int8_t* w3;
  const float* m3;
  const float* b3;
  int8_t* out;
  int B, H, W, Cin, Ch, Cout, stride, Ho, Wo;
  int th, tw, ih, iw, nty, ntx;  // output tile, its input tile with halo, tiles an image
  int cin4, ds, cout4, kc;       // row strides in shared memory; k a w3 slab
  int off_w1s, off_hid, off_w3s, off_dwo;  // byte offsets in shared memory
  int x_words;                   // the input may be read as aligned 32-bit words
  int hidden_grid, dw_grid, out_mode;
  float inv_h, qmax_h, inv_d, qmax_d, inv_sh, qmax_sh, ratio_out, qmin_o, qmax_o;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

template <bool UNSIGNED>
__global__ void __launch_bounds__(THREADS) mbconv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);                    // [PH][cin4]
  int32_t* xw = reinterpret_cast<int32_t*>(smem);                  // the same, as words
  int32_t* w1s = reinterpret_cast<int32_t*>(smem + p.off_w1s);     // [cin4/4][CK] packed k
  float* hid = reinterpret_cast<float*>(smem + p.off_hid);         // [PH][CK]
  float* w3s = reinterpret_cast<float*>(smem + p.off_w3s);         // [kc][cout4]
  __nv_bfloat16* dwo = reinterpret_cast<__nv_bfloat16*>(smem + p.off_dwo);  // [PO][ds]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int t = blockIdx.x;
  const int tx = t % p.ntx;
  t /= p.ntx;
  const int ty = t % p.nty;
  const int64_t b = t / p.nty;
  const int oh0 = ty * p.th, ow0 = tx * p.tw;                       // first output pixel
  const int ih0 = oh0 * p.stride - 1, iw0 = ow0 * p.stride - 1;     // first halo pixel
  const int PH = p.ih * p.iw, PO = p.th * p.tw;
  const int words = p.cin4 / 4;

  // ---- the input tile with its halo; zeros outside the image and past Cin.
  if (p.x_words) {
    for (int e = tid; e < PH * words; e += THREADS) {
      const int pix = e / words, wd = e % words;
      const int r = ih0 + pix / p.iw, c = iw0 + pix % p.iw;
      int32_t v = 0;
      if (r >= 0 && r < p.H && c >= 0 && c < p.W) {
        v = reinterpret_cast<const int32_t*>(p.x + ((b * p.H + r) * p.W + c) * p.Cin)[wd];
      }
      xw[e] = v;
    }
  } else {
    for (int e = tid; e < PH * p.cin4; e += THREADS) {
      const int pix = e / p.cin4, k = e % p.cin4;
      const int r = ih0 + pix / p.iw, c = iw0 + pix % p.iw;
      int8_t v = 0;
      if (k < p.Cin && r >= 0 && r < p.H && c >= 0 && c < p.W) {
        v = p.x[((b * p.H + r) * p.W + c) * p.Cin + k];
      }
      xs[e] = v;
    }
  }
  __syncthreads();

  // ---- hidden channels in chunks of CK: expand -> depthwise -> dwo.
  for (int c0 = 0; c0 < p.Ch; c0 += CK) {
    const int ch = c0 + lane;
    const bool ch_ok = ch < p.Ch;
    if (p.w1 != nullptr) {
      for (int e = tid; e < words * CK; e += THREADS) {
        const int k4 = e / CK, cc = c0 + e % CK;
        uint32_t pk = 0;
        if (cc < p.Ch) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = 4 * k4 + i;
            if (k < p.Cin) {
              const uint8_t wb = static_cast<uint8_t>(p.w1[static_cast<int64_t>(k) * p.Ch + cc]);
              pk |= static_cast<uint32_t>(wb) << (8 * i);
            }
          }
        }
        w1s[e] = static_cast<int32_t>(pk);
      }
      __syncthreads();
      const float m1 = ch_ok ? p.m1[ch] : 0.0f;
      const float b1 = ch_ok ? p.b1[ch] : 0.0f;
      for (int p0 = warp * NP; p0 < PH; p0 += WARPS * NP) {
        int32_t acc[NP], neg[NP];
        const int32_t* xr[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          acc[j] = 0;
          neg[j] = 0;
          xr[j] = xw + min(p0 + j, PH - 1) * words;
        }
        for (int k4 = 0; k4 < words; ++k4) {
          const int32_t wv = w1s[k4 * CK + lane];
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            const int32_t xv = xr[j][k4];
            acc[j] = __dp4a(xv, wv, acc[j]);
            // uint8 bits: x = signed byte + 256 where it is negative.
            if (UNSIGNED) neg[j] = __dp4a((xv >> 7) & 0x01010101, wv, neg[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int pix = p0 + j;
          if (pix >= PH) break;
          const int r = ih0 + pix / p.iw, c = iw0 + pix % p.iw;
          float h = 0.0f;
          if (ch_ok && r >= 0 && r < p.H && c >= 0 && c < p.W) {
            const int32_t a = UNSIGNED ? acc[j] + 256 * neg[j] : acc[j];
            h = fmaxf(__fadd_rn(__fmul_rn(static_cast<float>(a), m1), b1), 0.0f);
            if (p.hidden_grid) h = clampf(rintf(__fmul_rn(h, p.inv_h)), 0.0f, p.qmax_h);
          }
          hid[pix * CK + lane] = h;
        }
      }
    } else {
      for (int pix = warp; pix < PH; pix += WARPS) {
        float v = 0.0f;
        if (ch_ok) {
          const int8_t xv = xs[pix * p.cin4 + ch];
          v = UNSIGNED ? static_cast<float>(static_cast<uint8_t>(xv)) : static_cast<float>(xv);
        }
        hid[pix * CK + lane] = v;
      }
    }
    __syncthreads();

    {
      float wv[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) wv[i] = ch_ok ? static_cast<float>(p.w2[i * p.Ch + ch]) : 0.0f;
      const float m2 = ch_ok ? p.m2[ch] : 0.0f;
      const float b2 = ch_ok ? p.b2[ch] : 0.0f;
      for (int op = warp; op < PO; op += WARPS) {
        const int r = op / p.tw, c = op % p.tw;
        const float* base = hid + ((r * p.stride) * p.iw + c * p.stride) * CK + lane;
        float acc = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc = __fadd_rn(acc, __fmul_rn(base[(dy * p.iw + dx) * CK], wv[dy * 3 + dx]));
        float y = fmaxf(__fadd_rn(__fmul_rn(acc, m2), b2), 0.0f);
        if (p.dw_grid) y = clampf(rintf(__fmul_rn(y, p.inv_d)), 0.0f, p.qmax_d);
        if (ch_ok) dwo[op * p.ds + ch] = __float2bfloat16_rn(y);
      }
    }
    __syncthreads();  // the next chunk overwrites hid
  }

  // ---- project: TP x TC register tiles, k in order across the w3 slabs.
  const int ncg = p.cout4 / TC;
  const int tiles = ncg * ((PO + TP - 1) / TP);
  const bool word_store = (p.Cout % TC) == 0;
  for (int pass0 = 0; pass0 < tiles; pass0 += THREADS) {
    const int tile = pass0 + tid;
    const bool active = tile < tiles;
    const int cg = active ? tile % ncg : 0;
    const int pg = active ? tile / ncg : 0;
    float acc[TP][TC];
    const __nv_bfloat16* yr[TP];
#pragma unroll
    for (int j = 0; j < TP; ++j) {
      yr[j] = dwo + min(pg * TP + j, PO - 1) * p.ds;
#pragma unroll
      for (int i = 0; i < TC; ++i) acc[j][i] = 0.0f;
    }
    for (int k0 = 0; k0 < p.Ch; k0 += p.kc) {
      const int kn = min(p.kc, p.Ch - k0);
      __syncthreads();  // the slab before this one has been read by all
      for (int e = tid; e < kn * p.cout4; e += THREADS) {
        const int k = e / p.cout4, c = e % p.cout4;
        w3s[e] = c < p.Cout
                     ? static_cast<float>(p.w3[static_cast<int64_t>(k0 + k) * p.Cout + c])
                     : 0.0f;
      }
      __syncthreads();
      if (active) {
        for (int k = 0; k < kn; ++k) {
          const float4 wv = *reinterpret_cast<const float4*>(w3s + k * p.cout4 + cg * TC);
#pragma unroll
          for (int j = 0; j < TP; ++j) {
            // bf16 x int8 is exact in f32: the fma's single rounding is
            // the rounded add of the exact product.
            const float yv = __bfloat162float(yr[j][k0 + k]);
            acc[j][0] = fmaf(yv, wv.x, acc[j][0]);
            acc[j][1] = fmaf(yv, wv.y, acc[j][1]);
            acc[j][2] = fmaf(yv, wv.z, acc[j][2]);
            acc[j][3] = fmaf(yv, wv.w, acc[j][3]);
          }
        }
      }
    }
    if (!active) continue;
    float m3[TC], b3[TC];
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const int co = cg * TC + i;
      m3[i] = co < p.Cout ? p.m3[co] : 0.0f;
      b3[i] = co < p.Cout ? p.b3[co] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < TP; ++j) {
      const int op = pg * TP + j;
      if (op >= PO) break;
      const int r = op / p.tw, c = op % p.tw;
      const int oh = oh0 + r, ow = ow0 + c;
      if (oh >= p.Ho || ow >= p.Wo) continue;
      int8_t* dst = p.out + ((b * p.Ho + oh) * p.Wo + ow) * p.Cout + cg * TC;
      // Residual blocks have stride 1: the input pixel sits one halo in.
      const int8_t* res = xs + ((r + 1) * p.iw + (c + 1)) * p.cin4 + cg * TC;
      uint32_t packed = 0;
#pragma unroll
      for (int i = 0; i < TC; ++i) {
        if (cg * TC + i >= p.Cout) break;
        const float pf = __fadd_rn(__fmul_rn(acc[j][i], m3[i]), b3[i]);
        float o;
        if (p.out_mode == OUT_PLAIN) {
          o = clampf(rintf(__fmul_rn(pf, p.ratio_out)), p.qmin_o, p.qmax_o);
        } else {
          const float q = clampf(rintf(__fmul_rn(pf, p.inv_sh)), -p.qmax_sh - 1.0f, p.qmax_sh);
          const float s = __fadd_rn(q, static_cast<float>(res[i]));
          o = p.out_mode == OUT_RES_RATIO
                  ? clampf(rintf(__fmul_rn(s, p.ratio_out)), p.qmin_o, p.qmax_o)
                  : clampf(s, -128.0f, 127.0f);
        }
        const int8_t v = static_cast<int8_t>(static_cast<int>(o));
        if (word_store) {
          packed |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * i);
        } else {
          dst[i] = v;
        }
      }
      if (word_store) *reinterpret_cast<uint32_t*>(dst) = packed;
    }
  }
}

inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Fills the tile fields of p for an output tile of th x tw pixels; returns
// the shared memory one block needs.
size_t layout(Params& p, int th, int tw) {
  p.th = th;
  p.tw = tw;
  p.ih = (th - 1) * p.stride + 3;
  p.iw = (tw - 1) * p.stride + 3;
  p.nty = (p.Ho + th - 1) / th;
  p.ntx = (p.Wo + tw - 1) / tw;
  const size_t PH = static_cast<size_t>(p.ih) * p.iw, PO = static_cast<size_t>(th) * tw;
  p.cin4 = (p.Cin + 3) / 4 * 4;
  p.cout4 = (p.Cout + 3) / 4 * 4;
  // Row stride of dwo in 32-bit words odd: the TP pixels of neighbouring
  // threads fall on different banks.
  p.ds = (p.Ch + 1) / 2 * 2;
  if (p.ds % 4 == 0) p.ds += 2;
  p.kc = W3_SLAB_FLOATS / p.cout4;
  if (p.kc < 1) p.kc = 1;
  if (p.kc > p.Ch) p.kc = p.Ch;
  const size_t xs = align16(PH * p.cin4);
  const size_t w1s = p.w1 != nullptr ? align16(static_cast<size_t>(p.cin4) * CK) : 0;
  const size_t hid = align16(PH * CK * sizeof(float));
  const size_t w3s = align16(static_cast<size_t>(p.kc) * p.cout4 * sizeof(float));
  // The expand's operands and the project's slab are never live together.
  const size_t shared = w1s + hid > w3s ? w1s + hid : w3s;
  p.off_w1s = static_cast<int>(xs);
  p.off_hid = static_cast<int>(xs + w1s);
  p.off_w3s = static_cast<int>(xs);
  p.off_dwo = static_cast<int>(xs + shared);
  return xs + shared + align16(PO * p.ds * sizeof(__nv_bfloat16));
}

// Operations one launch does with this tile, in the units its loops run in:
// the expand in rounds of WARPS * NP halo pixels (dp4a does four products an
// instruction), the nine taps over the output pixels, the projection in
// passes of THREADS register tiles, and a charge a block for its barriers.
double tile_cost(const Params& p) {
  const int PH = p.ih * p.iw, PO = p.th * p.tw;
  const int rounds = (PH + WARPS * NP - 1) / (WARPS * NP);
  const double expand = p.w1 != nullptr
                            ? static_cast<double>(rounds) * WARPS * NP * p.Cin * p.Ch / 4.0
                            : static_cast<double>(PH) * p.Ch;
  const int tiles = p.cout4 / TC * ((PO + TP - 1) / TP);
  const int passes = (tiles + THREADS - 1) / THREADS;
  const double project = static_cast<double>(passes) * THREADS * TP * TC * p.Ch;
  const double taps = 9.0 * PO * p.Ch;
  return static_cast<double>(p.nty) * p.ntx * (expand + taps + project + 50000.0);
}

}  // namespace

extern "C" int spef_fused_mbconv(
    const int8_t* x, int in_unsigned, const int8_t* w1, const float* m1, const float* b1,
    const int8_t* w2, const float* m2, const float* b2, const int8_t* w3, const float* m3,
    const float* b3, int8_t* out, int B, int H, int W, int Cin, int Ch, int Cout, int stride,
    int hidden_grid, float inv_h, float qmax_h, int dw_grid, float inv_d, float qmax_d,
    int out_mode, float inv_sh, float qmax_sh, float ratio_out, float qmin_o, float qmax_o,
    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ch <= 0 || Cout <= 0 ||
      (stride != 1 && stride != 2) || out_mode < OUT_PLAIN || out_mode > OUT_RES_SAME)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w1 == nullptr && Ch != Cin) return static_cast<int>(cudaErrorInvalidValue);
  if (out_mode != OUT_PLAIN && (stride != 1 || Cin != Cout || in_unsigned))
    return static_cast<int>(cudaErrorInvalidValue);

  Params p{};
  p.x = x; p.w1 = w1; p.m1 = m1; p.b1 = b1; p.w2 = w2; p.m2 = m2; p.b2 = b2;
  p.w3 = w3; p.m3 = m3; p.b3 = b3; p.out = out;
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Ch = Ch; p.Cout = Cout; p.stride = stride;
  p.Ho = (H - 1) / stride + 1;
  p.Wo = (W - 1) / stride + 1;
  p.x_words = (Cin % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);
  p.hidden_grid = hidden_grid; p.dw_grid = dw_grid; p.out_mode = out_mode;
  p.inv_h = inv_h; p.qmax_h = qmax_h; p.inv_d = inv_d; p.qmax_d = qmax_d;
  p.inv_sh = inv_sh; p.qmax_sh = qmax_sh; p.ratio_out = ratio_out;
  p.qmin_o = qmin_o; p.qmax_o = qmax_o;

  // The cheapest tile whose shared memory lets two blocks share an SM; if
  // none does, the cheapest that fits one block.
  static const int sizes[] = {1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 16, 20, 24, 30, 32};
  int best_th = 0, best_tw = 0;
  double best_cost = 0.0;
  for (const size_t limit : {SMEM_TWO, SMEM_MAX}) {
    for (const int sh : sizes) {
      for (const int sw : sizes) {
        const int th = sh < p.Ho ? sh : p.Ho, tw = sw < p.Wo ? sw : p.Wo;
        if (layout(p, th, tw) > limit) continue;
        const double cost = tile_cost(p);
        if (best_th == 0 || cost < best_cost) {
          best_th = th;
          best_tw = tw;
          best_cost = cost;
        }
      }
    }
    if (best_th != 0) break;
  }
  if (best_th == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layout(p, best_th, best_tw);
  const int64_t blocks = static_cast<int64_t>(B) * p.nty * p.ntx;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = in_unsigned ? mbconv_kernel<true> : mbconv_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_MAX));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spef_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
