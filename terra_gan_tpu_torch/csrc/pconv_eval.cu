// Fused eval-mode partial-convolution stage (K2), fp32, NHWC.
//
// Replaces the TPU kernel terra_gan_tpu/ops/pallas/pconv_kernel.py ::
// fused_pconv_eval (:297; bodies _kernel_s1 :98, _kernel_s2 :123,
// _epilogue :146, and the tall-stage strip form _call_kernel_s1 :232).
// One call computes a whole PConv2d stage of the U-Net in eval mode:
//
//   xm       = concat(x_a, x_b) * m            (implicit concat, no copy)
//   s        = boxsum_k(m)                     (the frozen ones-conv)
//   ratio    = k*k / (s + 1e-8) * [s > 0]
//   out      = ReLU(((conv(xm, w) + bias) * ratio) * a + bb)
//   new_mask = [s > 0]
//
// where a = gamma / sqrt(var + eps), bb = beta - mean * a fold the eval
// BatchNorm. The bias sits inside the renormalisation, as in the
// reference layer; the division is IEEE (no fast math) and the > 0 gate
// is exact, so 0/1 masks give exactly the reference's new_mask.
//
// The train forward (kTrain): the same product, box-sum and ratio, and an
// epilogue that writes the partial conv alone,
//
//   out      = (conv(xm, w) + bias) * ratio,   new_mask = [s > 0],
//
// what ops/pconv.py partial_conv2d_split returns. BatchNorm on the batch
// statistics and the ReLU follow it in PyTorch, and its backward is cuDNN's
// dgrad and wgrad (ops/cuda/pconv_kernel.py PConvTrain); bn_a and bn_b are
// not read. Each kernel is a body templated on kTrain: the eval kernels are
// the bodies at kTrain = false under their own names, the *_train_kernel
// ones at kTrain = true. Train mode runs it because cuDNN's heuristic,
// with its search off, takes an FFT path of tens of thousands of small
// GEMMs a step at some batches (33,024 at batch 5), which the host cannot
// launch as fast as the device runs them.
//
// The MMA variant: an implicit GEMM on the tensor cores in 3xTF32.
//   M = B*OH*OW output pixels (the batch folded into M), N = Cout,
//   K = k*k*(Ca+Cb) ordered (ky, kx, c): a K-chunk is kBK = 32 contiguous
//   NHWC channels of one tap, read from x_a for c < Ca and from x_b for
//   c >= Ca in place; a channel count that is not a multiple of 32 is
//   zero-filled by the copy (the wrapper requires Ca, Cb % 4 == 0).
//   Each fp32 operand is split into a TF32 hi and a TF32 residual lo,
//   and every product is lo*hi + hi*lo, then hi*hi, into one fp32
//   accumulator: the per-product error is about 2^-22 (TF32 alone:
//   2^-11), which the eval forward's 1e-6 NRMSE gate on dec2's features
//   needs (plain TF32 reads 1.45e-5 there). The weights arrive as two
//   planes, hi and lo, OHWI, K-major, from pack_tf32_kernel below: the
//   model packs every stage's planes in one launch at each eval forward,
//   so they are never older than the weights, however these were written
//   (an in-place write through .data moves no version counter); x*m is
//   formed and split in registers, as A goes from
//   shared memory into the MMA fragments, so it never reaches device
//   memory and the mask keeps its float semantics (0 * NaN is NaN).
//
// Bound on the H100 (SXM, 700 W): 3 TF32 products per fp32 product over
// 495 TFLOP/s of dense TF32, or the bytes over 3.35 TB/s, whichever is
// larger. At batch 2 the 14 stages are 186.6 GFLOP: 1.13 ms of
// operations; the deep stages at batch 1 are bound by their weight bytes.
//
// Design and why (times: profile_slice.py's stage leg on the H100, 700 W,
// which also runs each MMA stage on the other tile and unsplit; PERF.md):
// - mma.sync.m16n8k8 TF32 (HMMA in the SASS), not wgmma: A must be
//   masked and split between shared memory and the MMA, which a register
//   A operand of mma.sync takes as it is; wgmma's register-A form needs
//   the warpgroup fragment layout and 64-row tiles that enc7 and dec7
//   (16-64 pixels at batch 1) cannot fill. mma.sync reaches a part of
//   the dense TF32 rate; it is the first step, wgmma the next.
// - Tiles: 256 threads, 8 warps of 64 x 32 outputs each: 128 x 128 for
//   Cout > 64, 256 x 64 for Cout <= 64 and k <= 5 (at k = 7 that tile's
//   mask taps would not fit). At Cout = 64 (dec2, dec1) 256 x 64 is
//   1.8-1.9x faster than 128 x 128, half of whose columns would be empty;
//   elsewhere 128 x 128 is 2-5 % faster, 1.4x at enc7. Fragments
//   are read with 8-byte loads in a K order permuted within each 8-step,
//   identically for A and B; rows padded to 40 floats keep these loads
//   and the 16-byte copies free of bank conflicts.
// - Accumulation: each chunk's 3 x 4 MMAs sum from zero, two m-tiles at a
//   time, and are then added to the running sum in IEEE fp32. The MMA's
//   own accumulation truncates; into one running sum over K it read
//   7.9e-7 NRMSE on dec2's features, against the 1e-6 gate.
// - A three-stage ring of cp.async copies (16 bytes a thread, zero-fill
//   for padding, ragged channels and out-of-range rows and channels):
//   chunk i+2 is in flight while chunk i is multiplied; one barrier a
//   chunk of 32 channels. Three is the most that fits: 190-215 KB of
//   shared memory, one block an SM (four stages would need 250-270 KB).
// - The mask of every tap of the tile's pixels is staged once a tile
//   (while the first copies fly); the box-sum, the ratio and new_mask
//   come from it. new_mask is written once a pixel (by N-tile 0).
// - Split-K where the M x N tiles fill the 132 SMs' waves badly (the
//   deep stages; the wrapper's plan_stage picks the count): split z
//   takes the chunks [z*C/S, (z+1)*C/S), writes an fp32 partial tile to
//   a workspace, and pconv_splitk_reduce_kernel sums the splits in
//   order, with no atomics, and applies the epilogue: bitwise the same
//   result from call to call. Every split stage is faster split: at
//   batch 8 enc7 (30 splits) 9x, dec7 (8) 6x, enc5 (2) 1.8x; at batch 1
//   dec7 (30) 13x.
//
// The one-channel variant (pconv_c1_kernel), enc1 at every width: one
// input channel (Ca + Cb == 1), Cout a multiple of 8 up to 64, any k up
// to 7, stride 1 or 2. The MMA variant's 32-channel chunks would be 31/32
// zeros here. At batch 8 and 512^2 the stage writes 134 MB of output
// (over twice the 50 MB L2) and reads 17 MB: bound by its bytes, 0.046 ms
// at 3.35 TB/s, over its 3.29 GFLOP of 3xTF32 products (0.020 ms).
// - Persistent blocks, two an SM, each walking output tiles of 8 rows x
//   32 columns (a warp a row); plan_c1 in the wrapper sets the grid.
// - Each block stages the weight's TF32 planes (the forward's pack,
//   [Cout][k*k]) once into shared memory, rows of k*k padded with zeros to
//   56, with the bias and the folded BatchNorm.
// - A tile's x and mask patch (21 x 69 at stride 2, k 7) is staged once
//   by cp.async as 21 rows of 72 floats from a 16-byte boundary (16 bytes
//   a copy where W % 4 == 0, 4 otherwise), zero outside the image; the
//   next tile's patch is in flight (a double buffer) while this one is
//   multiplied. x*m is formed once a staged element (0 * NaN stays NaN)
//   and split once into TF32 hi and lo planes of the same layout, a float4
//   at a time.
// - The box-sum is separable: row sums of k over the staged mask (every
//   thread), then each thread's column sums of k for its own pixels, each
//   sum's loads unrolled to 7 and issued together; on 0/1 masks every
//   partial sum is an exact integer, so new_mask and the ratio equal the
//   direct k*k-tap sum's.
// - The product on the tensor cores in 3xTF32 (mma.sync): M = a warp's 32
//   pixels, N = Cout; K = k*k padded with zeros to a multiple of 8, in
//   k-steps of 8 taps (m16n8k8): K = 49 runs as 56. A fragments are
//   gathered from the split planes through a table of tap offsets (a padded
//   tap reads tap 0, whose weight is 0 there), B from the weight planes; per
//   k-step lo*hi, hi*lo, then hi*hi into one sum from zero, the three
//   products into one sum 8 MMAs apart.
// - The epilogue in registers (bias, ratio, the folded BatchNorm, a ReLU
//   that keeps NaN); a quad's neighbours swap halves of an n-tile pair, so
//   each thread streams one float4 (__stcs) and a quad fills 64 bytes of a
//   pixel's channel row.
// Measured on an H100 80GB HBM3 at 700 W (profile_slice.py --legs stage,
// device ms by graph replay, batch 8): 0.086-0.087 ms against the SIMT
// kernel's 0.383-0.385 and cuDNN's conv alone 0.310. An fp32-FMA inner
// product over the same blocks (4 pixels x 16 channels a thread) took
// 0.143-0.149 against the MMA's 0.086-0.110 in the same calls. With the stores left out the
// kernel took 0.079-0.090, with the MMAs left out 0.064-0.077, with both
// left out 0.041-0.050: what holds it is the latency of the per-tile
// phases at 16 warps an SM, not the tensor cores. Issuing the three
// products into one sum 2 MMAs apart cost 9 %; runtime divisions and
// k-loops that were not unrolled in the staging, split and box-sum 12 %;
// float2 stores 2 % over the float4s; plain stores against __stcs nothing.
// A last k-step of 4 taps (m16n8k4, K = 49 as 52) took 0.0853 and 0.0856
// against K = 56's 0.0868 twice, in turns in one call: 1.5-1.8 %, 0.0015
// ms of a 19 ms forward, for a second copy of the k-step; not kept.
//
// The SIMT variant (pconv_simt_kernel): the other channel counts that are
// not multiples of 4 (only narrow test models have them). One block per
// (batch element, 8x8 output tile, 64 output channels); the masked
// input patch is staged 8 channels at a time and each thread
// accumulates 4 pixels x 4 output channels in fp32 FMA, reading HWIO
// weights as float4.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

// ---------------------------------------------------------------- SIMT

constexpr int kTH = 8;         // output tile rows
constexpr int kTW = 8;         // output tile columns
constexpr int kBN = 64;        // output channels per block
constexpr int kCK = 8;         // input channels per staged chunk
constexpr int kThreads = 256;  // 16 pixel groups x 16 channel groups
constexpr int kMaxK = 7;
constexpr int kMaxStride = 2;
constexpr int kMaxPH = (kTH - 1) * kMaxStride + kMaxK;
constexpr int kMaxPW = (kTW - 1) * kMaxStride + kMaxK;
constexpr int kMaxPatch = kMaxPH * kMaxPW;

template <bool kTrain>
__device__ __forceinline__ void pconv_simt_body(
    const float* __restrict__ xa, const float* __restrict__ xb, const float* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ bias, const float* __restrict__ bn_a,
    const float* __restrict__ bn_b, float* __restrict__ out, float* __restrict__ new_mask, int H,
    int W, int Ca, int Cb, int Cout, int k, int stride, int pad, int OH, int OW, int tiles_x) {
  __shared__ float patch[kCK][kMaxPatch];
  __shared__ float mpatch[kMaxPatch];
  __shared__ float s_ratio[kTH * kTW];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * kBN;
  const int oy0 = (blockIdx.x / tiles_x) * kTH;
  const int ox0 = (blockIdx.x % tiles_x) * kTW;
  const int PH = (kTH - 1) * stride + k;
  const int PW = (kTW - 1) * stride + k;
  const int npatch = PH * PW;
  const int iy0 = oy0 * stride - pad;
  const int ix0 = ox0 * stride - pad;
  const int cin = Ca + Cb;

  // Mask patch; outside the image it is the conv's zero padding.
  for (int i = tid; i < npatch; i += kThreads) {
    const int iy = iy0 + i / PW;
    const int ix = ix0 + i % PW;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      v = mask[((size_t)b * H + iy) * W + ix];
    }
    mpatch[i] = v;
  }
  __syncthreads();

  // Box-sum, renormalisation ratio and the new mask, one pixel a thread.
  if (tid < kTH * kTW) {
    const int py = tid / kTW;
    const int px = tid % kTW;
    float s = 0.f;
    for (int ky = 0; ky < k; ++ky) {
      for (int kx = 0; kx < k; ++kx) {
        s += mpatch[(py * stride + ky) * PW + px * stride + kx];
      }
    }
    const bool valid = s > 0.f;
    s_ratio[tid] = valid ? (float)(k * k) / (s + 1e-8f) : 0.f;
    const int oy = oy0 + py;
    const int ox = ox0 + px;
    if (blockIdx.y == 0 && oy < OH && ox < OW) {
      new_mask[((size_t)b * OH + oy) * OW + ox] = valid ? 1.f : 0.f;
    }
  }

  const int tn = tid % 16;         // output channels n .. n+3
  const int tm = tid / 16;         // pixels (py, px0 .. px0+3)
  const int py = tm / 2;
  const int px0 = (tm % 2) * 4;
  const int n = n0 + 4 * tn;
  const bool n_ok = n < Cout;      // the wrapper requires Cout % 4 == 0
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }

  for (int c0 = 0; c0 < cin; c0 += kCK) {
    __syncthreads();  // the previous chunk is consumed (and s_ratio is set)
    for (int i = tid; i < kCK * npatch; i += kThreads) {
      const int c = i % kCK;
      const int pos = i / kCK;
      const int cg = c0 + c;
      const int iy = iy0 + pos / PW;
      const int ix = ix0 + pos % PW;
      float v = 0.f;
      if (cg < cin && iy >= 0 && iy < H && ix >= 0 && ix < W) {
        const size_t pix = ((size_t)b * H + iy) * W + ix;
        const float xv = cg < Ca ? xa[pix * Ca + cg] : xb[pix * Cb + (cg - Ca)];
        v = xv * mpatch[pos];
      }
      patch[c][pos] = v;
    }
    __syncthreads();

    const int ck = min(kCK, cin - c0);
    for (int ky = 0; ky < k; ++ky) {
      for (int kx = 0; kx < k; ++kx) {
        const float* wp = w + ((size_t)(ky * k + kx) * cin + c0) * Cout + n;
        const int base = (py * stride + ky) * PW + px0 * stride + kx;
#pragma unroll
        for (int c = 0; c < kCK; ++c) {
          if (c < ck) {
            float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
            if (n_ok) wv = __ldg(reinterpret_cast<const float4*>(wp + (size_t)c * Cout));
            const float* pr = &patch[c][base];
            const float a[4] = {pr[0], pr[stride], pr[2 * stride], pr[3 * stride]};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[j][0] += a[j] * wv.x;
              acc[j][1] += a[j] * wv.y;
              acc[j][2] += a[j] * wv.z;
              acc[j][3] += a[j] * wv.w;
            }
          }
        }
      }
    }
  }

  if (!n_ok) return;
  const float4 bv = *reinterpret_cast<const float4*>(bias + n);
  float4 av, cv;
  if (!kTrain) {
    av = *reinterpret_cast<const float4*>(bn_a + n);
    cv = *reinterpret_cast<const float4*>(bn_b + n);
  }
  const int oy = oy0 + py;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ox = ox0 + px0 + j;
    if (oy < OH && ox < OW) {
      const float r = s_ratio[py * kTW + px0 + j];
      float4 o;
      if (kTrain) {
        o.x = (acc[j][0] + bv.x) * r;
        o.y = (acc[j][1] + bv.y) * r;
        o.z = (acc[j][2] + bv.z) * r;
        o.w = (acc[j][3] + bv.w) * r;
      } else {
        o.x = ((acc[j][0] + bv.x) * r) * av.x + cv.x;
        o.y = ((acc[j][1] + bv.y) * r) * av.y + cv.y;
        o.z = ((acc[j][2] + bv.z) * r) * av.z + cv.z;
        o.w = ((acc[j][3] + bv.w) * r) * av.w + cv.w;
        // ReLU that keeps a NaN, as torch.relu does
        o.x = o.x < 0.f ? 0.f : o.x;
        o.y = o.y < 0.f ? 0.f : o.y;
        o.z = o.z < 0.f ? 0.f : o.z;
        o.w = o.w < 0.f ? 0.f : o.w;
      }
      *reinterpret_cast<float4*>(out + (((size_t)b * OH + oy) * OW + ox) * Cout + n) = o;
    }
  }
}

#define TG_SIMT_PARAMS                                                                         \
  const float* __restrict__ xa, const float* __restrict__ xb, const float* __restrict__ mask, \
      const float* __restrict__ w, const float* __restrict__ bias,                            \
      const float* __restrict__ bn_a, const float* __restrict__ bn_b, float* __restrict__ out, \
      float* __restrict__ new_mask, int H, int W, int Ca, int Cb, int Cout, int k, int stride, \
      int pad, int OH, int OW, int tiles_x
#define TG_SIMT_ARGS \
  xa, xb, mask, w, bias, bn_a, bn_b, out, new_mask, H, W, Ca, Cb, Cout, k, stride, pad, OH, OW, tiles_x

__global__ void __launch_bounds__(kThreads) pconv_simt_kernel(TG_SIMT_PARAMS) {
  pconv_simt_body<false>(TG_SIMT_ARGS);
}

// at least one block an SM: with the eval kernel's bounds ptxas holds this
// one to 40 registers and spills
__global__ void __launch_bounds__(kThreads, 1) pconv_simt_train_kernel(TG_SIMT_PARAMS) {
  pconv_simt_body<true>(TG_SIMT_ARGS);
}

#undef TG_SIMT_PARAMS
#undef TG_SIMT_ARGS

// ----------------------------------------------------------------- MMA

constexpr int kBK = 32;           // K-chunk: 32 channels of one tap
constexpr int kLds = kBK + 8;     // shared-memory row stride, in floats
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kMmaThreads = 256;  // 8 warps, a 64 x 32 output tile each

struct MmaArgs {
  const float* xa;
  const float* xb;
  const float* mask;
  const float* w_hi;      // [Cout][k][k][Ca+Cb], TF32 hi
  const float* w_lo;      // the same, TF32 residual
  const float* bias;
  const float* bn_a;
  const float* bn_b;
  float* out;
  float* new_mask;
  float* ws;              // [splits][M][Cout] partial sums, splits > 1
  float* ratio_ws;        // [M] renormalisation ratios, splits > 1
  int H, W, Ca, Cb, Cout, k, stride, pad, OH, OW, M;
  int nca, ncb;           // K-chunks a tap of x_a and of x_b
  int chunks;             // k*k*(nca+ncb)
  int splits;
};

__host__ __device__ constexpr int mma_smem_floats(int bm, int bn, int kk) {
  return kStages * bm * kLds + kStages * 2 * bn * kLds  // the A and B rings
         + 4 * bm                                        // row table (int4)
         + bm                                            // ratios
         + bm * kk;                                      // mask taps
}

template <int WM, int WN, bool kTrain>
__device__ __forceinline__ void pconv_mma_body(const MmaArgs& p) {
  constexpr int BM = WM * 64;
  constexpr int BN = WN * 32;
  constexpr int kSegA = BM * (kBK / 4) / kMmaThreads;      // 16-byte copies a thread
  constexpr int kSegB = 2 * BN * (kBK / 4) / kMmaThreads;  // both planes
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                                 // [kStages][BM][kLds]
  float* sB = sA + kStages * BM * kLds;             // [kStages][2][BN][kLds]
  int4* rowtab = reinterpret_cast<int4*>(sB + kStages * 2 * BN * kLds);  // [BM]
  float* s_ratio = reinterpret_cast<float*>(rowtab + BM);                // [BM]
  float* mtap = s_ratio + BM;                                            // [BM][k*k]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int z = blockIdx.z;
  const int kk = p.k * p.k;
  const int cin = p.Ca + p.Cb;
  const int Kw = kk * cin;
  const int OHW = p.OH * p.OW;
  const int per_tap = p.nca + p.ncb;

  // Each row of the tile: (its image's first pixel, top-left input row
  // and column of its window). A row past M gets a window far outside
  // the image, so every tap reads as padding.
  for (int r = tid; r < BM; r += kMmaThreads) {
    const int pix = m0 + r;
    int4 e = make_int4(0, -(1 << 28), -(1 << 28), 0);
    if (pix < p.M) {
      const int b = pix / OHW;
      const int rem = pix - b * OHW;
      const int oy = rem / p.OW;
      const int ox = rem - oy * p.OW;
      e = make_int4(b * p.H * p.W, oy * p.stride - p.pad, ox * p.stride - p.pad, 0);
    }
    rowtab[r] = e;
  }
  __syncthreads();

  const int c_begin = (int)((long long)z * p.chunks / p.splits);
  const int c_end = (int)((long long)(z + 1) * p.chunks / p.splits);
  const int nchunk = c_end - c_begin;

  // Chunk c (tap-major, then x_a's chunks, then x_b's) into ring slot `slot`.
  auto load_chunk = [&](int c, int slot) {
    const int tap = c / per_tap;
    const int sub = c - tap * per_tap;
    const int ky = tap / p.k;
    const int kx = tap - ky * p.k;
    const bool part_a = sub < p.nca;
    const int c0 = (part_a ? sub : sub - p.nca) * kBK;
    const int C = part_a ? p.Ca : p.Cb;
    const float* src = part_a ? p.xa : p.xb;
    const int koff = tap * cin + (part_a ? 0 : p.Ca) + c0;
    float* a_dst = sA + slot * BM * kLds;
#pragma unroll
    for (int i = 0; i < kSegA; ++i) {
      const int seg = tid + i * kMmaThreads;
      const int r = seg >> 3;
      const int q = seg & 7;
      const int4 e = rowtab[r];
      const int iy = e.y + ky;
      const int ix = e.z + kx;
      const int ch = c0 + 4 * q;
      const bool ok = (unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W && ch < C;
      const float* g = ok ? src + ((size_t)(e.x + iy * p.W + ix) * C + ch) : p.xa;
      cp_async16(a_dst + r * kLds + 4 * q, g, ok);
    }
    float* b_dst = sB + slot * 2 * BN * kLds;
#pragma unroll
    for (int i = 0; i < kSegB; ++i) {
      const int seg = tid + i * kMmaThreads;
      const int plane = seg / (BN * 8);
      const int rr = seg - plane * BN * 8;
      const int r = rr >> 3;
      const int q = rr & 7;
      const int n = n0 + r;
      const bool ok = n < p.Cout && c0 + 4 * q < C;
      const float* w = plane ? p.w_lo : p.w_hi;
      const float* g = ok ? w + ((size_t)n * Kw + koff + 4 * q) : w;
      cp_async16(b_dst + (plane * BN + r) * kLds + 4 * q, g, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunk) load_chunk(c_begin + s, s);
    cp_async_commit();
  }

  // While the first chunks fly: the mask at every tap of every row, zero
  // outside the image (the ones-conv's padding), and from it the ratio.
  for (int i = tid; i < BM * kk; i += kMmaThreads) {
    const int r = i / kk;
    const int tp = i - r * kk;
    const int ky = tp / p.k;
    const int kx = tp - ky * p.k;
    const int4 e = rowtab[r];
    const int iy = e.y + ky;
    const int ix = e.z + kx;
    float v = 0.f;
    if ((unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W) {
      v = p.mask[e.x + iy * p.W + ix];
    }
    mtap[i] = v;
  }
  __syncthreads();
  if (tid < BM) {
    float s = 0.f;
    for (int tp = 0; tp < kk; ++tp) s += mtap[tid * kk + tp];
    const bool valid = s > 0.f;
    const float ratio = valid ? (float)kk / (s + 1e-8f) : 0.f;
    s_ratio[tid] = ratio;
    const int pix = m0 + tid;
    if (blockIdx.y == 0 && z == 0 && pix < p.M) {
      p.new_mask[pix] = valid ? 1.f : 0.f;
      if (p.splits > 1) p.ratio_ws[pix] = ratio;
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int g = lane >> 2;  // the fragment's row (A, C) or column (B)
  const int t = lane & 3;   // the fragment's K index (A, B) or column pair (C)
  const int arow = wm * 64 + g;
  const int brow = wn * 32 + g;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c = 0; c < nchunk; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed for all; slot (c-1) % kStages is free
    if (c + kStages - 1 < nchunk) load_chunk(c_begin + c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();

    const int slot = c % kStages;
    const float* a_s = sA + slot * BM * kLds;
    const float* bh_s = sB + slot * 2 * BN * kLds;
    const float* bl_s = bh_s + BN * kLds;
    const int tap = (c_begin + c) / per_tap;
    float mv[4][2];  // the mask at this tap for the thread's 8 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mv[i][0] = mtap[(arow + i * 16) * kk + tap];
      mv[i][1] = mtap[(arow + i * 16 + 8) * kk + tap];
    }

    // K order within the chunk: at step ks the quad's 8 K indices are the
    // channels 8ks .. 8ks+7, thread t's logical index t the channel
    // 8ks + 2t and index t + 4 the next, read as one 8-byte load.
    // Two m-tiles at a time, the chunk's products are summed on the tensor
    // cores from zero and then added to acc in IEEE fp32: the MMA's own
    // accumulation truncates, and into a running sum of the whole K its
    // error grows with K (on the H100, dec2's features read 7.9e-7 NRMSE
    // that way in chip_smoke.py, against a 1e-6 gate).
#pragma unroll
    for (int ip = 0; ip < 2; ++ip) {
      float part[2][4][4];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[ii][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kBK / 8; ++ks) {
        const int col = 8 * ks + 2 * t;
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 vh = *reinterpret_cast<const float2*>(bh_s + (brow + j * 8) * kLds + col);
          const float2 vl = *reinterpret_cast<const float2*>(bl_s + (brow + j * 8) * kLds + col);
          bhi[j][0] = __float_as_uint(vh.x);
          bhi[j][1] = __float_as_uint(vh.y);
          blo[j][0] = __float_as_uint(vl.x);
          blo[j][1] = __float_as_uint(vl.y);
        }
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int i = 2 * ip + ii;
          const float2 u0 = *reinterpret_cast<const float2*>(a_s + (arow + i * 16) * kLds + col);
          const float2 u1 = *reinterpret_cast<const float2*>(a_s + (arow + i * 16 + 8) * kLds + col);
          // x * m, as the fragment wants it: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
          const float v[4] = {u0.x * mv[i][0], u1.x * mv[i][1], u0.y * mv[i][0], u1.y * mv[i][1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ahi[ii][e] = tf32_rna(v[e]);
            alo[ii][e] = tf32_rna(v[e] - __uint_as_float(ahi[ii][e]));
          }
        }
        // the small products first, hi*hi last, into the same sum
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(part[ii][j], alo[ii], bhi[j][0], bhi[j][1]);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(part[ii][j], ahi[ii], blo[j][0], blo[j][1]);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(part[ii][j], ahi[ii], bhi[j][0], bhi[j][1]);
      }
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[2 * ip + ii][j][e] += part[ii][j][e];
    }
  }
  cp_async_wait<0>();

  // Epilogue: the fragment's rows g, g+8 and columns 2t, 2t+1.
  const bool split = p.splits > 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = arow + i * 16 + hr * 8;
      const int pix = m0 + r;
      if (pix >= p.M) continue;
      const float ratio = s_ratio[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        if (n >= p.Cout) continue;  // Cout % 4 == 0: n and n + 1 both in range
        const float v0 = acc[i][j][2 * hr];
        const float v1 = acc[i][j][2 * hr + 1];
        if (split) {
          *reinterpret_cast<float2*>(p.ws + ((size_t)z * p.M + pix) * p.Cout + n) =
              make_float2(v0, v1);
        } else if (kTrain) {
          *reinterpret_cast<float2*>(p.out + (size_t)pix * p.Cout + n) =
              make_float2((v0 + p.bias[n]) * ratio, (v1 + p.bias[n + 1]) * ratio);
        } else {
          float2 o;
          o.x = relu_keep_nan(((v0 + p.bias[n]) * ratio) * p.bn_a[n] + p.bn_b[n]);
          o.y = relu_keep_nan(((v1 + p.bias[n + 1]) * ratio) * p.bn_a[n + 1] + p.bn_b[n + 1]);
          *reinterpret_cast<float2*>(p.out + (size_t)pix * p.Cout + n) = o;
        }
      }
    }
  }
}

template <int WM, int WN>
__global__ void __launch_bounds__(kMmaThreads, 1) pconv_mma_kernel(const MmaArgs p) {
  pconv_mma_body<WM, WN, false>(p);
}

template <int WM, int WN>
__global__ void __launch_bounds__(kMmaThreads, 1) pconv_mma_train_kernel(const MmaArgs p) {
  pconv_mma_body<WM, WN, true>(p);
}

// The splits' partial sums added in split order (no atomics), then the
// epilogue; a block per pixel (grid-stride), a thread per 4 channels.
template <bool kTrain>
__device__ __forceinline__ void pconv_splitk_reduce_body(
    const float* __restrict__ ws, const float* __restrict__ ratio_ws,
    const float* __restrict__ bias, const float* __restrict__ bn_a,
    const float* __restrict__ bn_b, float* __restrict__ out, int M, int Cout, int splits) {
  const size_t plane = (size_t)M * Cout;
  for (int pix = blockIdx.x; pix < M; pix += gridDim.x) {
    const float r = ratio_ws[pix];
    for (int n = 4 * threadIdx.x; n < Cout; n += 4 * blockDim.x) {
      const size_t i = (size_t)pix * Cout + n;
      float4 s = *reinterpret_cast<const float4*>(ws + i);
      for (int zz = 1; zz < splits; ++zz) {
        const float4 v = *reinterpret_cast<const float4*>(ws + zz * plane + i);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const float4 bv = *reinterpret_cast<const float4*>(bias + n);
      if (kTrain) {
        *reinterpret_cast<float4*>(out + i) =
            make_float4((s.x + bv.x) * r, (s.y + bv.y) * r, (s.z + bv.z) * r, (s.w + bv.w) * r);
        continue;
      }
      const float4 av = *reinterpret_cast<const float4*>(bn_a + n);
      const float4 cv = *reinterpret_cast<const float4*>(bn_b + n);
      float4 o;
      o.x = relu_keep_nan(((s.x + bv.x) * r) * av.x + cv.x);
      o.y = relu_keep_nan(((s.y + bv.y) * r) * av.y + cv.y);
      o.z = relu_keep_nan(((s.z + bv.z) * r) * av.z + cv.z);
      o.w = relu_keep_nan(((s.w + bv.w) * r) * av.w + cv.w);
      *reinterpret_cast<float4*>(out + i) = o;
    }
  }
}

__global__ void __launch_bounds__(128)
pconv_splitk_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ ratio_ws,
                           const float* __restrict__ bias, const float* __restrict__ bn_a,
                           const float* __restrict__ bn_b, float* __restrict__ out, int M,
                           int Cout, int splits) {
  pconv_splitk_reduce_body<false>(ws, ratio_ws, bias, bn_a, bn_b, out, M, Cout, splits);
}

__global__ void __launch_bounds__(128)
pconv_splitk_reduce_train_kernel(const float* __restrict__ ws, const float* __restrict__ ratio_ws,
                                 const float* __restrict__ bias, float* __restrict__ out, int M,
                                 int Cout, int splits) {
  pconv_splitk_reduce_body<true>(ws, ratio_ws, bias, nullptr, nullptr, out, M, Cout, splits);
}

template <int WM, int WN>
int launch_mma(const MmaArgs& a, bool train, cudaStream_t stream) {
  constexpr int BM = WM * 64;
  constexpr int BN = WN * 32;
  const size_t smem = sizeof(float) * mma_smem_floats(BM, BN, a.k * a.k);
  auto* const kernel = train ? pconv_mma_train_kernel<WM, WN> : pconv_mma_kernel<WM, WN>;
  // above 48 KB only after this; per call, since it is set per device
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.M + BM - 1) / BM, (a.Cout + BN - 1) / BN, a.splits);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  const int blocks = a.M < 132 * 16 ? a.M : 132 * 16;
  if (train) {
    pconv_splitk_reduce_train_kernel<<<blocks, 128, 0, stream>>>(a.ws, a.ratio_ws, a.bias, a.out,
                                                                 a.M, a.Cout, a.splits);
  } else {
    pconv_splitk_reduce_kernel<<<blocks, 128, 0, stream>>>(a.ws, a.ratio_ws, a.bias, a.bn_a,
                                                           a.bn_b, a.out, a.M, a.Cout, a.splits);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ one channel (enc1)

constexpr int kC1TH = 8;          // output tile rows: a warp a row
constexpr int kC1TW = 32;         // output tile columns: a warp's two m-tiles
constexpr int kC1Threads = 256;
constexpr int kC1BlocksPerSm = 2;
constexpr int kC1MaxN = 64;       // output channels
constexpr int kC1KP = 56;         // k*k padded to 7 k-steps of 8: a weight row
constexpr int kC1PH = (kC1TH - 1) * kMaxStride + kMaxK;  // 21 patch rows
constexpr int kC1PW = (kC1TW - 1) * kMaxStride + kMaxK;  // 69 patch columns
// a staged row (x, mask, and the x*m planes in the same layout) starts at
// the 16-byte boundary at or before the patch's first column, 0-3 columns
// early: 3 + 69 columns used of 18 float4s
constexpr int kC1Pitch = 72;
static_assert(3 + kC1PW <= kC1Pitch && kC1Pitch % 4 == 0, "a staged row holds the patch row");

// shared memory, in floats
constexpr int kC1SmemW = 2 * kC1MaxN * kC1KP;        // weight planes hi, lo [64][56]
constexpr int kC1SmemRawBuf = 2 * kC1PH * kC1Pitch;  // one buffer: x, mask [21][72]
constexpr int kC1SmemPlane = kC1PH * kC1Pitch;       // x*m hi, lo [21][72]
constexpr int kC1SmemRows = kC1PH * kC1TW;           // the mask's row sums [21][32]
constexpr int kC1SmemFloats = kC1SmemW + 2 * kC1SmemRawBuf + 2 * kC1SmemPlane + kC1SmemRows +
                              3 * kC1MaxN    // bias, bn_a, bn_b
                              + kC1KP;       // tap offsets (int)

struct C1Args {
  const float* x;         // [B][H][W]
  const float* mask;      // [B][H][W]
  const float* w_hi;      // [Cout][k*k], TF32 hi
  const float* w_lo;      // [Cout][k*k], TF32 residual
  const float* bias;
  const float* bn_a;
  const float* bn_b;
  float* out;             // [B][OH][OW][Cout]
  float* new_mask;        // [B][OH][OW]
  int H, W, Cout, k, stride, pad, OH, OW, tiles_x, tiles_y, tiles;
};

// 4 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

// tile t of the walk: its batch element and first output row and column
__device__ __forceinline__ void c1_tile(const C1Args& p, int t, int& b, int& oy0, int& ox0) {
  const int tx = t % p.tiles_x;
  const int rest = t / p.tiles_x;
  b = rest / p.tiles_y;
  oy0 = (rest - b * p.tiles_y) * kC1TH;
  ox0 = tx * kC1TW;
}

// Tile t's x and mask patch into raw ([x, mask][PH][kC1Pitch]): rows from
// iy0, kC1Pitch columns from the 16-byte boundary at or before ix0; zero
// outside the image (the convolutions' padding). With W % 4 == 0 a float4
// of a row lies wholly in the image or wholly out of it.
template <bool kVec>
__device__ __forceinline__ void c1_stage(const C1Args& p, int t, float* raw, int PH) {
  int b, oy0, ox0;
  c1_tile(p, t, b, oy0, ox0);
  const int iy0 = oy0 * p.stride - p.pad;
  const int ixa = (ox0 * p.stride - p.pad) & ~3;
  constexpr int per = kVec ? kC1Pitch / 4 : kC1Pitch;  // copies a row
  const int n = 2 * PH * per;
  for (int i = threadIdx.x; i < n; i += kC1Threads) {
    const int arr = i >= PH * per;
    const int rem = i - arr * PH * per;
    const int r = rem / per;
    const int c = (rem - r * per) * (kVec ? 4 : 1);
    const int iy = iy0 + r;
    const int ix = ixa + c;
    const bool ok = (unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W;
    const float* src = arr ? p.mask : p.x;
    const float* g = ok ? src + ((b * p.H + iy) * p.W + ix) : src;
    float* dst = raw + (arr * kC1PH + r) * kC1Pitch + c;
    if (kVec)
      cp_async16(dst, g, ok);
    else
      cp_async4(dst, g, ok);
  }
}

__device__ __forceinline__ void c1_stage(const C1Args& p, int t, float* raw, int PH, bool vec) {
  if (vec)
    c1_stage<true>(p, t, raw, PH);
  else
    c1_stage<false>(p, t, raw, PH);
}

template <bool kTrain>
__device__ __forceinline__ void pconv_c1_body(const C1Args& p) {
  extern __shared__ __align__(16) float smem[];
  float* sW = smem;                          // hi, lo [64][56]
  float* sRaw = sW + kC1SmemW;               // [2 buffers][x, mask][21][72]
  float* sPl = sRaw + 2 * kC1SmemRawBuf;     // x*m hi, lo in the staged layout
  float* sRows = sPl + 2 * kC1SmemPlane;     // [21][32]
  float* sEpi = sRows + kC1SmemRows;         // bias, bn_a, bn_b [64] each
  int* sTab = reinterpret_cast<int*>(sEpi + 3 * kC1MaxN);  // [56]

  const int tid = threadIdx.x;
  const int k = p.k, s = p.stride, kk = k * k;
  const int PH = (kC1TH - 1) * s + k;
  // ox0 * s is a multiple of 4, so every tile's patch starts (-pad) & 3
  // columns past its row's 16-byte boundary
  const int shift = (-p.pad) & 3;
  const bool vec = (p.W & 3) == 0;

  // once a block: the weights, the epilogue's vectors, the tap offsets
  for (int i = tid; i < kC1MaxN * kC1KP; i += kC1Threads) {
    const int n = i / kC1KP;
    const int kx = i - n * kC1KP;
    const bool ok = n < p.Cout && kx < kk;
    sW[i] = ok ? p.w_hi[n * kk + kx] : 0.f;
    sW[kC1MaxN * kC1KP + i] = ok ? p.w_lo[n * kk + kx] : 0.f;
  }
  for (int i = tid; i < kC1MaxN; i += kC1Threads) {
    const bool ok = i < p.Cout;
    sEpi[i] = ok ? p.bias[i] : 0.f;
    if (!kTrain) {
      sEpi[kC1MaxN + i] = ok ? p.bn_a[i] : 0.f;
      sEpi[2 * kC1MaxN + i] = ok ? p.bn_b[i] : 0.f;
    }
  }
  // a tap's offset from a pixel's window origin in the planes; a padded
  // tap reads tap 0 (finite, or NaN where the pixel's output is NaN anyway)
  for (int i = tid; i < kC1KP; i += kC1Threads) {
    sTab[i] = i < kk ? (i / k) * kC1Pitch + i % k : 0;
  }

  int t = blockIdx.x;
  if (t < p.tiles) c1_stage(p, t, sRaw, PH, vec);
  cp_async_commit();

  const int lane = tid & 31;
  const int g = lane >> 2;  // the fragment's row (A, C) or column (B)
  const int tq = lane & 3;  // the fragment's K index (A, B) or column pair (C)
  const int py = tid >> 5;  // the warp's output row of the tile
  // k-steps of 8 taps over K padded to a multiple of 8 (K = 49: 7 k-steps)
  const int ksteps = (kk + 7) >> 3;
  const int ntiles = p.Cout >> 3;
  const float* pHi = sPl;
  const float* pLo = sPl + kC1SmemPlane;
  const int base = py * s * kC1Pitch + shift + g * s;  // pixel g's window origin

  for (int it = 0; t < p.tiles; t += gridDim.x, ++it) {
    const float* rx = sRaw + (it & 1) * kC1SmemRawBuf;
    const float* rm = rx + kC1PH * kC1Pitch;
    cp_async_wait<0>();
    __syncthreads();  // this patch landed; the last tile's planes and sums are read
    if (t + (int)gridDim.x < p.tiles)
      c1_stage(p, t + gridDim.x, sRaw + ((it + 1) & 1) * kC1SmemRawBuf, PH, vec);
    cp_async_commit();

    // x*m once a staged element, float4 by float4 in the staged layout,
    // split into TF32 hi and lo
    for (int i = tid; i < PH * kC1Pitch / 4; i += kC1Threads) {
      const float4 xv = reinterpret_cast<const float4*>(rx)[i];
      const float4 mv = reinterpret_cast<const float4*>(rm)[i];
      const float v[4] = {xv.x * mv.x, xv.y * mv.y, xv.z * mv.z, xv.w * mv.w};
      float h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = __uint_as_float(tf32_rna(v[e]));
        l[e] = __uint_as_float(tf32_rna(v[e] - h[e]));
      }
      reinterpret_cast<float4*>(sPl)[i] = make_float4(h[0], h[1], h[2], h[3]);
      reinterpret_cast<float4*>(sPl + kC1SmemPlane)[i] = make_float4(l[0], l[1], l[2], l[3]);
    }
    // the mask's row sums of k at each output column of the tile (the k
    // loads of a sum issued together)
    for (int i = tid; i < PH * kC1TW; i += kC1Threads) {
      const int r = i / kC1TW;
      const float* mr = rm + r * kC1Pitch + shift + (i - r * kC1TW) * s;
      float sum = 0.f;
#pragma unroll
      for (int kx = 0; kx < kMaxK; ++kx)
        if (kx < k) sum += mr[kx];
      sRows[i] = sum;
    }
    __syncthreads();

    int b, oy0, ox0;
    c1_tile(p, t, b, oy0, ox0);
    const int oy = oy0 + py;
    // the thread's pixels g + 8q: column sums of the row sums, the ratio
    // and the new mask
    float ratio[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int px = g + 8 * q;
      float sum = 0.f;
#pragma unroll
      for (int ky = 0; ky < kMaxK; ++ky)
        if (ky < k) sum += sRows[(py * s + ky) * kC1TW + px];
      const bool valid = sum > 0.f;
      ratio[q] = valid ? (float)kk / (sum + 1e-8f) : 0.f;
      const int ox = ox0 + px;
      if (tq == 0 && oy < p.OH && ox < p.OW)
        p.new_mask[(b * p.OH + oy) * p.OW + ox] = valid ? 1.f : 0.f;
    }

    // the warp's 32 pixels (m-tiles g, g+8 and g+16, g+24) x Cout
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    // K order within a k-step: the quad's logical index t is tap 8st + 2t
    // and t + 4 the next, identically for A and B (a float2 of B)
#pragma unroll
    for (int st = 0; st < kC1KP / 8; ++st) {
      if (st < ksteps) {
        const int2 o = *reinterpret_cast<const int2*>(sTab + 8 * st + 2 * tq);
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int b0 = base + 16 * i * s;
          const int b1 = b0 + 8 * s;
          // (g, t), (g+8, t), (g, t+4), (g+8, t+4)
          const int at[4] = {b0 + o.x, b1 + o.x, b0 + o.y, b1 + o.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ahi[i][e] = __float_as_uint(pHi[at[e]]);
            alo[i][e] = __float_as_uint(pLo[at[e]]);
          }
        }
        // four n-tiles at a time: the three products into one sum lie 8
        // MMAs apart, past the MMA's latency (mma_tf32 is issued in order)
#pragma unroll
        for (int jg = 0; jg < 8; jg += 4) {
          if (jg < ntiles) {
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float* wr = sW + (8 * (jg + jj) + g) * kC1KP + 8 * st + 2 * tq;
              const float2 wh = *reinterpret_cast<const float2*>(wr);
              const float2 wl = *reinterpret_cast<const float2*>(wr + kC1MaxN * kC1KP);
              bh[jj][0] = __float_as_uint(wh.x);
              bh[jj][1] = __float_as_uint(wh.y);
              bl[jj][0] = __float_as_uint(wl.x);
              bl[jj][1] = __float_as_uint(wl.y);
            }
            // the small products first, hi*hi last, into the same sum; an
            // n-tile past Cout (whose weights are 0) is skipped
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (jg + jj < ntiles) mma_tf32(acc[i][jg + jj], alo[i], bh[jj][0], bh[jj][1]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (jg + jj < ntiles) mma_tf32(acc[i][jg + jj], ahi[i], bl[jj][0], bl[jj][1]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (jg + jj < ntiles) mma_tf32(acc[i][jg + jj], ahi[i], bh[jj][0], bh[jj][1]);
          }
        }
      }
    }

    // epilogue: the fragment's pixels g + 8q and channels 8j + 2t, + 1;
    // for an n-tile pair (j, j + 1) the quad's neighbours swap halves, so
    // an even t stores channels 8j + 2t .. + 3 and an odd t 8(j+1) + 2(t-1)
    // .. + 3 as one float4: a quad's store fills 64 bytes of a pixel's row
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      if (j < ntiles) {
        const bool pair = j + 1 < ntiles;
        float2 bv[2], av[2], cv[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = 8 * (j + jj) + 2 * tq;
          bv[jj] = *reinterpret_cast<const float2*>(sEpi + n);
          if (!kTrain) {
            av[jj] = *reinterpret_cast<const float2*>(sEpi + kC1MaxN + n);
            cv[jj] = *reinterpret_cast<const float2*>(sEpi + 2 * kC1MaxN + n);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float r = ratio[2 * i + h];
            float2 o[2];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              if (kTrain) {
                o[jj].x = (acc[i][j + jj][2 * h] + bv[jj].x) * r;
                o[jj].y = (acc[i][j + jj][2 * h + 1] + bv[jj].y) * r;
              } else {
                o[jj].x =
                    relu_keep_nan(((acc[i][j + jj][2 * h] + bv[jj].x) * r) * av[jj].x + cv[jj].x);
                o[jj].y = relu_keep_nan(((acc[i][j + jj][2 * h + 1] + bv[jj].y) * r) * av[jj].y +
                                        cv[jj].y);
              }
            }
            const int ox = ox0 + 16 * i + 8 * h + g;
            const bool in = oy < p.OH && ox < p.OW;
            float* const row = p.out + (size_t)((b * p.OH + oy) * p.OW + ox) * p.Cout;
            if (pair) {
              const bool odd = tq & 1;
              const float2 give = odd ? o[0] : o[1];
              const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, give.x, 1),
                                             __shfl_xor_sync(0xffffffffu, give.y, 1));
              const float4 q = odd ? make_float4(got.x, got.y, o[1].x, o[1].y)
                                   : make_float4(o[0].x, o[0].y, got.x, got.y);
              float* const dst = row + (odd ? 8 * (j + 1) + 2 * (tq - 1) : 8 * j + 2 * tq);
              if (in) __stcs(reinterpret_cast<float4*>(dst), q);
            } else if (in) {  // the last of an odd number of n-tiles
              __stcs(reinterpret_cast<float2*>(row + 8 * j + 2 * tq), o[0]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(kC1Threads, kC1BlocksPerSm) pconv_c1_kernel(const C1Args p) {
  pconv_c1_body<false>(p);
}

__global__ void __launch_bounds__(kC1Threads, kC1BlocksPerSm)
    pconv_c1_train_kernel(const C1Args p) {
  pconv_c1_body<true>(p);
}

// ---------------------------------------------------------------- pack

constexpr int kMaxPack = 16;  // weights a launch packs

struct PackArgs {
  const float* w[kMaxPack];  // nn.Conv2d's [Cout][Cin][k][k]
  float* hi[kMaxPack];       // [Cout][k][k][Cin], TF32 hi
  float* lo[kMaxPack];       // the same, TF32 residual (0 where hi is not finite)
  int cin[kMaxPack];
  int kk[kMaxPack];
  int end[kMaxPack];         // running output-channel counts: a block each
  int n;
};

// pack_pconv_weight of up to kMaxPack weights in one launch, bound by its
// bytes: a block per output channel transposes its [Cin][k*k] slab to
// [k*k][Cin] through shared memory, reading and writing contiguous runs
// (the model's k*k are odd, so the strided reads of shared memory meet no
// bank conflict).
__global__ void __launch_bounds__(256) pack_tf32_kernel(const __grid_constant__ PackArgs p) {
  extern __shared__ float slab[];
  int s = 0;
  while ((int)blockIdx.x >= p.end[s]) ++s;
  const int n = blockIdx.x - (s ? p.end[s - 1] : 0);
  const int cin = p.cin[s];
  const int kk = p.kk[s];
  const int len = cin * kk;
  const float* const src = p.w[s] + (size_t)n * len;
  for (int i = threadIdx.x; i < len; i += blockDim.x) slab[i] = src[i];
  __syncthreads();
  float* const hi = p.hi[s] + (size_t)n * len;
  float* const lo = p.lo[s] + (size_t)n * len;
  for (int e = threadIdx.x; e < len; e += blockDim.x) {
    const int tap = e / cin;
    const float v = slab[(e - tap * cin) * kk + tap];
    const float h = __uint_as_float(tf32_rna(v));
    hi[e] = h;
    lo[e] = isfinite(h) ? __uint_as_float(tf32_rna(v - h)) : 0.f;
  }
}

}  // namespace

// Plain C entry points for ctypes. x_b may be null when Cb == 0. With
// train != 0 a stage writes the train forward's output (bn_a and bn_b are
// not read and may be null), else the eval forward's.
// Each returns the cudaError_t of its launches (0 on success).

// SIMT variant; w is HWIO ([k][k][Ca+Cb][Cout]).
extern "C" int tg_pconv_eval_f32(const float* xa, const float* xb,
                                 const float* mask, const float* w,
                                 const float* bias, const float* bn_a,
                                 const float* bn_b, float* out, float* new_mask,
                                 int B, int H, int W, int Ca, int Cb, int Cout,
                                 int k, int stride, int pad, int train, void* stream) {
  if (k < 1 || k > kMaxK || stride < 1 || stride > kMaxStride || pad < 0 ||
      Ca < 1 || Cb < 0 || Cout < 4 || Cout % 4 != 0 || B < 1 ||
      B > 65535 || (!train && (bn_a == nullptr || bn_b == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int OH = (H + 2 * pad - k) / stride + 1;
  const int OW = (W + 2 * pad - k) / stride + 1;
  if (OH < 1 || OW < 1) return (int)cudaErrorInvalidValue;
  const int tiles_y = (OH + kTH - 1) / kTH;
  const int tiles_x = (OW + kTW - 1) / kTW;
  const dim3 grid(tiles_y * tiles_x, (Cout + kBN - 1) / kBN, B);
  auto* const kernel = train ? pconv_simt_train_kernel : pconv_simt_kernel;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      xa, xb, mask, w, bias, bn_a, bn_b, out, new_mask, H, W, Ca, Cb, Cout, k,
      stride, pad, OH, OW, tiles_x);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one MMA block: tile 0 is 128 x 128, tile 1 256 x 64.
extern "C" int tg_pconv_mma_smem_bytes(int tile, int k) {
  return (int)sizeof(float) *
         (tile == 0 ? mma_smem_floats(128, 128, k * k) : mma_smem_floats(256, 64, k * k));
}

// MMA variant (3xTF32); w_hi, w_lo are pack_pconv_weight's planes
// ([Cout][k][k][Ca+Cb]). With splits > 1, ws holds splits * M * Cout
// floats and ratio_ws M; the second launch sums the splits.
extern "C" int tg_pconv_eval_mma_f32(const float* xa, const float* xb, const float* mask,
                                     const float* w_hi, const float* w_lo, const float* bias,
                                     const float* bn_a, const float* bn_b, float* out,
                                     float* new_mask, float* ws, float* ratio_ws, int B, int H,
                                     int W, int Ca, int Cb, int Cout, int k, int stride,
                                     int pad, int tile, int splits, int train, void* stream) {
  if (k < 1 || k > kMaxK || stride < 1 || stride > kMaxStride || pad < 0 || Ca < 4 ||
      Ca % 4 != 0 || Cb < 0 || Cb % 4 != 0 || Cout < 4 || Cout % 4 != 0 || B < 1 ||
      (tile != 0 && tile != 1) || splits < 1 || (Cb > 0 && xb == nullptr) ||
      (!train && (bn_a == nullptr || bn_b == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int OH = (H + 2 * pad - k) / stride + 1;
  const int OW = (W + 2 * pad - k) / stride + 1;
  if (OH < 1 || OW < 1) return (int)cudaErrorInvalidValue;
  MmaArgs a;
  a.xa = xa;
  a.xb = xb;
  a.mask = mask;
  a.w_hi = w_hi;
  a.w_lo = w_lo;
  a.bias = bias;
  a.bn_a = bn_a;
  a.bn_b = bn_b;
  a.out = out;
  a.new_mask = new_mask;
  a.ws = ws;
  a.ratio_ws = ratio_ws;
  a.H = H;
  a.W = W;
  a.Ca = Ca;
  a.Cb = Cb;
  a.Cout = Cout;
  a.k = k;
  a.stride = stride;
  a.pad = pad;
  a.OH = OH;
  a.OW = OW;
  a.M = B * OH * OW;
  a.nca = (Ca + kBK - 1) / kBK;
  a.ncb = (Cb + kBK - 1) / kBK;
  a.chunks = k * k * (a.nca + a.ncb);
  a.splits = splits;
  if (splits > a.chunks || (splits > 1 && (ws == nullptr || ratio_ws == nullptr)) ||
      tg_pconv_mma_smem_bytes(tile, k) > 232448) {  // a block's shared memory on sm_90
    return (int)cudaErrorInvalidValue;
  }
  return tile == 0 ? launch_mma<2, 4>(a, train != 0, (cudaStream_t)stream)
                   : launch_mma<4, 2>(a, train != 0, (cudaStream_t)stream);
}

// The one-channel variant's dynamic shared memory, the blocks an SM holds,
// its threads and output tile.
extern "C" int tg_pconv_c1_info(int* smem_bytes, int* blocks_per_sm, int* threads, int* tile_h,
                                int* tile_w) {
  const int smem = (int)sizeof(float) * kC1SmemFloats;
  cudaError_t err = cudaFuncSetAttribute(pconv_c1_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, pconv_c1_kernel, kC1Threads,
                                                      smem);
  *smem_bytes = smem;
  *threads = kC1Threads;
  *tile_h = kC1TH;
  *tile_w = kC1TW;
  return (int)err;
}

// The one-channel variant (enc1), 3xTF32: x, mask [B][H][W] (one
// channel); w_hi, w_lo pack_pconv_weight's planes ([Cout][k][k][1]); Cout
// a multiple of 8 up to 64; grid persistent blocks (the wrapper's
// plan_c1) walk the tiles of 8 x 32 outputs; B*H*W and B*OH*OW < 2^31.
extern "C" int tg_pconv_eval_c1_f32(const float* x, const float* mask, const float* w_hi,
                                    const float* w_lo, const float* bias, const float* bn_a,
                                    const float* bn_b, float* out, float* new_mask, int B, int H,
                                    int W, int Cout, int k, int stride, int pad, int grid,
                                    int train, void* stream) {
  if (k < 1 || k > kMaxK || stride < 1 || stride > kMaxStride || pad < 0 || Cout < 8 ||
      Cout > kC1MaxN || Cout % 8 != 0 || B < 1 || H < 1 || W < 1 || grid < 1 ||
      w_hi == nullptr || w_lo == nullptr || (long long)B * H * W >= (1LL << 31) ||
      (!train && (bn_a == nullptr || bn_b == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int OH = (H + 2 * pad - k) / stride + 1;
  const int OW = (W + 2 * pad - k) / stride + 1;
  if (OH < 1 || OW < 1 || (long long)B * OH * OW >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int tiles_y = (OH + kC1TH - 1) / kC1TH;
  const int tiles_x = (OW + kC1TW - 1) / kC1TW;
  const long long tiles = (long long)B * tiles_y * tiles_x;
  if (tiles + grid >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  C1Args a;
  a.x = x;
  a.mask = mask;
  a.w_hi = w_hi;
  a.w_lo = w_lo;
  a.bias = bias;
  a.bn_a = bn_a;
  a.bn_b = bn_b;
  a.out = out;
  a.new_mask = new_mask;
  a.H = H;
  a.W = W;
  a.Cout = Cout;
  a.k = k;
  a.stride = stride;
  a.pad = pad;
  a.OH = OH;
  a.OW = OW;
  a.tiles_x = tiles_x;
  a.tiles_y = tiles_y;
  a.tiles = (int)tiles;
  const int smem = (int)sizeof(float) * kC1SmemFloats;
  auto* const kernel = train ? pconv_c1_train_kernel : pconv_c1_kernel;
  // above 48 KB only after this; per call, since it is set per device
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kC1Threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The MMA variant's weight planes of n <= 16 weights in one launch: w[i]
// [cout[i]][cin[i]][k[i]][k[i]] into hi[i] and lo[i] [cout][k][k][cin];
// cin * k * k floats within a block's shared memory.
extern "C" int tg_pack_tf32_planes(const float* const* w, float* const* hi, float* const* lo,
                                   const int* cout, const int* cin, const int* k, int n,
                                   void* stream) {
  if (n < 1 || n > kMaxPack) return (int)cudaErrorInvalidValue;
  PackArgs p;
  p.n = n;
  long long blocks = 0, slab = 0;
  for (int s = 0; s < n; ++s) {
    const long long len = (long long)cin[s] * k[s] * k[s];
    if (cout[s] < 1 || cin[s] < 1 || k[s] < 1 || w[s] == nullptr || hi[s] == nullptr ||
        lo[s] == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    p.w[s] = w[s];
    p.hi[s] = hi[s];
    p.lo[s] = lo[s];
    p.cin[s] = cin[s];
    p.kk[s] = k[s] * k[s];
    blocks += cout[s];
    p.end[s] = (int)blocks;
    slab = len > slab ? len : slab;
  }
  const long long smem = slab * (long long)sizeof(float);
  if (blocks > 0x7fffffff || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pack_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pack_tf32_kernel<<<(int)blocks, 256, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
