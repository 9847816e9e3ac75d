// Fused eval-mode decoder tail (K3), fp32, NHWC.
//
// Replaces the TPU kernel terra_gan_tpu/ops/pallas/tail_kernel.py ::
// fused_decoder_tail (body _tail_kernel; oracle tail_reference). One
// launch computes the PConv U-Net's last three ops for a batch:
//
//   up   = bilinear2x(d)                       (align_corners=False taps)
//   m512 = max(nearest2x(dm), xm)
//   s    = boxsum3(m512)
//   dec1 = ReLU(((conv3x3([up, x] * m512) + bias) * ratio) * a + bb)
//          ratio = 9 / (s + 1e-8) * [s > 0]
//   y    = sigmoid(conv3x3(dec1, k_fin) + b_fin) * (1 - xm) + x * xm
//
// with a, bb the eval BatchNorm folded per channel. The skip term (x
// convolved with k_skip) is optional: without it this is the model's own
// tail, whose dec1 convolves the upsampled features alone. The bias sits
// inside the renormalisation, the division is IEEE (no fast math) and the
// > 0 gate is exact, as in K2. d [B,H,W,C] and dm [B,H,W,1] come from dec2;
// x, xm and y are [B,2H,2W,1]; the 512^2 x C dec1 tensor never reaches
// device memory.
//
// Bound on the H100 (SXM, 700 W): operations. dec1 is 98.5 % of them: at
// d = [1,256,256,64] it is 19.33 GFLOP of fp32 products, taken here as 3
// TF32 products each (3xTF32, below) at 495 TFLOP/s of dense TF32: 0.117
// ms a tile; the final conv, 0.30 GFLOP of fp32 FMAs at 67 TFLOP/s, adds
// 0.005 ms. The bytes (d 33.6 MB a tile; x, xm, y 3 MB) take 0.011 ms.
//
// Design and why:
// - dec1 is an implicit GEMM on the tensor cores (mma.sync.m16n8k8 TF32,
//   HMMA in the SASS): M = the dec1 positions of a block's tile, N = C
//   (64, the output channels zero-padded to 8 n-tiles of 8), K = 9 C in
//   (tap, channel) order. 3xTF32 (mma_tf32.cuh) keeps fp32 accuracy: the
//   tail's gate is the composite at 1e-5 NRMSE, which plain TF32 fails on
//   spread weights. Each chunk of K (one tap x 8 channels, one MMA k-step)
//   is summed from zero on the tensor cores and then added to the running
//   sum in IEEE fp32, as K2 does: the MMA's own accumulation truncates,
//   and into one sum over K its error grows with K.
// - A is split once. Per chunk of 8 input channels the block builds V =
//   up(d) * m512 on its V tile in shared memory, already split into TF32
//   hi and lo planes, beside the chunk's weights split the same way, so
//   no warp splits an operand again and no cached weight planes are
//   needed. The upsample is K1 fwd's exact tap expression, so V is
//   bitwise the unfused path's K1 output times the mask.
// - The tile: a block computes 14 x 14 outputs of one batch element. The
//   final conv needs dec1 on a 16 x 16 tile (a 1-pixel halo), which needs
//   V on 18 x 18 (another). 16 x 16 dec1 positions are exactly 16 m-tiles
//   (one dec1 row each), and their accumulators fill 8 warps x 64
//   registers: dec1 is computed (16/14)^2 = 1.31x over (1.34x at 512^2,
//   where 37 tiles cover 518 rows), against 1.27x for a 16 x 16 output
//   tile, whose 18 x 18 dec1 positions would pad to 21 m-tiles and not
//   fit the registers of two blocks an SM.
// - Occupancy: 256 threads (8 warps, each 2 dec1 rows x 64 channels: 2 x 8
//   MMA tiles), at most 128 registers a thread and 106 KB of shared
//   memory, so two blocks share an SM (16 warps): one block's staging
//   overlaps the other's MMAs.
// - Pipeline: the chunk's source rows of d (an 11 x 11 patch of 8
//   channels) and its fp32 weights (9 taps x 8 x 64) are copied with
//   cp.async one chunk ahead into a double buffer, while the current
//   chunk's MMAs run; the block then builds the hi/lo planes from shared
//   memory: two barriers a chunk.
// - Fragments are 8-byte loads in a K order permuted within the k-step
//   (logical index t is channel 2t, t+4 channel 2t+1, identically for A
//   and B), from planes of 8 floats a row: no bank conflicts.
// - The epilogue applies bias, ratio, the folded BatchNorm and ReLU (one
//   that keeps a NaN, as torch.relu does) to the accumulators and writes
//   dec1 into shared memory over the staging buffers; a dec1 position
//   outside the image is the final conv's zero padding and is written as
//   0. The skip term (one input channel) is added as fp32 FMAs before it.
//   Then one thread per output pixel takes the 3 x 3 x C final conv from
//   shared memory (1.5 % of the FLOPs), the sigmoid (accurate expf) and
//   the composite.
// - No atomics: two calls give the same bits.
// None of the TPU layout workarounds carry over (W-phase planes,
// pre-shifted tap planes, host-built halo strips, the lane-alignment
// envelope).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kT = 14;              // output tile edge (even: the source patch starts on a row)
constexpr int kE = kT + 2;          // dec1 tile edge: the final conv's halo; 16 = one m-tile a row
constexpr int kV = kT + 4;          // V tile edge: dec1's halo
constexpr int kS = kV / 2 + 2;      // source patch edge of d under the V tile
constexpr int kNE = kE * kE;
constexpr int kNV = kV * kV;
constexpr int kNS = kS * kS;
constexpr int kCK = 8;              // input channels a chunk: one MMA k-step
constexpr int kMaxC = 64;           // 8 n-tiles of 8 output channels
constexpr int kNT = kMaxC / 8;
constexpr int kThreads = 256;       // 8 warps x 2 dec1 rows
constexpr int kD1 = kNE + 4;        // dec1's channel stride in shared memory (no bank conflicts)
static_assert(kE == 16 && kThreads / 32 * 2 == kE, "a warp takes two 16-wide dec1 rows");
static_assert(kT % 2 == 0, "the V tile must start on an even row");

// shared memory, in floats; dec1 (kMaxC x kD1) reuses the staging part
constexpr int kRawW = 9 * kCK * kMaxC;           // a chunk's fp32 weights [tap][ci][n]
constexpr int kRawD = kNS * kCK;                 // a chunk's d patch [pos][ci]
constexpr int kOffRawW = 0;                      // two of each: the copy ring
constexpr int kOffRawD = kOffRawW + 2 * kRawW;
constexpr int kOffWhi = kOffRawD + 2 * kRawD;    // [tap][n][ci]
constexpr int kOffWlo = kOffWhi + kRawW;
constexpr int kOffVhi = kOffWlo + kRawW;         // [pos][ci]
constexpr int kOffVlo = kOffVhi + kNV * kCK;
constexpr int kStaging = kOffVlo + kNV * kCK;
constexpr int kOffM = kStaging;                  // m512 on the V tile, 0 outside the image
constexpr int kOffXv = kOffM + kNV;              // x * m512 on the V tile
constexpr int kOffRatio = kOffXv + kNV;          // renorm ratio a dec1 position; -1 outside
constexpr int kOffKfin = kOffRatio + kNE;        // k_fin [tap][c]
constexpr int kSmemFloats = kOffKfin + 9 * kMaxC;
static_assert(kMaxC * kD1 <= kStaging, "dec1 fits over the staging buffers");
static_assert(kOffRawD % 4 == 0 && kOffWhi % 4 == 0 && kOffVhi % 4 == 0 && kOffVlo % 4 == 0 &&
              kOffM % 4 == 0 && kOffKfin % 4 == 0, "16-byte aligned buffers");

// One upsampled value times the mask: K1 fwd's
// fma(wy0, fma(wx1, a01, wx0*a00), wy1*fma(wx0, a10, wx1*a11)), spelled out
// so that no contraction choice differs from K1's, then the product with
// m512 that K2 stages.
__device__ __forceinline__ float tap(float wy0, float wy1, float wx0, float wx1,
                                     float a00, float a01, float a10, float a11,
                                     float m) {
  const float r0 = __fmaf_rn(wx1, a01, __fmul_rn(wx0, a00));
  const float r1 = __fmaf_rn(wx0, a10, __fmul_rn(wx1, a11));
  return __fmul_rn(__fmaf_rn(wy0, r0, __fmul_rn(wy1, r1)), m);
}

// v as TF32 hi and the TF32 residual lo (K2's split of x * m)
__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = __uint_as_float(tf32_rna(v));
  lo = __uint_as_float(tf32_rna(v - hi));
}

struct TailArgs {
  const float* d;
  const float* dm;
  const float* x;
  const float* xm;
  const float* k_main;
  const float* k_skip;
  const float* bias;
  const float* bn_a;
  const float* bn_b;
  const float* k_fin;
  const float* b_fin;
  float* y;
  int H, W, C, tiles_x;
};

__global__ void __launch_bounds__(kThreads, 2) decoder_tail_kernel(const TailArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* const s_m = smem + kOffM;
  float* const s_xv = smem + kOffXv;
  float* const s_ratio = smem + kOffRatio;
  float* const s_kfin = smem + kOffKfin;
  const float* const whi = smem + kOffWhi;
  const float* const wlo = smem + kOffWlo;
  const float* const vhi = smem + kOffVhi;
  const float* const vlo = smem + kOffVlo;

  const int tid = threadIdx.x;
  const int H = p.H, W = p.W, C = p.C;
  const int b = blockIdx.y;
  const int OH = 2 * H;
  const int OW = 2 * W;
  const int oy0 = (blockIdx.x / p.tiles_x) * kT;
  const int ox0 = (blockIdx.x % p.tiles_x) * kT;
  const int vy0 = oy0 - 2;  // V tile origin; dec1's is (oy0 - 1, ox0 - 1)
  const int vx0 = ox0 - 2;
  const int sy0 = vy0 / 2 - 1;  // source patch origin in d (vy0 is even)
  const int sx0 = vx0 / 2 - 1;
  const int nchunk = (C + kCK - 1) / kCK;

  // Chunk ch's d patch and fp32 weights into ring slot `slot`; zero-filled
  // outside the image and past C (so padded channels add nothing).
  auto load_chunk = [&](int ch, int slot) {
    const int c0 = ch * kCK;
    float* const rd = smem + kOffRawD + slot * kRawD;
#pragma unroll 1
    for (int i = tid; i < kNS * 2; i += kThreads) {
      const int q = i & 1;
      const int pos = i >> 1;
      const int sy = sy0 + pos / kS;
      const int sx = sx0 + pos % kS;
      const int c = c0 + 4 * q;
      const bool ok = (unsigned)sy < (unsigned)H && (unsigned)sx < (unsigned)W && c < C;
      const float* g = ok ? p.d + ((((size_t)b * H + sy) * W + sx) * C + c) : p.d;
      cp_async16(rd + pos * kCK + 4 * q, g, ok);
    }
    float* const rw = smem + kOffRawW + slot * kRawW;
#pragma unroll 1
    for (int i = tid; i < 9 * kCK * (kMaxC / 4); i += kThreads) {
      const int nq = i % (kMaxC / 4);
      const int r = i / (kMaxC / 4);  // tap * kCK + ci
      const int ci = r % kCK;
      const int t = r / kCK;
      const bool ok = c0 + ci < C && 4 * nq < C;
      const float* g = ok ? p.k_main + (((size_t)t * C + c0 + ci) * C + 4 * nq) : p.k_main;
      cp_async16(rw + r * kMaxC + 4 * nq, g, ok);
    }
  };

  load_chunk(0, 0);
  cp_async_commit();

  // While it flies: m512 and x * m512 on the V tile, k_fin.
  for (int i = tid; i < kNV; i += kThreads) {
    const int vy = vy0 + i / kV;
    const int vx = vx0 + i % kV;
    float m = 0.f, xv = 0.f;
    if (vy >= 0 && vy < OH && vx >= 0 && vx < OW) {
      const size_t pix = ((size_t)b * OH + vy) * OW + vx;
      m = fmaxf(p.dm[((size_t)b * H + vy / 2) * W + vx / 2], p.xm[pix]);
      xv = __fmul_rn(p.x[pix], m);
    }
    s_m[i] = m;
    s_xv[i] = xv;
  }
  for (int i = tid; i < 9 * C; i += kThreads) s_kfin[i] = p.k_fin[i];
  __syncthreads();
  for (int i = tid; i < kNE; i += kThreads) {
    const int py = i / kE;
    const int px = i % kE;
    const int ey = oy0 - 1 + py;
    const int ex = ox0 - 1 + px;
    float r = -1.f;
    if (ey >= 0 && ey < OH && ex >= 0 && ex < OW) {
      float s = 0.f;
      for (int ky = 0; ky < 3; ++ky) {
        for (int kx = 0; kx < 3; ++kx) s += s_m[(py + ky) * kV + px + kx];
      }
      r = s > 0.f ? 9.f / (s + 1e-8f) : 0.f;
    }
    s_ratio[i] = r;
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment's row (A, C) or column (B)
  const int t = lane & 3;   // the fragment's K index (A, B) or column pair (C)
  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int ch = 0; ch < nchunk; ++ch) {
    if (ch + 1 < nchunk) load_chunk(ch + 1, (ch + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ch landed for all; the planes' last MMAs are done

    // Build the chunk's hi/lo planes from the copies (loops kept rolled:
    // the accumulators hold half the registers meanwhile).
    {
      const float* const rd = smem + kOffRawD + (ch & 1) * kRawD;
#pragma unroll 1
      for (int i = tid; i < kNV * 2; i += kThreads) {
        const int q = i / kNV;
        const int pos = i - q * kNV;
        const int oy = vy0 + pos / kV;
        const int ox = vx0 + pos % kV;
        float4 h = make_float4(0.f, 0.f, 0.f, 0.f), l = h;
        if (oy >= 0 && oy < OH && ox >= 0 && ox < OW) {
          // K1 fwd's source index and weights (upsample2x.cu)
          const float sy = fmaxf(0.5f * ((float)oy + 0.5f) - 0.5f, 0.0f);
          const float sx = fmaxf(0.5f * ((float)ox + 0.5f) - 0.5f, 0.0f);
          const int y0 = (int)sy;
          const int x0 = (int)sx;
          const int y1 = y0 + (y0 < H - 1 ? 1 : 0);
          const int x1 = x0 + (x0 < W - 1 ? 1 : 0);
          const float wy1 = sy - (float)y0, wy0 = 1.0f - wy1;
          const float wx1 = sx - (float)x0, wx0 = 1.0f - wx1;
          const int r0 = (y0 - sy0) * kS, r1 = (y1 - sy0) * kS;
          const int c0 = x0 - sx0, c1 = x1 - sx0;
          const float4 a00 = *reinterpret_cast<const float4*>(rd + (r0 + c0) * kCK + 4 * q);
          const float4 a01 = *reinterpret_cast<const float4*>(rd + (r0 + c1) * kCK + 4 * q);
          const float4 a10 = *reinterpret_cast<const float4*>(rd + (r1 + c0) * kCK + 4 * q);
          const float4 a11 = *reinterpret_cast<const float4*>(rd + (r1 + c1) * kCK + 4 * q);
          const float m = s_m[pos];
          split(tap(wy0, wy1, wx0, wx1, a00.x, a01.x, a10.x, a11.x, m), h.x, l.x);
          split(tap(wy0, wy1, wx0, wx1, a00.y, a01.y, a10.y, a11.y, m), h.y, l.y);
          split(tap(wy0, wy1, wx0, wx1, a00.z, a01.z, a10.z, a11.z, m), h.z, l.z);
          split(tap(wy0, wy1, wx0, wx1, a00.w, a01.w, a10.w, a11.w, m), h.w, l.w);
        }
        *reinterpret_cast<float4*>(smem + kOffVhi + pos * kCK + 4 * q) = h;
        *reinterpret_cast<float4*>(smem + kOffVlo + pos * kCK + 4 * q) = l;
      }
      const float* const rw = smem + kOffRawW + (ch & 1) * kRawW;
#pragma unroll 1
      for (int i = tid; i < 9 * kMaxC * 2; i += kThreads) {
        const int n = i % kMaxC;
        const int q = (i / kMaxC) & 1;
        const int tp = i / (2 * kMaxC);
        const float* const src = rw + (tp * kCK + 4 * q) * kMaxC + n;
        float v[4], h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = src[e * kMaxC];
          h[e] = __uint_as_float(tf32_rna(v[e]));
          l[e] = isfinite(h[e]) ? __uint_as_float(tf32_rna(v[e] - h[e])) : 0.f;  // as pack_pconv_weight
        }
        const int o = (tp * kMaxC + n) * kCK + 4 * q;
        *reinterpret_cast<float4*>(smem + kOffWhi + o) = make_float4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<float4*>(smem + kOffWlo + o) = make_float4(l[0], l[1], l[2], l[3]);
      }
    }
    __syncthreads();  // the planes are built

    // The chunk's 9 taps, one MMA k-step each. The warp's m-tiles are dec1
    // rows 2 warp and 2 warp + 1; fragment row g is dec1 column g (g + 8
    // the other half), whose V row at tap (ky, kx) is shifted by ky rows
    // and kx columns. The K order within the k-step: thread t's logical
    // index t is channel 2t, index t + 4 channel 2t + 1, one 8-byte load.
#pragma unroll
    for (int tp = 0; tp < 9; ++tp) {
      const int ky = tp / 3;
      const int kx = tp % 3;
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (2 * warp + i + ky) * kV + g + kx;
        const float2 h0 = *reinterpret_cast<const float2*>(vhi + r * kCK + 2 * t);
        const float2 h1 = *reinterpret_cast<const float2*>(vhi + (r + 8) * kCK + 2 * t);
        const float2 l0 = *reinterpret_cast<const float2*>(vlo + r * kCK + 2 * t);
        const float2 l1 = *reinterpret_cast<const float2*>(vlo + (r + 8) * kCK + 2 * t);
        // (g, t), (g+8, t), (g, t+4), (g+8, t+4)
        ahi[i][0] = __float_as_uint(h0.x);
        ahi[i][1] = __float_as_uint(h1.x);
        ahi[i][2] = __float_as_uint(h0.y);
        ahi[i][3] = __float_as_uint(h1.y);
        alo[i][0] = __float_as_uint(l0.x);
        alo[i][1] = __float_as_uint(l1.x);
        alo[i][2] = __float_as_uint(l0.y);
        alo[i][3] = __float_as_uint(l1.y);
      }
      // one n-tile at a time (the registers of two blocks an SM): the
      // k-step's products summed from zero on the tensor cores, the small
      // ones first, then added in IEEE fp32
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int o = (tp * kMaxC + j * 8 + g) * kCK + 2 * t;
        const float2 vh = *reinterpret_cast<const float2*>(whi + o);
        const float2 vl = *reinterpret_cast<const float2*>(wlo + o);
        const uint32_t bh0 = __float_as_uint(vh.x), bh1 = __float_as_uint(vh.y);
        const uint32_t bl0 = __float_as_uint(vl.x), bl1 = __float_as_uint(vl.y);
        float part[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(part[i], alo[i], bh0, bh1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(part[i], ahi[i], bl0, bl1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(part[i], ahi[i], bh0, bh1);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][e];
      }
    }
  }
  cp_async_wait<0>();

  // The accumulators: rows g and g + 8 (dec1 columns), columns 2t, 2t + 1
  // of each n-tile (output channels).
  if (p.k_skip != nullptr) {  // conv3x3(x * m512, k_skip), one input channel, fp32
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int py = 2 * warp + i;
        const int px = g + 8 * hr;
#pragma unroll 1
        for (int tp = 0; tp < 9; ++tp) {
          const float v = s_xv[(py + tp / 3) * kV + px + tp % 3];
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int n = 8 * j + 2 * t;
            if (n < C) {
              const float2 w = __ldg(reinterpret_cast<const float2*>(p.k_skip + tp * C + n));
              acc[i][j][2 * hr] = fmaf(v, w.x, acc[i][j][2 * hr]);
              acc[i][j][2 * hr + 1] = fmaf(v, w.y, acc[i][j][2 * hr + 1]);
            }
          }
        }
      }
    }
  }

  __syncthreads();  // every read of the staging buffers is done: dec1 overwrites them
  float* const D1 = smem;  // [c][kD1]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int pos = (2 * warp + i) * kE + g + 8 * hr;
      const float r = s_ratio[pos];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = 8 * j + 2 * t;
        if (n < C) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(p.bias + n));
          const float2 av = __ldg(reinterpret_cast<const float2*>(p.bn_a + n));
          const float2 cv = __ldg(reinterpret_cast<const float2*>(p.bn_b + n));
          const float o0 = relu_keep_nan(((acc[i][j][2 * hr] + bv.x) * r) * av.x + cv.x);
          const float o1 = relu_keep_nan(((acc[i][j][2 * hr + 1] + bv.y) * r) * av.y + cv.y);
          D1[n * kD1 + pos] = r < 0.f ? 0.f : o0;  // outside the image: zero padding
          D1[(n + 1) * kD1 + pos] = r < 0.f ? 0.f : o1;
        }
      }
    }
  }
  __syncthreads();

  // The final conv: one thread per output pixel of the tile, 16 a row.
  const int qy = tid / 16;
  const int qx = tid % 16;
  const int oy = oy0 + qy;
  const int ox = ox0 + qx;
  if (qy < kT && qx < kT && oy < OH && ox < OW) {
    float f = 0.f;
    for (int c = 0; c < C; c += 4) {
#pragma unroll
      for (int tp = 0; tp < 9; ++tp) {
        const float4 k4 = *reinterpret_cast<const float4*>(s_kfin + tp * C + c);
        const float* const dr = D1 + c * kD1 + (qy + tp / 3) * kE + qx + tp % 3;
        f = fmaf(dr[0], k4.x, f);
        f = fmaf(dr[kD1], k4.y, f);
        f = fmaf(dr[2 * kD1], k4.z, f);
        f = fmaf(dr[3 * kD1], k4.w, f);
      }
    }
    const float o = 1.f / (1.f + expf(-(f + p.b_fin[0])));
    const size_t pix = ((size_t)b * OH + oy) * OW + ox;
    const float mk = p.xm[pix];
    p.y[pix] = o * (1.f - mk) + p.x[pix] * mk;
  }
}

int prepare() {
  cudaError_t err = cudaFuncSetAttribute(decoder_tail_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemFloats * (int)sizeof(float));
  if (err != cudaSuccess) return (int)err;
  // as much of the SM's 256 KB as shared memory as it takes, for two blocks
  return (int)cudaFuncSetAttribute(decoder_tail_kernel,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// The kernel's geometry on this card: its dynamic shared memory in bytes,
// the blocks an SM holds, its threads a block and its output tile edge.
extern "C" int tg_decoder_tail_info(int* smem_bytes, int* blocks_per_sm, int* threads,
                                    int* tile) {
  const int err = prepare();
  if (err) return err;
  *smem_bytes = kSmemFloats * (int)sizeof(float);
  *threads = kThreads;
  *tile = kT;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, decoder_tail_kernel,
                                                            kThreads, *smem_bytes);
}

// Plain C entry point for ctypes. d [B,H,W,C], dm [B,H,W,1], x, xm and y
// [B,2H,2W,1]; k_main [3,3,C,C] (HWIO), k_skip [3,3,1,C] or null, k_fin
// [3,3,C,1]; bias, bn_a, bn_b [C]; b_fin [1]. C a multiple of 4 up to 64,
// every pointer 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int tg_decoder_tail_f32(const float* d, const float* dm, const float* x,
                                   const float* xm, const float* k_main,
                                   const float* k_skip, const float* bias,
                                   const float* bn_a, const float* bn_b,
                                   const float* k_fin, const float* b_fin, float* y,
                                   int B, int H, int W, int C, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 4 || C > kMaxC || C % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = prepare();
  if (err) return err;
  const int tiles_y = (2 * H + kT - 1) / kT;
  const int tiles_x = (2 * W + kT - 1) / kT;
  const TailArgs a{d, dm, x, xm, k_main, k_skip, bias, bn_a, bn_b, k_fin, b_fin, y,
                   H, W, C, tiles_x};
  const dim3 grid(tiles_y * tiles_x, B);
  decoder_tail_kernel<<<grid, kThreads, kSmemFloats * sizeof(float), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
