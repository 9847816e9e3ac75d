// A block FFC's local and cross convolutions (Big-LaMa, models/lama.py), fp32, NCHW,
// forward and backward.
//
// Replaces no TPU kernel: the JAX package has no Big-LaMa. The port's
// block FFC computes
//
//   y_l = conv3x3_reflect(x_l, W_l2l) + conv3x3_reflect(x_g, W_g2l)
//   y_g = conv3x3_reflect(x_l, W_l2g) + s
//
// (s the spectral transform's output, computed before), 36 times a
// forward at 64^2 and 128 local, 384 global channels. Through nn.Conv2d
// these were three reflect pads, three cuDNN convolutions and two sums;
// with its search off cuDNN took its fp32 FFT path for l2g and g2l and an
// fp32 implicit GEMM for l2l, off the tensor cores: 464.7 ms of a 1,645
// ms training step at batch 16 on an H100, 6.4 % of the work's least time.
// This kernel computes both outputs in one launch, on the tensor cores at
// fp32 accuracy (3xTF32), reading the reflect padding in its own tile loads.
//
// Work and bound: 2 * B*H*W * 9 * (Nl*(Ca+Cb) + Ng*Ca) operations, 135.3
// GFLOP an FFC at batch 16 and 64^2: 0.82 ms at 165 TFLOP/s (3 TF32
// products per fp32 product at 495 TFLOP/s of dense TF32), against 0.11
// ms for its 0.38 GB of inputs and outputs at 3.35 TB/s: operations bound.
//
// Design:
// - Two implicit GEMMs, M = B*H*W pixels and N = output channels: y_l
//   over K = 9*(Ca+Cb), the channel concat [x_l; x_g] read in place from
//   both tensors, the two convolutions summed in the accumulator; y_g over
//   K = 9*Ca, s added in the epilogue. A block takes 128 pixels (2 rows x
//   64 columns of one image) by 128 output channels of one output; the
//   grid's blockIdx.y walks y_l's channel tiles first, then y_g's, so the
//   blocks with 4x the K of the others start first. One launch for both
//   outputs: on an H100, two launches (y_l, then y_g) were within 3 % of it
//   at batches 16 and 8 and 7-24 % slower at batch 5, where y_l's last
//   wave fills few SMs.
// - K runs in stages of (part, 16 channels, kernel row ky): 48 K indices,
//   (kx, channel). A stage stages the part's 16 channels at the tile's two
//   input rows (reflected) as rows of 72 floats holding columns x0-4 ..
//   x0+67: the 64 interior columns by 16-byte cp.async (4-byte copies
//   where W % 4 != 0), and the columns x0-1 and x0+64 by 4-byte copies
//   from their reflected sources (column 1 and W-2 at the image's edges).
//   The three taps kx = 0, 1, 2 read that row shifted by one column; no
//   padded copy is written anywhere.
// - Weights: pack_pconv_weights' TF32 hi and lo planes of l2l, g2l and
//   l2g, [N][3][3][C] (OHWI, K-major), one pack a forward; a stage copies
//   its 3 x 16 K values of 128 output channels from both planes.
// - 3xTF32 on mma.sync m16n8k8 as K2 (pconv_eval.cu): 8 warps, each 64
//   pixels (one tile row) by 32 channels; x is split into TF32 hi and lo
//   in registers as it goes from shared memory into the fragments;
//   lo*hi and hi*lo, then hi*hi, per stage summed from zero two m-tiles at
//   a time and then added to the running sum in IEEE fp32.
// - A three-stage ring of cp.async copies (200 KB of shared memory, one
//   block an SM): stage i+2 in flight while stage i is multiplied.
// - Epilogue from registers into NCHW: a warp's store covers 8
//   consecutive pixels of 4 channels, 32-byte sectors whole.
//
// The backward (FFCLocal.backward in ops/cuda/ffc_kernel.py) is two more
// kernels of this file, the input gradients (dgrad) and the weight
// gradients (wgrad); they too replace no TPU kernel. Through autograd each
// FFC's backward was three cuDNN convolution_backward calls on the
// reflect-padded inputs, formed again, and two reflect pads' backward:
// cuDNN's fp32 dgrad engine, its wgrad implicit GEMM and wgrad_alg0 (with
// atomics), and its FFT path's complex GEMMs, all off the tensor cores.
//
// dgrad: with dP_l, dP_g the gradients of the reflect-padded inputs,
//
//   dP_l = conv(pad0_2(g_l), rot(W_l2l)) + conv(pad0_2(g_g), rot(W_l2g))
//   dP_g = conv(pad0_2(g_l), rot(W_g2l))
//
// (rot(W) = W flipped in both taps, input and output channels swapped;
// pad0_2 zero padding 2), then grad_x = the reflect pad's adjoint of dP,
// which adds padded row 0 onto row 1, row H+1 onto row H-2, the same for
// the columns, and the corners both ways. Work and bound: the forward's,
// 135.3 GFLOP and 0.82 ms at batch 16. Design:
// - dP's interior (padded rows 1..H, columns 1..W) is the forward's own
//   shape, the channel counts swapped: ffc_dgrad_kernel is
//   ffc_local_kernel's body (one source, ffc_conv_body) with g_l, g_g in
//   place of x_l, x_g and pack_pconv_weights' planes of rot(W): the tile
//   loads read zeros, not the reflection, outside the image, and there is
//   no s. The forward's instantiation is the same code as before.
// - The border of dP (padded rows 0 and H+1, columns 0 and W+1: 2(W+H)+4
//   positions a channel, 2 % of the work at 64^2) is what the fold adds.
//   Each border value reads one line of g (row 0, row H-1, column 0 or
//   column W-1) through one kernel row or column of taps. So
//   ffc_dgrad_frame_kernel first gathers those lines of every channel into
//   a compact frame (the columns' strided reads made once, not once a
//   channel block), and ffc_dgrad_border_kernel computes the border in
//   fp32 FMAs into a scratch: a lane an output channel and 16 positions of
//   one line in its registers, the frame and the weights staged in shared
//   memory; a block sums a group of 128 input channels (grad_x_l's 512
//   over 4 blocks, so that no block holds an SM for the whole sum) into a
//   slice of its own. After the interior, ffc_dgrad_fold_kernel adds onto
//   each output in rows 1, H-2 or columns 1, W-2 the border values that
//   reflect onto it, each the sum of its slices, in a fixed order. A 66^2
//   scratch of the whole of dP would have cost the 2x64 tile a second,
//   almost empty column tile a row; a halo in the epilogue would have
//   needed weights of another kernel row than the stage holds; the fold in
//   the main kernel's epilogue serialised its loads in the blocks of rows
//   1 and H-2 (0.1 ms an FFC at batch 16 on an H100).
//
// wgrad: dW_l2l = g_l * P(x_l), dW_g2l = g_l * P(x_g), dW_l2g = g_g * P(x_l)
// (P the reflect pad, * the correlation over pixels): each a GEMM of
// [N] x [9 C] over K = B*H*W = 65,536 pixels at batch 16, 1.03 M outputs
// in all. Work and bound: the forward's, 135.3 GFLOP and 0.82 ms. Design:
// - A job is 128 output channels n by 16 input channels c, all 9 taps
//   (a 128 x 144 tile of one product); the grid is (job, split): the K
//   pixels are cut into `splits` contiguous ranges of stages (one stage a
//   row segment of 64 pixels of one image), so that few jobs (56 at
//   Big-LaMa's widths) fill the SMs; plan_wgrad picks the count from the
//   jobs, the stages and the SM count. blockIdx.x walks the jobs fastest,
//   so the blocks in flight share their pixels in the L2.
// - A stage stages g's 128 rows of 64 pixels and x's 16 channels at rows
//   y-1, y, y+1 (reflected) as rows of 72 floats, columns x0-4 .. x0+67,
//   by cp.async as the forward does: no padded copy is formed. Pixels past
//   W read g as zero.
// - 3xTF32 on mma.sync m16n8k8, A = g (16 channels n by 8 pixels), B = x
//   at the tap's shift (8 pixels by 8 channels c), both split into TF32 hi
//   and lo in registers: 8 warps, each 32 n by 8 c by 9 taps (18
//   fragments); each stage's 64 pixels summed from zero and then added to
//   the running sum in IEEE fp32, as the forward does. (Splitting x once a
//   stage into (hi, lo) pairs in shared memory, which 4 warps and 9 taps
//   read again, cost a second barrier a stage and read 9 % slower on an
//   H100.)
// - Split-K without atomics: each block writes its 128 x 144 sums into
//   its own slice of a scratch, coalesced in the fragments' order, and
//   ffc_wgrad_reduce_kernel adds the splits in their order 0, 1, ... in
//   fp32 into nn.Conv2d's [N][C][3][3]. The gradients repeat bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kFTR = 2;             // output rows a tile
constexpr int kFTW = 64;            // output columns a tile
constexpr int kFBN = 128;           // output channels a tile
constexpr int kFG = 16;             // input channels a stage
constexpr int kFKS = 3 * kFG;       // K indices a stage: (kx, channel)
constexpr int kFRow = 72;           // a staged input row: columns x0-4 .. x0+67
constexpr int kFCs = kFTR * kFRow + 4;  // a staged channel, padded: 2t*kFCs spreads banks
constexpr int kFLdb = kFKS + 8;     // a weight row in shared memory
constexpr int kFStages = 3;
constexpr int kFThreads = 256;
constexpr int kFStageA = kFG * kFCs;
constexpr int kFStageB = 2 * kFBN * kFLdb;
constexpr int kFSmemFloats = kFStages * (kFStageA + kFStageB);

struct FfcArgs {
  const float* xl;      // [B][Ca][H][W]
  const float* xg;      // [B][Cb][H][W]
  const float* s;       // [B][Ng][H][W], added to y_g
  const float* wll_hi;  // l2l planes [Nl][3][3][Ca]
  const float* wll_lo;
  const float* wgl_hi;  // g2l planes [Nl][3][3][Cb]
  const float* wgl_lo;
  const float* wlg_hi;  // l2g planes [Ng][3][3][Ca]
  const float* wlg_lo;
  float* yl;            // [B][Nl][H][W]
  float* yg;            // [B][Ng][H][W]
  int H, W, Ca, Cb, Nl, Ng;
  int tiles_x, tiles_y;  // an image's column and row tiles
  int nl_tiles;          // y_l's channel tiles: jobs below it are y_l's
};

// 4 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ int reflect_row(int y, int H) {
  y = y < 0 ? -y : (y >= H ? 2 * H - 2 - y : y);
  return y < 0 ? 0 : (y >= H ? H - 1 : y);  // rows of a tile past H read in range
}

// Where the dgrad's border scratch keeps padded position (py, px) of a
// channel: padded row 0 (W+2 columns), row H+1, then columns 0 and W+1 at
// padded rows 1..H.
__device__ __forceinline__ int border_index(int py, int px, int H, int W) {
  if (py == 0) return px;
  if (py == H + 1) return W + 2 + px;
  return 2 * (W + 2) + (px == 0 ? 0 : H) + py - 1;
}

// The reflect pad's adjoint at output (y, x), less dP's own (y+1, x+1):
// the border values of every padded position that reflects onto (y, x),
// in the order padded row y+1, 0, H+1 and within each column x+1, 0, W+1,
// each the sum of its `groups` slices (a slice a group of input channels,
// nbd floats apart) in their order.
__device__ __forceinline__ float fold_sum(const float* bd, int groups, int nbd, int y, int x,
                                          int H, int W) {
  const int pys[3] = {y + 1, y == 1 ? 0 : -1, y == H - 2 ? H + 1 : -1};
  const int pxs[3] = {x + 1, x == 1 ? 0 : -1, x == W - 2 ? W + 1 : -1};
  float f = 0.f;
  for (int i = 0; i < 3; ++i) {
    if (pys[i] < 0) continue;
    for (int j = 0; j < 3; ++j) {
      if (pxs[j] < 0 || (i == 0 && j == 0)) continue;
      const float* v = bd + border_index(pys[i], pxs[j], H, W);
      float sum = v[0];
      for (int k = 1; k < groups; ++k) sum += v[(size_t)k * nbd];
      f += sum;
    }
  }
  return f;
}

// The forward (kDgrad false) and the dgrad's interior (kDgrad true: zero
// padding, no s).
template <bool kVec, bool kDgrad>
__device__ __forceinline__ void ffc_conv_body(const FfcArgs& p) {
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                         // [kFStages][kFG][kFCs]
  float* sB = sA + kFStages * kFStageA;     // [kFStages][2][kFBN][kFLdb]

  const int tid = threadIdx.x;
  const int per_img = p.tiles_y * p.tiles_x;
  const int b = blockIdx.x / per_img;
  const int rem = blockIdx.x - b * per_img;
  const int ty = rem / p.tiles_x;
  const int y0 = ty * kFTR;
  const int x0 = (rem - ty * p.tiles_x) * kFTW;
  const int job = blockIdx.y;
  const bool local = job < p.nl_tiles;
  const int N = local ? p.Nl : p.Ng;
  const int n0 = (local ? job : job - p.nl_tiles) * kFBN;
  const int ga = (p.Ca + kFG - 1) / kFG;
  const int gb = (p.Cb + kFG - 1) / kFG;
  const int nstage = 3 * (local ? ga + gb : ga);
  const size_t HW = (size_t)p.H * p.W;
  const float* wa_hi = local ? p.wll_hi : p.wlg_hi;
  const float* wa_lo = local ? p.wll_lo : p.wlg_lo;

  // Stage c: x_l's groups then (y_l only) x_g's, each as ky = 0, 1, 2.
  auto load_stage = [&](int c, int slot) {
    const bool part_a = c < 3 * ga;
    const int cc = part_a ? c : c - 3 * ga;
    const int grp = cc / 3;
    const int ky = cc - 3 * grp;
    const int C = part_a ? p.Ca : p.Cb;
    const float* src = (part_a ? p.xl : p.xg) + (size_t)b * C * HW;
    const float* w_hi = part_a ? wa_hi : p.wgl_hi;
    const float* w_lo = part_a ? wa_lo : p.wgl_lo;
    const int c0 = grp * kFG;
    int row0, row1;
    bool in0 = true, in1 = true;  // the dgrad's rows inside the image; outside, zeros
    if (kDgrad) {
      in0 = (unsigned)(y0 + ky - 1) < (unsigned)p.H;
      in1 = y0 + ky < p.H;
      row0 = in0 ? y0 + ky - 1 : 0;
      row1 = in1 ? y0 + ky : 0;
    } else {
      row0 = reflect_row(y0 + ky - 1, p.H);
      row1 = reflect_row(y0 + ky, p.H);
    }
    float* a_dst = sA + slot * kFStageA;
    {  // a thread's copies: channels tid / 32 + 8 i, one row, 4 columns
      const int r = (tid >> 4) & 1;
      const int q = tid & 15;
      const int x = x0 + 4 * q;
      const float* row = src + (size_t)(r ? row1 : row0) * p.W + x;
      if (x < p.W) {  // columns past W are never read for a stored output
#pragma unroll
        for (int i = 0; i < kFG * kFTR * (kFTW / 4) / kFThreads; ++i) {
          const int ch = (tid >> 5) + 8 * i;
          bool ok = c0 + ch < C;
          if (kDgrad) ok = ok && (r ? in1 : in0);
          float* dst = a_dst + ch * kFCs + r * kFRow + 4 + 4 * q;
          const float* g = ok ? row + (size_t)(c0 + ch) * HW : src;
          if (kVec) {
            cp_async16(dst, g, ok);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (x + e < p.W) cp_async4(dst + e, ok ? g + e : src, ok);
            }
          }
        }
      }
    }
    if (tid < kFG * kFTR * 2) {  // the columns x0-1 and the one after the tile's last
      const int ch = tid >> 2;
      const int r = (tid >> 1) & 1;
      int pos, x;
      if ((tid & 1) == 0) {
        pos = 3;
        x = x0 > 0 ? x0 - 1 : 1;
      } else {
        const int end = x0 + kFTW < p.W ? x0 + kFTW : p.W;
        pos = end - x0 + 4;
        x = x0 + kFTW < p.W ? x0 + kFTW : p.W - 2;
      }
      bool ok = c0 + ch < C;
      // the dgrad's zero padding: no column left of the image or right of it
      if (kDgrad) ok = ok && (r ? in1 : in0) && ((tid & 1) == 0 ? x0 > 0 : x0 + kFTW < p.W);
      const float* g = ok ? src + ((size_t)(c0 + ch) * p.H + (r ? row1 : row0)) * p.W + x : src;
      cp_async4(a_dst + ch * kFCs + r * kFRow + pos, g, ok);
    }
    // Weights: four threads copy a run of 16 channels (64 bytes) of one
    // (plane, output channel, kx); a thread's 12 runs differ by plane, kx
    // and a block of 64 output channels, each a constant offset from one base.
    const int nr = tid >> 2;
    const int ch = c0 + 4 * (tid & 3);
    const size_t w_off = ((size_t)(n0 + nr) * 9 + ky * 3) * C + ch;
    float* b_dst = sB + slot * kFStageB + nr * kFLdb + 4 * (tid & 3);
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const float* w = plane ? w_lo : w_hi;
#pragma unroll
      for (int nb = 0; nb < kFBN / 64; ++nb) {
        const bool ok = n0 + nb * 64 + nr < N && ch < C;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* g = ok ? w + w_off + (size_t)(nb * 64 * 9 + kx) * C : w;
          cp_async16(b_dst + (plane * kFBN + nb * 64) * kFLdb + kx * kFG, g, ok);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < nstage) load_stage(s, s);
    cp_async_commit();
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // the tile row
  const int wn = warp & 3;   // 32 output channels
  const int g = lane >> 2;
  const int t = lane & 3;
  const int brow = wn * 32 + g;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c = 0; c < nstage; ++c) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // stage c landed for all; slot (c-1) % kFStages is free
    if (c + kFStages - 1 < nstage) load_stage(c + kFStages - 1, (c + kFStages - 1) % kFStages);
    cp_async_commit();

    const int slot = c % kFStages;
    // pixel column px at tap kx reads the staged row at px + kx + 3
    const float* a_s = sA + slot * kFStageA + wm * kFRow + g + 3;
    const float* bh_s = sB + slot * kFStageB;
    const float* bl_s = bh_s + kFBN * kFLdb;

    // K order within a k-step of 8 (kx = ks / 2, channels 8 (ks % 2) ..):
    // thread t's logical index t is channel 2t and t + 4 channel 2t + 1,
    // in A and in B alike (B read as one 8-byte load).
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
      for (int ks = 0; ks < kFKS / 8; ++ks) {
        const int kx = ks >> 1;
        const int col = 8 * ks + 2 * t;
        uint32_t bhi[4][2], blo[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 vh = *reinterpret_cast<const float2*>(bh_s + (brow + j * 8) * kFLdb + col);
          const float2 vl = *reinterpret_cast<const float2*>(bl_s + (brow + j * 8) * kFLdb + col);
          bhi[j][0] = __float_as_uint(vh.x);
          bhi[j][1] = __float_as_uint(vh.y);
          blo[j][0] = __float_as_uint(vl.x);
          blo[j][1] = __float_as_uint(vl.y);
        }
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int i = 2 * ip + ii;
          const float* a0 = a_s + (8 * (ks & 1) + 2 * t) * kFCs + i * 16 + kx;
          // (pixel g, channel 2t), (g+8, 2t), (g, 2t+1), (g+8, 2t+1)
          const float v[4] = {a0[0], a0[8], a0[kFCs], a0[kFCs + 8]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ahi[ii][e] = tf32_rna(v[e]);
            alo[ii][e] = tf32_rna(v[e] - __uint_as_float(ahi[ii][e]));
          }
        }
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

  // Epilogue: fragment rows g, g+8 are pixels, columns 2t, 2t+1 channels.
  const int y = y0 + wm;
  if (y >= p.H) return;
  float* out = local ? p.yl : p.yg;
  const size_t plane0 = (size_t)b * N * HW + (size_t)y * p.W;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int x = x0 + i * 16 + g + hr * 8;
      if (x >= p.W) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + 2 * t + e;
          if (n >= N) continue;
          const size_t idx = plane0 + (size_t)n * HW + x;
          float v = acc[i][j][2 * hr + e];
          if (!kDgrad && !local) v += p.s[idx];
          out[idx] = v;
        }
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kFThreads, 1) ffc_local_kernel(const FfcArgs p) {
  ffc_conv_body<kVec, false>(p);
}

// dP's interior: p's x_l, x_g are g_l, g_g, its weights rot(W)'s planes,
// its y_l, y_g grad_x_l, grad_x_g.
template <bool kVec>
__global__ void __launch_bounds__(kFThreads, 1) ffc_dgrad_kernel(const FfcArgs p) {
  ffc_conv_body<kVec, true>(p);
}

template <bool kVec, bool kDgrad>
int launch_ffc(const FfcArgs& a, int blocks, int jobs, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * kFSmemFloats;
  // above 48 KB only after this; per call, since it is set per device
  cudaError_t err = kDgrad ? cudaFuncSetAttribute(ffc_dgrad_kernel<kVec>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
                           : cudaFuncSetAttribute(ffc_local_kernel<kVec>,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (kDgrad) {
    ffc_dgrad_kernel<kVec><<<dim3(blocks, jobs), kFThreads, smem, stream>>>(a);
  } else {
    ffc_local_kernel<kVec><<<dim3(blocks, jobs), kFThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// ---- dgrad: the border of dP ----

constexpr int kBRun = 16;       // border positions a warp, a lane's sums
constexpr int kBGroup = 128;    // input channels a block sums: grad_x_l's 512 over 4 blocks
constexpr int kBMaxWarps = 24;  // 18 runs at 64^2
constexpr int kBStageW = 9 * 32;  // a staged input channel's weights: [tap][lane's channel]

struct BorderArgs {
  const float* gl;   // [B][Nl][H][W]
  const float* gg;   // [B][Ng][H][W]
  const float* wll;  // nn.Conv2d's weights: l2l [Nl][Ca][3][3]
  const float* wlg;  // l2g [Ng][Ca][3][3]
  const float* wgl;  // g2l [Nl][Cb][3][3]
  float* bd;         // [B][Ca+Cb][groups_l][2(W+2)+2H]: a slice a group of input channels
  float* frame;      // [B][Nl+Ng][nframe]: ffc_dgrad_frame_kernel's
  int H, W, Ca, Cb, Nl, Ng;
  int runs_row, runs_col;  // runs of kBRun positions of a padded row (W+2), of a column (H)
  int nc;                  // input channels a staged chunk
  int chunks_l;            // grad_x_l's chunks of 32 channels (0 when not needed)
  // groups of kBGroup input channels: grad_x_l's (Nl+Ng), grad_x_g's (Nl);
  // groups_l, the larger, is the scratch's slices a channel
  int groups_l, groups_g;
  int nframe;              // a channel's frame, its four lines padded (frame_line)
};

// A line of g's frame: its length in g and where its q = 0 sits in a
// channel's frame. Each line is kept with 2 zeros before it and enough
// after it for the last run's window (runs * kBRun + 4 floats in all), so
// the border kernel reads positions - 2 .. + kBRun - 1 without a test.
struct FrameLine {
  int len, base;
};

__device__ __forceinline__ FrameLine frame_line(int line, int H, int W, int runs_row,
                                                int runs_col) {
  const int lr = runs_row * kBRun + 4;
  const int lc = runs_col * kBRun + 4;
  const int start = line == 0 ? 0 : (line == 1 ? lr : (line == 2 ? 2 * lr : 2 * lr + lc));
  return {line < 2 ? W : H, start + 2};
}

// g's frame, the lines of g the border reads: row 0, row H-1, column 0
// and column W-1 of each channel of g_l, then of g_g, zero-padded (see
// frame_line), as [B][Nl+Ng][nframe]; a thread an element, the columns'
// strided reads made once here.
__global__ void __launch_bounds__(kFThreads) ffc_dgrad_frame_kernel(const BorderArgs p,
                                                                    long long total) {
  const long long i = (long long)blockIdx.x * kFThreads + threadIdx.x;
  if (i >= total) return;
  const long long bn = i / p.nframe;
  const int e = (int)(i - bn * p.nframe);
  const int lr = p.runs_row * kBRun + 4;
  const int lc = p.runs_col * kBRun + 4;
  const int line = e < lr ? 0 : (e < 2 * lr ? 1 : (e < 2 * lr + lc ? 2 : 3));
  const FrameLine fl = frame_line(line, p.H, p.W, p.runs_row, p.runs_col);
  const int q = e - fl.base;
  float v = 0.f;
  if ((unsigned)q < (unsigned)fl.len) {
    const int b = (int)(bn / (p.Nl + p.Ng));
    const int n = (int)(bn - (long long)b * (p.Nl + p.Ng));
    const size_t HW = (size_t)p.H * p.W;
    const float* g = n < p.Nl ? p.gl + ((size_t)b * p.Nl + n) * HW
                              : p.gg + ((size_t)b * p.Ng + n - p.Nl) * HW;
    const size_t at = line == 0 ? q
                      : line == 1 ? (size_t)(p.H - 1) * p.W + q
                      : line == 2 ? (size_t)q * p.W : (size_t)q * p.W + p.W - 1;
    v = g[at];
  }
  p.frame[i] = v;
}

// dP at padded row 0 or H+1 (line 0, 1; positions px = 0..W+1) or padded
// column 0 or W+1 (line 2, 3; positions py = 1..H): for each input
// channel n, the sum over the taps t = 0, 1, 2 of g[n] at position - t
// along g's row 0, row H-1, column 0 or column W-1 times W[n][c] at
// kernel row 0, 2 (taps kx = t) or kernel column 0, 2 (taps ky = t).
// A block: one image's border for 32 output channels over a group of
// kBGroup input channels, a lane a channel; a warp a run of kBRun
// positions of one line, their sums in registers. The groups' sums go to
// slices of their own, which the fold adds in order.
// Chunks of nc input channels are staged first by cp.async: g's frame
// (ffc_dgrad_frame_kernel's, its lines padded), whose values
// every lane of a warp reads at one address, and the weights as
// [tap][channel], a lane's own word. Each weight read serves kBRun
// positions and each frame read a window of them.
__global__ void __launch_bounds__(32 * kBMaxWarps) ffc_dgrad_border_kernel(const BorderArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int nframe = p.nframe;
  float* sw = smem;                    // [nc][9][32]
  float* sf = smem + p.nc * kBStageW;  // [nc][nframe]
  const int jobs_l = p.chunks_l * p.groups_l;
  const bool local = (int)blockIdx.x < jobs_l;
  const int job = local ? blockIdx.x : blockIdx.x - jobs_l;
  const int groups = local ? p.groups_l : p.groups_g;
  const int chunk = job / groups;
  const int grp = job - chunk * groups;
  const int b = blockIdx.y;
  const int cout = local ? p.Ca : p.Cb;
  const int c0 = chunk * 32;
  const int n_all = local ? p.Nl + p.Ng : p.Nl;
  const int nfirst = grp * kBGroup;
  const int nin = min(n_all, nfirst + kBGroup);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nruns = 2 * (p.runs_row + p.runs_col);
  const int nbd = 2 * (p.W + 2) + 2 * p.H;
  const bool mine = c0 + lane < cout;

  for (int r0 = 0; r0 < nruns; r0 += nwarps) {
    const int run = r0 + warp;
    int line, p0, end;
    if (run < 2 * p.runs_row) {
      line = run / p.runs_row;
      p0 = (run - line * p.runs_row) * kBRun;
      end = p.W + 2;
    } else {
      const int r = run - 2 * p.runs_row;
      line = 2 + r / p.runs_col;
      p0 = 1 + (r - (line - 2) * p.runs_col) * kBRun;
      end = p.H + 1;
    }
    const bool active = run < nruns && mine;
    const bool row = line < 2;
    const int base = active ? frame_line(line, p.H, p.W, p.runs_row, p.runs_col).base : 0;
    const int tap0 = line == 1 ? 6 : (line == 3 ? 2 : 0);
    const int tstep = row ? 1 : 3;

    float acc[kBRun];
#pragma unroll
    for (int i = 0; i < kBRun; ++i) acc[i] = 0.f;
    for (int n0 = nfirst; n0 < nin; n0 += p.nc) {
      __syncthreads();  // the last chunk's reads are done
      // the chunk's weights and frame by 4-byte cp.async, all in flight at once
      for (int i = threadIdx.x; i < p.nc * kBStageW; i += blockDim.x) {
        const int nn = i / kBStageW;
        const int r = i - nn * kBStageW;
        const int cl = r / 9;
        const int tap = r - 9 * cl;
        const int n = n0 + nn;
        const bool ok = n < nin && c0 + cl < cout;
        const float* w = !ok ? p.wll
                         : local ? (n < p.Nl ? p.wll + (size_t)n * cout * 9
                                             : p.wlg + (size_t)(n - p.Nl) * cout * 9)
                                 : p.wgl + (size_t)n * cout * 9;
        cp_async4(sw + nn * kBStageW + tap * 32 + cl, ok ? w + (size_t)(c0 + cl) * 9 + tap : w,
                  ok);
      }
      const float* fsrc = p.frame + ((size_t)b * (p.Nl + p.Ng) + n0) * nframe;
      const int nk_all = min(p.nc, nin - n0) * nframe;
      for (int i = threadIdx.x; i < p.nc * nframe; i += blockDim.x) {
        cp_async4(sf + i, i < nk_all ? fsrc + i : p.frame, i < nk_all);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (active) {
        const int nk = min(p.nc, nin - n0);
        for (int nn = 0; nn < nk; ++nn) {
          const float* w = sw + nn * kBStageW + lane;
          const float w0 = w[tap0 * 32], w1 = w[(tap0 + tstep) * 32];
          const float w2 = w[(tap0 + 2 * tstep) * 32];
          const float* f = sf + nn * nframe + base;
          float fv[kBRun + 2];  // positions p0-2 .. p0+kBRun-1 of the line, zero outside it
#pragma unroll
          for (int v = 0; v < kBRun + 2; ++v) fv[v] = f[p0 - 2 + v];
#pragma unroll
          for (int i = 0; i < kBRun; ++i) {
            acc[i] = fmaf(fv[i + 2], w0, acc[i]);
            acc[i] = fmaf(fv[i + 1], w1, acc[i]);
            acc[i] = fmaf(fv[i], w2, acc[i]);
          }
        }
      }
    }
    if (active) {
      const size_t ch = (size_t)b * (p.Ca + p.Cb) + (local ? 0 : p.Ca) + c0 + lane;
      float* bd = p.bd + (ch * p.groups_l + grp) * nbd;
#pragma unroll
      for (int i = 0; i < kBRun; ++i) {
        const int pos = p0 + i;
        if (pos >= end) break;
        const int py = line == 0 ? 0 : (line == 1 ? p.H + 1 : pos);
        const int px = row ? pos : (line == 2 ? 0 : p.W + 1);
        bd[border_index(py, px, p.H, p.W)] = acc[i];
      }
    }
  }
}

// The reflect pad's adjoint onto dP's interior, which ffc_dgrad_kernel
// stored as grad_x: a thread a target in rows 1, H-2 or columns 1, W-2
// (each once) of a channel, adding fold_sum's border values. Channels
// [0, Ca) are grad_x_l's, [Ca, Ca+Cb) grad_x_g's; a null output is skipped.
__global__ void __launch_bounds__(kFThreads) ffc_dgrad_fold_kernel(const BorderArgs p,
                                                                   float* dxl, float* dxg,
                                                                   long long total) {
  const long long i = (long long)blockIdx.x * kFThreads + threadIdx.x;
  if (i >= total) return;
  const int per = 2 * (p.W + p.H);  // candidate targets a channel
  const long long ch = i / per;     // b * (Ca + Cb) + channel
  const int t = (int)(i - ch * per);
  const int b = (int)(ch / (p.Ca + p.Cb));
  const int c = (int)(ch - (long long)b * (p.Ca + p.Cb));
  const bool local = c < p.Ca;
  float* out = local ? dxl : dxg;
  if (out == nullptr) return;
  int y, x;
  if (t < p.W) {  // row 1
    y = 1;
    x = t;
  } else if (t < 2 * p.W) {  // row H-2, unless it is row 1
    y = p.H - 2;
    x = t - p.W;
    if (y == 1) return;
  } else {  // columns 1 and W-2 off those rows
    const bool first = t < 2 * p.W + p.H;
    y = first ? t - 2 * p.W : t - 2 * p.W - p.H;
    x = first ? 1 : p.W - 2;
    if (y == 1 || y == p.H - 2 || (!first && x == 1)) return;
  }
  const int cout = local ? p.Ca : p.Cb;
  const int cc = local ? c : c - p.Ca;
  const int nbd = 2 * (p.W + 2) + 2 * p.H;
  out[(((size_t)b * cout + cc) * p.H + y) * p.W + x] +=
      fold_sum(p.bd + (size_t)ch * p.groups_l * nbd, local ? p.groups_l : p.groups_g, nbd, y, x,
               p.H, p.W);
}

// ---- wgrad ----

constexpr int kWBM = 128;                // output channels n a job
constexpr int kWBC = 16;                 // input channels c a job, each with its 9 taps
constexpr int kWPix = 64;                // pixels a stage: a row segment
constexpr int kWGs = kWPix + 4;          // a staged row of g, padded: 4g + t spreads banks
constexpr int kWRow = 72;                // a staged row of x: columns x0-4 .. x0+67
constexpr int kWCs = 3 * kWRow + 4;      // a staged channel of x (rows y-1, y, y+1), padded
constexpr int kWStageG = kWBM * kWGs;
constexpr int kWStageX = kWBC * kWCs;
constexpr int kWStages = 3;
constexpr int kWSmemFloats = kWStages * (kWStageG + kWStageX);
constexpr int kWAcc = 9 * 2 * 4;         // a thread's sums: 9 taps x 2 m-tiles x a fragment
constexpr int kWTile = kWAcc * kFThreads;  // a job's sums, the scratch's slice a split

struct WgradArgs {
  const float* xl;  // [B][Ca][H][W]
  const float* xg;  // [B][Cb][H][W]
  const float* gl;  // [B][Nl][H][W]
  const float* gg;  // [B][Ng][H][W]
  float* part;      // [jobs][splits][kWTile]
  float* wll;       // [Nl][Ca][3][3]
  float* wgl;       // [Nl][Cb][3][3]
  float* wlg;       // [Ng][Ca][3][3]
  int H, W, Ca, Cb, Nl, Ng;
  int tiles_x, stages, splits;
  int jobs_ll, jobs_gl;  // the jobs of l2l, then g2l (0 where not needed); the rest l2g's
  int ct_a, ct_b;        // channel tiles of x_l, x_g
};

struct WgradJob {
  const float* g;
  const float* x;
  float* out;
  int N, C, n0, c0;
};

__device__ __forceinline__ WgradJob wgrad_job(const WgradArgs& p, int job) {
  WgradJob j;
  int ct;
  if (job < p.jobs_ll) {
    j.g = p.gl; j.x = p.xl; j.out = p.wll; j.N = p.Nl; j.C = p.Ca; ct = p.ct_a;
  } else if ((job -= p.jobs_ll) < p.jobs_gl) {
    j.g = p.gl; j.x = p.xg; j.out = p.wgl; j.N = p.Nl; j.C = p.Cb; ct = p.ct_b;
  } else {
    job -= p.jobs_gl;
    j.g = p.gg; j.x = p.xl; j.out = p.wlg; j.N = p.Ng; j.C = p.Ca; ct = p.ct_a;
  }
  j.n0 = (job / ct) * kWBM;
  j.c0 = (job - (job / ct) * ct) * kWBC;
  return j;
}

template <bool kVec>
__global__ void __launch_bounds__(kFThreads, 1) ffc_wgrad_kernel(const WgradArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* sG = smem;                       // [kWStages][kWBM][kWGs]
  float* sX = sG + kWStages * kWStageG;   // [kWStages][kWBC][kWCs]

  const int tid = threadIdx.x;
  const WgradJob jb = wgrad_job(p, blockIdx.x);
  const int split = blockIdx.y;
  const int k0 = (int)((long long)p.stages * split / p.splits);
  const int nst = (int)((long long)p.stages * (split + 1) / p.splits) - k0;
  const size_t HW = (size_t)p.H * p.W;
  const int per_img = p.H * p.tiles_x;

  // Staged x past the image's right edge meets only pixels whose g is 0:
  // zero it once, so that no uninitialised word (a NaN's bits) meets them.
  for (int i = tid; i < kWStages * kWStageX; i += kFThreads) sX[i] = 0.f;
  __syncthreads();

  auto load_stage = [&](int k, int slot) {
    const int b = k / per_img;
    const int rem = k - b * per_img;
    const int y = rem / p.tiles_x;
    const int x0 = (rem - y * p.tiles_x) * kWPix;
    {  // g: 128 channels, 64 pixels; a thread's 8 copies, channels tid / 16 + 16 i
      const int q = tid & 15;
      const int x = x0 + 4 * q;
      const float* src = jb.g + ((size_t)b * jb.N + jb.n0) * HW + (size_t)y * p.W + x;
      float* dst = sG + slot * kWStageG + 4 * q;
#pragma unroll
      for (int i = 0; i < kWBM / 16; ++i) {
        const int r = (tid >> 4) + 16 * i;
        const bool okr = jb.n0 + r < jb.N;
        if (kVec) {
          const bool ok = okr && x < p.W;
          cp_async16(dst + r * kWGs, ok ? src + (size_t)r * HW : jb.g, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = okr && x + e < p.W;
            cp_async4(dst + r * kWGs + e, ok ? src + (size_t)r * HW + e : jb.g, ok);
          }
        }
      }
    }
    // x: 16 channels at rows y-1, y, y+1 (reflected); a thread's 3 copies
    const float* xsrc = jb.x + ((size_t)b * jb.C + jb.c0) * HW;
    float* x_dst = sX + slot * kWStageX;
#pragma unroll
    for (int i = 0; i < kWBC * 3 * (kWPix / 4) / kFThreads; ++i) {
      const int idx = tid + kFThreads * i;
      const int ch = idx / 48;
      const int rr = (idx >> 4) % 3;
      const int q = idx & 15;
      const int x = x0 + 4 * q;
      if (x < p.W) {  // columns past W meet only pixels whose g is 0
        const bool ok = jb.c0 + ch < jb.C;
        const float* src = xsrc + ((size_t)ch * p.H + reflect_row(y + rr - 1, p.H)) * p.W + x;
        float* dst = x_dst + ch * kWCs + rr * kWRow + 4 + 4 * q;
        if (kVec) {
          cp_async16(dst, ok ? src : jb.x, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (x + e < p.W) cp_async4(dst + e, ok ? src + e : jb.x, ok);
          }
        }
      }
    }
    if (tid < kWBC * 3 * 2) {  // the columns x0-1 and the one after the segment's last
      const int ch = tid / 6;
      const int rr = (tid >> 1) % 3;
      int pos, x;
      if ((tid & 1) == 0) {
        pos = 3;
        x = x0 > 0 ? x0 - 1 : 1;
      } else {
        const int end = x0 + kWPix < p.W ? x0 + kWPix : p.W;
        pos = end - x0 + 4;
        x = x0 + kWPix < p.W ? x0 + kWPix : p.W - 2;
      }
      const bool ok = jb.c0 + ch < jb.C;
      const float* src = xsrc + ((size_t)ch * p.H + reflect_row(y + rr - 1, p.H)) * p.W + x;
      cp_async4(x_dst + ch * kWCs + rr * kWRow + pos, ok ? src : jb.x, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < nst) load_stage(k0 + s, s);
    cp_async_commit();
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;   // 32 output channels n
  const int wc = warp >> 2;  // 8 input channels c
  const int g = lane >> 2;
  const int t = lane & 3;

  float acc[9][2][4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][m][e] = 0.f;

  for (int c = 0; c < nst; ++c) {
    cp_async_wait<kWStages - 2>();
    __syncthreads();  // stage c landed for all; slot (c-1) % kWStages is free
    if (c + kWStages - 1 < nst) load_stage(k0 + c + kWStages - 1, (c + kWStages - 1) % kWStages);
    cp_async_commit();

    const int slot = c % kWStages;
    // A: g[n][pixel]; B at tap (ky, kx): x[c][row ky][pixel + kx + 3]
    const float* a_s = sG + slot * kWStageG + (wm * 32 + g) * kWGs + t;
    const float* b_s = sX + slot * kWStageX + (wc * 8 + g) * kWCs + t + 3;
    float part[9][2][4];
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[k][m][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < kWPix / 8; ++ks) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* a0 = a_s + m * 16 * kWGs + ks * 8;
        // (channel g, pixel t), (g+8, t), (g, t+4), (g+8, t+4)
        const float v[4] = {a0[0], a0[8 * kWGs], a0[4], a0[8 * kWGs + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[m][e] = tf32_rna(v[e]);
          alo[m][e] = tf32_rna(v[e] - __uint_as_float(ahi[m][e]));
        }
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float* b0 = b_s + (k / 3) * kWRow + ks * 8 + k % 3;
        // (pixel t, channel g), (t+4, g)
        const float v0 = b0[0], v1 = b0[4];
        const uint32_t bh0 = tf32_rna(v0), bh1 = tf32_rna(v1);
        const uint32_t bl0 = tf32_rna(v0 - __uint_as_float(bh0));
        const uint32_t bl1 = tf32_rna(v1 - __uint_as_float(bh1));
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(part[k][m], alo[m], bh0, bh1);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(part[k][m], ahi[m], bl0, bl1);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(part[k][m], ahi[m], bh0, bh1);
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][m][e] += part[k][m][e];
  }
  cp_async_wait<0>();

  // the split's sums, in the fragments' order: float4 (tap k, m-tile m) of thread tid
  float4* out = reinterpret_cast<float4*>(p.part) +
                ((size_t)blockIdx.x * p.splits + split) * (kWTile / 4) + tid;
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int m = 0; m < 2; ++m)
      out[(k * 2 + m) * kFThreads] = make_float4(acc[k][m][0], acc[k][m][1], acc[k][m][2],
                                                 acc[k][m][3]);
}

// A thread a weight-gradient element: the splits' sums added in the order
// 0, 1, ..., written into nn.Conv2d's layout.
__global__ void __launch_bounds__(kFThreads) ffc_wgrad_reduce_kernel(const WgradArgs p,
                                                                     int total) {
  const int i = blockIdx.x * kFThreads + threadIdx.x;
  if (i >= total) return;
  const int job = i / kWTile;
  const int e = i - job * kWTile;
  const float* src = p.part + (size_t)job * p.splits * kWTile + e;
  float s = src[0];
  for (int k = 1; k < p.splits; ++k) s += src[(size_t)k * kWTile];
  const int q = e / (4 * kFThreads);         // tap * 2 + m-tile
  const int tid = (e >> 2) % kFThreads;
  const int e4 = e & 3;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const WgradJob jb = wgrad_job(p, job);
  const int n = jb.n0 + (warp & 3) * 32 + (q & 1) * 16 + (lane >> 2) + 8 * (e4 >> 1);
  const int c = jb.c0 + (warp >> 2) * 8 + 2 * (lane & 3) + (e4 & 1);
  if (n < jb.N && c < jb.C) jb.out[((size_t)n * jb.C + c) * 9 + (q >> 1)] = s;
}

template <bool kVec>
int launch_wgrad(const WgradArgs& a, int jobs, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * kWSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(ffc_wgrad_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ffc_wgrad_kernel<kVec><<<dim3(jobs, a.splits), kFThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a block, its threads, and its tile (rows,
// columns, output channels).
extern "C" int tg_ffc_local_info(int* smem_bytes, int* threads, int* tile_rows, int* tile_cols,
                                 int* tile_channels) {
  *smem_bytes = (int)sizeof(float) * kFSmemFloats;
  *threads = kFThreads;
  *tile_rows = kFTR;
  *tile_cols = kFTW;
  *tile_channels = kFBN;
  return 0;
}

// y_l = l2l(x_l) + g2l(x_g), y_g = l2g(x_l) + s: 3x3 convolutions at
// stride 1 with reflect padding 1, NCHW fp32, contiguous. The weights are
// pack_pconv_weight's planes ([N][3][3][C]); Ca, Cb multiples of 4; H,
// W >= 2.
extern "C" int tg_ffc_local_f32(const float* xl, const float* xg, const float* s,
                                const float* wll_hi, const float* wll_lo, const float* wgl_hi,
                                const float* wgl_lo, const float* wlg_hi, const float* wlg_lo,
                                float* yl, float* yg, int B, int H, int W, int Ca, int Cb, int Nl,
                                int Ng, void* stream) {
  if (B < 1 || H < 2 || W < 2 || Ca < 4 || Ca % 4 != 0 || Cb < 4 || Cb % 4 != 0 || Nl < 1 ||
      Ng < 1) {
    return (int)cudaErrorInvalidValue;
  }
  FfcArgs a;
  a.xl = xl;
  a.xg = xg;
  a.s = s;
  a.wll_hi = wll_hi;
  a.wll_lo = wll_lo;
  a.wgl_hi = wgl_hi;
  a.wgl_lo = wgl_lo;
  a.wlg_hi = wlg_hi;
  a.wlg_lo = wlg_lo;
  a.yl = yl;
  a.yg = yg;
  a.H = H;
  a.W = W;
  a.Ca = Ca;
  a.Cb = Cb;
  a.Nl = Nl;
  a.Ng = Ng;
  a.tiles_x = (W + kFTW - 1) / kFTW;
  a.tiles_y = (H + kFTR - 1) / kFTR;
  a.nl_tiles = (Nl + kFBN - 1) / kFBN;
  const int ng_tiles = (Ng + kFBN - 1) / kFBN;
  const long long blocks = (long long)B * a.tiles_y * a.tiles_x;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int jobs = a.nl_tiles + ng_tiles;
  if (jobs > 65535) return (int)cudaErrorInvalidValue;
  return W % 4 == 0 ? launch_ffc<true, false>(a, (int)blocks, jobs, (cudaStream_t)stream)
                    : launch_ffc<false, false>(a, (int)blocks, jobs, (cudaStream_t)stream);
}

// grad_x_l and grad_x_g of ffc_local (bit 0 and 1 of `need`; a null
// output where its bit is clear) from g_l = grad y_l, g_g = grad y_g:
// g's frame and the border kernel into `scratch` (tg_ffc_dgrad_scratch's
// floats: the border's values [B][Ca+Cb][ceil((Nl+Ng)/128)][2(W+2)+2H], a
// slice a group of 128 input channels, then the frame), then dP's
// interior, then the reflect fold. wll, wlg, wgl are nn.Conv2d's weights
// (l2l, l2g, g2l); t*_hi, t*_lo pack_pconv_weight's planes of their
// rot(W) = W.transpose(0, 1).flip(2, 3): [Ca][3][3][Nl], [Ca][3][3][Ng],
// [Cb][3][3][Nl]. Nl, Ng multiples of 4; H, W >= 2.
extern "C" int tg_ffc_dgrad_f32(const float* gl, const float* gg, const float* wll,
                                const float* wlg, const float* wgl, const float* tll_hi,
                                const float* tll_lo, const float* tlg_hi, const float* tlg_lo,
                                const float* tgl_hi, const float* tgl_lo, float* scratch,
                                float* dxl, float* dxg, int B, int H, int W, int Ca, int Cb,
                                int Nl, int Ng, int need, void* stream) {
  if (B < 1 || H < 2 || W < 2 || Nl < 4 || Nl % 4 != 0 || Ng < 4 || Ng % 4 != 0 || Ca < 1 ||
      Cb < 1 || (need & ~3) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (need == 0) return 0;
  const bool need_l = need & 1, need_g = need & 2;
  BorderArgs d;
  d.gl = gl;
  d.gg = gg;
  d.wll = wll;
  d.wlg = wlg;
  d.wgl = wgl;
  d.bd = scratch;
  d.frame = scratch + (size_t)B * (Ca + Cb) * ((Nl + Ng + kBGroup - 1) / kBGroup) *
                          (2 * (W + 2) + 2 * H);
  d.H = H;
  d.W = W;
  d.Ca = Ca;
  d.Cb = Cb;
  d.Nl = Nl;
  d.Ng = Ng;
  d.runs_row = (W + 2 + kBRun - 1) / kBRun;
  d.runs_col = (H + kBRun - 1) / kBRun;
  const int runs = 2 * (d.runs_row + d.runs_col);
  d.nframe = 2 * (d.runs_row * kBRun + 4) + 2 * (d.runs_col * kBRun + 4);
  // as many input channels a chunk as 96 KB of shared memory holds, up to 32
  const long long per_n = (long long)kBStageW + d.nframe;
  d.nc = (int)(24 * 1024 / per_n < 32 ? 24 * 1024 / per_n : 32);
  d.chunks_l = need_l ? (Ca + 31) / 32 : 0;
  d.groups_l = (Nl + Ng + kBGroup - 1) / kBGroup;
  d.groups_g = (Nl + kBGroup - 1) / kBGroup;
  const int chunks = d.chunks_l * d.groups_l + (need_g ? (Cb + 31) / 32 : 0) * d.groups_g;
  if (d.nc < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const int border_threads = 32 * (runs < kBMaxWarps ? runs : kBMaxWarps);
  const int border_smem = (int)(sizeof(float) * d.nc * per_n);

  // the forward's arguments with the roles swapped: g_l, g_g are its x_l,
  // x_g (Nl, Ng channels), grad_x_l, grad_x_g its y_l, y_g (Ca, Cb channels)
  FfcArgs a;
  a.xl = gl;
  a.xg = gg;
  a.s = nullptr;
  a.wll_hi = tll_hi;
  a.wll_lo = tll_lo;
  a.wgl_hi = tlg_hi;
  a.wgl_lo = tlg_lo;
  a.wlg_hi = tgl_hi;
  a.wlg_lo = tgl_lo;
  a.yl = dxl;
  a.yg = dxg;
  a.H = H;
  a.W = W;
  a.Ca = Nl;
  a.Cb = Ng;
  a.Nl = Ca;
  a.Ng = Cb;
  a.tiles_x = (W + kFTW - 1) / kFTW;
  a.tiles_y = (H + kFTR - 1) / kFTR;
  a.nl_tiles = need_l ? (Ca + kFBN - 1) / kFBN : 0;
  const int jobs = a.nl_tiles + (need_g ? (Cb + kFBN - 1) / kFBN : 0);
  const long long blocks = (long long)B * a.tiles_y * a.tiles_x;
  if (blocks > 0x7fffffff || jobs > 65535) return (int)cudaErrorInvalidValue;

  cudaStream_t st = (cudaStream_t)stream;
  const long long frame = (long long)B * (Nl + Ng) * d.nframe;
  ffc_dgrad_frame_kernel<<<(unsigned)((frame + kFThreads - 1) / kFThreads), kFThreads, 0, st>>>(
      d, frame);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ffc_dgrad_border_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, border_smem);
  if (err != cudaSuccess) return (int)err;
  ffc_dgrad_border_kernel<<<dim3(chunks, B), border_threads, border_smem, st>>>(d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = (cudaError_t)(W % 4 == 0 ? launch_ffc<true, true>(a, (int)blocks, jobs, st)
                                 : launch_ffc<false, true>(a, (int)blocks, jobs, st));
  if (err != cudaSuccess) return (int)err;
  const long long targets = (long long)B * (Ca + Cb) * 2 * (W + H);
  ffc_dgrad_fold_kernel<<<(unsigned)((targets + kFThreads - 1) / kFThreads), kFThreads, 0, st>>>(
      d, dxl, dxg, targets);
  return (int)cudaGetLastError();
}

// The floats of tg_ffc_dgrad_f32's scratch.
extern "C" long long tg_ffc_dgrad_scratch(int B, int H, int W, int Ca, int Cb, int Nl, int Ng) {
  const long long groups = (Nl + Ng + kBGroup - 1) / kBGroup;
  const long long nframe = 2LL * (((W + 2 + kBRun - 1) / kBRun) * kBRun + 4) +
                           2LL * (((H + kBRun - 1) / kBRun) * kBRun + 4);
  return (long long)B * ((Ca + Cb) * groups * (2LL * (W + 2) + 2LL * H) + (Nl + Ng) * nframe);
}

// The weight gradients of ffc_local (bit 0, 1, 2 of `need`: l2l, g2l,
// l2g; a null output where its bit is clear) from x_l, x_g and g_l =
// grad y_l, g_g = grad y_g, NCHW fp32, contiguous, into nn.Conv2d's
// layouts: wll [Nl][Ca][3][3], wgl [Nl][Cb][3][3], wlg [Ng][Ca][3][3].
// `part` holds jobs x splits x tg_ffc_wgrad_info's tile_sums floats;
// `splits` is plan_wgrad's. H, W >= 2.
extern "C" int tg_ffc_wgrad_f32(const float* xl, const float* xg, const float* gl,
                                const float* gg, float* part, float* wll, float* wgl, float* wlg,
                                int B, int H, int W, int Ca, int Cb, int Nl, int Ng, int need,
                                int splits, void* stream) {
  if (B < 1 || H < 2 || W < 2 || Ca < 1 || Cb < 1 || Nl < 1 || Ng < 1 || (need & ~7) != 0 ||
      splits < 1 || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  WgradArgs a;
  a.xl = xl;
  a.xg = xg;
  a.gl = gl;
  a.gg = gg;
  a.part = part;
  a.wll = wll;
  a.wgl = wgl;
  a.wlg = wlg;
  a.H = H;
  a.W = W;
  a.Ca = Ca;
  a.Cb = Cb;
  a.Nl = Nl;
  a.Ng = Ng;
  a.tiles_x = (W + kWPix - 1) / kWPix;
  const long long stages = (long long)B * H * a.tiles_x;
  if (stages > 0x7fffffff || splits > stages) return (int)cudaErrorInvalidValue;
  a.stages = (int)stages;
  a.splits = splits;
  a.ct_a = (Ca + kWBC - 1) / kWBC;
  a.ct_b = (Cb + kWBC - 1) / kWBC;
  const int mt_l = (Nl + kWBM - 1) / kWBM;
  const int mt_g = (Ng + kWBM - 1) / kWBM;
  a.jobs_ll = (need & 1) ? mt_l * a.ct_a : 0;
  a.jobs_gl = (need & 2) ? mt_l * a.ct_b : 0;
  const long long jobs = (long long)a.jobs_ll + a.jobs_gl + ((need & 4) ? mt_g * a.ct_a : 0);
  if (jobs == 0) return 0;
  if (jobs * kWTile > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = W % 4 == 0 ? launch_wgrad<true>(a, (int)jobs, st)
                             : launch_wgrad<false>(a, (int)jobs, st);
  if (err != 0) return err;
  const int total = (int)(jobs * kWTile);
  ffc_wgrad_reduce_kernel<<<(total + kFThreads - 1) / kFThreads, kFThreads, 0, st>>>(a, total);
  return (int)cudaGetLastError();
}

// The wgrad kernel's dynamic shared memory, threads, job tile (output
// channels, input channels), pixels a stage and sums a job a split.
extern "C" int tg_ffc_wgrad_info(int* smem_bytes, int* threads, int* tile_n, int* tile_c,
                                 int* pixels, int* tile_sums) {
  *smem_bytes = (int)sizeof(float) * kWSmemFloats;
  *threads = kFThreads;
  *tile_n = kWBM;
  *tile_c = kWBC;
  *pixels = kWPix;
  *tile_sums = kWTile;
  return 0;
}
