// A block FFC's local and cross convolutions (Big-LaMa, models/lama.py), fp32, NCHW.
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

template <bool kVec>
__global__ void __launch_bounds__(kFThreads, 1) ffc_local_kernel(const FfcArgs p) {
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
    const int row0 = reflect_row(y0 + ky - 1, p.H);
    const int row1 = reflect_row(y0 + ky, p.H);
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
          const bool ok = c0 + ch < C;
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
      const bool ok = c0 + ch < C;
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
          if (!local) v += p.s[idx];
          out[idx] = v;
        }
      }
    }
  }
}

template <bool kVec>
int launch_ffc(const FfcArgs& a, int blocks, int jobs, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * kFSmemFloats;
  // above 48 KB only after this; per call, since it is set per device
  cudaError_t err = cudaFuncSetAttribute(ffc_local_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ffc_local_kernel<kVec><<<dim3(blocks, jobs), kFThreads, smem, stream>>>(a);
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
  return W % 4 == 0 ? launch_ffc<true>(a, (int)blocks, jobs, (cudaStream_t)stream)
                    : launch_ffc<false>(a, (int)blocks, jobs, (cudaStream_t)stream);
}
