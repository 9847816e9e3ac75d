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
// Bound on the H100: fp32 FMA throughput. At d = [1,256,256,64] dec1 is
// 19.3 GFLOP, the final conv and the skip term 0.3 each, against about
// 20 MB of bytes (6 us at 3.35 TB/s): about 0.30 ms a tile at the 67
// TFLOP/s of fp32 outside the tensor cores.
//
// Design: one block computes one 16x16 output tile of one batch element
// on the 2H x 2W grid. dec1 is needed on the tile plus a 1-pixel halo
// (18x18, the final conv's support), so dec1 over the halo is computed
// again by the neighbouring blocks: (18/16)^2 = 1.27x the dec1 FLOPs. The
// block first builds m512 and x*m512 on the tile plus a 2-pixel halo
// (20x20, the support of the halo's dec1) and the renormalisation ratio
// of each dec1 position. Then, one chunk of 16 input channels at a time,
// it stages V = up(d) * m512 on the 20x20 patch in shared memory,
// computing the upsample from d through L1/L2 with K1 fwd's exact tap
// expression (so V is bitwise the unfused path's K1 output times the
// mask), beside the chunk of k_main. Each thread accumulates one row of
// 18 dec1 positions x 4 output channels in fp32 registers; a V row of 20
// values in registers serves the three kx taps. The epilogue applies
// bias, ratio, the folded BatchNorm and ReLU and writes dec1 into shared
// memory over the staging buffers; dec1 positions outside the image are
// the final conv's zero padding and are written as 0, not computed from
// clamped features. Last, one thread per output pixel reduces the 3x3xC
// final conv out of shared memory and writes the composite. Shared
// memory: 26 KB for V and 37 KB for the weights of a chunk, reused for
// the 83 KB of dec1 (C = 64), so dynamic shared memory above 48 KB.
// None of the TPU layout workarounds carry over (W-phase planes,
// pre-shifted tap planes, host-built halo strips, the lane-alignment
// envelope).

#include <cuda_runtime.h>

namespace {

constexpr int kT = 16;          // output tile edge
constexpr int kE = kT + 2;      // dec1 tile edge: the final conv's halo
constexpr int kV = kT + 4;      // V tile edge: dec1's halo
constexpr int kNE = kE * kE;
constexpr int kNV = kV * kV;
constexpr int kCK = 16;         // input channels per staged chunk
constexpr int kMaxC = 64;       // C / 4 channel groups x 18 rows <= 288 threads
constexpr int kMaxThreads = kE * kMaxC / 4;

__host__ __device__ constexpr int dyn_floats(int C) {
  return kCK * kNV + 9 * kCK * C > C * kNE ? kCK * kNV + 9 * kCK * C : C * kNE;
}

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

__global__ void __launch_bounds__(kMaxThreads)
decoder_tail_kernel(const float* __restrict__ d, const float* __restrict__ dm,
                    const float* __restrict__ x, const float* __restrict__ xm,
                    const float* __restrict__ k_main, const float* __restrict__ k_skip,
                    const float* __restrict__ bias, const float* __restrict__ bn_a,
                    const float* __restrict__ bn_b, const float* __restrict__ k_fin,
                    const float* __restrict__ b_fin, float* __restrict__ y, int H,
                    int W, int C, int tiles_x) {
  extern __shared__ float4 dyn4[];
  float* const Vs = reinterpret_cast<float*>(dyn4);  // [kCK][kNV]
  float4* const Ws4 = dyn4 + kCK * kNV / 4;          // [9][kCK][C/4]
  float* const D1 = reinterpret_cast<float*>(dyn4);  // [C][kNE], after the chunks
  __shared__ float s_m[kNV];       // m512 on the V tile, 0 outside the image
  __shared__ float s_xv[kNV];      // x * m512 on the V tile
  __shared__ float s_ratio[kNE];   // renorm ratio; -1 outside the image
  __shared__ float s_kfin[9 * kMaxC];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int G = C / 4;
  const int b = blockIdx.y;
  const int OH = 2 * H;
  const int OW = 2 * W;
  const int oy0 = (blockIdx.x / tiles_x) * kT;
  const int ox0 = (blockIdx.x % tiles_x) * kT;
  const int vy0 = oy0 - 2;  // V tile origin
  const int vx0 = ox0 - 2;
  const int ey0 = oy0 - 1;  // dec1 tile origin
  const int ex0 = ox0 - 1;

  for (int i = tid; i < kNV; i += nthreads) {
    const int vy = vy0 + i / kV;
    const int vx = vx0 + i % kV;
    float m = 0.f, xv = 0.f;
    if (vy >= 0 && vy < OH && vx >= 0 && vx < OW) {
      const size_t pix = ((size_t)b * OH + vy) * OW + vx;
      m = fmaxf(dm[((size_t)b * H + vy / 2) * W + vx / 2], xm[pix]);
      xv = __fmul_rn(x[pix], m);
    }
    s_m[i] = m;
    s_xv[i] = xv;
  }
  for (int i = tid; i < 9 * C; i += nthreads) s_kfin[i] = k_fin[i];
  __syncthreads();

  for (int i = tid; i < kNE; i += nthreads) {
    const int py = i / kE;
    const int px = i % kE;
    const int ey = ey0 + py;
    const int ex = ex0 + px;
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

  const int cg = tid % G;  // output channels 4cg .. 4cg+3
  const int py = tid / G;  // dec1 row; the thread covers its 18 positions
  float acc[kE][4];
#pragma unroll
  for (int p = 0; p < kE; ++p) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;
  }

  const float4* const d4 = reinterpret_cast<const float4*>(d);
  const float4* const km4 = reinterpret_cast<const float4*>(k_main);
  for (int c0 = 0; c0 < C; c0 += kCK) {
    const int ck = min(kCK, C - c0);  // a multiple of 4
    const int ck4 = ck / 4;
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kNV * ck4; i += nthreads) {
      const int q = i % ck4;
      const int pos = i / ck4;
      const int oy = vy0 + pos / kV;
      const int ox = vx0 + pos % kV;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
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
        const size_t row0 = ((size_t)b * H + y0) * W;
        const size_t row1 = ((size_t)b * H + y1) * W;
        const int g = c0 / 4 + q;
        const float4 a00 = __ldg(d4 + (row0 + x0) * G + g);
        const float4 a01 = __ldg(d4 + (row0 + x1) * G + g);
        const float4 a10 = __ldg(d4 + (row1 + x0) * G + g);
        const float4 a11 = __ldg(d4 + (row1 + x1) * G + g);
        const float m = s_m[pos];
        v = make_float4(tap(wy0, wy1, wx0, wx1, a00.x, a01.x, a10.x, a11.x, m),
                        tap(wy0, wy1, wx0, wx1, a00.y, a01.y, a10.y, a11.y, m),
                        tap(wy0, wy1, wx0, wx1, a00.z, a01.z, a10.z, a11.z, m),
                        tap(wy0, wy1, wx0, wx1, a00.w, a01.w, a10.w, a11.w, m));
      }
      float* const dst = Vs + (4 * q) * kNV + pos;
      dst[0] = v.x;
      dst[kNV] = v.y;
      dst[2 * kNV] = v.z;
      dst[3 * kNV] = v.w;
    }
    for (int i = tid; i < 9 * ck * G; i += nthreads) {
      const int n4 = i % G;
      const int r = i / G;
      const int c = r % ck;
      const int t = r / ck;
      Ws4[(t * kCK + c) * G + n4] =
          __ldg(km4 + ((size_t)t * C + c0 + c) * G + n4);
    }
    __syncthreads();

    for (int c = 0; c < ck; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* const vr = Vs + c * kNV + (py + ky) * kV;
        float v[kV];
#pragma unroll
        for (int q = 0; q < kV; ++q) v[q] = vr[q];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 w = Ws4[((ky * 3 + kx) * kCK + c) * G + cg];
#pragma unroll
          for (int p = 0; p < kE; ++p) {
            acc[p][0] = fmaf(v[p + kx], w.x, acc[p][0]);
            acc[p][1] = fmaf(v[p + kx], w.y, acc[p][1]);
            acc[p][2] = fmaf(v[p + kx], w.z, acc[p][2]);
            acc[p][3] = fmaf(v[p + kx], w.w, acc[p][3]);
          }
        }
      }
    }
  }

  if (k_skip != nullptr) {  // conv3x3(x * m512, k_skip), one input channel
    const float4* const ks4 = reinterpret_cast<const float4*>(k_skip);
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const float* const vr = s_xv + (py + ky) * kV;
      float v[kV];
#pragma unroll
      for (int q = 0; q < kV; ++q) v[q] = vr[q];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float4 w = __ldg(ks4 + (ky * 3 + kx) * G + cg);
#pragma unroll
        for (int p = 0; p < kE; ++p) {
          acc[p][0] = fmaf(v[p + kx], w.x, acc[p][0]);
          acc[p][1] = fmaf(v[p + kx], w.y, acc[p][1]);
          acc[p][2] = fmaf(v[p + kx], w.z, acc[p][2]);
          acc[p][3] = fmaf(v[p + kx], w.w, acc[p][3]);
        }
      }
    }
  }

  __syncthreads();  // every read of the staging buffers is done: dec1 overwrites them
  {
    const float4 bv = __ldg(reinterpret_cast<const float4*>(bias) + cg);
    const float4 av = __ldg(reinterpret_cast<const float4*>(bn_a) + cg);
    const float4 cv = __ldg(reinterpret_cast<const float4*>(bn_b) + cg);
    const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
    const float aj[4] = {av.x, av.y, av.z, av.w};
    const float cj[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int p = 0; p < kE; ++p) {
      const int pos = py * kE + p;
      const float r = s_ratio[pos];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float o = ((acc[p][j] + bj[j]) * r) * aj[j] + cj[j];
        o = o < 0.f ? 0.f : o;  // ReLU that keeps a NaN, as torch.relu does
        D1[(4 * cg + j) * kNE + pos] = r < 0.f ? 0.f : o;  // outside: zero padding
      }
    }
  }
  __syncthreads();

  const float bf = b_fin[0];
  for (int i = tid; i < kT * kT; i += nthreads) {
    const int qy = i / kT;
    const int qx = i % kT;
    const int oy = oy0 + qy;
    const int ox = ox0 + qx;
    if (oy >= OH || ox >= OW) continue;
    float f = 0.f;
    for (int c = 0; c < C; ++c) {
      const float* const dr = D1 + c * kNE + qy * kE + qx;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          f = fmaf(dr[ky * kE + kx], s_kfin[(ky * 3 + kx) * C + c], f);
        }
      }
    }
    const float o = 1.f / (1.f + expf(-(f + bf)));
    const size_t pix = ((size_t)b * OH + oy) * OW + ox;
    const float mk = xm[pix];
    y[pix] = o * (1.f - mk) + x[pix] * mk;
  }
}

}  // namespace

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
  const int smem = dyn_floats(C) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decoder_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (2 * H + kT - 1) / kT;
  const int tiles_x = (2 * W + kT - 1) / kT;
  const dim3 grid(tiles_y * tiles_x, B);
  decoder_tail_kernel<<<grid, kE * (C / 4), smem, (cudaStream_t)stream>>>(
      d, dm, x, xm, k_main, k_skip, bias, bn_a, bn_b, k_fin, b_fin, y, H, W, C,
      tiles_x);
  return (int)cudaGetLastError();
}
