// 2x bilinear upsample, NHWC, fp32 and bf16: the forward (K1 fwd) and its
// exact adjoint (K1 bwd).
//
// Replaces the TPU kernels terra_gan_tpu/ops/pallas/upsample_kernel.py ::
// upsample2x_fwd_pallas (_up_fwd, body _fwd_kernel) and
// upsample2x_bwd_pallas (_up_bwd, body _bwd_kernel). Semantics are torch
// F.interpolate(scale_factor=2, mode="bilinear", align_corners=False),
// which for a factor of 2 is a fixed 2-tap stencil per axis with the
// border clamped:
//
//   out[2i]   = 0.25 * in[max(i-1, 0)] + 0.75 * in[i]    (out[0] = in[0])
//   out[2i+1] = 0.75 * in[i]            + 0.25 * in[min(i+1, n-1)]
//
// in fp32 whatever the storage type. The forward evaluates the taps as
// torch's own CUDA kernel does (source index, weights, the order of the
// sums and which products its build fuses into FMAs, found on the card
// against torch 2.11+cu128), so in fp32 its result is torch's to the bit
// at the decoder's channel counts (C >= 16, torch's channels-last
// kernel): a train step through K1 then differs from torch's only by the
// backward's sum order, not by a forward ulp that a ReLU or max-pool tie
// would magnify.
// The adjoint, per axis, gathers the 4 output taps each input feeds:
//
//   dx[i] = 0.25 * g[2i-1] + 0.75 * g[2i] + 0.75 * g[2i+1] + 0.25 * g[2i+2]
//   with g[-1] = g[0] and g[2n] = g[2n-1]
//
// (at the clamped border the same input feeds both taps, so the clamped
// reads add its weight twice, which is what the forward did).
//
// Bound on the H100: device-memory bytes. The forward reads the input
// once (each output pixel gathers 4 neighbours that stay in L1/L2) and
// writes the output, 4x its size; the adjoint reads g once (each dx
// pixel gathers a clamped 4x4 window of g whose rows neighbouring
// threads share through L1/L2) and writes dx, a quarter of it. Each
// thread produces VEC contiguous channels of one output pixel with
// 16-byte loads and stores (VEC = 4 for fp32, 8 for bf16: the wrappers
// require C % VEC == 0 and 16-byte aligned pointers, which the model's
// tensors always give), and consecutive threads walk the channels, then
// the pixels, so every warp touches contiguous memory. The adjoint is a
// gather with one write per dx pixel: no atomics, so it is
// deterministic, where torch's own backward scatters with atomics. The
// TPU kernels' row blocks and halo inputs answer VMEM limits and are not
// needed here: each thread clamps its own taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

template <typename T, int VEC>
__global__ void upsample2x_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                                      int N, int H, int W, int C) {
  using P = Pack<T, VEC>;
  const int groups = C / VEC;
  const int OH = 2 * H;
  const int OW = 2 * W;
  const size_t total = (size_t)N * OH * OW * groups;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int g = (int)(idx % groups);
    size_t p = idx / groups;
    const int ox = (int)(p % OW);
    p /= OW;
    const int oy = (int)(p % OH);
    const int n = (int)(p / OH);

    // source index and weights as torch computes them (scale 1/2, the
    // index clamped at 0, the far tap clamped at the last row/column)
    const float sy = fmaxf(0.5f * ((float)oy + 0.5f) - 0.5f, 0.0f);
    const float sx = fmaxf(0.5f * ((float)ox + 0.5f) - 0.5f, 0.0f);
    const int y0 = (int)sy;
    const int x0 = (int)sx;
    const int y1 = y0 + (y0 < H - 1 ? 1 : 0);
    const int x1 = x0 + (x0 < W - 1 ? 1 : 0);
    const float wy1 = sy - (float)y0, wy0 = 1.0f - wy1;
    const float wx1 = sx - (float)x0, wx0 = 1.0f - wx1;

    const size_t row0 = ((size_t)n * H + y0) * W;
    const size_t row1 = ((size_t)n * H + y1) * W;
    const size_t c = (size_t)g * VEC;
    const P a00 = *reinterpret_cast<const P*>(x + (row0 + x0) * C + c);
    const P a01 = *reinterpret_cast<const P*>(x + (row0 + x1) * C + c);
    const P a10 = *reinterpret_cast<const P*>(x + (row1 + x0) * C + c);
    const P a11 = *reinterpret_cast<const P*>(x + (row1 + x1) * C + c);
    P o;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      // torch's wy0 * (wx0 * a00 + wx1 * a01) + wy1 * (wx0 * a10 + wx1 * a11)
      // (upsample_bilinear2d_nhwc_out_frame) with the FMAs its build makes
      // of it, spelled out so that no contraction choice of ours differs
      const float r0 = __fmaf_rn(wx1, to_f32(a01.v[v]), __fmul_rn(wx0, to_f32(a00.v[v])));
      const float r1 = __fmaf_rn(wx0, to_f32(a10.v[v]), __fmul_rn(wx1, to_f32(a11.v[v])));
      o.v[v] = from_f32<T>(__fmaf_rn(wy0, r0, __fmul_rn(wy1, r1)));
    }
    *reinterpret_cast<P*>(y + (((size_t)n * OH + oy) * OW + ox) * C + c) = o;
  }
}

// g: [N, 2H, 2W, C]; dx: [N, H, W, C].
template <typename T, int VEC>
__global__ void upsample2x_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx,
                                      int N, int H, int W, int C) {
  using P = Pack<T, VEC>;
  const int groups = C / VEC;
  const int GH = 2 * H;
  const int GW = 2 * W;
  const float taps[4] = {0.25f, 0.75f, 0.75f, 0.25f};
  const size_t total = (size_t)N * H * W * groups;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int cg = (int)(idx % groups);
    size_t p = idx / groups;
    const int j = (int)(p % W);
    p /= W;
    const int i = (int)(p % H);
    const int n = (int)(p / H);

    const int rows[4] = {max(2 * i - 1, 0), 2 * i, 2 * i + 1, min(2 * i + 2, GH - 1)};
    const int cols[4] = {max(2 * j - 1, 0), 2 * j, 2 * j + 1, min(2 * j + 2, GW - 1)};
    const size_t c = (size_t)cg * VEC;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const T* row = g + ((size_t)n * GH + rows[a]) * GW * C + c;
      float r[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) r[v] = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const P t = *reinterpret_cast<const P*>(row + (size_t)cols[b] * C);
#pragma unroll
        for (int v = 0; v < VEC; ++v) r[v] += taps[b] * to_f32(t.v[v]);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += taps[a] * r[v];
    }
    P o;
#pragma unroll
    for (int v = 0; v < VEC; ++v) o.v[v] = from_f32<T>(acc[v]);
    *reinterpret_cast<P*>(dx + (((size_t)n * H + i) * W + j) * C + c) = o;
  }
}

// N, H, W, C are the small side's: the forward's input, the adjoint's
// output. Returns the cudaError_t of the launch.
template <typename T, int VEC, bool BWD>
int launch(const void* in, void* out, int N, int H, int W, int C, cudaStream_t s) {
  const size_t total = (size_t)N * H * W * (C / VEC) * (BWD ? 1 : 4);
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  if (BWD) {
    upsample2x_bwd_kernel<T, VEC><<<blocks, threads, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), N, H, W, C);
  } else {
    upsample2x_fwd_kernel<T, VEC><<<blocks, threads, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out), N, H, W, C);
  }
  return (int)cudaGetLastError();
}

template <bool BWD>
int dispatch(const void* in, void* out, int N, int H, int W, int C, int dtype,
             void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (N < 1 || H < 1 || W < 1 || C < 1 || C % vec != 0 || dtype < 0 ||
      dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float, 4, BWD>(in, out, N, H, W, C, s);
  return launch<__nv_bfloat16, 8, BWD>(in, out, N, H, W, C, s);
}

}  // namespace

// Plain C entry points for ctypes. dtype: 0 = fp32, 1 = bf16. C must be a
// multiple of 4 (fp32) or 8 (bf16) and the pointers 16-byte aligned.
// Returns the cudaError_t of the launch.

// x [N, H, W, C] -> y [N, 2H, 2W, C].
extern "C" int tg_upsample2x_fwd(const void* x, void* y, int N, int H, int W,
                                 int C, int dtype, void* stream) {
  return dispatch<false>(x, y, N, H, W, C, dtype, stream);
}

// g [N, 2H, 2W, C] -> dx [N, H, W, C]; H and W are dx's.
extern "C" int tg_upsample2x_bwd(const void* g, void* dx, int N, int H, int W,
                                 int C, int dtype, void* stream) {
  return dispatch<true>(g, dx, N, H, W, C, dtype, stream);
}
