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
// would magnify. At the first row and column torch's source index is 0
// with weights (1, 0) on taps (0, min(1, n-1)): the zero-weight tap is
// still multiplied, so an inf or NaN there propagates as in torch.
// The adjoint, per axis, gathers the 4 output taps each input feeds:
//
//   dx[i] = 0.25 * g[2i-1] + 0.75 * g[2i] + 0.75 * g[2i+1] + 0.25 * g[2i+2]
//   with g[-1] = g[0] and g[2n] = g[2n-1]
//
// (at the clamped border the same input feeds both taps, so the clamped
// reads add its weight twice, which is what the forward did), summed per
// g row over its 4 columns in order, then over the 4 rows in order, with
// the FMAs that order contracts to (spelled out below).
//
// Bound on the H100: device-memory bytes (the forward reads x once and
// writes 4x its size; the adjoint reads g once and writes a quarter of
// it), about 2 flops a byte, far below the fp32 rate. So the design is
// about data movement and the instructions around it:
// - A thread owns one 16-byte channel group (VEC = 4 fp32 or 8 bf16
//   channels; the wrappers require C % VEC == 0 and 16-byte aligned
//   tensors). Forward: a thread takes one input pixel (i, j) and makes
//   its output quad (2i..2i+1, 2j..2j+1) from the 3x3 window of rows
//   {i-1, i, i+1} and columns {j-1, j, j+1}, clamped, held in registers:
//   9 loads (6 in the first row) for 4 stores, where a thread an output
//   pixel made 16. Adjoint: a thread takes one dx column of `rows` (1 or
//   2) dx rows; a dx pixel needs g columns 2j-1..2j+2 of 4 rows, and 2 dx
//   rows share 2 of their 6 g rows. A thread that slid along a run of dx
//   columns, carrying the 2 g columns the next one shares as each g
//   row's partial sum, loaded fewer bytes but measured slower at the
//   large shapes in both types (PERF.md, Findings), so it was not kept.
// - A block is a tile: `gb` channel groups (all of them up to 256; above
//   that blockIdx.y picks a slice of them) of `rt` columns across and
//   `ht` row blocks down, so the rows and columns its threads share come
//   from L1 and each input byte crosses from L2 little more than once.
//   That, not the register window, moved the time (PERF.md, Findings).
// - The tiling is plan_upsample's (ops/cuda/upsample_kernel.py), chosen
//   from the shape and timed there (profile_slice.py --legs k1); the
//   kernels only decode it. A shared-memory or TMA strip was not taken:
//   tiled, both directions come within 1.15-1.2x of the byte bound at
//   the largest shapes.
// - Consecutive lanes take consecutive channel groups; where C / VEC < 32
//   a warp spans 2 or more pixels, each of
//   C >= 8 * VEC channels, so every warp access covers whole 128-byte
//   lines.
// - 32-bit indices: the wrappers launch at most 2^31 - 1 elements of the
//   large side at a time (they split a larger batch), so every offset is
//   an int, and (n, row, column, group) come from one division chain per
//   thread. The grid covers the tiles once: no grid-stride loop and no
//   cap. A thread whose indices fall outside the tensors returns, so no
//   tiling reads or writes out of bounds.
// The adjoint is a gather with one write per dx pixel: no atomics, so it
// is deterministic, where torch's own backward scatters with atomics. The
// TPU kernels' row blocks and halo inputs answer VMEM limits and are not
// needed here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

// A launch's tiling, plan_upsample's (whose _Tiles mirrors it field for
// field): a block of `block` = gb * rt * ht threads takes channel groups
// gb * blockIdx.y .. + gb - 1 of a tile of `rt` columns across and `ht`
// blocks of `rows` rows down (rows of the forward's input, 1 a thread;
// dx rows of the adjoint, 1 or 2); blockIdx.x goes along the tiles of a
// row, then down (`tiles_w` by `tiles_h` a slice of an image), then over
// the images.
struct Upsample2xTiles {
  int rows, gb, slices, rt, ht, tiles_w, tiles_h, block;
};

namespace {

constexpr int kMaxThreads = 256;

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
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

// This thread's image n, first row i0, column j and channel group g;
// false where they fall outside the [N, H, W, C / VEC] small side.
__device__ __forceinline__ bool locate(const Upsample2xTiles& t, int N, int H, int W,
                                       int groups, int& n, int& i0, int& j, int& g) {
  const int q = threadIdx.x / t.gb;
  g = blockIdx.y * t.gb + threadIdx.x % t.gb;
  const int b = blockIdx.x / t.tiles_w;
  j = (blockIdx.x % t.tiles_w) * t.rt + q % t.rt;
  i0 = ((b % t.tiles_h) * t.ht + q / t.rt) * t.rows;
  n = b / t.tiles_h;
  return n < N && i0 < H && j < W && g < groups;
}

// One output pack from its four taps with torch's expression
// wy0 * (wx0 * a00 + wx1 * a01) + wy1 * (wx0 * a10 + wx1 * a11)
// (upsample_bilinear2d_nhwc_out_frame) and the FMAs its build makes of it,
// spelled out so that no contraction choice of ours differs.
template <typename T, int VEC>
__device__ __forceinline__ void bilerp(const Pack<T, VEC>& a00, const Pack<T, VEC>& a01,
                                       const Pack<T, VEC>& a10, const Pack<T, VEC>& a11,
                                       float wx0, float wx1, float wy0, float wy1, T* dst) {
  Pack<T, VEC> o;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float r0 = __fmaf_rn(wx1, to_f32(a01.v[v]), __fmul_rn(wx0, to_f32(a00.v[v])));
    const float r1 = __fmaf_rn(wx0, to_f32(a10.v[v]), __fmul_rn(wx1, to_f32(a11.v[v])));
    o.v[v] = from_f32<T>(__fmaf_rn(wy0, r0, __fmul_rn(wy1, r1)));
  }
  *reinterpret_cast<Pack<T, VEC>*>(dst) = o;
}

// The quad of input pixel (i, j): rows[r] and cols[c] are the offsets of
// rows (i-1, i, i+1) and columns (j-1, j, j+1), clamped, at this thread's
// channel group of its image. Torch's source index for output 2k is
// k - 0.25 (taps k-1, k with weights 0.25, 0.75), except at k = 0, where
// it is 0 (taps 0, min(1, n-1) with weights 1, 0); for 2k+1 it is
// k + 0.25 (taps k, min(k+1, n-1) with weights 0.75, 0.25). These are
// exact in fp32, so the weights are the values torch computes.
// TOP: i == 0 (row i-1 is not read); LEFT: j == 0.
template <typename T, int VEC, bool TOP, bool LEFT>
__device__ __forceinline__ void fwd_quad(const T* img, const int (&rows)[3], const int (&cols)[3],
                                         T* o0, T* o1, int C) {
  Pack<T, VEC> w[3][3];
#pragma unroll
  for (int r = TOP ? 1 : 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) w[r][c] = load<T, VEC>(img + rows[r] + cols[c]);
  }
  constexpr int e0 = TOP ? 1 : 0, e1 = TOP ? 2 : 1;   // rows of output row 2i
  constexpr int c0 = LEFT ? 1 : 0, c1 = LEFT ? 2 : 1;  // columns of output column 2j
  constexpr float wye0 = TOP ? 1.0f : 0.25f, wye1 = TOP ? 0.0f : 0.75f;
  constexpr float wxe0 = LEFT ? 1.0f : 0.25f, wxe1 = LEFT ? 0.0f : 0.75f;
  bilerp<T, VEC>(w[e0][c0], w[e0][c1], w[e1][c0], w[e1][c1], wxe0, wxe1, wye0, wye1, o0);
  bilerp<T, VEC>(w[e0][1], w[e0][2], w[e1][1], w[e1][2], 0.75f, 0.25f, wye0, wye1, o0 + C);
  bilerp<T, VEC>(w[1][c0], w[1][c1], w[2][c0], w[2][c1], wxe0, wxe1, 0.75f, 0.25f, o1);
  bilerp<T, VEC>(w[1][1], w[1][2], w[2][1], w[2][2], 0.75f, 0.25f, 0.75f, 0.25f, o1 + C);
}

// x [N, H, W, C] -> y [N, 2H, 2W, C]; one thread a (n, input pixel, group).
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    upsample2x_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int N, int H, int W, int C,
                          Upsample2xTiles tiles) {
  int n, i, j, g;
  if (!locate(tiles, N, H, W, C / VEC, n, i, j, g)) return;
  const int row = W * C;
  const T* img = x + n * H * row + g * VEC;
  const int rows[3] = {max(i - 1, 0) * row, i * row, min(i + 1, H - 1) * row};
  const int cols[3] = {max(j - 1, 0) * C, j * C, min(j + 1, W - 1) * C};
  T* o0 = y + (n * 2 * H + 2 * i) * 2 * row + 2 * j * C + g * VEC;
  T* o1 = o0 + 2 * row;
  if (i == 0) {
    if (j == 0) fwd_quad<T, VEC, true, true>(img, rows, cols, o0, o1, C);
    else fwd_quad<T, VEC, true, false>(img, rows, cols, o0, o1, C);
  } else {
    if (j == 0) fwd_quad<T, VEC, false, true>(img, rows, cols, o0, o1, C);
    else fwd_quad<T, VEC, false, false>(img, rows, cols, o0, o1, C);
  }
}

// g [N, 2H, 2W, C] -> dx [N, H, W, C]; H and W are dx's. One thread a
// (n, block of ROWS dx rows, dx column j, group): g rows 2i0-1 ..
// 2i0+2*ROWS and columns 2j-1 .. 2j+2, clamped. Each g row is summed over
// its 4 columns in order, then dx row s over g rows 2s .. 2s+3 of the
// window in order, with the FMAs that order contracts to, spelled out
// so that no contraction choice of the build changes a bit.
template <typename T, int VEC, int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
    upsample2x_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, int N, int H, int W, int C,
                          Upsample2xTiles tiles) {
  int n, i0, j, cg;
  if (!locate(tiles, N, H, W, C / VEC, n, i0, j, cg)) return;
  const int GH = 2 * H, GW = 2 * W;
  const int grow = GW * C;
  const T* img = g + n * GH * grow + cg * VEC;
  const int cols[4] = {max(2 * j - 1, 0) * C, 2 * j * C, (2 * j + 1) * C,
                       min(2 * j + 2, GW - 1) * C};
  const float taps[4] = {0.25f, 0.75f, 0.75f, 0.25f};
  float acc[ROWS][VEC];
#pragma unroll
  for (int k = 0; k < 2 * ROWS + 2; ++k) {
    const T* row = img + min(max(2 * i0 - 1 + k, 0), GH - 1) * grow;
    Pack<T, VEC> t[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) t[c] = load<T, VEC>(row + cols[c]);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float r = __fmaf_rn(taps[0], to_f32(t[0].v[v]), 0.0f);
#pragma unroll
      for (int c = 1; c < 4; ++c) r = __fmaf_rn(taps[c], to_f32(t[c].v[v]), r);
#pragma unroll
      for (int s = 0; s < ROWS; ++s) {
        const int a = k - 2 * s;
        if (a == 0) acc[s][v] = __fmaf_rn(taps[0], r, 0.0f);
        else if (a > 0 && a < 4) acc[s][v] = __fmaf_rn(taps[a], r, acc[s][v]);
      }
    }
  }
  T* out = dx + ((n * H + i0) * W + j) * C + cg * VEC;
#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    if (ROWS == 1 || i0 + s < H) {
      Pack<T, VEC> o;
#pragma unroll
      for (int v = 0; v < VEC; ++v) o.v[v] = from_f32<T>(acc[s][v]);
      *reinterpret_cast<Pack<T, VEC>*>(out + s * W * C) = o;
    }
  }
}

// N, H, W, C are the small side's: the forward's input, the adjoint's
// output. Returns the cudaError_t of the launch.
template <typename T, int VEC, bool BWD>
int launch(const void* in, void* out, int N, int H, int W, int C, const Upsample2xTiles& t,
           int grid, cudaStream_t s) {
  const dim3 blocks(grid, t.slices);
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  if (!BWD) {
    upsample2x_fwd_kernel<T, VEC><<<blocks, t.block, 0, s>>>(src, dst, N, H, W, C, t);
  } else if (t.rows == 1) {
    upsample2x_bwd_kernel<T, VEC, 1><<<blocks, t.block, 0, s>>>(src, dst, N, H, W, C, t);
  } else {
    upsample2x_bwd_kernel<T, VEC, 2><<<blocks, t.block, 0, s>>>(src, dst, N, H, W, C, t);
  }
  return (int)cudaGetLastError();
}

template <bool BWD>
int dispatch(const void* in, void* out, int N, int H, int W, int C, int dtype,
             const Upsample2xTiles* t, int grid, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (N < 1 || H < 1 || W < 1 || C < 1 || C % vec != 0 || dtype < 0 || dtype > 1 ||
      4LL * N * H * W * C > INT_MAX || t == nullptr || grid < 1 || t->slices < 1 ||
      t->slices > 65535 || t->block < 1 || t->block > kMaxThreads || t->gb < 1 || t->rt < 1 ||
      t->ht < 1 || t->tiles_w < 1 || t->tiles_h < 1 || t->rows < 1 ||
      t->rows > (BWD ? 2 : 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float, 4, BWD>(in, out, N, H, W, C, *t, grid, s);
  return launch<__nv_bfloat16, 8, BWD>(in, out, N, H, W, C, *t, grid, s);
}

}  // namespace

// Plain C entry points for ctypes. dtype: 0 = fp32, 1 = bf16. C must be a
// multiple of 4 (fp32) or 8 (bf16) and the pointers 16-byte aligned;
// `tiles` and `grid` are plan_upsample's (the forward's rows 1, the
// adjoint's 1 or 2), and the 2x side may hold at most
// 2^31 - 1 elements. Returns the cudaError_t of the launch.

// x [N, H, W, C] -> y [N, 2H, 2W, C].
extern "C" int tg_upsample2x_fwd(const void* x, void* y, int N, int H, int W, int C, int dtype,
                                 const Upsample2xTiles* tiles, int grid, void* stream) {
  return dispatch<false>(x, y, N, H, W, C, dtype, tiles, grid, stream);
}

// g [N, 2H, 2W, C] -> dx [N, H, W, C]; H and W are dx's.
extern "C" int tg_upsample2x_bwd(const void* g, void* dx, int N, int H, int W, int C, int dtype,
                                 const Upsample2xTiles* tiles, int grid, void* stream) {
  return dispatch<true>(g, dx, N, H, W, C, dtype, tiles, grid, stream);
}
