// The five Mosaic probes (P1-P5), fp32, as CUDA kernels for sm_90a.
//
// Replaces the TPU kernels of scripts/probe_mosaic.py :: probe_lane_reduce
// (P1), probe_matvec_dot (P2), probe_lane_concat_dot (P3),
// probe_mask_broadcast (P4) and probe_row_build (P5). On the TPU each probe
// asked whether Mosaic lowers one data movement the fused decoder tail
// needs (a lane-axis reduction, a matrix-vector dot, a lane concat feeding
// a K = 2C dot, a broadcast of a W-on-lanes field over C, static row-slice
// writes). Here each is the same function written in the card's own idiom,
// and the doctor and chip_smoke.py hold each against its plain PyTorch
// version:
//
//   P1  out[p]    = sum_c a[p, c] * k[c]                      one warp per p,
//                                                           __shfl_xor_sync tree
//   P2  out[p]    = sum_c a[p, c] * k[c, 0]                   L lanes per p (below)
//   P3  out[p, n] = sum_j [a, 2a][p, j] * k2[j, n], j < 2C    tiled SIMT product,
//                                                           [a, 2a] built in
//                                                           shared memory
//   P4  out[p, c] = a[p, c] * m[p]                           one float4 a thread
//                                                           (below)
//   P5  out[r]    = .25 * a[r] + .75 * a[r + 1], r < R - 1;   one thread per element
//       out[R-1]  = a[R-1]
//
// where p runs over the leading dimensions flattened. Bound on the H100: at
// the probes' own shapes (a = 16x64x64 fp32, 256 KiB) every one moves under
// 600 KB and does under 2.2 MFLOP, a bound under 0.2 us, far below the
// launch itself (an empty kernel takes longer): they are launch-bound, and
// their yardstick is the library call for the same function, timed the same
// way. P4 and P5 round each product and sum once, as torch does (spelled
// __fmul_rn/__fadd_rn so that nvcc cannot contract them into an FMA), so
// they give torch's bits; P1-P3 sum in another order than torch and are
// held to 1e-6 of the largest output.
//
// P2 and P4 each come in two variants, picked by the wrapper's planner
// (ops/cuda/probe_kernels.py :: plan_probe) and passed in by number:
// vec4 (C % 4 == 0 and 16-byte aligned rows) moves 16 bytes a load, scalar
// takes any C and any 4-byte alignment with the same thread mapping. Both
// use blocks of 128 threads, 32-bit indices and a grid-stride loop, so any
// grid covers every row.
//   P2: a row takes a group of L lanes, L the least power of two <= 32 with
//   4L >= C (C = 64: L = 16, a float4 a lane, two rows a warp, 1024 rows
//   over 128 blocks). Each lane reads its float4s of the row and of k with
//   __ldg and sums them with fmaf in order; the group then adds its partial
//   sums by an xor-shuffle tree of log2(L) steps. No shared memory, no
//   barrier; a row's loads are one contiguous 256-byte span.
//   P4: a thread takes a float4 of a, which lies in one row, so a row index
//   costs one 32-bit division a float4; m[p] is read once with __ldg.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void lane_reduce_kernel(const float* __restrict__ a, const float* __restrict__ k,
                                   float* __restrict__ out, int n, int c) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;  // whole warps leave together: warp is uniform in a warp
  const float* row = a + (size_t)warp * c;
  float s = 0.0f;
  for (int j = lane; j < c; j += 32) s = fmaf(row[j], k[j], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[warp] = s;
}

// P2 and P4's blocks; their variants as the wrapper numbers them
constexpr int kProbeThreads = 128;
constexpr int kScalar = 0, kVec4 = 1;

// The lanes a P2 row takes: the least power of two L <= 32 with 4L >= c.
int matvec_lanes(int c) {
  int lanes = 1;
  while (lanes < 32 && 4 * lanes < c) lanes <<= 1;
  return lanes;
}

template <int L, bool VEC4>
__global__ void __launch_bounds__(kProbeThreads)
    matvec_dot_kernel(const float* __restrict__ a, const float* __restrict__ k,
                      float* __restrict__ out, unsigned n, unsigned c) {
  constexpr unsigned kRowsPerWarp = 32 / L;
  const unsigned lane = threadIdx.x & (L - 1);
  const unsigned group = (threadIdx.x & 31) / L;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const unsigned stride = ((gridDim.x * blockDim.x) >> 5) * kRowsPerWarp;
  // r0 is the warp's first row, the same for all its lanes, so every lane
  // reaches each shuffle; a group past the last row adds zeros
  for (unsigned r0 = warp * kRowsPerWarp; r0 < n; r0 += stride) {
    const unsigned p = r0 + group;
    float s = 0.0f;
    if (p < n) {
      if (VEC4) {
        const unsigned c4 = c >> 2;
        const float4* row = reinterpret_cast<const float4*>(a) + p * c4;
        const float4* k4 = reinterpret_cast<const float4*>(k);
        for (unsigned j = lane; j < c4; j += L) {
          const float4 x = __ldg(row + j), w = __ldg(k4 + j);
          s = fmaf(x.x, w.x, s);
          s = fmaf(x.y, w.y, s);
          s = fmaf(x.z, w.z, s);
          s = fmaf(x.w, w.w, s);
        }
      } else {
        const float* row = a + p * c;
        for (unsigned j = lane; j < c; j += L) s = fmaf(__ldg(row + j), __ldg(k + j), s);
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off, L);
    if (p < n && lane == 0) out[p] = s;
  }
}

// Output tile BM x BN per block of (BN, BM / ROWS) threads; each thread
// keeps ROWS outputs of one column. The K = 2C axis goes BK at a time: the
// block builds the [a, 2a] slice of its BM rows in shared memory (2a is
// exact in fp32) beside the matching BK x BN slice of k2.
constexpr int BM = 32, BN = 32, BK = 32, ROWS = 4;

__global__ void lane_concat_dot_kernel(const float* __restrict__ a, const float* __restrict__ k2,
                                       float* __restrict__ out, int m, int c, int n) {
  __shared__ float as[BM][BK];
  __shared__ float bs[BK][BN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BN + tx;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int kdim = 2 * c;
  float acc[ROWS] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < kdim; k0 += BK) {
    for (int e = tid; e < BM * BK; e += BN * (BM / ROWS)) {
      const int r = e / BK, j = k0 + e % BK, p = row0 + r;
      float v = 0.0f;
      if (p < m && j < kdim) v = j < c ? a[(size_t)p * c + j] : 2.0f * a[(size_t)p * c + j - c];
      as[r][e % BK] = v;
    }
    for (int e = tid; e < BK * BN; e += BN * (BM / ROWS)) {
      const int j = k0 + e / BN, col = col0 + e % BN;
      bs[e / BN][e % BN] = (j < kdim && col < n) ? k2[(size_t)j * n + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float b = bs[kk][tx];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i] = fmaf(as[ty * ROWS + i][kk], b, acc[i]);
    }
    __syncthreads();
  }
  const int col = col0 + tx;
  if (col >= n) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int p = row0 + ty * ROWS + i;
    if (p < m) out[(size_t)p * n + col] = acc[i];
  }
}

template <bool VEC4>
__global__ void __launch_bounds__(kProbeThreads)
    mask_broadcast_kernel(const float* __restrict__ a, const float* __restrict__ mk,
                          float* __restrict__ out, unsigned n, unsigned c) {
  const unsigned stride = gridDim.x * blockDim.x;
  if (VEC4) {
    const unsigned c4 = c >> 2, total = n * c4;
    const float4* a4 = reinterpret_cast<const float4*>(a);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
      const float m = __ldg(mk + i / c4);
      const float4 x = __ldg(a4 + i);
      out4[i] = make_float4(__fmul_rn(x.x, m), __fmul_rn(x.y, m), __fmul_rn(x.z, m),
                            __fmul_rn(x.w, m));
    }
  } else {
    const unsigned total = n * c;
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
      out[i] = __fmul_rn(__ldg(a + i), __ldg(mk + i / c));
    }
  }
}

__global__ void row_build_kernel(const float* __restrict__ a, float* __restrict__ out, int rows,
                                 int row_elems) {
  const size_t total = (size_t)rows * row_elems;
  const size_t last = (size_t)(rows - 1) * row_elems;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = i < last ? __fadd_rn(__fmul_rn(0.25f, a[i]), __fmul_rn(0.75f, a[i + row_elems]))
                      : a[i];
  }
}

__global__ void empty_kernel() {}

int blocks_for(size_t threads_needed) {
  const size_t want = (threads_needed + kThreads - 1) / kThreads;
  return (int)(want < 132 * 32 ? (want ? want : 1) : 132 * 32);
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// Whether P2's or P4's wrapper planned a launch the kernel takes: blocks of
// kProbeThreads, and vec4 only for C % 4 == 0 and 16-byte aligned pointers.
bool probe_plan_ok(int variant, int c, int grid, int block, const void* p0, const void* p1) {
  if (grid < 1 || block != kProbeThreads) return false;
  if (variant == kScalar) return true;
  return variant == kVec4 && c % 4 == 0 && aligned16(p0) && aligned16(p1);
}

template <int L>
void launch_matvec_dot(int variant, int grid, int block, cudaStream_t stream, const float* a,
                       const float* k, float* out, int n, int c) {
  if (variant == kVec4)
    matvec_dot_kernel<L, true><<<grid, block, 0, stream>>>(a, k, out, n, c);
  else
    matvec_dot_kernel<L, false><<<grid, block, 0, stream>>>(a, k, out, n, c);
}

}  // namespace

// Plain C entry points for ctypes. Every pointer is fp32 and contiguous;
// n is the number of leading positions p. Each returns the cudaError_t of
// its launch.

// a [n, c], k [c] -> out [n]
extern "C" int tg_probe_lane_reduce(const void* a, const void* k, void* out, int n, int c,
                                    void* stream) {
  if (n < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((size_t)n * 32 + kThreads - 1) / kThreads);
  lane_reduce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(k), static_cast<float*>(out), n,
      c);
  return (int)cudaGetLastError();
}

// a [n, c], k [c, 1] -> out [n], in the variant (0 scalar, 1 vec4), grid
// and block (128 threads) of the wrapper's plan; n * c < 2^31
extern "C" int tg_probe_matvec_dot(const void* a, const void* k, void* out, int n, int c,
                                   int variant, int grid, int block, void* stream) {
  if (n < 1 || c < 1 || (long long)n * c > 0x7fffffffLL ||
      !probe_plan_ok(variant, c, grid, block, a, k))
    return (int)cudaErrorInvalidValue;
  const auto* pa = static_cast<const float*>(a);
  const auto* pk = static_cast<const float*>(k);
  auto* po = static_cast<float*>(out);
  const auto s = (cudaStream_t)stream;
  switch (matvec_lanes(c)) {
    case 1: launch_matvec_dot<1>(variant, grid, block, s, pa, pk, po, n, c); break;
    case 2: launch_matvec_dot<2>(variant, grid, block, s, pa, pk, po, n, c); break;
    case 4: launch_matvec_dot<4>(variant, grid, block, s, pa, pk, po, n, c); break;
    case 8: launch_matvec_dot<8>(variant, grid, block, s, pa, pk, po, n, c); break;
    case 16: launch_matvec_dot<16>(variant, grid, block, s, pa, pk, po, n, c); break;
    default: launch_matvec_dot<32>(variant, grid, block, s, pa, pk, po, n, c); break;
  }
  return (int)cudaGetLastError();
}

// a [m, c], k2 [2c, n] -> out [m, n]
extern "C" int tg_probe_lane_concat_dot(const void* a, const void* k2, void* out, int m, int c,
                                        int n, void* stream) {
  if (m < 1 || c < 1 || n < 1 || (m + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 block(BN, BM / ROWS);
  lane_concat_dot_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(k2), static_cast<float*>(out), m,
      c, n);
  return (int)cudaGetLastError();
}

// a [n, c], m [n] -> out [n, c], in the variant (0 scalar, 1 vec4), grid
// and block (128 threads) of the wrapper's plan; n * c < 2^31
extern "C" int tg_probe_mask_broadcast(const void* a, const void* mask, void* out, int n, int c,
                                       int variant, int grid, int block, void* stream) {
  if (n < 1 || c < 1 || (long long)n * c > 0x7fffffffLL ||
      !probe_plan_ok(variant, c, grid, block, a, out))
    return (int)cudaErrorInvalidValue;
  const auto* pa = static_cast<const float*>(a);
  const auto* pm = static_cast<const float*>(mask);
  auto* po = static_cast<float*>(out);
  if (variant == kVec4)
    mask_broadcast_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(pa, pm, po, n, c);
  else
    mask_broadcast_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(pa, pm, po, n, c);
  return (int)cudaGetLastError();
}

// a [rows, row_elems] -> out [rows, row_elems]
extern "C" int tg_probe_row_build(const void* a, void* out, int rows, int row_elems,
                                  void* stream) {
  if (rows < 1 || row_elems < 1) return (int)cudaErrorInvalidValue;
  row_build_kernel<<<blocks_for((size_t)rows * row_elems), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), static_cast<float*>(out), rows, row_elems);
  return (int)cudaGetLastError();
}

// One empty block of one warp: the floor under the probes' times.
extern "C" int tg_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
