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
//   P1  out[p]    = sum_c a[p, c] * k[c]                      P2's kernel: k [C] is
//                                                           k [C, 1]'s memory
//   P2  out[p]    = sum_c a[p, c] * k[c, 0]                   L lanes per p (below)
//   P3  out[p, n] = sum_j [a, 2a][p, j] * k2[j, n], j < 2C    R rows x BN columns a
//                                                           block, one load round
//                                                           (below)
//   P4  out[p, c] = a[p, c] * m[p]                           one float4 a thread
//                                                           (below)
//   P5  out[r]    = .25 * a[r] + .75 * a[r + 1], r < R - 1;   one float4 a thread
//       out[R-1]  = a[R-1]                                    (below)
//
// where p runs over the leading dimensions flattened. Bound on the H100: at
// the probes' own shapes (a = 16x64x64 fp32, 256 KiB) every one moves under
// 600 KB and does under 17 MFLOP, a bound under 0.3 us, below the launch
// itself (an empty kernel takes about 1 us): they are launch-bound, and
// their floor is one launch plus one trip to memory. P4 and P5 round each
// product and sum once, as torch does (spelled __fmul_rn/__fadd_rn so that
// nvcc cannot contract them into an FMA), so they give torch's bits; P1-P3
// sum in another order than torch and are held to 1e-6 of the largest
// output.
//
// P1-P4 each come in two variants, picked by the wrapper's planner
// (ops/cuda/probe_kernels.py :: plan_probe) and passed in by number: vec4
// (16-byte loads; C % 4 == 0 and 16-byte aligned inputs, for P3 also
// N % 4 == 0) and scalar (any C, N and 4-byte alignment) with the same
// thread mapping. The C entries check the plan and refuse one the kernel
// does not take.
//   P1 and P2: a row takes a group of L lanes, L the least power of two
//   <= 32 with 4L >= C (C = 64: L = 16, a float4 a lane, two rows a warp,
//   1024 rows over 128 blocks of 128 threads; a grid-stride loop takes any
//   rows past the grid). Each lane reads its float4s of the row and of k
//   with __ldg and sums them with fmaf in order; the group then adds its
//   partial sums by an xor-shuffle tree of log2(L) steps. No shared memory,
//   no barrier; a row's loads are one contiguous 256-byte span.
//   P3: a block takes a tile of R rows by BN = 4 BQ columns (R and BQ
//   powers of two, R <= 16, BQ <= 16), a 1-D grid over the tiles. Each
//   output has a thread in each of two groups (2 R BQ <= 256 threads; a
//   warp: 32 / R column quads of R rows): the a group sums lo over the a
//   half (k2's rows j < C), the 2a group hi over the 2a half (rows C + j),
//   each an fmaf chain in ascending j; after a second barrier the 2a group
//   hands hi over in shared memory and the a group writes lo + hi. Two
//   groups keep two warps on each scheduler, so one warp's wait on shared
//   memory hides behind the other's FMAs. The block stages its R rows of a
//   and the rows j and C + j of k2 at its columns (hot in L2) in shared
//   memory by cp.async (16 bytes a copy in vec4, 4 in scalar), all issued
//   before one barrier. Copying k2, whose lines every block reads at once,
//   costs: on the H100 (profile_slice.py --legs probes) one group of R = 8
//   by all 64 columns took 3.4 us, R = 1 23 us. So the planner picks the
//   R and BQ that stage the fewest bytes on the busiest SM: at the probe's
//   shape R = 16 by 32 columns, 128 blocks of 20 KB, each k2 line read by
//   64 blocks (R = 32 by 16 columns, 16 KB, read 5-10 % slower, its warps'
//   loads of a spanning 32 rows). Each a value is read from global memory
//   once: the 2a half
//   is 2 * the register that holds a (exact in fp32; an overflow gives
//   inf, as torch's a * 2.0 does). Where a block's stage passes the 48 KB
//   budget, K goes in chunks of kchunk columns of a (a multiple of 4; the
//   last chunk ends at C) with the next chunk's copies in flight (a double
//   buffer).
//   P4: a thread takes a float4 of a, which lies in one row, so a row index
//   costs one 32-bit division a float4; m[p] is read once with __ldg.
//   P5: a thread takes one float4 (vec4: a row of R = a.shape[0] holds a
//   multiple of 4 floats, a and out 16-byte aligned) or one float
//   (scalar), with 32-bit indices and no loop: at the probe's shape 16384
//   float4s, 64 blocks of 256. Element i of the first R - 1 rows reads
//   i and i + row; the last row is a copy.

#include <cuda_runtime.h>

#include "mma_tf32.cuh"  // smem_u32, cp_async16, cp_async_commit, cp_async_wait

namespace {

// P5's block
constexpr int kRowBuildThreads = 256;

// P1's, P2's and P4's blocks; every probe's variants as the wrapper numbers them
constexpr int kProbeThreads = 128;
constexpr int kScalar = 0, kVec4 = 1;

// The lanes a P1 or P2 row takes: the least power of two L <= 32 with 4L >= c.
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

// P3's tiles: at most 16 rows (a warp's float4 loads of a then span at
// most 256 bytes, two shared-memory wavefronts) by 64 columns, a thread of
// each of two groups an output (at most 2 x 128 threads), and 48 KB of
// shared memory a block (the most a launch takes without opting in)
constexpr int kConcatMaxRows = 16, kConcatMaxQuads = 16, kConcatThreads = 256;
constexpr unsigned kConcatSmemBudget = 48 * 1024;

// The a tile's row stride in floats: kcp rounded up to 4 mod 32, so 8
// consecutive rows' float4s at one column lie in 8 distinct groups of 4 banks.
__host__ __device__ inline unsigned concat_a_stride(unsigned kcp) {
  return kcp + ((4u - kcp) & 31u);
}

// One stage in floats: the a tile [rows][stride], then k2's two halves
// [kcp][bn] each (rows j, then rows C + j)
__host__ __device__ inline unsigned concat_stage_floats(unsigned rows, unsigned bn, unsigned kcp) {
  return rows * concat_a_stride(kcp) + 2u * kcp * bn;
}

// A block's shared memory in bytes: its stages, then the float4 a thread
// of the 2a group hands to the a group
__host__ __device__ inline unsigned concat_smem_bytes(unsigned rows, unsigned bq, unsigned kcp,
                                                      unsigned stages) {
  return 4u * (stages * concat_stage_floats(rows, 4u * bq, kcp) + 4u * rows * bq);
}

// 4 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

// Stage chunk [j0, j0 + kc) of a's columns: the tile's rows of a, and k2's
// rows j0 + jj and C + j0 + jj at the tile's columns; slots past kc (up to
// kcp), past the last row or past the last column are zero-filled. Thread
// (rs, qs) = (tid >> bq_log, tid & (bq - 1)), rs < 2R, takes float4 slots
// of a row of a and of k2 rows rs, rs + 2R, ...: no division.
template <bool VEC4>
__device__ __forceinline__ void concat_stage(float* buf, const float* __restrict__ a,
                                             const float* __restrict__ k2, unsigned m,
                                             unsigned c, unsigned n, unsigned row0,
                                             unsigned col0, unsigned rows_log, unsigned bq_log,
                                             unsigned kcp_max, unsigned j0, unsigned kc) {
  const unsigned rows = 1u << rows_log, bq = 1u << bq_log, bn = 4u * bq;
  const unsigned qs = threadIdx.x & (bq - 1), rs = threadIdx.x >> bq_log;
  const unsigned kcp = (kc + 3u) & ~3u;
  const unsigned stride = concat_a_stride(kcp_max);
  // a: row rs mod R, the two halves of the threads on alternate float4 runs
  float* sa = buf + (rs & (rows - 1)) * stride;
  const unsigned row = row0 + (rs & (rows - 1));
  for (unsigned u = 4u * (qs + (rs >> rows_log) * bq); u < kcp; u += 2u * bn) {
    if (VEC4) {
      const bool ok = row < m;  // kc is a multiple of 4 in vec4
      cp_async16(sa + u, ok ? a + row * c + j0 + u : a, ok);
    } else {
#pragma unroll
      for (unsigned e = 0; e < 4; ++e) {
        const bool ok = row < m && u + e < kc;
        cp_async4(sa + u + e, ok ? a + row * c + j0 + u + e : a, ok);
      }
    }
  }
  float* sk = buf + rows * stride + 4u * qs;
  const unsigned col = col0 + 4u * qs;
  for (unsigned h = 0; h < 2; ++h) {
    for (unsigned jj = rs; jj < kcp; jj += 2u * rows) {
      const unsigned kj = h * c + j0 + jj;  // k2's row
      float* dst = sk + (h * kcp_max + jj) * bn;
      if (VEC4) {
        const bool ok = jj < kc && col < n;  // n is a multiple of 4 in vec4
        cp_async16(dst, ok ? k2 + kj * n + col : k2, ok);
      } else {
#pragma unroll
        for (unsigned e = 0; e < 4; ++e) {
          const bool ok = jj < kc && col + e < n;
          cp_async4(dst + e, ok ? k2 + kj * n + col + e : k2, ok);
        }
      }
    }
  }
}

template <bool VEC4>
__global__ void __launch_bounds__(kConcatThreads, 4)
    lane_concat_dot_kernel(const float* __restrict__ a, const float* __restrict__ k2,
                           float* __restrict__ out, unsigned m, unsigned c, unsigned n,
                           unsigned rows_log, unsigned bq_log, unsigned kchunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const unsigned rows = 1u << rows_log, bn = 4u << bq_log;
  const unsigned col_tiles = (n + bn - 1) >> (bq_log + 2);
  const unsigned row0 = (blockIdx.x / col_tiles) << rows_log;
  const unsigned col0 = (blockIdx.x % col_tiles) * bn;
  const unsigned kcp_max = (kchunk + 3u) & ~3u;
  const unsigned stage = concat_stage_floats(rows, bn, kcp_max);
  const unsigned stride = concat_a_stride(kcp_max);
  const unsigned chunks = (c + kchunk - 1) / kchunk;
  // the thread's group (0: the a half, lo; 1: the 2a half, hi) and output:
  // row r of the tile, column quad q
  const unsigned half = threadIdx.x >> (rows_log + bq_log);
  const unsigned t = threadIdx.x & ((1u << (rows_log + bq_log)) - 1);
  const unsigned r = t & (rows - 1), q = t >> rows_log;

  concat_stage<VEC4>(smem, a, k2, m, c, n, row0, col0, rows_log, bq_log, kcp_max, 0,
                     min(kchunk, c));
  cp_async_commit();
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (unsigned ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {  // the next chunk's copies in flight while this one sums
      const unsigned j1 = (ch + 1) * kchunk;
      concat_stage<VEC4>(smem + ((ch + 1) & 1) * stage, a, k2, m, c, n, row0, col0, rows_log,
                         bq_log, kcp_max, j1, min(kchunk, c - j1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = smem + (ch & 1) * stage;
    const float* sa = buf + r * stride;
    // the group's half of k2: rows j (lo) or C + j (hi)
    const float4* kh = reinterpret_cast<const float4*>(buf + rows * stride) + q +
                       half * (kcp_max << bq_log);
    const unsigned kcp = (min(kchunk, c - ch * kchunk) + 3u) & ~3u;
#pragma unroll 2
    for (unsigned jj = 0; jj < kcp; jj += 4) {
      const float4 x = *reinterpret_cast<const float4*>(sa + jj);
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (unsigned e = 0; e < 4; ++e) {
        const float v = half ? __fmul_rn(2.0f, xs[e]) : xs[e];  // the 2a half, exact
        const float4 w = kh[(jj + e) << bq_log];
        s.x = fmaf(v, w.x, s.x);
        s.y = fmaf(v, w.y, s.y);
        s.z = fmaf(v, w.z, s.z);
        s.w = fmaf(v, w.w, s.w);
      }
    }
    if (ch + 1 < chunks) __syncthreads();  // the buffer is staged again at ch + 2
  }
  // the 2a group hands hi to the a group, which writes lo + hi
  float4* xchg = reinterpret_cast<float4*>(smem + (chunks > 1 ? 2 : 1) * stage);
  if (half) xchg[t] = s;
  __syncthreads();
  const unsigned row = row0 + r, col = col0 + 4u * q;
  if (half || row >= m) return;
  const float4 hi = xchg[t];
  const float4 o4 = make_float4(__fadd_rn(s.x, hi.x), __fadd_rn(s.y, hi.y), __fadd_rn(s.z, hi.z),
                                __fadd_rn(s.w, hi.w));
  float* o = out + row * n + col;
  if (VEC4) {
    if (col < n) *reinterpret_cast<float4*>(o) = o4;
  } else {
    const float os[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
    for (unsigned e = 0; e < 4; ++e)
      if (col + e < n) o[e] = os[e];
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

template <bool VEC4>
__global__ void __launch_bounds__(kRowBuildThreads)
    row_build_kernel(const float* __restrict__ a, float* __restrict__ out, unsigned total,
                     unsigned last, unsigned row) {
  // total, last (the items before the last row) and row in float4s (vec4) or floats
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  if (VEC4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4 x = __ldg(a4 + i);
    float4 o = x;
    if (i < last) {
      const float4 y = __ldg(a4 + i + row);
      o = make_float4(__fadd_rn(__fmul_rn(0.25f, x.x), __fmul_rn(0.75f, y.x)),
                      __fadd_rn(__fmul_rn(0.25f, x.y), __fmul_rn(0.75f, y.y)),
                      __fadd_rn(__fmul_rn(0.25f, x.z), __fmul_rn(0.75f, y.z)),
                      __fadd_rn(__fmul_rn(0.25f, x.w), __fmul_rn(0.75f, y.w)));
    }
    reinterpret_cast<float4*>(out)[i] = o;
  } else {
    const float x = __ldg(a + i);
    out[i] = i < last ? __fadd_rn(__fmul_rn(0.25f, x), __fmul_rn(0.75f, __ldg(a + i + row))) : x;
  }
}

__global__ void empty_kernel() {}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// Whether P1's, P2's or P4's wrapper planned a launch the kernel takes:
// blocks of kProbeThreads, and vec4 only for C % 4 == 0 and 16-byte
// aligned pointers.
bool probe_plan_ok(int variant, int c, int grid, int block, const void* p0, const void* p1) {
  if (grid < 1 || block != kProbeThreads) return false;
  if (variant == kScalar) return true;
  return variant == kVec4 && c % 4 == 0 && aligned16(p0) && aligned16(p1);
}

// log2 of v where v is a power of two in [1, max], else -1
int pow2_log(int v, int max) {
  for (int l = 0; (1 << l) <= max; ++l)
    if (v == 1 << l) return l;
  return -1;
}

template <int L>
void launch_matvec_dot(int variant, int grid, int block, cudaStream_t stream, const float* a,
                       const float* k, float* out, int n, int c) {
  if (variant == kVec4)
    matvec_dot_kernel<L, true><<<grid, block, 0, stream>>>(a, k, out, n, c);
  else
    matvec_dot_kernel<L, false><<<grid, block, 0, stream>>>(a, k, out, n, c);
}

// P1's and P2's launch: out[p] = sum_c a[p, c] * k[c] in the plan's variant
int matvec_dot(const void* a, const void* k, void* out, int n, int c, int variant, int grid,
               int block, void* stream) {
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

}  // namespace

// Plain C entry points for ctypes. Every pointer is fp32 and contiguous;
// n (m for P3) is the number of leading positions p. Each returns the
// cudaError_t of its launch, or cudaErrorInvalidValue for a plan the
// kernel does not take.

// a [n, c], k [c] -> out [n]: P2's kernel (k [c] is k [c, 1]'s memory), in
// the variant (0 scalar, 1 vec4), grid and block (128 threads) of the
// wrapper's plan; n * c < 2^31
extern "C" int tg_probe_lane_reduce(const void* a, const void* k, void* out, int n, int c,
                                    int variant, int grid, int block, void* stream) {
  return matvec_dot(a, k, out, n, c, variant, grid, block, stream);
}

// a [n, c], k [c, 1] -> out [n], in the variant (0 scalar, 1 vec4), grid
// and block (128 threads) of the wrapper's plan; n * c < 2^31
extern "C" int tg_probe_matvec_dot(const void* a, const void* k, void* out, int n, int c,
                                   int variant, int grid, int block, void* stream) {
  return matvec_dot(a, k, out, n, c, variant, grid, block, stream);
}

// a [m, c], k2 [2c, n] -> out [m, n], in the variant (0 scalar, 1 vec4),
// grid (the tiles, 1-D), block (2 * rows * BQ <= 256 threads, BQ a power
// of two <= 16), rows (a power of two <= 16) and kchunk (c in one stage,
// else a multiple of 4 below c, two stages) of the wrapper's plan; every
// tensor < 2^31 elements, and the block's shared memory within 48 KB
extern "C" int tg_probe_lane_concat_dot(const void* a, const void* k2, void* out, int m, int c,
                                        int n, int variant, int grid, int block, int rows,
                                        int kchunk, void* stream) {
  const long long big = 0x7fffffffLL;
  if (m < 1 || c < 1 || n < 1 || (long long)m * c > big || (long long)m * n > big ||
      2LL * c * n > big)
    return (int)cudaErrorInvalidValue;
  const int rows_log = pow2_log(rows, kConcatMaxRows);
  if (rows_log < 0 || block > kConcatThreads || block % (2 * rows) != 0)
    return (int)cudaErrorInvalidValue;
  const int bq_log = pow2_log(block / (2 * rows), kConcatMaxQuads);
  if (bq_log < 0) return (int)cudaErrorInvalidValue;
  const int bn = 4 << bq_log;
  const long long tiles = (long long)((m + rows - 1) / rows) * ((n + bn - 1) / bn);
  const bool chunked = kchunk < c;
  if (grid != tiles || kchunk < 1 || kchunk > c || (chunked && kchunk % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const unsigned smem = concat_smem_bytes(rows, 1u << bq_log, (kchunk + 3) & ~3, chunked ? 2 : 1);
  if (smem > kConcatSmemBudget) return (int)cudaErrorInvalidValue;
  const auto* pa = static_cast<const float*>(a);
  const auto* pk = static_cast<const float*>(k2);
  auto* po = static_cast<float*>(out);
  const auto s = (cudaStream_t)stream;
  if (variant == kVec4) {
    if (c % 4 != 0 || n % 4 != 0 || kchunk % 4 != 0 || !aligned16(a) || !aligned16(k2) ||
        !aligned16(out))
      return (int)cudaErrorInvalidValue;
    lane_concat_dot_kernel<true><<<grid, block, smem, s>>>(pa, pk, po, m, c, n, rows_log, bq_log,
                                                           kchunk);
  } else if (variant == kScalar) {
    lane_concat_dot_kernel<false><<<grid, block, smem, s>>>(pa, pk, po, m, c, n, rows_log, bq_log,
                                                            kchunk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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

// a [rows, row_elems] -> out [rows, row_elems], in the variant (0 scalar,
// 1 vec4: row_elems % 4 == 0, a and out 16-byte aligned), grid and block
// (256 threads, a float4 or a float each) of the wrapper's plan;
// rows * row_elems < 2^31
extern "C" int tg_probe_row_build(const void* a, void* out, int rows, int row_elems, int variant,
                                  int grid, int block, void* stream) {
  if (rows < 1 || row_elems < 1 || (long long)rows * row_elems > 0x7fffffffLL ||
      block != kRowBuildThreads)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = variant == kVec4;
  if ((!vec4 && variant != kScalar) ||
      (vec4 && (row_elems % 4 != 0 || !aligned16(a) || !aligned16(out))))
    return (int)cudaErrorInvalidValue;
  const unsigned row = vec4 ? row_elems / 4 : row_elems;
  const unsigned total = row * (unsigned)rows;
  if ((long long)grid != ((long long)total + block - 1) / block) return (int)cudaErrorInvalidValue;
  const auto* pa = static_cast<const float*>(a);
  auto* po = static_cast<float*>(out);
  const auto s = (cudaStream_t)stream;
  if (vec4)
    row_build_kernel<true><<<grid, block, 0, s>>>(pa, po, total, total - row, row);
  else
    row_build_kernel<false><<<grid, block, 0, s>>>(pa, po, total, total - row, row);
  return (int)cudaGetLastError();
}

// One empty block of one warp: the floor under the probes' times.
extern "C" int tg_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
