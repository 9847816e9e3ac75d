// Tensor-core and copy helpers shared by K2 (pconv_eval.cu) and K3
// (decoder_tail.cu): 16-byte cp.async copies (P3 in probes.cu takes them
// too), the TF32 rounding both
// kernels split fp32 operands with, and mma.sync m16n8k8 in TF32.
//
// 3xTF32: an fp32 value v is split into hi = tf32(v) and lo = tf32(v - hi)
// (both rounded to nearest, ties away from zero, as cvt.rna rounds and as
// the wrappers' tf32_round emulates), and a product a * b is taken as
// lo_a * hi_b + hi_a * lo_b, then hi_a * hi_b: about 2^-22 of |a b| off,
// where TF32 alone is 2^-11 off.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// round to TF32, to nearest with ties away from zero (pack_pconv_weight's rounding)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a * b on the tensor cores: A 16x8 (row), B 8x8 (col), TF32 in, fp32 sum
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float relu_keep_nan(float v) { return v < 0.f ? 0.f : v; }

}  // namespace
