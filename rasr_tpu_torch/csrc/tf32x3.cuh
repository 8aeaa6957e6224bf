// The 3xTF32 split of fp32 operands, and the cp.async copies of the MFCC
// kernel's sample spans, for Hopper (sm_90a). Shared by gmm_fused.cu and
// mfcc_fused.cu.
//
// An fp32 operand x splits into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna: round to nearest, ties away from zero). A product runs as
// lo*hi + hi*lo + hi*hi on the tensor cores (wgmma, TF32 in, fp32
// accumulate: sm90.cuh): each partial product of two TF32 values is exact
// in fp32 and the dropped lo*lo term is below 2^-22 of |a*b|, the accuracy
// of an fp32 product. rasr_tpu_torch/ops/kernels/tf32.py is the host side
// of the same split.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int SMEM_MAX = 232448;  // the dynamic shared memory a block may use on Hopper

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> (hi, lo) as fp32 bit patterns with the low 13 mantissa bits zero
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  const uint32_t h = to_tf32(x);
  hi = __uint_as_float(h);
  lo = __uint_as_float(to_tf32(x - hi));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

}  // namespace tf32x3
