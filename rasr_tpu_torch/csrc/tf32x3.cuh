// 3xTF32 tensor-core products at fp32 accuracy, and cp.async copies, for
// Hopper (sm_90a). Shared by gmm_fused.cu and mfcc_fused.cu.
//
// An fp32 operand x splits into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna: round to nearest, ties away from zero). A product runs as
// lo*hi + hi*lo + hi*hi on the tensor cores (mma.sync m16n8k8, TF32 in,
// fp32 accumulate): each partial product of two TF32 values is exact in
// fp32 and the dropped lo*lo term is below 2^-22 of |a*b|, the accuracy
// of an fp32 product. rasr_tpu_torch/ops/kernels/tf32.py is the host side
// of the same split.
//
// Fragment layouts of mma.sync.aligned.m16n8k8 (lane = 4 g + t):
//   A 16x8 (row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B 8x8 (col-major):  b0 (k=t, n=g), b1 (k=t+4, n=g)
//   C 16x8:             c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// The kernels keep both operands in shared memory in fragment order, so a
// lane loads each fragment plane with one 16-byte load (no bank conflicts):
// A as [16x8 tile][plane hi/lo][lane][a0..a3], B as
// [8x8 tile][lane][hi b0, hi b1, lo b0, lo b1].
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

// Where element (row, col) of a 16x8 A tile sits: lane * 4 + register.
__device__ __forceinline__ int a_slot(int row, int col) {
  const int lane = (row & 7) * 4 + (col & 3);
  return lane * 4 + (row >> 3) + 2 * (col >> 2);
}

// d += a * b on the tensor cores (not volatile: the compiler may interleave
// independent products, which hides the latency of dependent ones)
__device__ __forceinline__ void mma(float (&d)[4], const float4& a, float b0, float b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)),
        "r"(__float_as_uint(a.z)), "r"(__float_as_uint(a.w)),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// d += a * b at fp32 accuracy for I x J independent products, with a as
// hi/lo fragments and b as (hi b0, hi b1, lo b0, lo b1): first the small
// terms of every product, then the large ones, so each accumulator's three
// dependent products sit I*J products apart.
template <int I, int J>
__device__ __forceinline__ void mma3(float (&d)[I][J][4], const float4 (&a_hi)[I],
                                     const float4 (&a_lo)[I], const float4 (&b)[J]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) mma(d[i][j], a_lo[i], b[j].x, b[j].y);
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) mma(d[i][j], a_hi[i], b[j].z, b[j].w);
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) mma(d[i][j], a_hi[i], b[j].x, b[j].y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
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
