// Shared device helpers for the port's Hopper kernels (sm_90a):
// cp.async copies, ldmatrix fragment loads and mma.sync tensor-core ops.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared async copy. src_bytes = 0 zero-fills the
// destination (ragged tile edges); src must still be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, s32 accumulate.
__device__ __forceinline__ void mma_s8_16832(int32_t* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Packed bf16 pairs (low half = lower address), each result rounded once to
// nearest even: fma.rn of an exact product or sum, so a * 1 + b is the
// correctly rounded sum and a * b + (-0) the correctly rounded product, as
// bf16 arithmetic that rounds after every op computes them. Written as PTX,
// so nothing is contracted across two calls.
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

constexpr uint32_t BF16X2_ONE = 0x3F803F80u;       // (1.0, 1.0)
constexpr uint32_t BF16X2_NEG_ZERO = 0x80008000u;  // (-0.0, -0.0)

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  return bf16x2_fma(a, b, BF16X2_NEG_ZERO);
}

__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  return bf16x2_fma(a, BF16X2_ONE, b);
}

// Bits of the bf16 nearest to v (ties to even).
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
