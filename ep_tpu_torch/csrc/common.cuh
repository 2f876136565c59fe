// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every entry point is a plain C function: pointers and the CUDA stream come
// in as void*, sizes as int, and the function returns cudaGetLastError() so
// the Python wrapper can raise when a launch was refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#define EP_EXPORT extern "C" __attribute__((visibility("default")))

namespace ep {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 bf16 values travel as one 16-byte vector.
union Pack8 {
  uint4 u;
  unsigned short s[8];
  __device__ __forceinline__ float get(int e) const {
    return __bfloat162float(__ushort_as_bfloat16(s[e]));
  }
  __device__ __forceinline__ void set(int e, float v) {
    s[e] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ uint4 zero_pack() { return make_uint4(0u, 0u, 0u, 0u); }

// Two f32 values rounded to bf16 and packed into one 32-bit mma operand
// register (lo in the low half).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The two bf16 values packed in a 32-bit word (lo in the low half), as f32.
__device__ __forceinline__ float bf16_lo(unsigned pair) {
  return __uint_as_float(pair << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared (cp.async, bypassing L1).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the row address
// of matrix l/8 (the .trans form delivers each matrix transposed).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), d
// 16x8 f32. Thread (g = lane/4, t = lane%4) holds d rows g and g+8, columns
// 2t and 2t+1. Not volatile: the product has no side effect, so the compiler
// may interleave it with the (ordered, volatile) shared-memory loads.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ep
