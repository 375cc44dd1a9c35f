// Helpers shared by the hand-written Hopper kernels of awq_tpu_torch.
//
// Each .cu file is built on its own into a shared library with a plain C
// interface (see awq_tpu_torch/_build.py) and includes this header once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

extern "C" const char* awq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Nibble `s` of a pack_int4 word as an exact float in [0, 15]: OR the code
// into the mantissa of 2^23 and subtract 2^23 (one LOP3 and one FADD, no
// int-to-float conversion unit).
__device__ __forceinline__ float nibble_f32(int32_t w, int s) {
  const uint32_t bits = 0x4B000000u | ((static_cast<uint32_t>(w) >> (4 * s)) & 0xFu);
  return __uint_as_float(bits) - 8388608.0f;
}

// D += A·B on one m16n8k16 tile, bf16 inputs, f32 accumulators.
// A (16x16, row-major): a[0] = (row g, k 2t..2t+1), a[1] = (row g+8, same k),
// a[2] = (row g, k 2t+8..2t+9), a[3] = (row g+8, k 2t+8..2t+9).
// B (16x8, k-major pairs): b[0] = (k 2t..2t+1, col g), b[1] = (k 2t+8..2t+9, col g).
// C: c[0..1] = (row g, cols 2t, 2t+1), c[2..3] = (row g+8, same cols);
// g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_bits(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static inline int cdiv(int a, int b) { return (a + b - 1) / b; }
