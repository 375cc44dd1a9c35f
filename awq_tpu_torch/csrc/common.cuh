// Helpers shared by the hand-written Hopper kernels of awq_tpu_torch.
//
// Each .cu file is built on its own into a shared library with a plain C
// interface (see awq_tpu_torch/_build.py) and includes this header once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// Model-dtype code of activations and norm weights: 0 f32, 1 bf16, 2 f16.
__device__ __forceinline__ float load_act(const void* p, int md, size_t i) {
  if (md == 1) return __bfloat162float(static_cast<const bf16*>(p)[i]);
  if (md == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_act(void* p, int md, size_t i, float v) {
  if (md == 1) static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else if (md == 2) static_cast<__half*>(p)[i] = __float2half_rn(v);
  else static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Element conversions (activations and caches are f32, bf16 or f16).
template <typename CT> __device__ __forceinline__ float to_f32(CT v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename CT> __device__ __forceinline__ CT from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// Four consecutive elements (activations or cache) as f32 (p 4-element aligned).
template <typename CT> __device__ __forceinline__ void load4(const CT* p, float* o);
template <> __device__ __forceinline__ void load4<float>(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
template <> __device__ __forceinline__ void load4<bf16>(const bf16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  o[0] = __low2float(a); o[1] = __high2float(a); o[2] = __low2float(b); o[3] = __high2float(b);
}
template <> __device__ __forceinline__ void load4<__half>(const __half* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __half2 a = *reinterpret_cast<const __half2*>(&v.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&v.y);
  o[0] = __low2float(a); o[1] = __high2float(a); o[2] = __low2float(b); o[3] = __high2float(b);
}

template <> __device__ __forceinline__ void load4<int8_t>(const int8_t* p, float* o) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

// The element type a tensor-core tile of E-typed data is staged in: f16
// stays f16, bf16 stays bf16, and f32 is rounded to bf16 (mma.sync has no
// f32 operands; tf32 would need other fragment layouts).
template <typename E> struct MmaOf { using type = bf16; };
template <> struct MmaOf<__half> { using type = __half; };

// Two floats as one u32 of packed MT (bf16 or f16), lo in the low half.
template <typename MT> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A·B on one m16n8k16 tile, f16 inputs, f32 accumulators (the
// fragment layout of mma_bf16_16816 below).
__device__ __forceinline__ void mma_f16_16816(float* c, const uint32_t* a,
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// The same over f16 or bf16 elements.
template <typename MT> __device__ __forceinline__ uint32_t pack_bits(MT lo, MT hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

// mma over MT operands: bf16 or f16.
template <typename MT> __device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                                                uint32_t b0, uint32_t b1);
template <> __device__ __forceinline__ void mma_16816<bf16>(float* c, const uint32_t* a,
                                                           uint32_t b0, uint32_t b1) {
  mma_bf16_16816(c, a, b0, b1);
}
template <> __device__ __forceinline__ void mma_16816<__half>(float* c, const uint32_t* a,
                                                             uint32_t b0, uint32_t b1) {
  mma_f16_16816(c, a, b0, b1);
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
