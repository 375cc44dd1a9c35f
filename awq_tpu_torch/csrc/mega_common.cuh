// Helpers shared by the megakernels K4 (megakernel.cu), K5
// (megakernel_chunk.cu) and K6 (megakernel_batched.cu): typed loads and
// stores of activations and cache rows, bf16 rounding, the block-wide sum,
// and the launch plan of a cooperative persistent grid.
#pragma once

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int MK_THREADS = 256;   // 8 warps per block
constexpr int MK_WARPS = 8;
constexpr int MK_HD = 128;        // head_dim
constexpr int MK_G = 128;         // quantization group
constexpr int MK_MAXG = 8;        // most q heads per kv head

// bf16 pair (lo = nibble t, hi = nibble t+4 of the pack_int4 word w)
// holding the exact codes: (w >> 4t) & 0x000F000F | 0x43004300 is 128 + q
// in bf16, and one bf16 subtract takes the 128 off.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w, int t) {
  uint32_t v = ((w >> (4 * t)) & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             __float2bfloat162_rn(128.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

// 16-byte global -> shared copy that does not pass through registers;
// `bytes` < 16 zero-fills the rest. A thread's copies are complete after
// cp_async_wait<N>() leaves at most N of its commit groups pending, and
// visible to the other lanes of its warp after a __syncwarp().
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes = 16) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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

// Cache element conversions (the cache is f32, bf16 or f16).
template <typename CT> __device__ __forceinline__ float to_f32(CT v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename CT> __device__ __forceinline__ CT from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// Four consecutive cache elements as f32 (p 4-element aligned).
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

// JAX's quantize_kv (models/llama.py:391) of the current token's k and v
// rows, 128 f32 values each in shared memory, after rounding them to bf16,
// the dtype JAX's megakernels return k/v in for an int8 cache:
// s = max(absmax, 1e-6f) / 127 and q = clip(rint(x / s), -127, 127), a true
// division and round-half-even (the build has no fast-math flag), bit-equal
// to quantize_kv. Called by all MK_THREADS (256) threads of the block, at a
// point every thread reaches: thread t takes element t & 127 of row t >> 7
// (k, then v). Writes the 128 codes at kq and vq, the scales at *ks and *vs
// and, where kout and vout are not null, the bf16 values there. `red` holds
// MK_WARPS floats of shared memory.
__device__ __forceinline__ void quantize_kv_rows(const float* kc, const float* vc,
                                                 int8_t* kq, int8_t* vq, float* ks,
                                                 float* vs, bf16* kout, bf16* vout,
                                                 float* red) {
  const int t = threadIdx.x, d = t & (MK_HD - 1), which = t >> 7;
  const float x = bf16r(which ? vc[d] : kc[d]);
  const float a = warp_max(fabsf(x));
  __syncthreads();                       // red is free
  if ((t & 31) == 0) red[t >> 5] = a;
  __syncthreads();
  const float* r = red + which * (MK_HD / 32);
  const float s = fmaxf(fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3])), 1e-6f) / 127.f;
  (which ? vq : kq)[d] = static_cast<int8_t>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
  if (d == 0) *(which ? vs : ks) = s;
  bf16* o = which ? vout : kout;
  if (o) o[d] = __float2bfloat16_rn(x);
  __syncthreads();                       // red may be reused
}

// HF rotate-half rope of element d of a 128-wide row x (f32).
__device__ __forceinline__ float rope_at(const float* x, const float* cosr,
                                        const float* sinr, int d) {
  const float rot = d < MK_HD / 2 ? -x[d + MK_HD / 2] : x[d - MK_HD / 2];
  return x[d] * cosr[d] + rot * sinr[d];
}

// Sum over the block's 256 threads; every thread gets the total. `red`
// holds MK_WARPS floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < MK_WARPS; ++w) t += red[w];
  return t;
}

// Merge the attention slices of one query row, by one warp: slice sp's
// running max and sum are pml[2·row], pml[2·row + 1] and its unnormalised
// output pacc[128·row ..] for row = row0 + sp·stride. A slice that saw no
// position has max -inf and adds exp(-inf) = 0. Lane l gets channels
// 4l .. 4l+3 in ac.
__device__ __forceinline__ void combine_row(const float* pml, const float* pacc, size_t row0,
                                            int stride, int nsplit, float* ac) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int sp = lane; sp < nsplit; sp += 32) mx = fmaxf(mx, pml[(row0 + (size_t)sp * stride) * 2]);
  mx = warp_max(mx);
  float ls = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) ac[e] = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < nsplit; ++sp) {
    const size_t row = row0 + (size_t)sp * stride;
    const float f = expf(pml[row * 2] - mx);
    const float4 v = *reinterpret_cast<const float4*>(pacc + row * MK_HD + lane * 4);
    ls += pml[row * 2 + 1] * f;
    ac[0] += v.x * f; ac[1] += v.y * f; ac[2] += v.z * f; ac[3] += v.w * f;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) ac[e] /= ls;
}

// Size of a cooperative persistent grid: the blocks that fit on the card
// at once with `smem` bytes of dynamic shared memory each, at most
// `max_per_sm` per SM. The attribute has to be set before the occupancy
// query, since it changes the answer.
template <typename K>
static int coop_grid(K kernel, size_t smem, int* grid, int max_per_sm = 1 << 30) {
  int dev = 0, sms = 0, occ = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) return static_cast<int>(cudaErrorNotSupported);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, MK_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = (occ < max_per_sm ? occ : max_per_sm) * sms;
  return 0;
}
