// Helpers shared by the megakernels K4 (megakernel.cu) and K6 with K5, its
// chunk mode (megakernel_batched.cu): the unit's weight format, the code
// pairs of both formats, typed loads of cache rows, the block-wide sum, and
// the launch plan of a cooperative persistent grid.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int MK_THREADS = 256;   // 8 warps per block
constexpr int MK_WARPS = 8;
constexpr int MK_HD = 128;        // head_dim
constexpr int MK_G = 128;         // quantization group
constexpr int MK_MAXG = 8;        // most q heads per kv head

// The weight format of the unit: each megakernel source is built once per
// format (_build.UNITS passes -DAWQ_MEGA_W3=0 for pack_int4, 1 for
// pack_int3), so the matmul tiles pick their loads and code pairs at
// compile time. A grid-uniform runtime flag in one build cost K4's W4 token
// step 4% on the H100 80GB HBM3 at 700 W (210 registers against 192).
#ifndef AWQ_MEGA_W3
#error "build with -DAWQ_MEGA_W3=0 (pack_int4) or 1 (pack_int3): see _build.UNITS"
#endif
constexpr bool UNIT_W3 = AWQ_MEGA_W3;

// bf16 pair (lo = nibble t, hi = nibble t+4 of the pack_int4 word w)
// holding the exact codes: (w >> 4t) & 0x000F000F | 0x43004300 is 128 + q
// in bf16, and one bf16 subtract takes the 128 off.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w, int t) {
  uint32_t v = ((w >> (4 * t)) & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             __float2bfloat162_rn(128.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

// The W3 (pack_int3) mode of the same pairs. A lane of the matmul tiles
// holds, for its word row r (a 128-group g = 2c' + h of 256-chunk c'), the
// lo word 24c' + 8h + r (fields f = 0..15: channel 128g + 8f + r) and the
// hi word 24c' + 16 + r (bit 16h + f). The W4 pair (t, t+4) of k16 half
// cc is channels 128g + 64cc + 8t + r and + 32: lo fields 8cc + t and
// 8cc + t + 4, 8 bits apart. w3_spread moves them 16 bits apart, so that
// one shift and mask per t yields the pair as codes_bf16x2 does: the lo
// word's bytes 2cc and 2cc+1 go to bytes 0 and 2 (one PRMT), and the hi
// word's byte 2h + cc goes to both, its nibbles then shifted to bits 2..5
// and 18..21, the value 4 of the code.
__device__ __forceinline__ void w3_spread(uint32_t lo, uint32_t hi, int h, int cc,
                                          uint32_t& ls, uint32_t& hs) {
  ls = __byte_perm(lo, 0u, cc ? 0x4342u : 0x4140u);
  const uint32_t k = 2 * h + cc;
  const uint32_t b = __byte_perm(hi, 0u, 0x4040u | k | (k << 8));
  hs = ((b << 2) & 0x3Cu) | ((b >> 2) & 0x3C0000u);
}

__device__ __forceinline__ uint32_t codes3_bf16x2(uint32_t ls, uint32_t hs, int t) {
  uint32_t v = ((ls >> (2 * t)) & 0x00030003u) | ((hs >> t) & 0x00040004u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             __float2bfloat162_rn(128.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

// The wrappers' code of a cache element type: 0 f32, 1 bf16, 2 f16, 3 int8.
template <typename CT> constexpr int cache_code() {
  return sizeof(CT) == 1 ? 3 : sizeof(CT) == 4 ? 0 : std::is_same<CT, bf16>::value ? 1 : 2;
}

// Code-word rows of a [IC, OC] weight in either format: pack_int4's IC/8
// or pack_int3's IC·3/32.
__device__ __forceinline__ size_t qrows(int ic, int w3) {
  return w3 ? (size_t)ic * 3 / 32 : (size_t)ic / 8;
}

// One lane's code words of 128-group g for a 32-column matmul tile: four
// 16-byte loads, columns 4gq .. 4gq+3 of the tile; base = qw + 2tq·OC +
// n0 + 4gq. W4 (pack_int4): word rows 8c + 2tq and 8c + 2tq + 1 of chunks
// c = 2g, 2g + 1, in that order. W3 (pack_int3, 256-chunk c' = g / 2,
// h = g % 2): lo rows 24c' + 8h + 2tq, + 1, then hi rows 24c' + 16 + 2tq,
// + 1. A hi word holds both groups of its chunk; the two warps that take
// groups 2c' and 2c' + 1 of one block read it at about the same time, so
// the second read is served on chip and the device memory sees each code
// byte once (0.375 B per weight against W4's 0.5).
template <bool W3>
__device__ __forceinline__ void load_group(uint4* w, const int32_t* base, int g, int OC) {
  if constexpr (W3) {
    const size_t lo = (size_t)(24 * (g >> 1) + 8 * (g & 1)), hi = (size_t)(24 * (g >> 1) + 16);
    w[0] = __ldg(reinterpret_cast<const uint4*>(base + lo * OC));
    w[1] = __ldg(reinterpret_cast<const uint4*>(base + (lo + 1) * OC));
    w[2] = __ldg(reinterpret_cast<const uint4*>(base + hi * OC));
    w[3] = __ldg(reinterpret_cast<const uint4*>(base + (hi + 1) * OC));
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = __ldg(reinterpret_cast<const uint4*>(base + (size_t)(16 * g + 8 * (r >> 1) + (r & 1)) * OC));
  }
}

// The words that k16 half cc of group g's B fragments come from, column
// j = 0..3: p0/q0 for word row 2tq, p1/q1 for 2tq + 1. W4: the chunk's
// words as loaded (q unused); W3: w3_spread of the lo and hi words.
template <bool W3>
__device__ __forceinline__ void group_words(const uint4* w, int g, int cc, uint32_t* p0,
                                            uint32_t* p1, uint32_t* q0, uint32_t* q1) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(&w[W3 ? 0 : 2 * cc]);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(&w[W3 ? 1 : 2 * cc + 1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (W3) {
      w3_spread(a[j], reinterpret_cast<const uint32_t*>(&w[2])[j], g & 1, cc, p0[j], q0[j]);
      w3_spread(b[j], reinterpret_cast<const uint32_t*>(&w[3])[j], g & 1, cc, p1[j], q1[j]);
    } else {
      p0[j] = a[j];
      p1[j] = b[j];
    }
  }
}

// The bf16 code pair of k16 step t from group_words' p and q.
template <bool W3>
__device__ __forceinline__ uint32_t code_pair(uint32_t p, uint32_t q, int t) {
  if constexpr (W3) return codes3_bf16x2(p, q, t);
  else return codes_bf16x2(p, t);
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

// JAX's quantize_kv (models/llama.py:391) of the current token's k and v
// rows, 128 f32 values each in shared memory, after rounding them to bf16,
// the dtype JAX's megakernels return k/v in for an int8 cache:
// s = max(absmax, 1e-6f) * f32(1/127), as XLA computes the source's
// division by the constant 127 under jit, and q = clip(rint(x / s), -127,
// 127), a true division and round-half-even (the build has no fast-math
// flag), bit-equal to quantize_kv. Called by all MK_THREADS (256) threads
// of the block, at a point every thread reaches: thread t takes element
// t & 127 of row t >> 7 (k, then v). Writes the 128 codes at kq and vq, the
// scales at *ks and *vs and, where kout and vout are not null, the bf16
// values there. `red` holds MK_WARPS floats of shared memory.
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
  const float s = __fmul_rn(fmaxf(fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3])), 1e-6f), 1.f / 127.f);
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
// query, since it changes the answer. The answer is kept per (device,
// kernel, bytes): a launch after the first makes no runtime call but the
// launch itself, so that it can be captured into a CUDA graph.
template <typename K>
static int coop_grid(K kernel, size_t smem, int* grid, int max_per_sm = 1 << 30) {
  struct Seen { int dev; const void* fn; size_t smem; int max_per_sm, grid; };
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0, sms = 0, occ = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].dev == dev && seen[i].fn == (const void*)kernel && seen[i].smem == smem
        && seen[i].max_per_sm == max_per_sm) {
      *grid = seen[i].grid;
      return 0;
    }
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
  if (n_seen < 64) seen[n_seen++] = Seen{dev, (const void*)kernel, smem, max_per_sm, *grid};
  return 0;
}
