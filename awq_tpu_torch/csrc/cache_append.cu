// K7: the batched KV-cache append for Hopper (sm_90a).
//
// Replaces the Pallas kernel of awq_tpu/ops/cache_append.py:
// batched_cache_append (_append_kernel). One launch copies the new k/v of
// every layer and row, kv [L, 2, B, n_kv, HD], into the cache
// [L, 2, B, n_kv, T, HD] at each row's own position lengths[b], in place:
//   cache[l, s, b, h, lengths[b], :] = kv[l, s, b, h, :]
// lengths is read on the device (no host sync) and clamped to [0, T-1], as
// the JAX wrapper clamps, so a length at or past T can spoil only the last
// position and never writes outside the cache.
//
// What bounds it on the H100: device memory, and at these sizes the launch:
// L·2·B·n_kv rows of HD elements are read once and written once (1 MiB each
// way at L 32, B 8, n_kv 8, HD 128 in bf16). It is a pure scatter with no
// reduction. The TPU kernel read, patched and wrote back an 8-row window
// per position, because a single-position write breaks Mosaic's (8, 128)
// tile; here a thread moves 16 bytes of a row straight to its place, and
// the rows of one (l, s, b, h) are contiguous on both sides.
//
// Paged mode (the stacked paged step's append; JAX scatters it with a
// per-row dynamic_update_slice loop in XLA): the same copy into the page
// pool [L, 2, NP, n_kv, page, HD], row b's position p at page
// tables[b, p / page], offset p % page, with p clamped to [0, MP·page − 1].
// Freed slots' table rows are 0, the trash page, so their writes land
// there.
//
// int8 mode (the int8 KV cache, KVCache8; JAX quantizes with quantize_kv
// and writes with a per-row dynamic_update_slice loop in XLA,
// models/llama.py:1313-1325): codes [L, 2, B, n_kv, T, HD] int8 and scales
// [L, 2, B, n_kv, T] f32, HD 128 or 64. HD / 4 lanes per (l, s, b, h) row
// (a warp at 128, a half-warp at 64, two rows a warp): lane j of the row
// holds elements 4j..4j+3, a max over the row's lanes gives its absmax, and
// the lane writes its 4 codes as one 32-bit word (HD bytes per row,
// coalesced) and the row's first lane the scale. The arithmetic is quantize_kv's under jit to the bit: s =
// max(absmax, 1e-6f) * f32(1/127) (XLA turns the source's division by the
// constant 127 into this product) and q = clip(rint(x / s), -127, 127), a
// true division and round-half-even (the build has no fast-math flag).
// Bound by device memory
// as the copy: the bf16 rows in, 132 bytes per row out.
#include "common.cuh"

namespace {

// One thread per 16 bytes; `vecs` 16-byte vectors per row of HD elements.
__global__ void __launch_bounds__(256) cache_append_kernel(
    uint4* __restrict__ cache, const uint4* __restrict__ kv,
    const int* __restrict__ lengths, int B, int nkv, int T, int vecs, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long row = i / vecs;          // (l, s, b, h) flattened
  const int v = static_cast<int>(i % vecs);
  const int b = static_cast<int>((row / nkv) % B);
  const int pos = min(max(lengths[b], 0), T - 1);
  cache[(row * T + pos) * vecs + v] = kv[i];
}

__global__ void __launch_bounds__(256) cache_append_paged_kernel(
    uint4* __restrict__ pool, const uint4* __restrict__ kv,
    const int* __restrict__ lengths, const int* __restrict__ tables, int B, int nkv,
    int np, int page, int mp, int vecs, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long row = i / vecs;          // (l, s, b, h) flattened
  const int v = static_cast<int>(i % vecs);
  const int h = static_cast<int>(row % nkv);
  const int b = static_cast<int>((row / nkv) % B);
  const long long ls = row / ((long long)nkv * B);   // l * 2 + s
  const int pos = min(max(lengths[b], 0), mp * page - 1);
  const int pid = tables[(size_t)b * mp + pos / page];
  pool[((((ls * np + pid) * nkv + h) * page) + pos % page) * vecs + v] = kv[i];
}

template <typename T>
__device__ __forceinline__ void load4f(const T* p, float* o);
template <> __device__ __forceinline__ void load4f<float>(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
template <> __device__ __forceinline__ void load4f<bf16>(const bf16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// HD / 4 lanes per (l, s, b, h) row of HD elements; 256 / (HD / 4) rows per
// block. A row's lanes are consecutive and aligned, so the max over them
// stays inside the row (the two rows of a warp at HD 64 both take part in
// every shuffle: no lane leaves early).
template <typename T, int HD>
__global__ void __launch_bounds__(256) cache_append_int8_kernel(
    int8_t* __restrict__ codes, float* __restrict__ scales, const T* __restrict__ kv,
    const int* __restrict__ lengths, int B, int nkv, int T_, int rows) {
  constexpr int LPR = HD / 4;                             // lanes a row
  const int row = blockIdx.x * (256 / LPR) + threadIdx.x / LPR;   // (l, s, b, h) flattened
  const int lane = threadIdx.x % LPR;
  const bool live = row < rows;
  if constexpr (LPR == 32) {
    if (!live) return;
  } else {
    // a warp's rows end together only where `rows` is even; the other lanes
    // still join the shuffles below
    if (__all_sync(0xffffffffu, !live)) return;
  }
  const int b = live ? (row / nkv) % B : 0;
  const int pos = min(max(lengths[b], 0), T_ - 1);
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) load4f<T>(kv + (size_t)row * HD + lane * 4, x);
  float a = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
  if constexpr (LPR == 32) {
    a = warp_max(a);
  } else {
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (!live) return;
  }
  const float s = __fmul_rn(fmaxf(a, 1e-6f), 1.f / 127.f);
  uint32_t word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float q = fminf(fmaxf(rintf(x[e] / s), -127.f), 127.f);
    word |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu) << (8 * e);
  }
  const size_t at = (size_t)row * T_ + pos;
  *reinterpret_cast<uint32_t*>(codes + at * HD + lane * 4) = word;
  if (lane == 0) scales[at] = s;
}

}  // namespace

// Caller guarantees (ops/cache_append.py checks them): contiguous cache
// [L, 2, B, nkv, T, HD] and kv [L, 2, B, nkv, HD] of one dtype on one
// device, both 16-byte aligned, HD·itemsize a multiple of 16; lengths [B]
// int32 on that device. `rows` is L·2·B·nkv and `row_bytes` HD·itemsize.
extern "C" int awq_cache_append(void* cache, const void* kv, const void* lengths,
                                int rows, int B, int nkv, int T, int row_bytes,
                                void* stream) {
  if (rows <= 0) return 0;
  if (row_bytes % 16 || B < 1 || nkv < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vecs = row_bytes / 16;
  const long long total = (long long)rows * vecs;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  cache_append_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache), static_cast<const uint4*>(kv),
      static_cast<const int*>(lengths), B, nkv, T, vecs, total);
  return static_cast<int>(cudaGetLastError());
}

// Paged mode: pool [L, 2, np, nkv, page, HD] and kv [L, 2, B, nkv, HD] of one
// dtype on one device, 16-byte aligned; lengths [B] and tables [B, mp] int32
// on that device, page ids in [0, np). `rows` is L·2·B·nkv.
extern "C" int awq_cache_append_paged(void* pool, const void* kv, const void* lengths,
                                      const void* tables, int rows, int B, int nkv,
                                      int np, int page, int mp, int row_bytes,
                                      void* stream) {
  if (rows <= 0) return 0;
  if (row_bytes % 16 || B < 1 || nkv < 1 || np < 1 || page < 1 || mp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vecs = row_bytes / 16;
  const long long total = (long long)rows * vecs;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  cache_append_paged_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(pool), static_cast<const uint4*>(kv),
      static_cast<const int*>(lengths), static_cast<const int*>(tables), B, nkv, np, page,
      mp, vecs, total);
  return static_cast<int>(cudaGetLastError());
}

namespace {
template <int HD>
int launch_int8(void* codes, void* scales, const void* kv, const void* lengths, int rows,
                int B, int nkv, int T, int kv_f32, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(cdiv(rows, 256 / (HD / 4)));
  if (kv_f32)
    cache_append_int8_kernel<float, HD><<<blocks, 256, 0, st>>>(
        static_cast<int8_t*>(codes), static_cast<float*>(scales),
        static_cast<const float*>(kv), static_cast<const int*>(lengths), B, nkv, T, rows);
  else
    cache_append_int8_kernel<bf16, HD><<<blocks, 256, 0, st>>>(
        static_cast<int8_t*>(codes), static_cast<float*>(scales),
        static_cast<const bf16*>(kv), static_cast<const int*>(lengths), B, nkv, T, rows);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// int8 mode: codes int8 [L, 2, B, nkv, T, hd] and scales f32 [L, 2, B, nkv, T],
// kv [L, 2, B, nkv, hd] bf16 (kv_f32 = 0) or f32 (1), lengths [B] int32, all
// contiguous on one device; hd 128 or 64. `rows` is L·2·B·nkv.
extern "C" int awq_cache_append_int8(void* codes, void* scales, const void* kv,
                                     const void* lengths, int rows, int B, int nkv, int T,
                                     int kv_f32, int hd, void* stream) {
  if (rows <= 0) return 0;
  if (B < 1 || nkv < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_int8<128>(codes, scales, kv, lengths, rows, B, nkv, T, kv_f32, st);
  if (hd == 64) return launch_int8<64>(codes, scales, kv, lengths, rows, B, nkv, T, kv_f32, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
