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
