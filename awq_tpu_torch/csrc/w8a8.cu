// The int8-activation prefill matmuls for Hopper (sm_90a): per-token int8
// quantization of x, K11 (int8 x against the cached int8 weights) and K10
// (int8 x against W4 codes requantized to int8 inside the kernel).
//
// Replaces, from awq_tpu/ops/w4a16.py:
// - K11: w8a8_matmul_stacked_tiled (_w8a8_kernel_stacked, Pallas row 8),
//       y = ((f32(xq @ w8^T)) * scol) * sx over the prefill weight cache
//       W8Stack (w8 int8 [OC, IC] per layer, scol f32 [OC]);
// - K10: w4a8_matmul_stacked_tiled_folded (_w4a8_kernel_folded, row 7),
//       the same with w8 requantized from the pack_int4 codes per column:
//         s, sz = bf16(scales), bf16(szeros)      (f32 [IC/G, OC])
//         scol  = max(max(0, max_g s) * f32(15/127), 1e-12)
//         w8    = clip(rint(((128 + q) - (128 + sz/s)) * (s * (1/scol))), -127, 127)
//       every operation one f32 operation in this order (the "128 +" on
//       both sides is the TPU kernel's bf16-bitpack arithmetic: it drops
//       z's low bits, and build_w8_stack mirrors it), so that K10, K11 over
//       a cache built by build_w8_stack, and the plain versions agree bit
//       for bit;
// - quant_per_token: awq_tpu/ops/w8a8.py::quant_per_token (XLA in JAX):
//       sx = max(absmax(f32 x), 1e-5) * f32(1/127) (XLA's jit turns the
//       JAX source's division by the constant 127 into this product),
//       xq = clip(rint(x / sx), -128, 127) with a true division (__fdiv_rn),
//       one block per row, one pass over its x (below).
//
// What bounds them on the H100: at prefill lengths the product is bound by
// tensor-core operations (2·M·IC·OC int8 operations against IC·OC weight
// bytes for K11, IC·OC/2 for K10), at short prompts by the weight bytes;
// int8 runs at twice the bf16 rate. The int32 sums are exact, so the only
// rounding is the epilogue's, in the fixed order above.
//
// K11 (w8a8_wgmma_kernel): x codes [M, IC] and the cached w8 [OC, IC] are
// both K-major, as wgmma's s8 form requires of both operands, so TMA
// tiles (128 channels, 128-byte swizzle) feed it with no transform: one
// producer warp keeps a ring of stages in flight, two consumer warpgroups
// issue wgmma.mma_async s8·s8 -> s32 and release each stage once the
// products that read it are done. M <= 64 swaps the operands (the weights
// the 64-row operand, the tokens N = 16, 32 or 64); longer prompts take
// 128-token by 128-column tiles. Where the tiles are fewer than the SMs,
// the host plan splits IC (ops/w4a16.py::gemm_plan); the splits write
// int32 partials and w8a8_splitk_epilogue sums them (exact in any order)
// and applies the epilogue.
//
// K10 (w4a8_wgmma_kernel) is K11's product fed by a requantizing stage:
// - warp specialization over three rings: one producer warp streams each
//   128-channel stage's x tile (TMA, 128-byte swizzle, as K11) and a
//   second its 16 code rows (TMA, or 4-byte cp.async where OC·4 is no
//   multiple of 16, as K1); two requant warpgroups (a thread per output
//   column) take alternate stages, hold a stage's codes in registers and
//   free their slot at once (so the codes run ahead of the products),
//   then turn them into int8 straight into the swizzled K-major B tile
//   that wgmma's s8 form reads, fence.proxy.async and arrive on an
//   mbarrier; two consumer warpgroups of 64 tokens issue wgmma.mma_async
//   s8·s8 -> s32 (SS form) and free each stage's x and B tiles. The
//   requant overlaps the tensor cores instead of preceding them.
// - the requant's arithmetic is JAX's per-element chain above, evaluated
//   once per (column, group, code value): the sixteen int8 results of a
//   column's group form a lookup table in four registers, and each word of
//   eight codes becomes eight int8 values with six PRMT byte selects and
//   two LOP3 (the table's halves and a byte mask of the codes' top bits).
//   The same f32 operations on the same operands give the same int8 codes,
//   so the output stays bit-equal, while the f32 work and the slow f32 ->
//   int conversions shrink G / 16 times (8x at group 128). A stage's
//   scales are read from global memory a stage ahead (two register sets
//   in turn) and its tables built before its codes arrive.
// - the lookup writes a word's eight codes (channels 8s + r of its 64-block,
//   s = 0..7) to eight adjacent bytes: within each 64-channel block, B's K
//   order is 8r + s instead of 8s + r. The x codes carry the same
//   permutation (quant_per_token_kernel's `perm`, written by the
//   quantization launch), so the int32 sums, exact in any order, are those
//   of the natural order.
// - 128-token by 128-column tiles, one block per SM (576 threads; 5 x and
//   B tiles and 7 code tiles in flight); split-K where the tiles are fewer than the
//   SMs (ops/w4a16.py::gemm_plan's "w4a8" kind), int32 partials summed by
//   w8a8_splitk_epilogue with scol written by the first M tile's blocks.
// scol is computed once per block, the column maxima over the IC/G scale
// rows split across the consumer and requant threads before the first
// stage, and handed to the consumers' epilogue by an mbarrier. What holds
// it (clock64 in an instrumented copy, PERF.md §6): one requant warpgroup
// spent ~2,000 cycles a stage in dependent shared-memory and global round
// trips whatever its share of the words, hence two warpgroups on
// alternate stages and the tables built ahead.
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

// 128 + v for a code v in [0, 15], exact: the code in the mantissa of 2^7.
__device__ __forceinline__ float code128_f32(uint32_t v) {
  return __uint_as_float(0x43000000u | (v << 16));
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// ---- quant_per_token: one pass -------------------------------------------
//
// Bound by device memory: a row's x read once and its codes written once
// (M * IC * (sizeof(x) + 1) bytes). One block a row, a thread a 16-channel
// chunk (two chunks, `NCH`, past 16384 channels): its x is loaded as
// 16-byte vectors into registers, every load issued before any is used (one
// memory latency a row, not a loop of them), the absmax taken on the raw
// bits (a magnitude's bits order as its value: the sign masked off, an
// integer max, two 16-bit halves at once for bf16 and f16), reduced by
// shuffles and one shared-memory round, and the codes computed from the
// registers by the true division (__fdiv_rn: JAX's `x / sx` under jit
// divides by a tensor) and stored as a 16-byte word. A chunk of 16 keeps a
// thread's chain of divisions short (each is a branch of its own, so they
// run one after another; 64 a thread made short prompts slower than the
// two-pass kernel). With `perm` (K10's channel order: 64c + 8s + r written
// to 64c + 8r + s) a 64-channel block is the chunks of four adjacent lanes,
// rows s = 2j, 2j + 1 of the 8 x 8 byte matrix on lane j: each lane packs
// the 2 x 2 bytes every lane of its quad needs by byte permutes, three xor
// shuffles trade them, and byte permutes assemble the lane's 16 output
// bytes (rows r = 2j, 2j + 1), again one 16-byte store. A row whose IC is
// no multiple of 16 (x rows not 16-byte aligned) takes the same chunking
// with element loads and byte stores (VEC false). A row wider than the
// registers of one block hold (QPT_ONE_PASS_IC channels: two chunks of
// each of 1024 threads; 64 registers a thread at that size) is taken in
// passes of that many channels (LOOP): the absmax over every pass, then
// each pass loaded again and quantized, so such a row is read twice.
constexpr int QPT_CHUNK = 16;          // channels a chunk
constexpr int QPT_THREADS = 1024;
constexpr int QPT_ONE_PASS_IC = 2 * QPT_THREADS * QPT_CHUNK;   // two chunks a thread

// The bits of the largest magnitude among a 16-byte vector's elements: f32
// (mag_bits), or bf16 / f16 in each halfword (mag_bits2: __vmaxu2 is a
// per-halfword unsigned max); bits_f32 turns them into the float they
// stand for.
__device__ __forceinline__ uint32_t mag_bits(uint4 v) {
  return max(max(v.x & 0x7fffffffu, v.y & 0x7fffffffu), max(v.z & 0x7fffffffu, v.w & 0x7fffffffu));
}
__device__ __forceinline__ uint32_t mag_bits2(uint4 v) {
  return __vmaxu2(__vmaxu2(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu),
                  __vmaxu2(v.z & 0x7fff7fffu, v.w & 0x7fff7fffu));
}
template <typename T> __device__ __forceinline__ float bits_f32(uint32_t m);
template <> __device__ __forceinline__ float bits_f32<float>(uint32_t m) {
  return __uint_as_float(m);
}
template <> __device__ __forceinline__ float bits_f32<bf16>(uint32_t m) {
  return __uint_as_float(max(m & 0xffffu, m >> 16) << 16);
}
template <> __device__ __forceinline__ float bits_f32<__half>(uint32_t m) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(max(m & 0xffffu, m >> 16))));
}

// Element e of a 16-byte vector of T as f32.
template <typename T> __device__ __forceinline__ float elem_f32(const uint4& v, int e) {
  const uint32_t w = (&v.x)[e * (int)sizeof(T) / 4];
  if constexpr (sizeof(T) == 4) return __uint_as_float(w);
  else if constexpr (std::is_same<T, bf16>::value)
    return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
  else return __half2float(__ushort_as_half(static_cast<unsigned short>(e & 1 ? w >> 16 : w)));
}

__device__ __forceinline__ uint32_t code_byte(float x, float scale) {
  return static_cast<uint32_t>(clamp_int(__float2int_rn(__fdiv_rn(x, scale)), -128, 127)) & 0xffu;
}

// r[i] for a lane-dependent i in [0, 4), by selects (no local memory).
__device__ __forceinline__ uint32_t pick4(const uint32_t* r, int i) {
  return i & 2 ? (i & 1 ? r[3] : r[2]) : (i & 1 ? r[1] : r[0]);
}

// K10's order within a 64-channel block held by a quad of lanes: lane
// j = lane % 4 holds the codes of channels 16 j .. 16 j + 15, i.e. rows
// s = 2 j, 2 j + 1 of the 8 x 8 matrix (channel 8 s + r), as w[0] = row
// 2 j columns 0..3, w[1] = row 2 j columns 4..7, w[2], w[3] row 2 j + 1.
// Returns the lane's 16 output bytes 16 j .. 16 j + 15: output rows r =
// 2 j, 2 j + 1, each the bytes of rows s = 0..7 at column r. Every lane of
// the warp must call it (xor shuffles over the whole warp).
__device__ __forceinline__ uint4 perm_quad(const uint32_t* w) {
  const int j = threadIdx.x & 3;
  uint32_t recv[4];   // recv[d]: rows 2 (j ^ d), 2 (j ^ d) + 1 at columns 2 j, 2 j + 1
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int t = j ^ d;                 // the lane this packet is for: its columns 2t, 2t+1
    const uint32_t c = 2 * (t & 1);      // their byte within a word of four columns
    const uint32_t a = t & 2 ? w[1] : w[0], b = t & 2 ? w[3] : w[2];
    const uint32_t pk = __byte_perm(a, b, c | (c + 1) << 4 | (c + 4) << 8 | (c + 5) << 12);
    recv[d] = d ? __shfl_xor_sync(0xffffffffu, pk, d) : pk;
  }
  // from lane i: [row 2i col 2j, row 2i col 2j+1, row 2i+1 col 2j, row 2i+1 col 2j+1]
  const uint32_t p0 = pick4(recv, j), p1 = pick4(recv, j ^ 1), p2 = pick4(recv, j ^ 2),
                 p3 = pick4(recv, j ^ 3);
  return make_uint4(__byte_perm(p0, p1, 0x6420), __byte_perm(p2, p3, 0x6420),
                    __byte_perm(p0, p1, 0x7531), __byte_perm(p2, p3, 0x7531));
}

// A thread's chunks of one pass: chunk i covers channels c0[i] .. c0[i] +
// 15 of the row, c0[i] = base + 16 (t + i * blockDim.x), so the lanes of a
// quad hold one 64-channel block (blockDim.x % 4 == 0), zeros past the row.
// VEC: 16-byte vectors v; else f32 elements xs.
template <typename T, bool VEC, int NCH>
struct QptChunks {
  static constexpr int EV = 16 / (int)sizeof(T);     // elements a 16-byte vector
  static constexpr int NV = QPT_CHUNK / EV;          // vectors a chunk: 4 f32, 2 bf16 / f16
  int c0[NCH];
  uint4 v[NCH][NV];
  float xs[VEC ? 1 : NCH][VEC ? 1 : QPT_CHUNK];

  // Loads the pass at channel `base`, every load issued before any is
  // used; returns the largest magnitude among them.
  __device__ __forceinline__ float load(const T* row, int base, int IC) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) c0[i] = base + (threadIdx.x + i * (int)blockDim.x) * QPT_CHUNK;
    if constexpr (VEC) {   // IC % 16 == 0: whole vectors, whole 16-byte words
#pragma unroll
      for (int i = 0; i < NCH; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j)
          v[i][j] = c0[i] < IC ? __ldg(reinterpret_cast<const uint4*>(row + c0[i]) + j)
                               : make_uint4(0u, 0u, 0u, 0u);
      uint32_t mb = 0;
#pragma unroll
      for (int i = 0; i < NCH; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if constexpr (sizeof(T) == 4) mb = max(mb, mag_bits(v[i][j]));
          else mb = __vmaxu2(mb, mag_bits2(v[i][j]));
        }
      return bits_f32<T>(mb);
    } else {
#pragma unroll
      for (int i = 0; i < NCH; ++i)
#pragma unroll
        for (int e = 0; e < QPT_CHUNK; ++e)
          xs[i][e] = c0[i] + e < IC ? to_f32<T>(row[c0[i] + e]) : 0.f;
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < NCH; ++i)
#pragma unroll
        for (int e = 0; e < QPT_CHUNK; ++e) amax = fmaxf(amax, fabsf(xs[i][e]));
      return amax;
    }
  }

  // The codes of the loaded pass, stored into the row's `out`.
  template <bool PERM>
  __device__ __forceinline__ void store(int8_t* out, int IC, float scale) const {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      if constexpr (VEC) {
        uint32_t w[QPT_CHUNK / 4];   // channels 4 k .. 4 k + 3, the first in the low byte
#pragma unroll
        for (int k = 0; k < QPT_CHUNK / 4; ++k) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * k + e;
            word |= code_byte(elem_f32<T>(v[i][c / EV], c % EV), scale) << (8 * e);
          }
          w[k] = word;
        }
        // past the row the lanes still take part in the quad's shuffles
        const uint4 o = PERM ? perm_quad(w) : make_uint4(w[0], w[1], w[2], w[3]);
        if (c0[i] < IC) *reinterpret_cast<uint4*>(out + c0[i]) = o;
      } else {
#pragma unroll
        for (int e = 0; e < QPT_CHUNK; ++e)
          if (c0[i] + e < IC) out[c0[i] + e] = static_cast<int8_t>(code_byte(xs[i][e], scale));
      }
    }
  }
};

// One block a row; LOOP: the row in passes of NCH * blockDim.x * 16
// channels, read twice (above).
template <typename T, bool VEC, bool PERM, int NCH, bool LOOP>
__global__ void __launch_bounds__(QPT_THREADS) quant_per_token_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int IC) {
  __shared__ float red[QPT_THREADS / 32];
  const int m = blockIdx.x, t = threadIdx.x;
  const T* row = x + (size_t)m * IC;
  int8_t* out = xq + (size_t)m * IC;
  const int span = NCH * (int)blockDim.x * QPT_CHUNK;   // channels a pass
  const int passes = LOOP ? (IC + span - 1) / span : 1;
  QptChunks<T, VEC, NCH> ch;
  float amax = 0.f;
  for (int p = 0; p < passes; ++p) amax = fmaxf(amax, ch.load(row, p * span, IC));
  amax = warp_max(amax);
  if ((t & 31) == 0) red[t >> 5] = amax;
  __syncthreads();
  amax = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) amax = fmaxf(amax, red[w]);
  const float scale = __fmul_rn(fmaxf(amax, 1e-5f), 1.f / 127.f);
  if (t == 0) sx[m] = scale;
  for (int p = 0; p < passes; ++p) {
    if constexpr (LOOP) ch.load(row, p * span, IC);
    ch.template store<PERM>(out, IC, scale);
  }
}

template <typename T, int NCH, bool LOOP>
int quant_launch_n(const void* x, void* xq, void* sx, int M, int IC, bool vec, int perm,
                   cudaStream_t st) {
  const int threads =
      LOOP ? QPT_THREADS : cdiv(cdiv(cdiv(IC, QPT_CHUNK), NCH), 32) * 32;
  const T* xp = static_cast<const T*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  if (perm)
    quant_per_token_kernel<T, true, true, NCH, LOOP><<<M, threads, 0, st>>>(xp, q, s, IC);
  else if (vec)
    quant_per_token_kernel<T, true, false, NCH, LOOP><<<M, threads, 0, st>>>(xp, q, s, IC);
  else
    quant_per_token_kernel<T, false, false, NCH, LOOP><<<M, threads, 0, st>>>(xp, q, s, IC);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int quant_launch(const void* x, void* xq, void* sx, int M, int IC, int perm,
                 cudaStream_t st) {
  const bool vec = IC % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % 16 == 0;
  if (perm && !vec) return static_cast<int>(cudaErrorInvalidValue);
  if (IC <= QPT_THREADS * QPT_CHUNK)
    return quant_launch_n<T, 1, false>(x, xq, sx, M, IC, vec, perm, st);
  if (IC <= QPT_ONE_PASS_IC) return quant_launch_n<T, 2, false>(x, xq, sx, M, IC, vec, perm, st);
  return quant_launch_n<T, 2, true>(x, xq, sx, M, IC, vec, perm, st);
}

// ---- K11: wgmma s8 fed by a TMA ring -----------------------------------

namespace k11 {
constexpr int BN = 128;        // output columns of a block
constexpr int KS = 128;        // channels (bytes) of one ring stage: one 128-byte swizzled row
constexpr int THREADS = 288;   // two consumer warpgroups and one producer warp
constexpr int MAX_STAGES = 8;
}  // namespace k11

// NT < 128: the int8 weights are wgmma's 64-row operand (warpgroup w takes
// columns n0 + 64w..) and the NT tokens its N; NT == 128: 128 tokens (64 a
// warpgroup) against N = 128 columns. Both operands K-major, as wgmma's s8
// form requires, straight from TMA. Split `blockIdx.z` sums stages
// [z*n/splits, (z+1)*n/splits) and writes int32 partials where `partial`
// is given; else the epilogue (f32(acc) * scol) * sx, rounded once to T.
template <typename T, int NT>
__global__ void __launch_bounds__(k11::THREADS, NT < 128 ? 2 : 1) w8a8_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ sx, const float* __restrict__ scol, T* __restrict__ out,
    int32_t* __restrict__ partial, int M, int IC, int OC, int stages, int splits) {
  constexpr bool SWAP = NT < 128;
  constexpr int N = SWAP ? NT : k11::BN;
  constexpr int NACC = N / 2;
  constexpr int XB = NT * 128, SB = XB + k11::BN * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hop::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * SB);
  uint64_t* empty = full + stages;

  const int m0 = blockIdx.x * NT, n0 = blockIdx.y * k11::BN, split = blockIdx.z;
  const int n_st = (IC + k11::KS - 1) / k11::KS;   // a last half stage reads zeros past IC
  const int s_begin = static_cast<int>(static_cast<long long>(split) * n_st / splits);
  const int nst = static_cast<int>(static_cast<long long>(split + 1) * n_st / splits) - s_begin;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], 256);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {   // the producer warp: one lane issues the TMA loads
    if ((threadIdx.x & 31) == 0) {
      for (int i = 0; i < nst; ++i) {
        const int st = i % stages, k0 = (s_begin + i) * k11::KS;
        hop::mbar_wait(&empty[st], ((i / stages) & 1) ^ 1);
        uint8_t* base = ring + st * SB;
        hop::mbar_expect_tx(&full[st], SB);
        hop::tma_load_2d(base, &xmap, &full[st], k0, m0);
        hop::tma_load_2d(base + XB, &wmap, &full[st], k0, n0);
      }
    }
    return;
  }

  const int wg = warp >> 2, t = threadIdx.x & 127, wi = t >> 5, lane = t & 31;
  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  for (int i = 0; i < nst; ++i) {
    const int st = i % stages;
    hop::mbar_wait(&full[st], (i / stages) & 1);
    const uint8_t* xs = ring + st * SB;
    const uint8_t* ws = xs + XB;
    const uint64_t da = hop::desc_k128(SWAP ? ws + wg * 64 * 128 : xs + wg * 64 * 128);
    const uint64_t db = hop::desc_k128(SWAP ? xs : ws);
    hop::fence_regs<NACC>(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::Wgmma<int8_t, N>::mma(acc, da + 2 * kk, db + 2 * kk);
    hop::wg_commit();
    hop::wg_wait<1>();   // the previous stage's products are done: release it
    hop::fence_regs<NACC>(acc);
    if (i > 0) hop::mbar_arrive(&empty[(i - 1) % stages]);
  }
  hop::wg_wait<0>();
  hop::fence_regs<NACC>(acc);

#pragma unroll
  for (int j8 = 0; j8 < NACC / 4; ++j8)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * wi + (lane >> 2) + 8 * h, c = 8 * j8 + 2 * (lane & 3) + e;
        const int tok = SWAP ? m0 + c : m0 + wg * 64 + r;
        const int oc = SWAP ? n0 + wg * 64 + r : n0 + c;
        if (tok >= M || oc >= OC) continue;
        const int v = acc[4 * j8 + 2 * h + e];
        if (partial) {
          partial[((size_t)split * M + tok) * OC + oc] = v;
        } else {
          out[(size_t)tok * OC + oc] =
              from_f32<T>(__fmul_rn(__fmul_rn(__int2float_rn(v), scol[oc]), sx[tok]));
        }
      }
}

// The splits' int32 partials summed (exact in any order), then K11's
// epilogue, in its order.
template <typename T>
__global__ void w8a8_splitk_epilogue(const int32_t* __restrict__ partial,
                                     const float* __restrict__ sx,
                                     const float* __restrict__ scol, T* __restrict__ out,
                                     int M, int OC, int splits) {
  const size_t n_out = (size_t)M * OC;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n_out;
       i += (size_t)gridDim.x * blockDim.x) {
    int s = 0;
    for (int sp = 0; sp < splits; ++sp) s += partial[sp * n_out + i];
    out[i] = from_f32<T>(__fmul_rn(__fmul_rn(__int2float_rn(s), scol[i % OC]), sx[i / OC]));
  }
}

template <typename T, int NT>
int k11_launch(const void* xq, const void* sx, const void* w8, const void* scol, void* out,
               void* partial, int M, int IC, int OC, int splits, cudaStream_t st) {
  static int smem_set = 0;
  const int n_st = cdiv(IC, k11::KS);
  const int sb = NT * 128 + k11::BN * 128 + 16;   // + its two mbarriers
  const int budget = (NT < 128 ? 113 : 227) * 1024 - 1024;
  const int stages = std::min(k11::MAX_STAGES, budget / sb);
  if (splits < 1 || splits > n_st) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = 1024 + stages * sb;
  CUtensorMap xm, wm;
  int err = hop::make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, IC, M, k11::KS, NT, true);
  if (!err)
    err = hop::make_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w8, IC, OC, k11::KS, k11::BN,
                        true);
  auto kernel = w8a8_wgmma_kernel<T, NT>;
  if (!err) err = hop::allow_smem(kernel, bytes, &smem_set);
  if (err) return err;
  const dim3 grid(NT < 128 ? 1 : cdiv(M, 128), cdiv(OC, k11::BN), splits);
  kernel<<<grid, k11::THREADS, bytes, st>>>(
      xm, wm, static_cast<const float*>(sx), static_cast<const float*>(scol),
      static_cast<T*>(out), splits > 1 ? static_cast<int32_t*>(partial) : nullptr, M, IC, OC,
      stages, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t want = ((size_t)M * OC + 255) / 256;
  w8a8_splitk_epilogue<T><<<static_cast<int>(want < 65535 ? want : 65535), 256, 0, st>>>(
      static_cast<const int32_t*>(partial), static_cast<const float*>(sx),
      static_cast<const float*>(scol), static_cast<T*>(out), M, OC, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int k11_nt(const void* xq, const void* sx, const void* w8, const void* scol, void* out,
           void* partial, int M, int IC, int OC, int nt, int splits, cudaStream_t st) {
  switch (nt) {
    case 16: return k11_launch<T, 16>(xq, sx, w8, scol, out, partial, M, IC, OC, splits, st);
    case 32: return k11_launch<T, 32>(xq, sx, w8, scol, out, partial, M, IC, OC, splits, st);
    case 64: return k11_launch<T, 64>(xq, sx, w8, scol, out, partial, M, IC, OC, splits, st);
    case 128: return k11_launch<T, 128>(xq, sx, w8, scol, out, partial, M, IC, OC, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- K10: wgmma s8 over a requantizing ring -----------------------------

namespace k10 {
constexpr int RQ = 2;           // requant warpgroups, taking alternate stages
constexpr int BM = 128;         // tokens of a block: two consumer warpgroups of 64
constexpr int BN = 128;         // output columns of a block
constexpr int KS = 128;         // channels of one stage
constexpr int ROWS = KS / 8;    // code rows of a stage
constexpr int WORKERS = 256 + 128 * RQ;   // consumer and requant threads
constexpr int THREADS = WORKERS + 64;     // and two producer warps (x, codes)
constexpr int STAGES = 5;       // x tiles and B tiles in flight
constexpr int CSTAGES = 7;      // code tiles in flight
constexpr int XB = BM * KS, WB = BN * KS, CB = ROWS * BN * 4;
constexpr int BARS = 4 * STAGES + 2 * CSTAGES + 1;
constexpr int SMEM = 1024 + STAGES * (XB + WB) + CSTAGES * CB + 8 * BARS + 4 * WORKERS;
}  // namespace k10

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t lop3_select(uint32_t hi, uint32_t lo, uint32_t mask) {
  uint32_t d;   // (hi & mask) | (lo & ~mask)
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;" : "=r"(d) : "r"(hi), "r"(lo), "r"(mask));
  return d;
}

// The eight codes of word w through the 16-entry table L (entry v in byte v
// % 4 of L[v / 4]): nibble s's value lands in byte s of lo (s < 4) or of
// hi. prmt's low 3 selector bits pick a byte of {L1:L0} or {L3:L2} (the
// top bit cleared); the byte mask of nibbles >= 8 comes from selecting
// bytes of {~0:0} with the nibbles' bits 1-3 (a set bit 3 of the selector,
// here the next nibble's bit 0, replicates the sign of 0x00 or 0xFF: no
// change).
__device__ __forceinline__ void lookup8(uint32_t w, const uint32_t* L, uint32_t& lo,
                                        uint32_t& hi) {
  const uint32_t wm = w & 0x77777777u, wh = wm >> 16;
  lo = lop3_select(prmt(L[2], L[3], wm), prmt(L[0], L[1], wm), prmt(0u, ~0u, w >> 1));
  hi = lop3_select(prmt(L[2], L[3], wh), prmt(L[0], L[1], wh), prmt(0u, ~0u, w >> 17));
}

// The int8 codes of a column's group for the sixteen code values, JAX's
// chain per value: clip(rint(((128 + q) - (128 + sz/s)) * (s * (1/scol))),
// -127, 127), each step one f32 operation in that order.
__device__ __forceinline__ void requant_table(float s_raw, float sz_raw, float inv, bool live,
                                              uint32_t* L) {
  const float s = bf16r(s_raw), sz = bf16r(sz_raw);
  const float zz = live ? __fadd_rn(128.f, __fdiv_rn(sz, s)) : 128.f;
  const float f = live ? __fmul_rn(s, inv) : 0.f;   // a column past OC requantizes to 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t packed = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float wf = __fmul_rn(__fsub_rn(code128_f32(4 * i + e), zz), f);
      packed |= (static_cast<uint32_t>(clamp_int(__float2int_rn(wf), -127, 127)) & 0xFFu)
                << (8 * e);
    }
    L[i] = packed;
  }
}

// Block (x, y, z): tokens [128x, 128x + 128), columns [128y, 128y + 128),
// split z of the IC stages. Warps 0-7 multiply (warpgroup w takes tokens
// 64w..); warps 8-15 requantize, warpgroup r the stages i = r mod 2
// (thread n column n: a stage's requant is a chain of dependent round
// trips, so two stages are in flight at once); warp 16 loads the x tiles
// and warp 17 the code tiles. Three rings: x tiles (filled by TMA, freed
// by the consumers), code tiles (filled by TMA or cp.async, freed by the
// requant as soon as it holds a stage's codes in registers, so they run
// ahead of the products) and B tiles (written by the requant, freed by
// the consumers). Split `blockIdx.z` writes int32 partials where `partial`
// is given (and its first M tile scol into scol_out); else the epilogue
// (f32(acc) * scol) * sx, rounded once to T.
template <typename T>
__global__ void __launch_bounds__(k10::THREADS, 1) w4a8_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
    const int32_t* __restrict__ qw, const float* __restrict__ scales,
    const float* __restrict__ szeros, const float* __restrict__ sx, T* __restrict__ out,
    int32_t* __restrict__ partial, float* __restrict__ scol_out, int M, int IC, int OC, int G,
    int splits, int tma_w, float col_ratio) {
  using namespace k10;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xring = hop::align1024(smem_raw);
  uint8_t* bring = xring + STAGES * XB;
  uint8_t* cring = bring + STAGES * WB;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(cring + CSTAGES * CB);
  uint64_t* xempty = xfull + STAGES;
  uint64_t* wready = xempty + STAGES;
  uint64_t* bempty = wready + STAGES;
  uint64_t* cfull = bempty + STAGES;
  uint64_t* cempty = cfull + CSTAGES;
  uint64_t* scol_bar = cempty + CSTAGES;
  float* scol_s = reinterpret_cast<float*>(scol_bar + 1);   // [WORKERS / BN][BN]

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int n_st = (IC + KS - 1) / KS;   // a last half stage reads zeros past IC
  const int s_begin = static_cast<int>(static_cast<long long>(split) * n_st / splits);
  const int nst = static_cast<int>(static_cast<long long>(split + 1) * n_st / splits) - s_begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_g = IC / G;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hop::mbar_init(&xfull[i], 1);
      hop::mbar_init(&xempty[i], 256);
      hop::mbar_init(&wready[i], 128);
      hop::mbar_init(&bempty[i], 256);
    }
    for (int i = 0; i < CSTAGES; ++i) {
      // the codes by TMA: the producer's expect_tx; by cp.async: one
      // arrival per lane
      hop::mbar_init(&cfull[i], tma_w ? 1 : 32);
      hop::mbar_init(&cempty[i], 128);
    }
    hop::mbar_init(scol_bar, 128);
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == WORKERS / 32) {   // the x producer
    if (lane == 0) {
      for (int i = 0; i < nst; ++i) {
        const int st = i % STAGES;
        hop::mbar_wait(&xempty[st], ((i / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&xfull[st], XB);
        hop::tma_load_2d(xring + st * XB, &xmap, &xfull[st], (s_begin + i) * KS, m0);
      }
    }
    return;
  }
  if (warp == WORKERS / 32 + 1) {   // the codes producer
    for (int i = 0; i < nst; ++i) {
      const int st = i % CSTAGES, kst = s_begin + i;
      hop::mbar_wait(&cempty[st], ((i / CSTAGES) & 1) ^ 1);
      uint8_t* cbase = cring + st * CB;
      if (tma_w) {
        if (lane == 0) {
          hop::mbar_expect_tx(&cfull[st], CB);
          hop::tma_load_2d(cbase, &qmap, &cfull[st], n0, kst * ROWS);
        }
      } else {   // row pitch OC*4 no multiple of 16: 4-byte copies
        int32_t* cd = reinterpret_cast<int32_t*>(cbase);
        for (int e = lane; e < ROWS * BN; e += 32) {
          const int r = kst * ROWS + e / BN, c = n0 + e % BN;
          const bool ok = c < OC && r < IC / 8;
          hop::cp_async4(cd + e, qw + (ok ? (size_t)r * OC + c : 0), ok);
        }
        hop::cp_async_arrive(&cfull[st]);
      }
    }
    if (!tma_w) hop::cp_async_wait_all();
    return;
  }

  // scol's column maxima, the IC/G scale rows split over the consumer and
  // requant threads (which have nothing else to do before the first stage)
  {
    constexpr int PARTS = WORKERS / BN;
    const int n = threadIdx.x % BN, part = threadIdx.x / BN, col = n0 + n;
    float smax = 0.f;
    if (col < OC) {
      for (int g0 = part; g0 < n_g; g0 += 8 * PARTS) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int g = g0 + u * PARTS;
          v[u] = g < n_g ? bf16r(scales[(size_t)g * OC + col]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) smax = fmaxf(smax, v[u]);
      }
    }
    scol_s[part * BN + n] = smax;
    hop::bar_sync(1, WORKERS);
  }

  if (warp >= 8) {   // the requant warpgroups
    const int q = threadIdx.x - 256, n = q % BN, r = q / BN, col = n0 + n;
    const bool live = col < OC;
    float smax = 0.f;
#pragma unroll
    for (int p = 0; p < WORKERS / BN; ++p) smax = fmaxf(smax, scol_s[p * BN + n]);
    const float sc = fmaxf(__fmul_rn(smax, col_ratio), 1e-12f);
    const float inv = __fdiv_rn(1.f, sc);
    hop::bar_sync(2, 128 * RQ);   // every part read before column n's slot is overwritten
    if (r == 0) {
      scol_s[n] = sc;
      if (scol_out != nullptr && blockIdx.x == 0 && split == 0 && live) scol_out[col] = sc;
      hop::mbar_arrive(scol_bar);
    }

    // the scale and szero of stage i's two 64-channel blocks (one group
    // each), read from global memory a stage ahead; zeros past IC or OC
    auto load_scales = [&](int i, float* v) {
      const int k0 = (s_begin + i) * KS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = (k0 + 64 * h) / G;
        const bool ok = live && i < nst && g < n_g;
        const size_t off = ok ? (size_t)g * OC + col : 0;
        v[2 * h] = ok ? __ldg(scales + off) : 0.f;
        v[2 * h + 1] = ok ? __ldg(szeros + off) : 0.f;
      }
    };
    // one stage: its tables from `cur` (read a stage ahead), the next
    // stage's scales into `nxt`, then the codes once they arrive
    auto requant_stage = [&](int i, const float* cur, float* nxt) {
      load_scales(i + RQ, nxt);
      // the tables before the codes arrive: their latency overlaps the wait
      const int k0 = (s_begin + i) * KS;
      uint32_t L[2][4];
      requant_table(cur[0], cur[1], inv, live, L[0]);
      if ((k0 + 64) / G != k0 / G) {
        requant_table(cur[2], cur[3], inv, live, L[1]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) L[1][e] = L[0][e];
      }
      const int cs = i % CSTAGES;
      hop::mbar_wait(&cfull[cs], (i / CSTAGES) & 1);
      const uint32_t* codes = reinterpret_cast<const uint32_t*>(cring + cs * CB);
      uint32_t w[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) w[k] = codes[k * BN + n];
      hop::mbar_arrive(&cempty[cs]);   // the codes are in registers
      const int st = i % STAGES;
      hop::mbar_wait(&bempty[st], ((i / STAGES) & 1) ^ 1);
      uint8_t* wt = bring + st * WB;
#pragma unroll
      for (int c = 0; c < 2; ++c)   // the stage's 64-channel blocks
#pragma unroll
        for (int j = 0; j < 4; ++j) {   // words 2j, 2j + 1: one 16-byte chunk of B's row n
          uint4 v;
          lookup8(w[8 * c + 2 * j], L[c], v.x, v.y);
          lookup8(w[8 * c + 2 * j + 1], L[c], v.z, v.w);
          *reinterpret_cast<uint4*>(wt + hop::swz128(n, 16 * (4 * c + j))) = v;
        }
      hop::fence_proxy_async();
      hop::mbar_arrive(&wready[st]);
    };
    // two register sets in turn, so that no copy waits for a load in flight
    float sa[4], sb[4];
    load_scales(r, sa);
    for (int i = r; i < nst; i += 2 * RQ) {
      requant_stage(i, sa, sb);
      if (i + RQ < nst) requant_stage(i + RQ, sb, sa);
    }
    return;
  }

  // the consumer warpgroups
  const int wg = warp >> 2, t = threadIdx.x & 127, wi = t >> 5;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int i = 0; i < nst; ++i) {
    const int st = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    hop::mbar_wait(&xfull[st], ph);
    hop::mbar_wait(&wready[st], ph);
    const uint64_t da = hop::desc_k128(xring + st * XB + wg * 64 * 128);
    const uint64_t db = hop::desc_k128(bring + st * WB);
    hop::fence_regs<64>(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::Wgmma<int8_t, 128>::mma(acc, da + 2 * kk, db + 2 * kk);
    hop::wg_commit();
    hop::wg_wait<1>();   // the previous stage's products are done: release its tiles
    hop::fence_regs<64>(acc);
    if (i > 0) {
      hop::mbar_arrive(&xempty[(i - 1) % STAGES]);
      hop::mbar_arrive(&bempty[(i - 1) % STAGES]);
    }
  }
  hop::wg_wait<0>();
  hop::fence_regs<64>(acc);
  hop::mbar_wait(scol_bar, 0);

#pragma unroll
  for (int j8 = 0; j8 < 16; ++j8)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rr = 16 * wi + (lane >> 2) + 8 * h, c = 8 * j8 + 2 * (lane & 3) + e;
        const int tok = m0 + wg * 64 + rr, oc = n0 + c;
        if (tok >= M || oc >= OC) continue;
        const int v = acc[4 * j8 + 2 * h + e];
        if (partial) {
          partial[((size_t)split * M + tok) * OC + oc] = v;
        } else {
          out[(size_t)tok * OC + oc] =
              from_f32<T>(__fmul_rn(__fmul_rn(__int2float_rn(v), scol_s[c]), sx[tok]));
        }
      }
}

// One K10 product: the TMA descriptors (x, and the code rows where OC·4 is
// a multiple of 16), the kernel over (M tiles, OC tiles, splits), then with
// splits > 1 K11's split epilogue over scol_out.
template <typename T>
int k10_launch(const void* xq, const void* sx, const void* qw, const void* scales,
               const void* szeros, void* out, void* partial, void* scol_out, int M, int IC,
               int OC, int G, int splits, cudaStream_t st) {
  using namespace k10;
  static_assert(SMEM <= 227 * 1024, "K10's rings outgrew the shared memory");
  static int smem_set = 0;
  const int n_st = cdiv(IC, KS);
  const bool tma_w = OC % 4 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0;
  if (splits < 1 || splits > n_st || (splits > 1 && (!partial || !scol_out)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, qm;
  int err = hop::make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, IC, M, KS, BM, true);
  qm = xm;
  if (!err && tma_w)
    err = hop::make_map(&qm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, qw, OC, IC / 8, BN, ROWS, false);
  auto kernel = w4a8_wgmma_kernel<T>;
  if (!err) err = hop::allow_smem(kernel, SMEM, &smem_set);
  if (err) return err;
  const dim3 grid(cdiv(M, BM), cdiv(OC, BN), splits);
  kernel<<<grid, THREADS, SMEM, st>>>(
      xm, qm, static_cast<const int32_t*>(qw), static_cast<const float*>(scales),
      static_cast<const float*>(szeros), static_cast<const float*>(sx), static_cast<T*>(out),
      splits > 1 ? static_cast<int32_t*>(partial) : nullptr,
      splits > 1 ? static_cast<float*>(scol_out) : nullptr, M, IC, OC, G, splits, tma_w,
      static_cast<float>(15.0 / 127.0));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t want = ((size_t)M * OC + 255) / 256;
  w8a8_splitk_epilogue<T><<<static_cast<int>(want < 65535 ? want : 65535), 256, 0, st>>>(
      static_cast<const int32_t*>(partial), static_cast<const float*>(sx),
      static_cast<const float*>(scol_out), static_cast<T*>(out), M, OC, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Caller guarantees: x [M, IC] contiguous of dtype code `dtype` (0 f32,
// 1 bf16, 2 f16), xq int8 [M, IC], sx f32 [M]; M >= 1, IC >= 1; with perm
// (K10's channel order within 64-blocks) IC % 64 == 0 and x, xq 16-byte
// aligned.
extern "C" int awq_quant_per_token(const void* x, void* xq, void* sx, int M, int IC,
                                   int dtype, int perm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((perm && IC % 64) || IC < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return quant_launch<float>(x, xq, sx, M, IC, perm, st);
    case 1: return quant_launch<bf16>(x, xq, sx, M, IC, perm, st);
    case 2: return quant_launch<__half>(x, xq, sx, M, IC, perm, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K11: `nt` and `splits` are the host plan's token tile (16, 32, 64 or
// 128) and split count (ops/w4a16.py::gemm_plan), partial int32
// [splits, M, OC] when splits > 1 (else null). Caller guarantees: xq int8
// [M, IC] and w8 int8 [OC, IC], both 16-byte aligned; sx f32 [M], scol f32
// [OC], out [M, OC] of dtype code `dtype`; IC % 64 == 0, M >= 1,
// 1 <= splits <= ceil(IC / 128).
extern "C" int awq_w8a8_gemm(const void* xq, const void* sx, const void* w8,
                             const void* scol, void* out, void* partial, int M, int IC,
                             int OC, int nt, int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return k11_nt<float>(xq, sx, w8, scol, out, partial, M, IC, OC, nt, splits, st);
    case 1: return k11_nt<bf16>(xq, sx, w8, scol, out, partial, M, IC, OC, nt, splits, st);
    case 2: return k11_nt<__half>(xq, sx, w8, scol, out, partial, M, IC, OC, nt, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K10 over the host plan's split count (ops/w4a16.py::gemm_plan, kind
// "w4a8"). Caller guarantees: xq int8 [M, IC] in K10's channel order
// (awq_quant_per_token with perm) and 16-byte aligned, sx f32 [M], out
// [M, OC] of dtype code `dtype`; qw int32 [IC/8, OC] in pack_int4's
// layout, scales/szeros f32 [IC/G, OC]; G % 64 == 0, IC % G == 0; with
// splits > 1, partial int32 [splits, M, OC] and scol_out f32 [OC] (else
// null).
extern "C" int awq_w4a8_gemm(const void* xq, const void* sx, const void* qw,
                             const void* scales, const void* szeros, void* out,
                             void* partial, void* scol_out, int M, int IC, int OC, int G,
                             int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AWQ_K10(T_) \
  return k10_launch<T_>(xq, sx, qw, scales, szeros, out, partial, scol_out, M, IC, OC, G, \
                        splits, st)
  switch (dtype) {
    case 0: AWQ_K10(float);
    case 1: AWQ_K10(bf16);
    case 2: AWQ_K10(__half);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AWQ_K10
}
