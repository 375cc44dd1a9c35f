// K1: the W4A16 and W3A16 dequant matmul for Hopper (sm_90a), shared body
// of w4a16.cu (W4, pack_int4) and w3a16.cu (W3, pack_int3), which build it
// in parallel as separate libraries.
//
// Replaces the Pallas kernels of awq_tpu/ops/w4a16.py: w4a16_matmul_pallas
// (_w4a16_kernel), w4a16_matmul_stacked (_w4a16_kernel_stacked) and the
// TPU-only tiled/folded layouts (w4a16_matmul_stacked_tiled,
// w4a16_matmul_stacked_tiled_folded), and in W3 mode w3a16_matmul_stacked
// (_w3a16_kernel_stacked) and its folded twin
// w3a16_matmul_stacked_tiled_folded (_w3a16_kernel_folded), which all
// compute
//     y[M, OC] = x[M, IC] @ (q * s - sz)      (+ bias), f32 accumulation
// with s = scales and sz = szeros = scales * zeros, both f32 [IC/G, OC],
// and q the codes of
// - pack_int4 (int32 [IC/8, OC]): input channel ic = 64c + 8s + r sits in
//   word 8c + r, nibble s;
// - pack_int3 (int32 [IC·3/32, OC], IC % 256 == 0): ic = 256c + 8s + r
//   (s < 32) keeps its low 2 bits in word 24c + 8(s >> 4) + r at bits
//   2(s & 15) and its high bit in word 24c + 16 + r at bit s.
// x, the bias and y are f32, bf16 or f16 (T, the JAX kernels' x.dtype).
//
// Layout: the kernels read both packings as they are stored (no repack at
// load): OC is the contiguous axis, so threads that walk OC read coalesced
// words. In both formats a "unit" of 8 input channels 8u + r (r < 8) sits
// in 8 word rows, one channel per row, so warp r of a block takes row r.
//
// (a) w4a16_gemv_kernel, M <= 8 (decode). Bound by device memory: every code
//     byte is read once per token (0.5 B per weight in W4, 0.375 B in W3,
//     plus 8 B of scales per group column), and the work per byte is a few
//     FMAs. Design: each thread owns 4 adjacent columns and loads one
//     16-byte vector per word row (a warp reads 512 contiguous bytes); the
//     8 warps of a block take the 8 word rows of each chunk (warp r = row
//     r; in W3 the lo rows r and 8 + r and the hi row 16 + r, each word
//     read once), so x, staged once in shared memory as f32, is a broadcast
//     read. IC is split over gridDim.y (split-K, 512 channels per block) so
//     that even OC = 4096 puts 256+ blocks on the 132 SMs; the splits write
//     f32 partials that a second kernel sums in a fixed order
//     (deterministic, no atomics) and rounds to T, adding the bias. Per
//     group the matmul-then-scale identity of the TPU kernel is kept:
//     y += s_g * sum(x*q) - sum(x) * sz_g, so the inner loop is one FMA per
//     code and m, and codes become floats by a mantissa OR (in W3 after
//     the lo and hi words are shifted once per 64 channels, so that each
//     code's shifts are constants). Any group size G that is a multiple of
//     8 and divides IC is taken (G = IC too): the sums are flushed with the
//     group's scales at every group edge (checked once per 64 channels
//     where G is a multiple of 64), and at the end of a split that cuts a
//     group, which carries its partial group into the partial sum (the
//     identity is linear, so the splits add up to the whole group).
// (b) w4a16_wgmma_kernel, M > 8 (prefill). The products are 2·M·IC·OC FLOPs
//     against IC·OC/2 code bytes: bound by the code bytes up to M ~ 150 in
//     bf16 (at M = 32, `down` reads 29 MB in 8.8 us at 3.35 TB/s), by the
//     tensor cores above. Design, for Hopper:
//     - a ring of stages in dynamic shared memory, filled by one producer
//       warp: each stage holds the x tile of its channels (TMA, 128-byte
//       swizzle, one 64-channel box per sub-step), the code rows (8 for a
//       64-channel W4 stage; 24, one pack_int3 chunk, for a 256-channel W3
//       stage) and the scale and szero rows of the groups it spans, by TMA
//       where the row pitch OC*4 is a multiple of 16 bytes, else by 4-byte
//       cp.async (OC = 202) into the same ring; mbarriers count the bytes
//       and the consumers' releases;
//     - the weights are wgmma's 64-row operand A, taken from registers, and
//       the block's NT tokens (16, 32, 64 or 128 by M) its N: y^T =
//       W^T x^T, so no tensor-core row works on padding at short prompts.
//       Each of two consumer warpgroups dequantizes its 64 output columns
//       of every 64-channel sub-step straight into the A fragment: in
//       pack_int4 a thread's channel pairs 8u + 2t, 8u + 2t + 1 are the
//       nibbles u of words 2t and 2t + 1 of its two rows. Each weight is
//       q*s - sz in f32, rounded once to the tile type (q*s as one FMA on
//       power-of-2-scaled operands, which rounds as __fmul_rn does); the A
//       registers are double-buffered, so the next sub-step's dequant runs
//       while this one's wgmma does. No weight tile passes through shared
//       memory (staged there for wgmma's descriptor, it is written and read
//       back once per sub-step: 1.5-2x the time at short prompts on the
//       H100);
//     - split-K where the tiles leave SMs idle: the host plan
//       (ops/w4a16.py::gemm_plan) cuts IC on stage edges into as many
//       ranges as one wave of blocks holds, each range writes f32
//       partials, and splitk_reduce_kernel sums them in split order (one
//       more launch, deterministic, no atomics) and adds the bias.
//     x of f32 enters as bf16, rounded by the wrapper (about 3 significant
//     digits; the plain version keeps f32), f16 x as f16. At long prompts a
//     sub-step takes ~1,250 cycles, ~725 of them a warpgroup's dequant and
//     ~190 its wait for the stage: the tensor cores are busy ~44% of it
//     (PERF.md §6). A 256-token tile would halve the dequant per FLOP, but
//     its 128 accumulators and two A buffers do not fit the 168 registers
//     a thread has here: ptxas then serializes the wgmma.
//
// OC need not be a multiple of 128 (qwen2/falcon widths): both kernels mask
// the column edge; the GEMV takes 16-byte loads only where the caller says
// the rows are 16-byte aligned (OC % 4 == 0), else 4-byte loads.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int GEMV_WARPS = 8;            // = word rows per unit
constexpr int GEMV_COLS = 4;             // columns per thread
constexpr int GEMV_TILE_N = 32 * GEMV_COLS;
constexpr int GEMV_MAX_SPLIT_K = 512;    // input channels per block

// 4 words of one code row at columns n0..n0+3 (16 bytes where full).
__device__ __forceinline__ void load_row4(const int32_t* row, int n0, int OC, bool full,
                                          uint32_t* w) {
  if (full) {
    const int4 v = *reinterpret_cast<const int4*>(row + n0);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < GEMV_COLS; ++j) w[j] = (n0 + j < OC) ? row[n0 + j] : 0;
  }
}

__device__ __forceinline__ void load_q4(const float* p, int n0, int OC, bool full, float* v) {
  if (full) {
    const float4 a = *reinterpret_cast<const float4*>(p + n0);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < GEMV_COLS; ++j) v[j] = n0 + j < OC ? p[n0 + j] : 0.f;
  }
}

template <int M, typename T, bool W3>
__global__ void __launch_bounds__(256) w4a16_gemv_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ qw,
    const float* __restrict__ scales, const float* __restrict__ szeros,
    float* __restrict__ partial, int IC, int OC, int G, int split_k, int vec) {
  constexpr int CH = W3 ? 256 : 64;      // channels per packing chunk
  constexpr int ROWS = W3 ? 24 : 8;      // code rows per chunk
  constexpr int UNITS = CH / 8;          // 8-channel units per chunk
  __shared__ float xs[M][GEMV_MAX_SPLIT_K];
  __shared__ float red[GEMV_WARPS][GEMV_TILE_N];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int split = blockIdx.y;
  const int k0 = split * split_k;
  const int klen = min(split_k, IC - k0);
  const int n0 = blockIdx.x * GEMV_TILE_N + lane * GEMV_COLS;

  for (int i = tid; i < M * klen; i += 256) {
    const int m = i / klen, k = i - m * klen;
    xs[m][k] = to_f32<T>(x[(size_t)m * IC + k0 + k]);
  }
  __syncthreads();

  const bool full = vec && (n0 + GEMV_COLS <= OC);
  float acc[M][GEMV_COLS], dot[M][GEMV_COLS], xsum[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    xsum[m] = 0.f;
#pragma unroll
    for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = dot[m][j] = 0.f;
  }
  int g = k0 / G;                 // the group of the next unit
  int left = (g + 1) * G - k0;    // its channels not yet summed
  auto flush = [&]() {
    float sc[GEMV_COLS], sz[GEMV_COLS];
    load_q4(scales + (size_t)g * OC, n0, OC, full, sc);
    load_q4(szeros + (size_t)g * OC, n0, OC, full, sz);
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) {
        acc[m][j] += dot[m][j] * sc[j] - xsum[m] * sz[j];
        dot[m][j] = 0.f;
      }
      xsum[m] = 0.f;
    }
  };

  // groups that are whole 64-channel blocks are flushed once per block,
  // smaller ones once per unit
  const bool fine = G % 64 != 0;
  for (int c = 0; c < klen / CH; ++c) {
    const int32_t* rows = qw + (size_t)((k0 / CH + c) * ROWS + warp) * OC;
    uint32_t w0[GEMV_COLS], w1[GEMV_COLS] = {}, w2[GEMV_COLS] = {};
    load_row4(rows, n0, OC, full, w0);
    if constexpr (W3) {
      load_row4(rows + (size_t)8 * OC, n0, OC, full, w1);
      load_row4(rows + (size_t)16 * OC, n0, OC, full, w2);
    }
    for (int b = 0; b < UNITS / 8; ++b) {    // blocks of 8 units (64 channels)
      // W3: the lo and hi words shifted so that unit 8b + u sits at lo
      // bits 2u and hi bit u
      uint32_t lw[GEMV_COLS], hw[GEMV_COLS];
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) {
        lw[j] = W3 ? (b < 2 ? w0[j] : w1[j]) >> (16 * (b & 1)) : w0[j];
        hw[j] = w2[j] >> (8 * b);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int kl = c * CH + (8 * b + u) * 8 + warp;
        float qv[GEMV_COLS];
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) {
          if constexpr (W3) {
            const uint32_t q = ((lw[j] >> (2 * u)) & 3u) | (((hw[j] >> u) & 1u) << 2);
            qv[j] = __uint_as_float(0x4B000000u | q) - 8388608.0f;
          } else {
            qv[j] = nibble_f32(lw[j], u);
          }
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float xv = xs[m][kl];
          xsum[m] += xv;
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j) dot[m][j] = fmaf(xv, qv[j], dot[m][j]);
        }
        if (fine) {
          left -= 8;
          if (left == 0) {
            flush();
            ++g;
            left = G;
          }
        }
      }
      if (!fine) {
        left -= 64;
        if (left == 0) {
          flush();
          ++g;
          left = G;
        }
      }
    }
  }
  if (left != G) flush();         // the split ends inside group g

  // sum the 8 warps' partials of each column, one row m at a time
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int j = 0; j < GEMV_COLS; ++j) red[warp][lane * GEMV_COLS + j] = acc[m][j];
    __syncthreads();
    if (tid < GEMV_TILE_N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < GEMV_WARPS; ++w) s += red[w][tid];
      const int n = blockIdx.x * GEMV_TILE_N + tid;
      if (n < OC) partial[((size_t)split * M + m) * OC + n] = s;
    }
    __syncthreads();
  }
}

// out[m, n] = T(sum over splits) (+ bias, added in T as the plain version
// adds it); the splits are summed in index order.
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const T* __restrict__ bias, T* __restrict__ out,
                                     int M, int OC, int nsplit) {
  const size_t n_out = (size_t)M * OC;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n_out;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) s += partial[sp * n_out + i];
    T r = from_f32<T>(s);
    if (bias) r = from_f32<T>(to_f32<T>(r) + to_f32<T>(bias[i % OC]));
    out[i] = r;
  }
}

// ---- (b) the GEMM entry: wgmma fed by a TMA / cp.async ring ---------------

namespace k1 {
constexpr int BN = 128;          // output columns of a block: 64 a consumer warpgroup
constexpr int THREADS = 288;     // two consumer warpgroups and one producer warp
constexpr int MAX_STAGES = 8;

template <bool W3> struct Fmt {
  static constexpr int KS = W3 ? 256 : 64;   // channels of one ring stage
  static constexpr int SUB = KS / 64;        // 64-channel wgmma sub-steps of a stage
  static constexpr int ROWS = W3 ? 24 : 8;   // code rows of a stage
};

// One ring stage: SUB x tiles [NT][64] (128-byte swizzled rows), the code
// rows [ROWS][BN], then ns rows of scales and of szeros [ns][BN]; 1024-aligned.
__host__ __device__ constexpr int stage_bytes(int sub, int nt, int rows, int ns) {
  return (sub * nt * 128 + rows * BN * 4 + 2 * ns * BN * 4 + 1023) / 1024 * 1024;
}

// Two blocks an SM for token tiles of up to 64 (registers and 113 KB of
// shared memory each), one above.
__host__ __device__ constexpr int blocks_per_sm(int nt) { return nt <= 64 ? 2 : 1; }
}  // namespace k1

// The code of unit u (channels 8u..8u+7 of a sub-step) in a word as the
// float 2^23 + q·2^k, exact: the code's bits stay in place under the
// mantissa of 2^23 (`magic`, held in a register so that mask and OR are
// one LOP3). W4: nibble u of w (the word's high half for u >= 4), k =
// 4(u % 4). W3: field u of the pre-shifted low word lo and the high bit,
// bit 2 + u of the pre-shifted hi, moved to bit 2 + 2u; k = 2u.
template <bool W3>
__device__ __forceinline__ float k1_code(uint32_t lo, uint32_t hi, int u, uint32_t magic) {
  if constexpr (W3) {
    return __uint_as_float((lo & (3u << (2 * u))) | ((hi << u) & (4u << (2 * u))) | magic);
  } else {
    return __uint_as_float(((u < 4 ? lo : lo >> 16) & (0xFu << (4 * (u & 3)))) | magic);
  }
}

// Consumer warpgroup w dequantizes its 64 output columns' weights of each
// 64-channel sub-step into registers, in the layout of wgmma's A operand,
// and multiplies them with the sub-step's NT tokens from shared memory (N):
// y^T = W^T x^T, block of 128 columns by NT tokens. Warp 8 is the producer.
// The A registers are double-buffered, so that sub-step j+1's dequant runs
// while sub-step j's products do. Split `blockIdx.z` sums stages
// [z*n/splits, (z+1)*n/splits) and writes f32 partials where `partial` is
// given, else the output.
template <typename MT, typename T, bool W3, int NT>
__global__ void __launch_bounds__(k1::THREADS, k1::blocks_per_sm(NT)) w4a16_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap zmap,
    const int32_t* __restrict__ qw, const float* __restrict__ scales,
    const float* __restrict__ szeros, const T* __restrict__ bias, T* __restrict__ out,
    float* __restrict__ partial, int M, int IC, int OC, int G, int ns, int stages, int splits,
    int tma_w) {
  using F = k1::Fmt<W3>;
  constexpr int NACC = NT / 2;
  constexpr int XB = NT * 128;            // one x sub-tile
  constexpr int CODE_B = F::ROWS * k1::BN * 4;
  const int SB = k1::stage_bytes(F::SUB, NT, F::ROWS, ns);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hop::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * SB);
  uint64_t* empty = full + stages;

  const int m0 = blockIdx.x * NT, n0 = blockIdx.y * k1::BN, split = blockIdx.z;
  const int n_st = IC / F::KS;
  const int s_begin = static_cast<int>(static_cast<long long>(split) * n_st / splits);
  const int nst = static_cast<int>(static_cast<long long>(split + 1) * n_st / splits) - s_begin;
  const int n_sub = nst * F::SUB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      // full: the producer's expect_tx, plus one cp.async arrival per lane
      // when the codes and scales come by cp.async; empty: each consumer warp
      hop::mbar_init(&full[i], tma_w ? 1 : 33);
      hop::mbar_init(&empty[i], 8);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {   // the producer warp
    const int sbytes = ns * k1::BN * 4;
    int st = 0;
    uint32_t ph = 0;
    for (int i = 0; i < nst; ++i) {
      hop::mbar_wait(&empty[st], ph ^ 1);
      uint8_t* base = ring + st * SB;
      uint8_t* cbase = base + F::SUB * XB;
      const int kst = s_begin + i, k0 = kst * F::KS, g0 = k0 / G;
      if (lane == 0) {
        hop::mbar_expect_tx(&full[st], F::SUB * XB + (tma_w ? CODE_B + 2 * sbytes : 0));
        for (int q = 0; q < F::SUB; ++q)
          hop::tma_load_2d(base + q * XB, &xmap, &full[st], k0 + 64 * q, m0);
        if (tma_w) {
          hop::tma_load_2d(cbase, &qmap, &full[st], n0, kst * F::ROWS);
          hop::tma_load_2d(cbase + CODE_B, &smap, &full[st], n0, g0);
          hop::tma_load_2d(cbase + CODE_B + sbytes, &zmap, &full[st], n0, g0);
        }
      }
      if (!tma_w) {   // row pitch OC*4 no multiple of 16: 4-byte copies
        int32_t* cd = reinterpret_cast<int32_t*>(cbase);
        for (int e = lane; e < F::ROWS * k1::BN; e += 32) {
          const int r = e / k1::BN, c = n0 + e % k1::BN;
          hop::cp_async4(cd + e, qw + (size_t)(kst * F::ROWS + r) * OC + (c < OC ? c : 0),
                         c < OC);
        }
        float* sd = reinterpret_cast<float*>(cbase + CODE_B);
        float* zd = sd + ns * k1::BN;
        for (int e = lane; e < ns * k1::BN; e += 32) {
          const int r = e / k1::BN, c = n0 + e % k1::BN;
          const bool ok = c < OC && g0 + r < IC / G;
          const size_t off = ok ? (size_t)(g0 + r) * OC + c : 0;
          hop::cp_async4(sd + e, scales + off, ok);
          hop::cp_async4(zd + e, szeros + off, ok);
        }
        hop::cp_async_arrive(&full[st]);
      }
      if (++st == stages) { st = 0; ph ^= 1; }
    }
    if (!tma_w) hop::cp_async_wait_all();
    return;
  }

  // the consumer warpgroups: thread (g, t) of warp wi holds A rows
  // (= columns of the tile) c0 = 64 wg + 16 wi + g and c0 + 8, and for
  // each unit u of a sub-step the channel pair 8u + 2t, 8u + 2t + 1: the
  // codes of words 2t and 2t + 1 of the unit's rows
  const int wg = warp >> 2, wi = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int c0 = 64 * wg + 16 * wi + gq;
  const bool whole = (G & 63) == 0;   // a sub-step lies in one group
  uint32_t magic;                     // 2^23's bits, opaque to constant folding
  asm volatile("mov.b32 %0, 0x4B000000;" : "=r"(magic));
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  // the sub-step to dequantize: its slot, parity and index in the stage;
  // the group of its first channel, the offset there, the stage's first group
  int d_st = 0, d_q = 0;
  uint32_t d_ph = 0;
  int g = (s_begin * F::KS) / G, rem = s_begin * F::KS - g * G, g0 = g;

  // A registers of one sub-step: a[4kk + 2h + i] holds row c0 + 8i at
  // channels 16kk + 8h + 2t (+1), i.e. unit u = 2kk + h. Each code becomes
  // q*s - sz in f32, rounded once to MT; q*s = fma(2^23 + q·2^k, s·2^-k,
  // -2^23·s·2^-k), rounded once as __fmul_rn(q, s) is: the scalings by
  // powers of 2 are exact.
  auto dequant = [&](uint32_t* a) {
    if (d_q == 0) {
      hop::mbar_wait(&full[d_st], d_ph);
      g0 = g;
    }
    const uint8_t* cbase = ring + d_st * SB + F::SUB * XB;
    const int32_t* codes = reinterpret_cast<const int32_t*>(cbase);
    const float* ss = reinterpret_cast<const float*>(cbase + CODE_B);
    const float* zs = ss + ns * k1::BN;
    // W4: words 2t, 2t + 1 of the sub-step; W3: lo words 8(q >> 1) + 2t (+1)
    // of the chunk at field 8(q & 1) + u, hi words 16 + 2t (+1) at bit 8q + u
    uint32_t lo[2][2], hi[2][2];
    const int hsh = 8 * d_q - 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * i, r = 2 * tq + e;
        lo[i][e] = static_cast<uint32_t>(codes[((W3 ? 8 * (d_q >> 1) : 0) + r) * k1::BN + col]);
        if constexpr (W3) {
          lo[i][e] >>= 16 * (d_q & 1);
          const uint32_t h = codes[(16 + r) * k1::BN + col];
          hi[i][e] = hsh >= 0 ? h >> hsh : h << 2;
        } else {
          hi[i][e] = 0u;
        }
      }
    const int gi0 = g - g0;
    float sv[2], zv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sv[i] = ss[gi0 * k1::BN + c0 + 8 * i];
      zv[i] = zs[gi0 * k1::BN + c0 + 8 * i];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (!whole) {
        const int gi = gi0 + (rem + 8 * u) / G;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sv[i] = ss[gi * k1::BN + c0 + 8 * i];
          zv[i] = zs[gi * k1::BN + c0 + 8 * i];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float sk = __fmul_rn(sv[i], W3 ? 1.f / (1 << (2 * u)) : 1.f / (1 << (4 * (u & 3))));
        const float nk = __fmul_rn(sk, -8388608.0f);
        const float w0 = __fsub_rn(__fmaf_rn(k1_code<W3>(lo[i][0], hi[i][0], u, magic), sk, nk), zv[i]);
        const float w1 = __fsub_rn(__fmaf_rn(k1_code<W3>(lo[i][1], hi[i][1], u, magic), sk, nk), zv[i]);
        a[4 * (u >> 1) + 2 * (u & 1) + i] = pack2<MT>(w0, w1);
      }
    }
    rem += 64;
    while (rem >= G) {
      rem -= G;
      ++g;
    }
    if (++d_q == F::SUB) {
      d_q = 0;
      if (++d_st == stages) { d_st = 0; d_ph ^= 1; }
    }
  };

  // the sub-step of the products: its slot and index in the stage
  int m_st = 0, m_q = 0, release = -1;
  auto mma = [&](uint32_t* a) {
    const uint64_t db = hop::desc_k128(ring + m_st * SB + m_q * XB);
    hop::fence_regs<NACC>(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::WgmmaRS<MT, NT>::mma(acc, a + 4 * kk, db + 2 * kk);
    hop::wg_commit();
    hop::wg_wait<1>();   // the previous sub-step's products are done
    hop::fence_regs<NACC>(acc);
    // release the stage whose last sub-step those were
    if (release >= 0) {
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[release]);
    }
    release = m_q == F::SUB - 1 ? m_st : -1;
    if (++m_q == F::SUB) {
      m_q = 0;
      if (++m_st == stages) m_st = 0;
    }
  };

  uint32_t a0[16], a1[16];
  if (n_sub > 0) dequant(a0);
  for (int j = 0; j < n_sub; j += 2) {
    mma(a0);
    if (j + 1 < n_sub) dequant(a1);   // a1's last products (j - 1) are done
    if (j + 1 >= n_sub) break;
    mma(a1);
    if (j + 2 < n_sub) dequant(a0);
  }
  hop::wg_wait<0>();
  hop::fence_regs<NACC>(acc);

#pragma unroll
  for (int j8 = 0; j8 < NACC / 4; ++j8)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = m0 + 8 * j8 + 2 * tq + e, oc = n0 + c0 + 8 * h;
        if (tok >= M || oc >= OC) continue;
        const float v = acc[4 * j8 + 2 * h + e];
        if (partial) {
          partial[((size_t)split * M + tok) * OC + oc] = v;
        } else {
          T o = from_f32<T>(v);
          if (bias) o = from_f32<T>(to_f32<T>(o) + to_f32<T>(bias[oc]));
          out[(size_t)tok * OC + oc] = o;
        }
      }
}

template <int M, typename T, bool W3>
void launch_gemv(const void* x, const int32_t* qw, const float* s, const float* sz,
                 float* partial, int IC, int OC, int G, int split_k, int vec,
                 cudaStream_t st) {
  const dim3 grid(cdiv(OC, GEMV_TILE_N), cdiv(IC, split_k));
  const dim3 block(32, GEMV_WARPS);
  w4a16_gemv_kernel<M, T, W3><<<grid, block, 0, st>>>(static_cast<const T*>(x), qw, s, sz,
                                                partial, IC, OC, G, split_k, vec);
}

template <typename T, bool W3>
int gemv(const void* x, const void* qw, const void* scales, const void* szeros,
         const void* bias, void* out, void* partial, int M, int IC, int OC, int G,
         int split_k, int vec, cudaStream_t st) {
  const int32_t* q = static_cast<const int32_t*>(qw);
  const float* s = static_cast<const float*>(scales);
  const float* sz = static_cast<const float*>(szeros);
  float* p = static_cast<float*>(partial);
  switch (M) {
    case 1: launch_gemv<1, T, W3>(x, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 2: launch_gemv<2, T, W3>(x, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 3: launch_gemv<3, T, W3>(x, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 4: launch_gemv<4, T, W3>(x, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 5: launch_gemv<5, T, W3>(x, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 6: launch_gemv<6, T, W3>(x, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 7: launch_gemv<7, T, W3>(x, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 8: launch_gemv<8, T, W3>(x, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_out = (size_t)M * OC;
  const int threads = 256;
  const size_t want = (n_out + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65535 ? want : 65535);
  splitk_reduce_kernel<T><<<blocks, threads, 0, st>>>(
      p, static_cast<const T*>(bias), static_cast<T*>(out), M, OC, cdiv(IC, split_k));
  return static_cast<int>(cudaGetLastError());
}


// One GEMM: the TMA descriptors of this call's operands (encoded on the
// host per launch: a stacked layer is a new address each time), then the
// kernel over (M tiles, OC tiles, splits), then with splits > 1 the
// ordered sum of the partials.
template <typename MT, typename T, bool W3, int NT>
int gemm_launch(const void* x, const void* qw, const void* scales, const void* szeros,
                const void* bias, void* out, void* partial, int M, int IC, int OC, int G,
                int splits, cudaStream_t st) {
  using F = k1::Fmt<W3>;
  static int smem_set = 0;
  const int n_st = IC / F::KS, n_g = IC / G;
  int ns = 1;   // the most groups one stage spans
  for (int i = 0; i < n_st; ++i)
    ns = std::max(ns, (i * F::KS + F::KS - 1) / G - (i * F::KS) / G + 1);
  const bool tma_w = OC % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(qw) | reinterpret_cast<uintptr_t>(scales) |
       reinterpret_cast<uintptr_t>(szeros)) % 16 == 0;
  const int sb = k1::stage_bytes(F::SUB, NT, F::ROWS, ns) + 16;   // + its two mbarriers
  auto fit = [&](int kb) { return std::min(k1::MAX_STAGES, (kb * 1024 - 1024) / sb); };
  int stages = fit(k1::blocks_per_sm(NT) == 2 ? 113 : 227);
  if (stages < 2) stages = fit(227);   // one block an SM
  if (stages < 2 || splits < 1 || splits > n_st) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = 1024 + stages * sb;

  CUtensorMap xm, qm, sm, zm;
  int err = hop::make_map(&xm, hop::TmaType<MT>::v, 2, x, IC, M, 64, NT, true);
  qm = sm = zm = xm;
  if (!err && tma_w)
    err = hop::make_map(&qm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, qw, OC, n_st * F::ROWS, k1::BN,
                        F::ROWS, false);
  if (!err && tma_w)
    err = hop::make_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, OC, n_g, k1::BN, ns,
                        false);
  if (!err && tma_w)
    err = hop::make_map(&zm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, szeros, OC, n_g, k1::BN, ns,
                        false);
  auto kernel = w4a16_wgmma_kernel<MT, T, W3, NT>;
  if (!err) err = hop::allow_smem(kernel, bytes, &smem_set);
  if (err) return err;
  const dim3 grid(cdiv(M, NT), cdiv(OC, k1::BN), splits);
  kernel<<<grid, k1::THREADS, bytes, st>>>(
      xm, qm, sm, zm, static_cast<const int32_t*>(qw), static_cast<const float*>(scales),
      static_cast<const float*>(szeros), splits > 1 ? nullptr : static_cast<const T*>(bias),
      static_cast<T*>(out), splits > 1 ? static_cast<float*>(partial) : nullptr, M, IC, OC, G,
      ns, stages, splits, tma_w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t want = ((size_t)M * OC + 255) / 256;
  splitk_reduce_kernel<T><<<static_cast<int>(want < 65535 ? want : 65535), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const T*>(bias), static_cast<T*>(out), M,
      OC, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename MT, typename T, bool W3>
int gemm(const void* x, const void* qw, const void* scales, const void* szeros,
         const void* bias, void* out, void* partial, int M, int IC, int OC, int G, int nt,
         int splits, cudaStream_t st) {
  switch (nt) {
    case 16: return gemm_launch<MT, T, W3, 16>(x, qw, scales, szeros, bias, out, partial, M, IC, OC, G, splits, st);
    case 32: return gemm_launch<MT, T, W3, 32>(x, qw, scales, szeros, bias, out, partial, M, IC, OC, G, splits, st);
    case 64: return gemm_launch<MT, T, W3, 64>(x, qw, scales, szeros, bias, out, partial, M, IC, OC, G, splits, st);
    case 128: return gemm_launch<MT, T, W3, 128>(x, qw, scales, szeros, bias, out, partial, M, IC, OC, G, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The entries of one format, dispatched on the dtype code of x (0 f32,
// 1 bf16, 2 f16).
template <bool W3>
int gemv_entry(const void* x, const void* qw, const void* scales, const void* szeros,
               const void* bias, void* out, void* partial, int M, int IC, int OC, int G,
               int split_k, int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return gemv<float, W3>(x, qw, scales, szeros, bias, out, partial, M, IC, OC,
                                   G, split_k, vec, st);
    case 1: return gemv<bf16, W3>(x, qw, scales, szeros, bias, out, partial, M, IC, OC,
                                  G, split_k, vec, st);
    case 2: return gemv<__half, W3>(x, qw, scales, szeros, bias, out, partial, M, IC, OC,
                                    G, split_k, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The GEMM over the plan's token tile `nt` (16, 32, 64 or 128) and
// split count; dtype is the output's code, and x is bf16 for an f32 output
// (the wrapper rounds f32 x to bf16 first).
template <bool W3>
int gemm_entry(const void* x, const void* qw, const void* scales, const void* szeros,
               const void* bias, void* out, void* partial, int M, int IC, int OC, int G,
               int nt, int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return gemm<bf16, float, W3>(x, qw, scales, szeros, bias, out, partial, M, IC, OC, G, nt, splits, st);
    case 1: return gemm<bf16, bf16, W3>(x, qw, scales, szeros, bias, out, partial, M, IC, OC, G, nt, splits, st);
    case 2: return gemm<__half, __half, W3>(x, qw, scales, szeros, bias, out, partial, M, IC, OC, G, nt, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
