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
//     byte is read once per call (0.5 B per weight in W4, 0.375 B in W3,
//     plus 8 B of scales per group column), the products are 2 M flops per
//     weight. The first version (one FMA and one shared-memory read of x per
//     code and row, one 16-byte load in flight per thread, x staged before
//     the first code load, f32 partials and a second launch) was bound by
//     instruction issue at M = 8 (1.3-1.5x torch.matmul on the dequantized
//     weight) and by memory latency at M = 1 (wo 6.2x its bound). Design:
//     - one launch a call, deterministic: the host plan (gemv_plan in
//       ops/w4a16.py) gives a block 128 output columns and a range of IC on
//       packing-chunk edges; where the column tiles alone leave SMs idle the
//       IC ranges of a tile form a thread-block cluster of up to 8 blocks,
//       which adds its ranks' sums through distributed shared memory in rank
//       order (no partial buffer, no reduce launch, no atomics);
//     - a producer warp streams the range through a ring of `stages` slots
//       in shared memory, each slot one packing chunk (8 code rows of 64
//       channels in W4, 24 of 256 in W3) and the scale rows of the groups it
//       spans: one cp.async.bulk a row (a 512-byte run of the 128 columns),
//       completing on the slot's mbarrier (4-byte cp.async where the row
//       pitch OC*4 is no multiple of 16: OC = 202); the consumer warps free a
//       slot through a second mbarrier. The first slots are requested before
//       the consumers stage the block's x (its rows over the range, in shared
//       memory, with their group sums). A block streams at a few GB/s on the
//       H100 whatever its ring's depth, so the plan keeps the rings short
//       (at most 5 slots, ~21 KB in flight a W4 block) and the blocks many
//       (three an SM where the column tiles allow, by more IC splits);
//     - the products on the tensor cores (mma.sync m16n8k16, bf16 for bf16 x,
//       f16 for f16 x): A is the weights, 16 output columns by 16 contiguous
//       input channels, B the M <= 8 rows of x (zero rows above M). Consumer
//       thread (gq, tq) holds words 2tq and 2tq + 1 of four adjacent columns
//       (two 16-byte shared loads); one PRMT puts byte j of both words side
//       by side, and a mask and an OR with the tile type's 2^7 (bf16) or 2^10
//       (f16) make 2^7 + q (2^10 + q) exactly for units 2j (channels 16j +
//       2tq, + 1) and 2j + 1 (16j + 8 + 2tq, + 1): no subtract (W3: the lo and
//       hi words' fields moved to the same places first). So a k-step is 16
//       contiguous channels and never crosses a group edge for G % 16 == 0
//       (64, 96, 128, IC). JAX's per-group identity is kept with the codes
//       biased as the JAX kernels bias them, s·Σ x·(c + q) − (c·s + sz)·Σ x
//       with c the power of 2 and f32 sums: the products sum in the mma
//       accumulators, folded into f32 totals with the group's scales and
//       the staged group sums of x at each group edge;
//     - f32 x (and a group size that is no multiple of 16, whose k-steps
//       would straddle groups) keeps f32 arithmetic on the CUDA cores over the
//       same ring, x staged as f32: a thread sums its own two channels of each
//       8-channel unit with the identity (exact codes) flushed at every group
//       edge, and the four lanes of a column are added at the end.
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
// the column edge; both take 16-byte copies only where the rows are 16-byte
// aligned (OC % 4 == 0), else 4-byte ones.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "pair_codes.cuh"

namespace {

namespace gv {
constexpr int CONSUMERS = 4;                 // warps that compute, 32 columns each
constexpr int THREADS = 32 * (CONSUMERS + 1);   // and one producer warp
constexpr int BN = 128;          // output columns of a block: 4 a consumer thread
constexpr int PITCH = BN + 4;    // words of a staged code row: 16 bytes of padding
constexpr int MAX_CLUSTER = 8;   // IC splits of one column tile (a portable cluster)
constexpr int MAX_STAGES = 9;

template <bool W3> struct Fmt {
  static constexpr int KS = W3 ? 256 : 64;   // channels of a stage: one packing chunk
  static constexpr int SUB = KS / 64;        // 64-channel sub-steps of a stage
  static constexpr int ROWS = W3 ? 24 : 8;   // code rows of a stage
};

// One ring stage: the code rows [ROWS][PITCH], then ns rows of scales and
// of szeros [ns][BN] (ns: the most groups a stage spans).
__host__ __device__ constexpr int stage_bytes(int rows, int ns) {
  return rows * PITCH * 4 + 2 * ns * BN * 4;
}

// A block's shared memory: m rows of x over the longest split's `range`
// channels (tensor cores: bf16/f16 pairs permuted within each 16-channel
// block, 32 bytes of padding a row; else f32, 16 bytes), their group sums
// (tensor cores), the ring, its mbarriers. The block's output tile [m][BN]
// reuses the ring after the last stage.
struct Layout {
  int xw, ngr, xs_off, ring_off, bar_off, total;
};
__host__ __device__ inline Layout layout(bool tc, int m, int range, int G, int stages, int sb) {
  Layout L;
  L.xw = tc ? range / 2 + 8 : range + 4;
  L.ngr = range / G + 2;
  L.xs_off = m * L.xw * 4;
  L.ring_off = (L.xs_off + (tc ? m * L.ngr * 4 : 0) + 127) / 128 * 128;
  L.bar_off = L.ring_off + stages * sb;
  L.total = L.bar_off + 2 * stages * 8;
  return L;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

// `bytes` (a multiple of 16) global -> shared by the bulk-copy engine,
// completing on `bar`'s transaction count; both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(hop::smem_u32(dst)), "l"(src), "r"(bytes), "r"(hop::smem_u32(bar))
      : "memory");
}

// The tile type's 2^7 (bf16) or 2^10 (f16) in both halves: OR-ed with a
// code in its low bits it is that power plus the code, exactly.
template <typename MT> struct Magic;
template <> struct Magic<bf16> {
  static constexpr uint32_t base = 0x43004300u;
  static constexpr float value = 128.f;
};
template <> struct Magic<__half> {
  static constexpr uint32_t base = 0x64006400u;
  static constexpr float value = 1024.f;
};
}  // namespace gv

// The GEMV: block (z, y) of a cluster of gridDim.x = splits blocks sums
// the stages [z*n/splits, (z+1)*n/splits) of column tile y (BN columns),
// and the cluster adds its splits in rank order. Warp CONSUMERS is the
// producer: it streams the range's stages through a ring of `stages`
// slots (bulk copies of the code and scale rows, mbarriers full/empty),
// while the consumer warps stage x in shared memory and then compute.
// Consumer thread (gq, tq) of warp w owns columns 32w + 4gq .. +3 and, of
// every 64-channel sub-step, the code words of rows 2tq and 2tq + 1 (W3:
// lo rows 8h + 2tq, + 1 and hi rows 16 + 2tq, + 1).
// TC: m16n8k16 on the tensor cores, A the weights (column 4gq + 2i + h of
// tile i is A row gq + 8h) as 2^7 + q (bf16) or 2^10 + q (f16), exact, B
// x's rows (row gq, zero from m_rows on); k = 2tq + e and 2tq + 8 + e at
// channels 16j + 2tq + e and 16j + 8 + 2tq + e of k-step j: byte j of code
// words 2tq + e, low and high nibble (W3: fields 2j, 2j + 1 of the moved
// words). At a group edge the group's products fold into f32 totals as
// s·(Σ x·(c + q)) − (sz + c·s)·Σ x, c the power of 2, JAX's identity with
// the codes biased as the JAX kernels bias them. Else (f32 x, or a group
// size that is no multiple of 16) the same loads feed f32 FMAs on the CUDA
// cores with exact codes, a thread summing its own channels and the four
// lanes of a column added in the end.
template <typename T, bool W3, bool TC, int M>
__global__ void __launch_bounds__(gv::THREADS) w4a16_gemv_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ qw, const float* __restrict__ scales,
    const float* __restrict__ szeros, const T* __restrict__ bias, T* __restrict__ out,
    int m_rows, int IC, int OC, int G, int ns, int stages, int vec) {
  using F = gv::Fmt<W3>;
  constexpr int SUB = F::SUB;
  extern __shared__ __align__(128) uint8_t gv_smem[];
  const int SB = gv::stage_bytes(F::ROWS, ns);
  const int splits = gridDim.x, split = blockIdx.x;
  const int n0 = blockIdx.y * gv::BN;
  const int n_st = IC / F::KS;
  const int s_begin = static_cast<int>(static_cast<long long>(split) * n_st / splits);
  const int nst = static_cast<int>(static_cast<long long>(split + 1) * n_st / splits) - s_begin;
  const gv::Layout L = gv::layout(TC, m_rows, (n_st + splits - 1) / splits * F::KS, G, stages, SB);
  uint8_t* ring = gv_smem + L.ring_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(gv_smem + L.bar_off);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int ngroups = IC / G;
  const int k_begin = s_begin * F::KS, k_len = nst * F::KS;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // full: the producer's expect_tx (bulk copies), or its arrival and one
      // cp.async arrival a lane (4-byte copies); empty: each consumer warp
      hop::mbar_init(&full[s], vec ? 1 : 33);
      hop::mbar_init(&empty[s], gv::CONSUMERS);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == gv::CONSUMERS) {   // the producer: every stage of the range in order
    const int ncols = min(gv::BN, OC - n0);
    for (int i = 0; i < nst; ++i) {
      const int s = i % stages;
      if (i >= stages) hop::mbar_wait(&empty[s], ((i / stages) - 1) & 1);
      uint8_t* base = ring + s * SB;
      const int kst = s_begin + i, g0 = kst * F::KS / G;
      float* sd = reinterpret_cast<float*>(base + F::ROWS * gv::PITCH * 4);
      float* zd = sd + ns * gv::BN;
      const int nsv = min(ns, ngroups - g0);   // scale rows that exist
      const int32_t* src = qw + (size_t)kst * F::ROWS * OC + n0;
      if (vec) {   // a bulk copy a row: OC % 4 == 0 and 16-byte aligned operands
        if (lane == 0) hop::mbar_expect_tx(&full[s], (F::ROWS + 2 * nsv) * ncols * 4);
        __syncwarp();
        for (int r = lane; r < F::ROWS + 2 * nsv; r += 32) {
          if (r < F::ROWS) {
            gv::bulk_load(base + r * gv::PITCH * 4, src + (size_t)r * OC, ncols * 4, &full[s]);
          } else {
            const int k = r - F::ROWS, z = k >= nsv, gr = z ? k - nsv : k;
            gv::bulk_load((z ? zd : sd) + gr * gv::BN, (z ? szeros : scales) +
                          (size_t)(g0 + gr) * OC + n0, ncols * 4, &full[s]);
          }
        }
      } else {     // 4-byte copies, zero past the last column
        for (int e = lane; e < F::ROWS * gv::BN; e += 32) {
          const int r = e / gv::BN, c = e % gv::BN;
          const bool ok = c < ncols;
          hop::cp_async4(reinterpret_cast<int32_t*>(base) + r * gv::PITCH + c,
                         ok ? src + (size_t)r * OC + c : qw, ok);
        }
        for (int e = lane; e < ns * gv::BN; e += 32) {
          const int r = e / gv::BN, c = e % gv::BN;
          const bool ok = c < ncols && r < nsv;
          const size_t off = ok ? (size_t)(g0 + r) * OC + n0 + c : 0;
          hop::cp_async4(sd + e, scales + off, ok);
          hop::cp_async4(zd + e, szeros + off, ok);
        }
        hop::cp_async_arrive(&full[s]);
        if (lane == 0) hop::mbar_arrive(&full[s]);
      }
    }
    if (!vec) hop::cp_async_wait_all();
  } else {
    // ---- the consumers: x of the range in shared memory, then the stages ----
    const int ctid = tid, col0 = 32 * warp + 4 * gq;
    uint32_t* xs_w = reinterpret_cast<uint32_t*>(gv_smem);
    float* xsum = reinterpret_cast<float*>(gv_smem + L.xs_off);
    const int g_first = k_begin / G;
    float* red = reinterpret_cast<float*>(ring);   // [m_rows][BN], after the last stage
    if constexpr (TC) {
      // x rows as pairs, each 16-channel block's 8 words stored w0 w4 w1 w5
      // w2 w6 w3 w7, so that a lane's b0, b1 of a k-step are one 8-byte word
      for (int i = ctid; i < m_rows * (k_len / 16); i += 32 * gv::CONSUMERS) {
        const int m = i / (k_len / 16), b = i - m * (k_len / 16);
        const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)m * IC + k_begin + 16 * b);
        const uint4 lo = p[0], hi = p[1];
        uint4* d = reinterpret_cast<uint4*>(xs_w + m * L.xw + 8 * b);
        d[0] = make_uint4(lo.x, hi.x, lo.y, hi.y);
        d[1] = make_uint4(lo.z, hi.z, lo.w, hi.w);
      }
      // the group sums of x over the range's channels, a warp each
      const int ngr = (k_begin + k_len - 1) / G - g_first + 1;
      for (int i = warp; i < m_rows * ngr; i += gv::CONSUMERS) {
        const int m = i / ngr, g = g_first + i - m * ngr;
        const int c0 = max(k_begin, g * G), c1 = min(k_begin + k_len, (g + 1) * G);
        float s = 0.f;
        for (int c = c0 + lane; c < c1; c += 32) s += to_f32<T>(x[(size_t)m * IC + c]);
        s = warp_sum(s);
        if (lane == 0) xsum[m * L.ngr + (g - g_first)] = s;
      }
    } else {
      float* xf = reinterpret_cast<float*>(gv_smem);
      for (int i = ctid; i < m_rows * k_len; i += 32 * gv::CONSUMERS) {
        const int m = i / k_len, k = i - m * k_len;
        xf[m * L.xw + k] = to_f32<T>(x[(size_t)m * IC + k_begin + k]);
      }
    }
    hop::bar_sync(1, 32 * gv::CONSUMERS);

    int g_cur = g_first;                  // the group being summed
    int left = (g_cur + 1) * G - k_begin;    // its channels still to come
    // this thread's code words of sub-step q of the stage in slot `base`,
    // W3's moved so that the sub-step's fields start at 0
    auto words = [&](const uint8_t* base, int q, uint32_t* lo0, uint32_t* lo1, uint32_t* hi0,
                     uint32_t* hi1) {
      const int32_t* cd = reinterpret_cast<const int32_t*>(base);
      const int r0 = (W3 ? 8 * (q >> 1) : 0) + 2 * tq;
      const uint4 a = *reinterpret_cast<const uint4*>(cd + r0 * gv::PITCH + col0);
      const uint4 b = *reinterpret_cast<const uint4*>(cd + (r0 + 1) * gv::PITCH + col0);
      lo0[0] = a.x; lo0[1] = a.y; lo0[2] = a.z; lo0[3] = a.w;
      lo1[0] = b.x; lo1[1] = b.y; lo1[2] = b.z; lo1[3] = b.w;
      if constexpr (W3) {
        const uint4 c = *reinterpret_cast<const uint4*>(cd + (16 + 2 * tq) * gv::PITCH + col0);
        const uint4 d = *reinterpret_cast<const uint4*>(cd + (17 + 2 * tq) * gv::PITCH + col0);
        hi0[0] = c.x; hi0[1] = c.y; hi0[2] = c.z; hi0[3] = c.w;
        hi1[0] = d.x; hi1[1] = d.y; hi1[2] = d.z; hi1[3] = d.w;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          lo0[c4] >>= 16 * (q & 1); lo1[c4] >>= 16 * (q & 1);
          hi0[c4] >>= 8 * q; hi1[c4] >>= 8 * q;
        }
      }
    };
    // the scale and szero rows of group g_cur in the stage at `base` (its
    // first group g0), this thread's four columns
    auto scale_rows = [&](const uint8_t* base, int g0, float* sv, float* zv) {
      const float* sd = reinterpret_cast<const float*>(base + F::ROWS * gv::PITCH * 4) +
                        (g_cur - g0) * gv::BN + col0;
      const float4 s4 = *reinterpret_cast<const float4*>(sd);
      const float4 z4 = *reinterpret_cast<const float4*>(sd + ns * gv::BN);
      sv[0] = s4.x; sv[1] = s4.y; sv[2] = s4.z; sv[3] = s4.w;
      zv[0] = z4.x; zv[1] = z4.y; zv[2] = z4.z; zv[3] = z4.w;
    };

    if constexpr (TC) {
      using MT = T;
      constexpr uint32_t BASE = gv::Magic<MT>::base;
      const bool xon = gq < m_rows;
      const uint32_t* xrow = xs_w + (xon ? gq : 0) * L.xw + 2 * tq;
      float acc[2][4], d[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 2; ++i) acc[i][e] = d[i][e] = 0.f;
      auto flush = [&](const uint8_t* base, int g0) {
        float sv[4], zv[4], xv[2];
        scale_rows(base, g0, sv, zv);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          xv[e] = 2 * tq + e < m_rows ? xsum[(2 * tq + e) * L.ngr + g_cur - g_first] : 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float s = sv[2 * t + h], zc = fmaf(gv::Magic<MT>::value, s, zv[2 * t + h]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              acc[t][2 * h + e] += d[t][2 * h + e] * s - xv[e] * zc;
              d[t][2 * h + e] = 0.f;
            }
          }
        ++g_cur;
      };
      for (int i = 0; i < nst; ++i) {
        const int s = i % stages;
        hop::mbar_wait(&full[s], (i / stages) & 1);
        const uint8_t* base = ring + s * SB;
        const int g0 = (s_begin + i) * F::KS / G;
        for (int q = 0; q < SUB; ++q) {
          uint32_t lo0[4], lo1[4], hi0[4], hi1[4];
          words(base, q, lo0, lo1, hi0, hi1);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint2 b = xon ? *reinterpret_cast<const uint2*>(xrow + 8 * (4 * (i * SUB + q) + j))
                                : make_uint2(0u, 0u);
            uint32_t pl[4], ph[4];   // column c's pairs of units 2j and 2j + 1
#pragma unroll
            for (int c = 0; c < 4; ++c)
              pc::code_pairs<W3>(lo0[c], lo1[c], hi0[c], hi1[c], j, BASE, pl[c], ph[c]);
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const uint32_t a[4] = {pl[2 * t], pl[2 * t + 1], ph[2 * t], ph[2 * t + 1]};
              mma_16816<MT>(d[t], a, b.x, b.y);
            }
            left -= 16;
            if (left == 0) {
              flush(base, g0);
              left = G;
            }
          }
        }
        if (i == nst - 1 && left != G) flush(base, g0);   // the split ends inside a group
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&empty[s]);
      }
      hop::bar_sync(1, 32 * gv::CONSUMERS);   // every consumer has left the ring
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = 2 * tq + e;
            if (m < m_rows) red[m * gv::BN + col0 + 2 * t + h] = acc[t][2 * h + e];
          }
    } else {
      const float* xf = reinterpret_cast<const float*>(gv_smem) + 2 * tq;
      float acc[M][4], dot[M][4], xs[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        xs[m] = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = dot[m][c] = 0.f;
      }
      auto flush = [&](const uint8_t* base, int g0) {
        float sv[4], zv[4];
        scale_rows(base, g0, sv, zv);
#pragma unroll
        for (int m = 0; m < M; ++m) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[m][c] += dot[m][c] * sv[c] - xs[m] * zv[c];
            dot[m][c] = 0.f;
          }
          xs[m] = 0.f;
        }
        ++g_cur;
      };
      for (int i = 0; i < nst; ++i) {
        const int s = i % stages;
        hop::mbar_wait(&full[s], (i / stages) & 1);
        const uint8_t* base = ring + s * SB;
        const int g0 = (s_begin + i) * F::KS / G;
        for (int q = 0; q < SUB; ++q) {
          uint32_t lo0[4], lo1[4], hi0[4], hi1[4];
          words(base, q, lo0, lo1, hi0, hi1);
          const float* xp = xf + 64 * (i * SUB + q);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            float qv[4][2];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if constexpr (W3) {   // field u of the moved lo words, bit u of the moved hi words
                qv[c][0] = static_cast<float>(((lo0[c] >> (2 * u)) & 3u) | (((hi0[c] >> u) & 1u) << 2));
                qv[c][1] = static_cast<float>(((lo1[c] >> (2 * u)) & 3u) | (((hi1[c] >> u) & 1u) << 2));
              } else {
                qv[c][0] = nibble_f32(lo0[c], u);
                qv[c][1] = nibble_f32(lo1[c], u);
              }
            }
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const float2 xv = *reinterpret_cast<const float2*>(xp + m * L.xw + 8 * u);
              xs[m] += xv.x + xv.y;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                dot[m][c] = fmaf(xv.y, qv[c][1], fmaf(xv.x, qv[c][0], dot[m][c]));
            }
            left -= 8;
            if (left == 0) {
              flush(base, g0);
              left = G;
            }
          }
        }
        if (i == nst - 1 && left != G) flush(base, g0);
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&empty[s]);
      }
      hop::bar_sync(1, 32 * gv::CONSUMERS);   // every consumer has left the ring
      // the four lanes of a column hold its channels 2tq, 2tq + 1 of each unit
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = acc[m][c];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (c == tq) red[m * gv::BN + col0 + c] = v;
        }
    }
  }

  // the output: one block writes its tile; a cluster's ranks each add a
  // slice of the tile over the ranks in order 0, 1, ... (deterministic)
  const float* red = reinterpret_cast<const float*>(ring);
  const int n_out = m_rows * gv::BN;
  auto emit = [&](int idx, float v) {
    const int m = idx / gv::BN, n = n0 + idx % gv::BN;
    if (n >= OC) return;
    T r = from_f32<T>(v);
    if (bias) r = from_f32<T>(to_f32<T>(r) + to_f32<T>(bias[n]));
    out[(size_t)m * OC + n] = r;
  };
  if (splits == 1) {
    if (warp == gv::CONSUMERS) return;
    hop::bar_sync(1, 32 * gv::CONSUMERS);
    for (int idx = tid; idx < n_out; idx += 32 * gv::CONSUMERS) emit(idx, red[idx]);
  } else {
    hop::cluster_sync();
    const int lo = split * n_out / splits, hi = (split + 1) * n_out / splits;
    if (warp < gv::CONSUMERS)
      for (int idx = lo + tid; idx < hi; idx += 32 * gv::CONSUMERS) {
        float v = 0.f;
        for (int q = 0; q < splits; ++q)
          v += gv::ld_cluster_f32(hop::cluster_map(red + idx, q));
        emit(idx, v);
      }
    hop::cluster_sync();   // the peers are done reading this block's sums
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

// The most groups one stage of KS channels spans.
static int stage_groups(int IC, int G, int KS) {
  int ns = 1;
  for (int k0 = 0; k0 < IC; k0 += KS) ns = std::max(ns, (k0 + KS - 1) / G - k0 / G + 1);
  return ns;
}

// One GEMV launch over the host plan (ops/w4a16.py::gemv_plan): grid
// (splits, column tiles), the splits of a tile one cluster. The plan is
// checked, not adjusted: one the kernel cannot run returns
// cudaErrorInvalidValue.
template <typename T, bool W3, bool TC, int M>
int gemv_launch(const void* x, const void* qw, const void* scales, const void* szeros,
                const void* bias, void* out, int m_rows, int IC, int OC, int G, int splits,
                int stages, int vec, cudaStream_t st) {
  using F = gv::Fmt<W3>;
  static int smem_set = 0;
  const int ns = stage_groups(IC, G, F::KS);
  const int range = (IC / F::KS + splits - 1) / splits * F::KS;
  const gv::Layout L = gv::layout(TC, m_rows, range, G, stages, gv::stage_bytes(F::ROWS, ns));
  if (splits < 1 || splits > gv::MAX_CLUSTER || splits > IC / F::KS || stages < 2 ||
      stages > gv::MAX_STAGES || L.total > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = w4a16_gemv_kernel<T, W3, TC, M>;
  const int err = hop::allow_smem(kernel, L.total, &smem_set);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(splits, cdiv(OC, gv::BN));
  cfg.blockDim = dim3(gv::THREADS);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const int32_t*>(qw),
      static_cast<const float*>(scales), static_cast<const float*>(szeros),
      static_cast<const T*>(bias), static_cast<T*>(out), m_rows, IC, OC, G, ns, stages, vec);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The CUDA-core body at M rows (f32 x, or a group size that is no
// multiple of 16).
template <typename T, bool W3>
int gemv_fma(const void* x, const void* qw, const void* s, const void* sz, const void* bias,
             void* out, int M, int IC, int OC, int G, int splits, int stages, int vec,
             cudaStream_t st) {
#define AWQ_GEMV_M(m_) case m_: return gemv_launch<T, W3, false, m_>(x, qw, s, sz, bias, out, M, IC, OC, G, splits, stages, vec, st);
  switch (M) {
    AWQ_GEMV_M(1) AWQ_GEMV_M(2) AWQ_GEMV_M(3) AWQ_GEMV_M(4)
    AWQ_GEMV_M(5) AWQ_GEMV_M(6) AWQ_GEMV_M(7) AWQ_GEMV_M(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AWQ_GEMV_M
}

template <typename T, bool W3>
int gemv(const void* x, const void* qw, const void* s, const void* sz, const void* bias,
         void* out, int M, int IC, int OC, int G, int splits, int stages, int vec,
         cudaStream_t st) {
  if (M < 1 || M > 8) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (!std::is_same<T, float>::value) {
    if (G % 16 == 0)
      return gemv_launch<T, W3, true, 8>(x, qw, s, sz, bias, out, M, IC, OC, G, splits, stages,
                                         vec, st);
  }
  return gemv_fma<T, W3>(x, qw, s, sz, bias, out, M, IC, OC, G, splits, stages, vec, st);
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
               const void* bias, void* out, int M, int IC, int OC, int G, int splits,
               int stages, int vec, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return gemv<float, W3>(x, qw, scales, szeros, bias, out, M, IC, OC, G, splits,
                                   stages, vec, st);
    case 1: return gemv<bf16, W3>(x, qw, scales, szeros, bias, out, M, IC, OC, G, splits,
                                  stages, vec, st);
    case 2: return gemv<__half, W3>(x, qw, scales, szeros, bias, out, M, IC, OC, G, splits,
                                    stages, vec, st);
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
