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
//       one block per row.
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
// K10 (w4a8_gemm_kernel) keeps the first design: one block computes a
// 128x128 output tile with 8 warps (2 x 4, each 64x32) running mma.sync
// m16n8k32 s8·s8 -> s32; per 64-channel step it stages the int8 x tile
// and the requantized weight tile in shared memory (rows padded to 80
// bytes, which keeps every fragment read conflict-free). Single-stage and
// synchronous. blockIdx.x walks M, so the blocks that run together share
// one weight column tile and re-read the small x from L2.
//
// K10's requant is ALU work repeated once per M tile: a prologue computes
// scol for the block's 128 columns from the scales alone (IC/G reads per
// column), then each step turns its 8 code rows x 128 columns into int8 in
// shared memory (two threads per column, four words each; the four codes
// of one nibble slot are four consecutive channels, one 32-bit store).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int QBM = 128, QBN = 128, QBK = 64, QROW = QBK + 16;  // bytes per smem row

// D += A·B on one m16n8k32 tile, int8 inputs, int32 accumulators.
// A (16x32, row-major): a[0] = (row g, k 4t..4t+3), a[1] = (row g+8, same k),
// a[2] = (row g, k 16+4t..16+4t+3), a[3] = (row g+8, k 16+4t..).
// B (32x8, k-major): b0 = (k 4t..4t+3, col g), b1 = (k 16+4t.., col g).
// C: c[0..1] = (row g, cols 2t, 2t+1), c[2..3] = (row g+8, same cols);
// g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_s32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 128 + nibble s of a pack_int4 word, exact: the code in the mantissa of 2^7.
__device__ __forceinline__ float code128_f32(uint32_t w, int s) {
  return __uint_as_float(0x43000000u | (((w >> (4 * s)) & 0xFu) << 16));
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

template <typename T>
__global__ void __launch_bounds__(256) quant_per_token_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int IC) {
  __shared__ float red[8];
  const int m = blockIdx.x, tid = threadIdx.x;
  const T* row = x + (size_t)m * IC;
  float amax = 0.f;
  for (int k = tid; k < IC; k += 256) amax = fmaxf(amax, fabsf(to_f32<T>(row[k])));
  amax = warp_max(amax);
  if ((tid & 31) == 0) red[tid >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < 8; ++w) amax = fmaxf(amax, red[w]);
  const float scale = __fmul_rn(fmaxf(amax, 1e-5f), 1.f / 127.f);
  if (tid == 0) sx[m] = scale;
  int8_t* out = xq + (size_t)m * IC;
  for (int k = tid; k < IC; k += 256)
    out[k] = static_cast<int8_t>(
        clamp_int(__float2int_rn(__fdiv_rn(to_f32<T>(row[k]), scale)), -128, 127));
}

// K10: int8 x against the W4 codes requantized per column in shared memory.
template <typename T>
__global__ void __launch_bounds__(256) w4a8_gemm_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx,
    const int32_t* __restrict__ qw, const float* __restrict__ scales,
    const float* __restrict__ szeros, T* __restrict__ out, int M, int IC, int OC, int G,
    float col_ratio) {
  __shared__ __align__(16) int8_t As[QBM][QROW];
  __shared__ __align__(16) int8_t Bs[QBN][QROW];   // [n][k]
  __shared__ float scol_s[QBN], inv_s[QBN], red[2][QBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps, 64x32 each
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * QBM, n0 = blockIdx.y * QBN;

  {
    // scol of the block's columns: two threads per column, half the groups each
    const int n = tid & (QBN - 1), half = tid >> 7, col = n0 + n;
    float smax = 0.f;
    if (col < OC)
      for (int g = half; g < IC / G; g += 2)
        smax = fmaxf(smax, bf16r(scales[(size_t)g * OC + col]));
    red[half][n] = smax;
    __syncthreads();
    if (tid < QBN) {
      const float sc = fmaxf(__fmul_rn(fmaxf(red[0][tid], red[1][tid]), col_ratio), 1e-12f);
      scol_s[tid] = sc;
      inv_s[tid] = __fdiv_rn(1.f, sc);
    }
    __syncthreads();
  }

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < IC; k0 += QBK) {
    // x tile: 128 rows x 4 vectors of 16 codes
    for (int i = tid; i < QBM * (QBK / 16); i += 256) {
      const int r = i >> 2, v = i & 3;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) val = *reinterpret_cast<const uint4*>(xq + (size_t)(m0 + r) * IC + k0 + 16 * v);
      *reinterpret_cast<uint4*>(&As[r][16 * v]) = val;
    }
    {
      // thread (n, j) requantizes word rows k0/8 + 4j + i (i < 4) of column
      // n: nibble u of row r is channel k0 + 8u + r. G % 64 == 0, so the
      // step lies in one group.
      const int n = tid & (QBN - 1), j = tid >> 7, col = n0 + n;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      float zz = 128.f, f = 0.f;   // a column past OC requantizes to 0
      if (col < OC) {
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = qw[(size_t)(k0 / 8 + 4 * j + i) * OC + col];
        const size_t gi = (size_t)(k0 / G) * OC + col;
        const float s = bf16r(scales[gi]), sz = bf16r(szeros[gi]);
        zz = __fadd_rn(128.f, __fdiv_rn(sz, s));
        f = __fmul_rn(s, inv_s[n]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        uint32_t packed = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wf = __fmul_rn(__fsub_rn(code128_f32(w[i], u), zz), f);
          const int q = clamp_int(__float2int_rn(wf), -127, 127);
          packed |= (static_cast<uint32_t>(q) & 0xFFu) << (8 * i);
        }
        *reinterpret_cast<uint32_t*>(&Bs[n][8 * u + 4 * j]) = packed;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QBK; kk += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + gq;
        a[mi][0] = ld_s32(&As[r][kk + 4 * tq]);
        a[mi][1] = ld_s32(&As[r + 8][kk + 4 * tq]);
        a[mi][2] = ld_s32(&As[r][kk + 16 + 4 * tq]);
        a[mi][3] = ld_s32(&As[r + 8][kk + 16 + 4 * tq]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + gq;
        const uint32_t b0 = ld_s32(&Bs[n][kk + 4 * tq]);
        const uint32_t b1 = ld_s32(&Bs[n][kk + 16 + 4 * tq]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_s8_16832(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

  // y = (f32(acc) * scol) * sx, rounded once to T
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = wn * 32 + ni * 8 + 2 * tq + e, col = n0 + c;
      if (col >= OC) continue;
      const float sc = scol_s[c];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + wm * 64 + mi * 16 + gq + half * 8;
          if (r >= M) continue;
          const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + e]), sc),
                                    sx[r]);
          out[(size_t)r * OC + col] = from_f32<T>(v);
        }
    }
}

template <typename T>
int quant_launch(const void* x, void* xq, void* sx, int M, int IC, cudaStream_t st) {
  quant_per_token_kernel<T><<<M, 256, 0, st>>>(static_cast<const T*>(x),
                                               static_cast<int8_t*>(xq),
                                               static_cast<float*>(sx), IC);
  return static_cast<int>(cudaGetLastError());
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

template <typename T>
int k10_launch(const void* xq, const void* sx, const void* qw, const void* scales,
               const void* szeros, void* out, int M, int IC, int OC, int G, cudaStream_t st) {
  const dim3 grid(cdiv(M, QBM), cdiv(OC, QBN));
  w4a8_gemm_kernel<T><<<grid, 256, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int32_t*>(qw), static_cast<const float*>(scales),
      static_cast<const float*>(szeros), static_cast<T*>(out), M, IC, OC, G,
      static_cast<float>(15.0 / 127.0));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Caller guarantees: x [M, IC] contiguous of dtype code `dtype` (0 f32,
// 1 bf16, 2 f16), xq int8 [M, IC], sx f32 [M]; M >= 1.
extern "C" int awq_quant_per_token(const void* x, void* xq, void* sx, int M, int IC,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return quant_launch<float>(x, xq, sx, M, IC, st);
    case 1: return quant_launch<bf16>(x, xq, sx, M, IC, st);
    case 2: return quant_launch<__half>(x, xq, sx, M, IC, st);
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

// K10. Caller guarantees: xq, sx, out as for awq_w8a8_gemm; qw int32
// [IC/8, OC] in pack_int4's layout, scales/szeros f32 [IC/G, OC];
// G % 64 == 0, IC % G == 0.
extern "C" int awq_w4a8_gemm(const void* xq, const void* sx, const void* qw,
                             const void* scales, const void* szeros, void* out, int M,
                             int IC, int OC, int G, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return k10_launch<float>(xq, sx, qw, scales, szeros, out, M, IC, OC, G, st);
    case 1: return k10_launch<bf16>(xq, sx, qw, scales, szeros, out, M, IC, OC, G, st);
    case 2: return k10_launch<__half>(xq, sx, qw, scales, szeros, out, M, IC, OC, G, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
