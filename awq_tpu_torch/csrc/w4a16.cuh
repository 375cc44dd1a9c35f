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
// (b) w4a16_gemm_kernel, M > 8 (prefill). Bound by tensor-core operations at
//     prefill lengths (2·M·IC·OC FLOPs against IC·OC/2 code bytes). One
//     block computes a 64x128 output tile: per 64-channel step it stages
//     the x tile and dequantizes the code tile (q*s - sz, rounded to the
//     tile's type exactly as the plain version rounds it to x.dtype) into
//     shared memory, then 8 warps run mma.sync m16n8k16 with f32
//     accumulators: bf16 for bf16 x, f16 for f16 x, and bf16 for f32 x,
//     whose x and dequantized weights are rounded to bf16 (about 3
//     significant digits; the plain version keeps f32). Single-stage and
//     synchronous: wgmma, TMA and a multistage pipeline are later work.
//
// OC need not be a multiple of 128 (qwen2/falcon widths): both kernels mask
// the column edge; the GEMV takes 16-byte loads only where the caller says
// the rows are 16-byte aligned (OC % 4 == 0), else 4-byte loads.
#pragma once

#include "common.cuh"

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

constexpr int GEMM_BM = 64, GEMM_BN = 128, GEMM_BK = 64, GEMM_PAD = 8;

// 8 consecutive elements of x as 8 MT values in one uint4.
template <typename T, typename MT>
__device__ __forceinline__ uint4 load_x8(const T* p) {
  if constexpr (sizeof(T) == 2) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    return make_uint4(pack2<MT>(a.x, a.y), pack2<MT>(a.z, a.w), pack2<MT>(b.x, b.y),
                      pack2<MT>(b.z, b.w));
  }
}

// WHOLE: G is a multiple of 64, so a 64-channel step lies in one group.
template <typename T, bool W3, bool WHOLE>
__global__ void __launch_bounds__(256) w4a16_gemm_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ qw,
    const float* __restrict__ scales, const float* __restrict__ szeros,
    const T* __restrict__ bias, T* __restrict__ out, int M, int IC, int OC, int G) {
  using MT = typename MmaOf<T>::type;
  // padded rows (72 elements = 36 words) keep the fragment reads conflict-free
  __shared__ __align__(16) MT As[GEMM_BM][GEMM_BK + GEMM_PAD];
  __shared__ __align__(16) MT Bs[GEMM_BN][GEMM_BK + GEMM_PAD];  // [n][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 32x32 each
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < IC; k0 += GEMM_BK) {
    // x tile: 64 rows x 8 vectors of 8 elements
    for (int i = tid; i < GEMM_BM * (GEMM_BK / 8); i += 256) {
      const int r = i / (GEMM_BK / 8), v = i % (GEMM_BK / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) val = load_x8<T, MT>(x + (size_t)(m0 + r) * IC + k0 + v * 8);
      *reinterpret_cast<uint4*>(&As[r][v * 8]) = val;
    }
    // code tile of this 64-channel step, channels k0 + 8u + r. Thread
    // (n, j) takes rows r = 2j and 2j + 1 of column n, whose unit u codes
    // are channels 8u + 2j and 8u + 2j + 1: one pair per u. W4: word rows
    // k0/8 + r, nibble u. W3: step q of 256-chunk c, unit 8q + u: lo word
    // 24c + 8(q >> 1) + r field 8(q & 1) + u, hi word 24c + 16 + r bit 8q + u.
    for (int i = tid; i < GEMM_BN * 4; i += 256) {
      const int n = i % GEMM_BN, j = i / GEMM_BN;
      const int col = n0 + n;
      const int c = k0 / 256, q = (k0 / 64) & 3;
      uint32_t a0 = 0, a1 = 0, h0 = 0, h1 = 0;
      if (col < OC) {
        if constexpr (W3) {
          const int32_t* lo = qw + (size_t)(24 * c + 8 * (q >> 1) + 2 * j) * OC + col;
          const int32_t* hi = qw + (size_t)(24 * c + 16 + 2 * j) * OC + col;
          a0 = lo[0]; a1 = lo[OC]; h0 = hi[0]; h1 = hi[OC];
        } else {
          a0 = qw[(size_t)(k0 / 8 + 2 * j) * OC + col];
          a1 = qw[(size_t)(k0 / 8 + 2 * j + 1) * OC + col];
        }
      }
      // one group per step (WHOLE), else one per unit
      const int g0 = k0 / G;
      float s = col < OC ? scales[(size_t)g0 * OC + col] : 0.f;
      float z = col < OC ? szeros[(size_t)g0 * OC + col] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (!WHOLE && col < OC) {
          const int g = (k0 + 8 * u) / G;
          s = scales[(size_t)g * OC + col];
          z = szeros[(size_t)g * OC + col];
        }
        float c0, c1;
        if constexpr (W3) {
          const int f = 8 * (q & 1) + u, b = 8 * q + u;
          c0 = __uint_as_float(0x4B000000u | ((a0 >> (2 * f)) & 3u) | (((h0 >> b) & 1u) << 2)) - 8388608.0f;
          c1 = __uint_as_float(0x4B000000u | ((a1 >> (2 * f)) & 3u) | (((h1 >> b) & 1u) << 2)) - 8388608.0f;
        } else {
          c0 = nibble_f32(a0, u);
          c1 = nibble_f32(a1, u);
        }
        const float lo = __fsub_rn(__fmul_rn(c0, s), z);
        const float hi = __fsub_rn(__fmul_rn(c1, s), z);
        *reinterpret_cast<uint32_t*>(&Bs[n][8 * u + 2 * j]) = pack2<MT>(lo, hi);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + gq;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * tq]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * tq]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 8 + 2 * tq]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 8 + 2 * tq]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + gq;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Bs[n][kk + 2 * tq]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Bs[n][kk + 8 + 2 * tq]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_16816<MT>(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm * 32 + mi * 16 + gq + half * 8;
        if (r >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + ni * 8 + 2 * tq + e;
          if (col >= OC) continue;
          T v = from_f32<T>(acc[mi][ni][half * 2 + e]);
          if (bias) v = from_f32<T>(to_f32<T>(v) + to_f32<T>(bias[col]));
          out[(size_t)r * OC + col] = v;
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

template <typename T, bool W3>
int gemm(const void* x, const void* qw, const void* scales, const void* szeros,
         const void* bias, void* out, int M, int IC, int OC, int G, cudaStream_t st) {
  const dim3 grid(cdiv(OC, GEMM_BN), cdiv(M, GEMM_BM));
  auto kernel = G % 64 == 0 ? w4a16_gemm_kernel<T, W3, true> : w4a16_gemm_kernel<T, W3, false>;
  kernel<<<grid, 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(qw),
      static_cast<const float*>(scales), static_cast<const float*>(szeros),
      static_cast<const T*>(bias), static_cast<T*>(out), M, IC, OC, G);
  return static_cast<int>(cudaGetLastError());
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

template <bool W3>
int gemm_entry(const void* x, const void* qw, const void* scales, const void* szeros,
               const void* bias, void* out, int M, int IC, int OC, int G, int dtype,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return gemm<float, W3>(x, qw, scales, szeros, bias, out, M, IC, OC, G, st);
    case 1: return gemm<bf16, W3>(x, qw, scales, szeros, bias, out, M, IC, OC, G, st);
    case 2: return gemm<__half, W3>(x, qw, scales, szeros, bias, out, M, IC, OC, G, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
