// K1: W4A16 dequant matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernels of awq_tpu/ops/w4a16.py: w4a16_matmul_pallas
// (_w4a16_kernel), w4a16_matmul_stacked (_w4a16_kernel_stacked) and the
// TPU-only tiled/folded layouts (w4a16_matmul_stacked_tiled,
// w4a16_matmul_stacked_tiled_folded), which all compute
//     y[M, OC] = x[M, IC] @ (q * s - sz)      (+ bias), f32 accumulation
// with q the int4 codes of pack_int4 (int32 [IC/8, OC]; input channel
// ic = 64c + 8s + r sits in word 8c + r, nibble s), s = scales and
// sz = szeros = scales * zeros, both f32 [IC/G, OC].
//
// Layout: the kernels read pack_int4's layout as it is (no repack at load):
// OC is the contiguous axis, so threads that walk OC read coalesced words,
// and one word row serves eight input channels of one column.
//
// (a) w4a16_gemv_kernel, M <= 8 (decode). Bound by device memory: every
//     code byte is read once per token (0.5 B per weight, plus 8 B of
//     scales per group column), and the work per byte is a few FMAs. Design:
//     each thread owns 4 adjacent columns and loads one 16-byte int4 vector
//     per word row (a warp reads 512 contiguous bytes); the 8 warps of a
//     block take the 8 word rows of each 64-channel chunk (warp y = row r),
//     so x, staged once in shared memory as f32, is a broadcast read. IC is
//     split over gridDim.y (split-K, 512 channels per block) so that even
//     OC = 4096 puts 256+ blocks on the 132 SMs; the splits write f32
//     partials that a second kernel sums in a fixed order (deterministic,
//     no atomics) and rounds to bf16, adding the bias. Per group the
//     matmul-then-scale identity of the TPU kernel is kept:
//     y += s_g * sum(x*q) - sum(x) * sz_g, so the inner loop is one FMA per
//     code and m, and codes become floats by a mantissa OR (nibble_f32).
// (b) w4a16_gemm_kernel, M > 8 (prefill). Bound by tensor-core operations
//     at prefill lengths (2·M·IC·OC FLOPs against IC·OC/2 code bytes). One
//     block computes a 64x128 output tile: per 64-channel chunk it stages
//     the x tile and dequantizes the code tile (q*s - sz, rounded to bf16
//     exactly as the plain version does) into shared memory, then 8 warps
//     run mma.sync m16n8k16 bf16 with f32 accumulators. Single-stage and
//     synchronous: wgmma, TMA and a multistage pipeline are later work.
//
// OC need not be a multiple of 128 (qwen2/falcon widths): both kernels mask
// the column edge; the GEMV takes 16-byte loads only where the caller says
// the rows are 16-byte aligned (OC % 4 == 0), else 4-byte loads.
#include "common.cuh"

namespace {

constexpr int GEMV_WARPS = 8;            // = word rows per 64-channel chunk
constexpr int GEMV_COLS = 4;             // columns per thread
constexpr int GEMV_TILE_N = 32 * GEMV_COLS;
constexpr int GEMV_MAX_SPLIT_K = 512;    // input channels per block

template <int M>
__global__ void __launch_bounds__(256) w4a16_gemv_kernel(
    const bf16* __restrict__ x, const int32_t* __restrict__ qw,
    const float* __restrict__ scales, const float* __restrict__ szeros,
    float* __restrict__ partial, int IC, int OC, int G, int split_k, int vec) {
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
    xs[m][k] = __bfloat162float(x[(size_t)m * IC + k0 + k]);
  }
  __syncthreads();

  const bool full = vec && (n0 + GEMV_COLS <= OC);
  float acc[M][GEMV_COLS];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = 0.f;

  const int chunks_per_group = G / 64;
  for (int c0 = 0; c0 < klen / 64; c0 += chunks_per_group) {
    float dot[M][GEMV_COLS];
    float xsum[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      xsum[m] = 0.f;
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) dot[m][j] = 0.f;
    }
    for (int cc = 0; cc < chunks_per_group; ++cc) {
      const int c = c0 + cc;  // chunk within this split
      const int32_t* row = qw + (size_t)(k0 / 8 + c * 8 + warp) * OC;
      int32_t w[GEMV_COLS];
      if (full) {
        const int4 v = *reinterpret_cast<const int4*>(row + n0);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) w[j] = (n0 + j < OC) ? row[n0 + j] : 0;
      }
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int kl = c * 64 + s * 8 + warp;
        float qv[GEMV_COLS];
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) qv[j] = nibble_f32(w[j], s);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float xv = xs[m][kl];
          xsum[m] += xv;
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j) dot[m][j] = fmaf(xv, qv[j], dot[m][j]);
        }
      }
    }
    const int g = (k0 + c0 * 64) / G;
    float sc[GEMV_COLS], sz[GEMV_COLS];
    if (full) {
      const float4 a = *reinterpret_cast<const float4*>(scales + (size_t)g * OC + n0);
      const float4 b = *reinterpret_cast<const float4*>(szeros + (size_t)g * OC + n0);
      sc[0] = a.x; sc[1] = a.y; sc[2] = a.z; sc[3] = a.w;
      sz[0] = b.x; sz[1] = b.y; sz[2] = b.z; sz[3] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j) {
        const bool in = n0 + j < OC;
        sc[j] = in ? scales[(size_t)g * OC + n0 + j] : 0.f;
        sz[j] = in ? szeros[(size_t)g * OC + n0 + j] : 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < GEMV_COLS; ++j)
        acc[m][j] += dot[m][j] * sc[j] - xsum[m] * sz[j];
  }

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

// out[m, n] = bf16(sum over splits) (+ bias, added in bf16 as the plain
// version adds it); the splits are summed in index order.
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const bf16* __restrict__ bias,
                                     bf16* __restrict__ out, int M, int OC,
                                     int nsplit) {
  const size_t n_out = (size_t)M * OC;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n_out;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) s += partial[sp * n_out + i];
    bf16 r = __float2bfloat16_rn(s);
    if (bias) r = __float2bfloat16_rn(__bfloat162float(r) + __bfloat162float(bias[i % OC]));
    out[i] = r;
  }
}

constexpr int GEMM_BM = 64, GEMM_BN = 128, GEMM_BK = 64, GEMM_PAD = 8;

__global__ void __launch_bounds__(256) w4a16_gemm_kernel(
    const bf16* __restrict__ x, const int32_t* __restrict__ qw,
    const float* __restrict__ scales, const float* __restrict__ szeros,
    const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int IC,
    int OC, int G) {
  // padded rows (72 bf16 = 36 words) keep the fragment reads conflict-free
  __shared__ __align__(16) bf16 As[GEMM_BM][GEMM_BK + GEMM_PAD];
  __shared__ __align__(16) bf16 Bs[GEMM_BN][GEMM_BK + GEMM_PAD];  // [n][k]
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
    // x tile: 64 rows x 8 vectors of 8 bf16
    for (int i = tid; i < GEMM_BM * (GEMM_BK / 8); i += 256) {
      const int r = i / (GEMM_BK / 8), v = i % (GEMM_BK / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * IC + k0 + v * 8);
      *reinterpret_cast<uint4*>(&As[r][v * 8]) = val;
    }
    // code tile of chunk c = k0/64: word rows 8c..8c+7. Thread (n, j) reads
    // rows 2j and 2j+1 of column n, whose nibble s are channels 8s+2j and
    // 8s+2j+1: one bf16 pair per s.
    const int c = k0 / 64;
    const int g = k0 / G;
    for (int i = tid; i < GEMM_BN * 4; i += 256) {
      const int n = i % GEMM_BN, j = i / GEMM_BN;
      const int col = n0 + n;
      int32_t w0 = 0, w1 = 0;
      float s = 0.f, z = 0.f;
      if (col < OC) {
        w0 = qw[(size_t)(8 * c + 2 * j) * OC + col];
        w1 = qw[(size_t)(8 * c + 2 * j + 1) * OC + col];
        s = scales[(size_t)g * OC + col];
        z = szeros[(size_t)g * OC + col];
      }
#pragma unroll
      for (int s8 = 0; s8 < 8; ++s8) {
        const float lo = __fsub_rn(__fmul_rn(nibble_f32(w0, s8), s), z);
        const float hi = __fsub_rn(__fmul_rn(nibble_f32(w1, s8), s), z);
        *reinterpret_cast<uint32_t*>(&Bs[n][8 * s8 + 2 * j]) = pack_bf16x2(lo, hi);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + gq;
        a[mi][0] = ld_u32(&As[r][kk + 2 * tq]);
        a[mi][1] = ld_u32(&As[r + 8][kk + 2 * tq]);
        a[mi][2] = ld_u32(&As[r][kk + 8 + 2 * tq]);
        a[mi][3] = ld_u32(&As[r + 8][kk + 8 + 2 * tq]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + gq;
        const uint32_t b0 = ld_u32(&Bs[n][kk + 2 * tq]);
        const uint32_t b1 = ld_u32(&Bs[n][kk + 8 + 2 * tq]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16_16816(acc[mi][ni], a[mi], b0, b1);
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
          bf16 v = __float2bfloat16_rn(acc[mi][ni][half * 2 + e]);
          if (bias) v = __float2bfloat16_rn(__bfloat162float(v) + __bfloat162float(bias[col]));
          out[(size_t)r * OC + col] = v;
        }
      }
}

template <int M>
void launch_gemv(const bf16* x, const int32_t* qw, const float* s,
                 const float* sz, float* partial, int IC, int OC, int G,
                 int split_k, int vec, cudaStream_t st) {
  const dim3 grid(cdiv(OC, GEMV_TILE_N), cdiv(IC, split_k));
  const dim3 block(32, GEMV_WARPS);
  w4a16_gemv_kernel<M><<<grid, block, 0, st>>>(x, qw, s, sz, partial, IC, OC, G, split_k, vec);
}

}  // namespace

// Caller guarantees: x bf16 [M, IC] contiguous, qw int32 [IC/8, OC],
// scales/szeros f32 [IC/G, OC], bias bf16 [OC] or null, out bf16 [M, OC],
// partial f32 [ceil(IC/split_k), M, OC]; 1 <= M <= 8; G % 64 == 0,
// split_k % G == 0, split_k <= 512, IC % G == 0.
extern "C" int awq_w4a16_gemv(const void* x, const void* qw, const void* scales,
                              const void* szeros, const void* bias, void* out,
                              void* partial, int M, int IC, int OC, int G,
                              int split_k, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int32_t* q = static_cast<const int32_t*>(qw);
  const float* s = static_cast<const float*>(scales);
  const float* sz = static_cast<const float*>(szeros);
  float* p = static_cast<float*>(partial);
  switch (M) {
    case 1: launch_gemv<1>(xb, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 2: launch_gemv<2>(xb, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 3: launch_gemv<3>(xb, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 4: launch_gemv<4>(xb, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 5: launch_gemv<5>(xb, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 6: launch_gemv<6>(xb, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 7: launch_gemv<7>(xb, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    case 8: launch_gemv<8>(xb, q, s, sz, p, IC, OC, G, split_k, vec, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_out = (size_t)M * OC;
  const int threads = 256;
  const int blocks = static_cast<int>((n_out + threads - 1) / threads < 65535
                                          ? (n_out + threads - 1) / threads
                                          : 65535);
  splitk_reduce_kernel<<<blocks, threads, 0, st>>>(
      p, static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, OC,
      cdiv(IC, split_k));
  return static_cast<int>(cudaGetLastError());
}

// Caller guarantees: x bf16 [M, IC] contiguous and 16-byte aligned, IC % 64
// == 0, G % 64 == 0; the other operands as for awq_w4a16_gemv.
extern "C" int awq_w4a16_gemm(const void* x, const void* qw, const void* scales,
                              const void* szeros, const void* bias, void* out,
                              int M, int IC, int OC, int G, void* stream) {
  const dim3 grid(cdiv(OC, GEMM_BN), cdiv(M, GEMM_BM));
  w4a16_gemm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int32_t*>(qw),
      static_cast<const float*>(scales), static_cast<const float*>(szeros),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, IC, OC, G);
  return static_cast<int>(cudaGetLastError());
}
