// K4: the whole-token (and whole-layer) W4A16 decode megakernel for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of awq_tpu/ops/megakernel.py:
// w4a16_llama_token_step (_token_kernel) and w4a16_llama_layer_step
// (_mega_kernel). One launch runs decoder layers [layer0, layer0 + n) of a
// llama-family model for ONE token, per layer
//   x = rmsnorm(h)·ln1; qkv = x @ W4(wqkv) (+ bias); rope(q, k);
//   GQA attention of q over cache [0, length) plus the current k/v;
//   h1 = h + attn @ W4(wo); xm = rmsnorm(h1)·ln2;
//   hm = silu(xm @ W4(gate))·(xm @ W4(up)); h = h1 + hm @ W4(down)
// (the residual rounded to bf16 between layers in the token entry), then
// optionally the final rmsnorm and a W4 head into f32 logits. The new k/v
// are written into the cache at `length` in place, and returned.
//
// What bounds it on the H100: device memory. A token streams every W4 code
// once (0.5 B per weight, plus 8 B of f32 scale and szero per group column)
// and the KV prefix once; at Llama-3-8B width that is 4.22 GB of weights and
// head, 1.26 ms at 3.35 TB/s. The TPU kernel was one grid step streaming
// blocks through VMEM by manual DMA; here one launch must keep all 132 SMs
// streaming, and what it does about that:
// - a persistent grid of as many 256-thread blocks as fit on the card at
//   once (cudaOccupancyMaxActiveBlocksPerMultiprocessor after the dynamic
//   shared-memory attribute is set), launched with
//   cudaLaunchCooperativeKernel, so the grid-wide barrier
//   (cooperative_groups::this_grid().sync()) between dependent phases is
//   valid: six per layer (QKV | attention | combine | o-proj | gate/up |
//   down);
// - every matmul phase hands out 32-column tiles over the full IC (OC/32
//   tiles: 128 for wo and down, 448 gate/up pairs, 4008 for the head) to
//   the grid's one block an SM, so no cross-block split-K and the result is
//   deterministic; inside a block the 8 warps take whole quantization groups
//   and sum them in shared memory in a fixed order;
// - a warp loads its next group's code words while it computes on the
//   current one, so the HBM latency is paid once per tile;
// - the products run on the tensor cores, as the TPU kernel ran them on
//   its MXU: a lane loads 16 bytes (4 columns) of a pack_int4 word row
//   (input channel 64c + 8s + r in word 8c + r, nibble s, read as stored)
//   and turns each word into bf16 pairs with one shift and one LOP3 per
//   pair ((w >> 4t) & 0x000F000F | 0x43004300 is 128 + q in bf16, exactly),
//   the B operand of mma.sync m16n8k16; the A operand is x in the matching
//   permuted channel order. A first version did the products on the CUDA
//   cores (a float per nibble, one FMA each) and was bound by instruction
//   issue at about a third of the HBM rate (4.6 ms per token). The JAX
//   kernel's per-group identity s·Σ bf16(x)·q − sz·Σ bf16(x) is kept with
//   the codes biased by 128 as the JAX kernels bias them:
//   s·Σ bf16(x)·(128 + q) − (128·s + sz)·Σ bf16(x), f32 accumulation, the
//   group sums of bf16(x) computed once;
// - the input row of a phase (rmsnorm of the residual, the attention
//   output or SiLU·mul) is rebuilt by each block in shared memory, rounded
//   to bf16 and permuted, which saves a barrier per norm; an rmsnorm loads
//   its row and the norm weights once, before its block sum;
// - gate column j and up column I + j go to the same block, so SiLU·mul is
//   fused into the gate/up phase;
// - attention is split over (kv head, position slice) items with an online
//   softmax per warp, and a combine phase merges the slices.
// The body is bound by the latency of its per-group work and of its
// stagings and barriers more than by bytes (PERF.md, the phase clocks of
// scripts/exp_mega_phases.py). Measured slower on the H100 and not kept:
// a weight stream through a cp.async ring a warp that runs through the
// barriers, with wo, down and gate/up split over IC and merged by the last
// block to arrive (4.67-5.5 ms a token: the per-lane copies take issue
// slots on the critical path, and a merge's __threadfence waits for the
// warp's copies in flight); the next phase's first group copied into shared
// memory before each barrier (+0.74 ms a token); the combine folded into
// the attention phase by the last slice to finish (+0.2 ms: its fence,
// atomic and serial merge cost more than the barrier it saves); the next
// group's scale rows loaded ahead with its codes (32 more registers, spills).
// int8 KV (the JAX kernel's cache_scales): the cache holds int8 codes and
// f32 scales [L, 2, 1, n_kv, T], one per position and head. The attention
// loop widens a position's codes to f32 and multiplies them by its scale
// before the dot, as the TPU kernel dequantizes (megakernel.py:512-536); the
// current token stays f32. The append rounds the current k/v to bf16 (the
// k_new/v_new it returns, JAX's kv_dt), reduces the 128-wide absmax over
// the block and writes 128 codes and one scale each (quantize_kv_rows):
// what JAX's caller appends after the kernel (models/llama.py:765-774).
// W3 mode (the JAX kernel's unpack="dense3", Pallas rows 15-16): every
// linear and the head hold pack_int3 codes. This source is built twice
// (_build.UNITS: megakernel, megakernel_w3), four cache instances each:
// the unit's format (UNIT_W3) picks the tile's loads and code pairs at
// compile time (load_group, group_words and code_pair in mega_common.cuh).
// The staged activations are the same in both modes: w3_spread moves the
// 3-bit codes into the pairs that the W4 permutation expects. A token then
// streams 0.375 B per weight (3.28 GB at Llama-3-8B width with the head).
// K12 and K13, the tensor-parallel halves (Pallas rows 19 and 20,
// awq_tpu/ops/megakernel_tp.py: w4a16_llama_attn_half / _attn_half_kernel
// and w4a16_llama_mlp_half / _mlp_half_kernel): the same kernel body over one
// layer of one rank's shards, compiled as two more instances (MODE below),
// as the JAX package builds them from K4's _attn_phases and _mlp_phases.
// K12 (MODE_ATT) runs phases 1-4 on the rank's q/k/v columns, kv heads and
// wo rows (IC = nq·128 of the rank, not H) and writes wo's f32 partial sum
// without the residual; K13 (MODE_MLP) runs phases 5-6 from an f32 residual
// on the rank's gate/up columns and down rows and writes down's f32
// partial. The caller all-reduces each partial over the group and adds the
// residual (models/llama.py). Bound by the rank's weight bytes, as K4.
// The MPT shape (Pallas rows 15-16's mpt_shape, megakernel.py:883-899;
// units megakernel_mpt and megakernel_mpt_w3, -DAWQ_MEGA_MPT=1, MODE_LAYERS
// over float caches only): per layer
//   x = layernorm(h)·ln1 (no bias); qkv = x @ W(wqkv); no rope;
//   attention with the ALiBi bias slope_h·t on the score of position t
//   (the current token's at `length`), slope_h = 2^(-8(h+1)/nq) computed
//   from the head index (nq a power of two), as _alibi_chunk_slopes does;
//   h1 = h + attn @ W(wo); xm = layernorm(h1)·ln2;
//   hm = gelu(xm @ W(up)) with the exact erf GELU; h = h1 + hm @ W(down)
// and the final LayerNorm before the head. The LayerNorm takes the mean in
// one block sum and the variance of the centred row in a second, both over
// the row held in registers (E[x²] − E[x]² in one pass would lose the
// variance where the residual's mean dominates). Up is a plain [H, I]
// stack: I/32 tiles of 32 columns (512 at MPT-7B's I = 16384), down's staged
// row I/2 words (32 KB); the attention scratch stays the larger region, so
// the shared memory and the grid are llama's.
// Activations live in a device workspace that the wrapper allocates; the
// kernel allocates nothing.
#include "mega_common.cuh"

#ifndef AWQ_MEGA_MPT
#define AWQ_MEGA_MPT 0
#endif
constexpr bool UNIT_MPT = AWQ_MEGA_MPT;   // the unit's layer shape: llama, or MPT

namespace {

struct TokenArgs {
  const void* h_in; void* h_out;
  const int32_t* qkv_w; const float* qkv_s; const float* qkv_z; const void* qkv_b;
  const int32_t* o_w; const float* o_s; const float* o_z;
  const int32_t* gu_w; const float* gu_s; const float* gu_z;
  const int32_t* dn_w; const float* dn_s; const float* dn_z;
  const void* ln1; const void* ln2; const float* cosr; const float* sinr;
  void* cache; void* k_new; void* v_new;
  const int32_t* hd_w; const float* hd_s; const float* hd_z; const void* norm_w;
  float* logits;
  float* scales;           // int8 cache: [L, 2, 1, nkv, T]
  float* ws;
  const int* pos;          // the position in device memory, or null: `length`
  int layer0, n_layers, L, H, I, nq, nkv, T, length, vocab, round_res, md, has_bias;
  int rope_ld;             // with pos: cosr/sinr are tables of rows this far apart
  int ws_split;            // attention slices the workspace holds a kv head
  float eps;
};

constexpr int TILE = 32;                       // columns per matmul tile
// What one launch runs: layers [layer0, layer0 + n) (K4), or one layer's
// attention half (K12) or MLP half (K13), each writing an f32 partial sum.
enum { MODE_LAYERS = 0, MODE_ATT = 1, MODE_MLP = 2 };
constexpr int ATT_FLOATS = MK_MAXG * MK_HD + 2 * MK_HD + 2 * MK_WARPS * MK_MAXG
                           + MK_WARPS * MK_MAXG * MK_HD;
constexpr int MAX_PER_SM = 4;                  // blocks per SM (barrier cost)
constexpr int PB = 4;                          // cache positions a warp loads at once

// The attention's slices for `npos` positions (the length and the current
// token) over a grid of `grid` blocks: about one item (kv head, slice) a
// block, at least 32 positions a slice; `nsplit` slices of `split_len`
// (the last one shorter). With `target`, `nsplit` is the slice count aimed
// at, an upper bound on the count of every shorter length.
__host__ __device__ inline void attn_split(int npos, int grid, int nkv, int* nsplit,
                                           int* split_len, bool target = false) {
  int ns = grid / nkv;
  ns = ns < 1 ? 1 : ns;
  const int most = (npos + 31) / 32;
  ns = ns > most ? most : ns;
  *split_len = (npos + ns - 1) / ns;
  *nsplit = target ? ns : (npos + *split_len - 1) / *split_len;
}
// The source row of a staged input sits in L2 (another block wrote it
// before the barrier): a thread issues SU pairs of loads before it stores
// any, so a row costs a few L2 round trips rather than one per element.
constexpr int SU = 8;

// The staged input row, in shared memory: xa[(c*4 + t)*4 + tq] holds the
// A fragment pair of lane tq for k16 step t of chunk c:
//   .x = bf16(x[64c + 8t + 2tq]),     bf16(x[64c + 8(t+4) + 2tq])
//   .y = bf16(x[64c + 8t + 2tq + 1]), bf16(x[64c + 8(t+4) + 2tq + 1])
// (the channels whose codes codes_bf16x2 pairs from words 8c + 2tq and
// 8c + 2tq + 1), and xsum[g] the sum of group g's bf16(x).

// xsum[g] = the sum of group g's bf16(x) in the staged row xa.
__device__ void group_sums(const uint32_t* xa, float* xsum, int n) {
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < n / MK_G; g += MK_WARPS) {
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(xa + g * 64);
    const float s = __low2float(v[lane]) + __high2float(v[lane]) +
                    __low2float(v[lane + 32]) + __high2float(v[lane + 32]);
    const float t = warp_sum(s);
    if (lane == 0) xsum[g] = t;
  }
  __syncthreads();
}

// The channel whose value is the low half of pair slot p of a staged row.
__device__ __forceinline__ int slot_channel(int p) {
  const int c = p >> 5, t = (p >> 3) & 3, tq = (p >> 1) & 3, h = p & 1;
  return c * 64 + t * 8 + 2 * tq + h;
}

template <typename F>
__device__ void stage_x(uint32_t* xa, float* xsum, int n, F value) {
  for (int p0 = threadIdx.x; p0 < n / 2; p0 += SU * MK_THREADS) {
    float lo[SU], hi[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int p = p0 + u * MK_THREADS, i = slot_channel(p);
      lo[u] = p < n / 2 ? value(i) : 0.f;
      hi[u] = p < n / 2 ? value(i + 32) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SU; ++u)
      if (p0 + u * MK_THREADS < n / 2) xa[p0 + u * MK_THREADS] = pack_bf16x2(lo[u], hi[u]);
  }
  group_sums(xa, xsum, n);
}

// xa = permuted bf16(src · rsqrt(mean(src²) + eps) · w), n values. A row of
// up to 2·SU·256 values is loaded once, the norm weights with it, before
// the block sum (one round trip); a longer one in two passes.
__device__ void stage_rms(uint32_t* xa, float* xsum, const float* src, const void* w,
                          int md, int n, float eps, float* red) {
  if (n / 2 > SU * MK_THREADS) {
    float ss = 0.f;
    for (int i = threadIdx.x * 4; i < n; i += MK_THREADS * 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    const float rs = rsqrtf(block_sum(ss, red) / n + eps);
    stage_x(xa, xsum, n, [&](int i) { return src[i] * rs * load_act(w, md, i); });
    return;
  }
  float lo[SU], hi[SU], wl[SU], wh[SU], ss = 0.f;
#pragma unroll
  for (int u = 0; u < SU; ++u) {
    const int p = threadIdx.x + u * MK_THREADS, i = slot_channel(p);
    const bool ok = p < n / 2;
    lo[u] = ok ? src[i] : 0.f;
    hi[u] = ok ? src[i + 32] : 0.f;
    wl[u] = ok ? load_act(w, md, i) : 0.f;
    wh[u] = ok ? load_act(w, md, i + 32) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < SU; ++u) ss += lo[u] * lo[u] + hi[u] * hi[u];
  const float rs = rsqrtf(block_sum(ss, red) / n + eps);
#pragma unroll
  for (int u = 0; u < SU; ++u) {
    const int p = threadIdx.x + u * MK_THREADS;
    if (p < n / 2) xa[p] = pack_bf16x2(lo[u] * rs * wl[u], hi[u] * rs * wh[u]);
  }
  group_sums(xa, xsum, n);
}

// xa = permuted bf16((src − mean) · rsqrt(var + eps) · w), the bias-free
// LayerNorm of the MPT shape: the mean in one block sum, the variance of the
// centred values in a second, f32, the row and its weights loaded once (a
// longer row than 2·SU·256 values read twice).
__device__ void stage_ln(uint32_t* xa, float* xsum, const float* src, const void* w,
                         int md, int n, float eps, float* red) {
  if (n / 2 > SU * MK_THREADS) {
    float s1 = 0.f;
    for (int i = threadIdx.x * 4; i < n; i += MK_THREADS * 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      s1 += v.x + v.y + v.z + v.w;
    }
    const float mean = block_sum(s1, red) / n;
    float ss = 0.f;
    for (int i = threadIdx.x * 4; i < n; i += MK_THREADS * 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      const float a = v.x - mean, b = v.y - mean, c = v.z - mean, d = v.w - mean;
      ss += a * a + b * b + c * c + d * d;
    }
    const float rs = rsqrtf(block_sum(ss, red) / n + eps);
    stage_x(xa, xsum, n, [&](int i) { return (src[i] - mean) * rs * load_act(w, md, i); });
    return;
  }
  float lo[SU], hi[SU], wl[SU], wh[SU], s1 = 0.f;
#pragma unroll
  for (int u = 0; u < SU; ++u) {
    const int p = threadIdx.x + u * MK_THREADS, i = slot_channel(p);
    const bool ok = p < n / 2;
    lo[u] = ok ? src[i] : 0.f;
    hi[u] = ok ? src[i + 32] : 0.f;
    wl[u] = ok ? load_act(w, md, i) : 0.f;
    wh[u] = ok ? load_act(w, md, i + 32) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < SU; ++u) s1 += lo[u] + hi[u];
  const float mean = block_sum(s1, red) / n;
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < SU; ++u) {
    if (threadIdx.x + u * MK_THREADS < n / 2) {
      lo[u] -= mean;
      hi[u] -= mean;
    }
    ss += lo[u] * lo[u] + hi[u] * hi[u];
  }
  const float rs = rsqrtf(block_sum(ss, red) / n + eps);
#pragma unroll
  for (int u = 0; u < SU; ++u) {
    const int p = threadIdx.x + u * MK_THREADS;
    if (p < n / 2) xa[p] = pack_bf16x2(lo[u] * rs * wl[u], hi[u] * rs * wh[u]);
  }
  group_sums(xa, xsum, n);
}

// The layer shape's norm: RMSNorm, or the MPT shape's LayerNorm.
__device__ __forceinline__ void stage_norm(uint32_t* xa, float* xsum, const float* src,
                                           const void* w, int md, int n, float eps,
                                           float* red) {
  if constexpr (UNIT_MPT) stage_ln(xa, xsum, src, w, md, n, eps, red);
  else stage_rms(xa, xsum, src, w, md, n, eps, red);
}

__device__ void stage_copy(uint32_t* xa, float* xsum, const float* src, int n) {
  stage_x(xa, xsum, n, [&](int i) { return src[i]; });
}

// The bf16 pair of k16 step t as 2^7 + q (exact: the code's bits in the
// mantissa of 128): one shift and one LOP3, no subtract; the 2^7·Σ bf16(x)
// it adds is taken off with the group's scales, as the JAX kernels bias
// their codes by 128.
template <bool W3>
__device__ __forceinline__ uint32_t biased_pair(uint32_t p, uint32_t q, int t) {
  if constexpr (W3) return ((p >> (2 * t)) & 0x00030003u) | ((q >> t) & 0x00040004u) | 0x43004300u;
  else return ((p >> (4 * t)) & 0x000F000Fu) | 0x43004300u;
}

// One 32-column tile of y = x @ W over the full IC. Warp w takes groups
// w, w+8, ...; lane (gq, tq) loads 16 bytes, columns n0 + 4gq .. 4gq+3, of
// each of its group's four word rows (load_group). Column 4gq + j is
// column gq of n8 tile j, so the mma of tile j leaves columns n0 + 8tq + j
// and n0 + 8tq + 4 + j in every row (A's rows are all x). Returns column
// n0 + threadIdx.x on threads 0..31.
__device__ float gemv_tile(const uint32_t* __restrict__ xa, const float* __restrict__ xsum,
                           const int32_t* __restrict__ qw, const float* __restrict__ sc,
                           const float* __restrict__ sz, int IC, int OC, int n0,
                           float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int ng = IC / MK_G;
  const int32_t* base = qw + (size_t)(2 * tq) * OC + n0 + 4 * gq;
  float acc[4][2] = {};
  // the code words of a warp's next group are loaded while it computes on
  // the current one, so the HBM latency is paid once per tile
  uint4 wc[4];
  if (warp < ng) load_group<UNIT_W3>(wc, base, warp, OC);
  for (int g = warp; g < ng; g += MK_WARPS) {
    uint4 wn[4];
    if (g + MK_WARPS < ng) load_group<UNIT_W3>(wn, base, g + MK_WARPS, OC);
    float part[4][4] = {};
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = 2 * g + cc;
      uint32_t p0[4], p1[4], q0[4], q1[4];
      group_words<UNIT_W3>(wc, g, cc, p0, p1, q0, q1);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint2 av = *reinterpret_cast<const uint2*>(xa + ((c * 4 + t) * 4 + tq) * 2);
        const uint32_t a[4] = {av.x, av.x, av.y, av.y};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_16816(part[j], a, biased_pair<UNIT_W3>(p0[j], q0[j], t),
                         biased_pair<UNIT_W3>(p1[j], q1[j], t));
      }
    }
    // this lane's columns: n0 + 8tq + 4e + j (e = 0, 1; j = 0..3):
    // s·Σ x·(128 + q) − (128·s + sz)·Σ x
    const size_t o = (size_t)g * OC + n0 + 8 * tq;
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(sc + o));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(sc + o + 4));
    const float4 z0 = __ldg(reinterpret_cast<const float4*>(sz + o));
    const float4 z1 = __ldg(reinterpret_cast<const float4*>(sz + o + 4));
    const float ss[2][4] = {{s0.x, s0.y, s0.z, s0.w}, {s1.x, s1.y, s1.z, s1.w}};
    const float zz[2][4] = {{z0.x, z0.y, z0.z, z0.w}, {z1.x, z1.y, z1.z, z1.w}};
    const float xs = xsum[g];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[j][e] += part[j][e] * ss[e][j] - xs * fmaf(128.f, ss[e][j], zz[e][j]);
#pragma unroll
    for (int r = 0; r < 4; ++r) wc[r] = wn[r];
  }
  if (gq == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) red[warp * TILE + 8 * tq + 4 * e + j] = acc[j][e];
  __syncthreads();
  float v = 0.f;
  if (threadIdx.x < TILE)
#pragma unroll
    for (int w = 0; w < MK_WARPS; ++w) v += red[w * TILE + threadIdx.x];
  __syncthreads();
  return v;
}

template <typename CT, int MODE>
__global__ void __launch_bounds__(MK_THREADS) token_kernel(TokenArgs a) {
  constexpr bool Q8 = sizeof(CT) == 1;   // int8 codes with f32 scales
  constexpr bool ATT = MODE != MODE_MLP, MLP = MODE != MODE_ATT;
  extern __shared__ float sm[];
  cg::grid_group grid = cg::this_grid();
  float* red = sm;                       // 256 floats
  float* xs = sm + MK_THREADS;           // attention scratch, or:
  uint32_t* xa = reinterpret_cast<uint32_t*>(xs);   // the staged input row
  float* xsum = xs + (a.H > a.I ? a.H : a.I) / 2;   // its group sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, I = a.I, nq = a.nq, nkv = a.nkv, grp = nq / nkv;
  const int nr = nq + 2 * nkv, oq = nr * MK_HD;
  float* hres = a.ws;
  float* qkv = hres + H;
  float* pml = qkv + oq;
  float* pacc = pml + (((size_t)nkv * a.ws_split * grp * 2 + 3) & ~(size_t)3);  // float4 rows
  float* xo = pacc + (size_t)nkv * a.ws_split * grp * MK_HD;
  float* h1 = xo + nq * MK_HD;
  float* hm = h1 + H;
  CT* cache = static_cast<CT*>(a.cache);
  const int gsize = gridDim.x * MK_THREADS;
  const int gtid = blockIdx.x * MK_THREADS + tid;
  const int vb = blockIdx.x;
  const size_t es = a.md ? 2 : 4;                // bytes of a norm weight
  // the position: from device memory (a captured decode step reads it
  // there at every replay), kept inside the cache
  const int length = a.pos ? min(max(*a.pos, 0), a.T - 1) : a.length;
  const float* cosr = UNIT_MPT ? nullptr : a.cosr + (a.pos ? (size_t)length * a.rope_ld : 0);
  const float* sinr = UNIT_MPT ? nullptr : a.sinr + (a.pos ? (size_t)length * a.rope_ld : 0);
  // the attention split, from the length itself: a launch that reads its
  // position in device memory sums in the order of a launch given that
  // length as a host int, whatever bound its workspace was sized for
  int nsplit, split_len;
  attn_split(length + 1, gridDim.x, nkv, &nsplit, &split_len);

  float* part = static_cast<float*>(a.h_out);   // K12, K13: the f32 partial
  if constexpr (MODE == MODE_MLP) {
    for (int i = gtid; i < H; i += gsize) h1[i] = static_cast<const float*>(a.h_in)[i];
  } else {
    for (int i = gtid; i < H; i += gsize) hres[i] = load_act(a.h_in, a.md, i);
  }
  grid.sync();

  for (int li = 0; li < a.n_layers; ++li) {
    const int l = a.layer0 + li;
    if constexpr (ATT) {
    // ---- phase 1: rmsnorm (MPT: layernorm) + fused QKV (+ bias) ----------
    {
      const int nt = oq / TILE;
      const int32_t* w = a.qkv_w + (size_t)l * qrows(H, UNIT_W3) * oq;
      const float* s = a.qkv_s + (size_t)l * (H / MK_G) * oq;
      const float* z = a.qkv_z + (size_t)l * (H / MK_G) * oq;
      if (vb < nt) stage_norm(xa, xsum, hres,
                              static_cast<const char*>(a.ln1) + (size_t)l * H * es, a.md, H,
                              a.eps, red);
      for (int t = vb; t < nt; t += gridDim.x) {
        const float v = gemv_tile(xa, xsum, w, s, z, H, oq, t * TILE, red);
        if (tid < TILE) {
          const int col = t * TILE + tid;
          qkv[col] = v + (a.has_bias ? load_act(a.qkv_b, a.md, (size_t)l * oq + col) : 0.f);
        }
      }
    }
    grid.sync();
    // ---- phase 2: rope (MPT: ALiBi) + attention slices + the in-place append
    {
      float* sq = xs;                               // [MK_MAXG][128] q·scale
      float* kc = sq + MK_MAXG * MK_HD;             // [128] current k (roped)
      float* vc = kc + MK_HD;                       // [128] current v
      float* wm = vc + MK_HD;                       // [8][MK_MAXG]
      float* wl = wm + MK_WARPS * MK_MAXG;          // [8][MK_MAXG]
      float* wacc = wl + MK_WARPS * MK_MAXG;        // [8][MK_MAXG][128]
      const float scale = 1.f / sqrtf((float)MK_HD);
      const int items = nkv * nsplit;
      const size_t T = a.T;
      for (int it = vb; it < items; it += gridDim.x) {
        const int kvh = it / nsplit, sp = it % nsplit;
        const int p0 = sp * split_len;
        const int p1 = min(p0 + split_len, length + 1);
        for (int i = tid; i < grp * MK_HD; i += MK_THREADS) {
          const int g = i / MK_HD, d = i % MK_HD;
          const float* qr = qkv + (kvh * grp + g) * MK_HD;
          sq[i] = (UNIT_MPT ? qr[d] : rope_at(qr, cosr, sinr, d)) * scale;
        }
        for (int d = tid; d < MK_HD; d += MK_THREADS) {
          const float* kr = qkv + (nq + kvh) * MK_HD;
          kc[d] = UNIT_MPT ? kr[d] : rope_at(kr, cosr, sinr, d);
          vc[d] = qkv[(nq + nkv + kvh) * MK_HD + d];
        }
        // MPT: the q heads' ALiBi slopes 2^(-8(h+1)/nq)
        float slope[MK_MAXG];
#pragma unroll
        for (int g = 0; g < MK_MAXG; ++g)
          slope[g] = UNIT_MPT ? exp2f(-(8.f / nq) * (float)(kvh * grp + g + 1)) : 0.f;
        __syncthreads();
        const size_t krow = (((size_t)l * 2 + 0) * nkv + kvh) * T;
        const size_t vrow = (((size_t)l * 2 + 1) * nkv + kvh) * T;
        if (sp == 0) {
          if constexpr (Q8) {
            const size_t o = ((size_t)li * nkv + kvh) * MK_HD;
            quantize_kv_rows(kc, vc, cache + (krow + length) * MK_HD,
                             cache + (vrow + length) * MK_HD, a.scales + krow + length,
                             a.scales + vrow + length, static_cast<bf16*>(a.k_new) + o,
                             static_cast<bf16*>(a.v_new) + o, red);
          } else {
            for (int d = tid; d < MK_HD; d += MK_THREADS) {
              cache[(krow + length) * MK_HD + d] = from_f32<CT>(kc[d]);
              cache[(vrow + length) * MK_HD + d] = from_f32<CT>(vc[d]);
              static_cast<CT*>(a.k_new)[((size_t)li * nkv + kvh) * MK_HD + d] = from_f32<CT>(kc[d]);
              static_cast<CT*>(a.v_new)[((size_t)li * nkv + kvh) * MK_HD + d] = from_f32<CT>(vc[d]);
            }
          }
        }
        float m[MK_MAXG], lsum[MK_MAXG], acc[MK_MAXG][4];
#pragma unroll
        for (int g = 0; g < MK_MAXG; ++g) {
          m[g] = -INFINITY; lsum[g] = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
        }
        for (int pb = p0 + warp; pb < p1; pb += MK_WARPS * PB) {
          // PB positions' k/v are loaded before any is used
          float kv4[PB][4], vv4[PB][4];
#pragma unroll
          for (int u = 0; u < PB; ++u) {
            const int p = pb + u * MK_WARPS;
            if (p < length && p < p1) {
              load4<CT>(cache + (krow + p) * MK_HD + lane * 4, kv4[u]);
              load4<CT>(cache + (vrow + p) * MK_HD + lane * 4, vv4[u]);
              if constexpr (Q8) {
                const float ks = a.scales[krow + p], vs = a.scales[vrow + p];
#pragma unroll
                for (int e = 0; e < 4; ++e) { kv4[u][e] *= ks; vv4[u][e] *= vs; }
              }
            } else if (p < p1) {
#pragma unroll
              for (int e = 0; e < 4; ++e) { kv4[u][e] = kc[lane * 4 + e]; vv4[u][e] = vc[lane * 4 + e]; }
            }
          }
#pragma unroll
          for (int u = 0; u < PB; ++u) {
            if (pb + u * MK_WARPS >= p1) break;
#pragma unroll
            for (int g = 0; g < MK_MAXG; ++g) {
              if (g >= grp) break;
              float dp = 0.f;
#pragma unroll
              for (int e = 0; e < 4; ++e) dp = fmaf(sq[g * MK_HD + lane * 4 + e], kv4[u][e], dp);
              float sc = warp_sum(dp);
              if constexpr (UNIT_MPT) sc += slope[g] * (float)(pb + u * MK_WARPS);
              const float mn = fmaxf(m[g], sc);
              const float alpha = expf(m[g] - mn);
              const float pr = expf(sc - mn);
              lsum[g] = lsum[g] * alpha + pr;
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[g][e] = acc[g][e] * alpha + pr * vv4[u][e];
              m[g] = mn;
            }
          }
        }
#pragma unroll
        for (int g = 0; g < MK_MAXG; ++g) {
          if (g >= grp) break;
          if (lane == 0) { wm[warp * MK_MAXG + g] = m[g]; wl[warp * MK_MAXG + g] = lsum[g]; }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            wacc[(warp * MK_MAXG + g) * MK_HD + lane * 4 + e] = acc[g][e];
        }
        __syncthreads();
        for (int i = tid; i < grp * MK_HD; i += MK_THREADS) {
          const int g = i / MK_HD, d = i % MK_HD;
          float mx = -INFINITY;
          for (int w = 0; w < MK_WARPS; ++w) mx = fmaxf(mx, wm[w * MK_MAXG + g]);
          float ls = 0.f, ac = 0.f;
          for (int w = 0; w < MK_WARPS; ++w) {
            const float mw = wm[w * MK_MAXG + g];
            if (mw == -INFINITY) continue;
            const float f = expf(mw - mx);
            ls += wl[w * MK_MAXG + g] * f;
            ac += wacc[(w * MK_MAXG + g) * MK_HD + d] * f;
          }
          const size_t row = (size_t)it * grp + g;
          pacc[row * MK_HD + d] = ac;
          if (d == 0) { pml[row * 2] = mx; pml[row * 2 + 1] = ls; }
        }
        __syncthreads();
      }
    }
    grid.sync();
    // ---- phase 3: combine the slices -> attention output rows, a warp per head
    for (int hq = vb + warp * gridDim.x; hq < nq; hq += gridDim.x * MK_WARPS) {
      float ac[4];
      combine_row(pml, pacc, (size_t)(hq / grp) * nsplit * grp + hq % grp, grp, nsplit, ac);
#pragma unroll
      for (int e = 0; e < 4; ++e) xo[hq * MK_HD + lane * 4 + e] = ac[e];
    }
    grid.sync();
    // ---- phase 4: o-proj (+ residual) over IC = nq·128 (= H in K4) -------
    {
      const int nt = H / TILE, ic = nq * MK_HD;
      const int32_t* w = a.o_w + (size_t)l * qrows(ic, UNIT_W3) * H;
      const float* s = a.o_s + (size_t)l * (ic / MK_G) * H;
      const float* z = a.o_z + (size_t)l * (ic / MK_G) * H;
      if (vb < nt) stage_copy(xa, xsum, xo, ic);
      for (int t = vb; t < nt; t += gridDim.x) {
        const float v = gemv_tile(xa, xsum, w, s, z, ic, H, t * TILE, red);
        if (tid < TILE) {
          if constexpr (MODE == MODE_ATT) part[t * TILE + tid] = v;
          else h1[t * TILE + tid] = hres[t * TILE + tid] + v;
        }
      }
    }
    if constexpr (MODE == MODE_LAYERS) grid.sync();
    }
    if constexpr (MLP) {
    // ---- phase 5: rmsnorm + gate/up, SiLU·mul fused (MPT: layernorm + up, GELU)
    {
      const int nt = I / TILE, oc = UNIT_MPT ? I : 2 * I;
      const int32_t* w = a.gu_w + (size_t)l * qrows(H, UNIT_W3) * oc;
      const float* s = a.gu_s + (size_t)l * (H / MK_G) * oc;
      const float* z = a.gu_z + (size_t)l * (H / MK_G) * oc;
      if (vb < nt) stage_norm(xa, xsum, h1,
                              static_cast<const char*>(a.ln2) + (size_t)l * H * es, a.md, H,
                              a.eps, red);
      for (int t = vb; t < nt; t += gridDim.x) {
        if constexpr (UNIT_MPT) {
          const float up = gemv_tile(xa, xsum, w, s, z, H, oc, t * TILE, red);
          if (tid < TILE) hm[t * TILE + tid] = 0.5f * up * (1.f + erff(up * 0.70710678118654752f));
        } else {
          const float gt = gemv_tile(xa, xsum, w, s, z, H, oc, t * TILE, red);
          const float up = gemv_tile(xa, xsum, w, s, z, H, oc, I + t * TILE, red);
          if (tid < TILE) hm[t * TILE + tid] = gt * (1.f / (1.f + expf(-gt))) * up;
        }
      }
    }
    grid.sync();
    // ---- phase 6: down + residual -----------------------------------------------
    {
      const int nt = H / TILE;
      const int32_t* w = a.dn_w + (size_t)l * qrows(I, UNIT_W3) * H;
      const float* s = a.dn_s + (size_t)l * (I / MK_G) * H;
      const float* z = a.dn_z + (size_t)l * (I / MK_G) * H;
      if (vb < nt) stage_copy(xa, xsum, hm, I);
      for (int t = vb; t < nt; t += gridDim.x) {
        const float v = gemv_tile(xa, xsum, w, s, z, I, H, t * TILE, red);
        if (tid < TILE) {
          if constexpr (MODE == MODE_MLP) {
            part[t * TILE + tid] = v;
          } else {
            const float y = h1[t * TILE + tid] + v;
            hres[t * TILE + tid] = a.round_res ? bf16r(y) : y;
          }
        }
      }
    }
    if constexpr (MODE == MODE_LAYERS) grid.sync();
    }
  }

  if constexpr (MODE != MODE_LAYERS) return;
  for (int i = gtid; i < H; i += gsize) store_act(a.h_out, a.md, i, hres[i]);
  if (a.vocab) {
    // ---- final rmsnorm (MPT: layernorm) + W4 head -> f32 logits ----------------
    const int nt = a.vocab / TILE;
    if (vb < nt) stage_norm(xa, xsum, hres, a.norm_w, a.md, H, a.eps, red);
    for (int t = vb; t < nt; t += gridDim.x) {
      const float v = gemv_tile(xa, xsum, a.hd_w, a.hd_s, a.hd_z, H, a.vocab, t * TILE, red);
      if (tid < TILE) a.logits[t * TILE + tid] = v;
    }
  }
}

// Pointer and size arguments, in the order the wrapper passes them.
enum { P_H, P_OUT, P_QW, P_QS, P_QZ, P_QB, P_OW, P_OS, P_OZ, P_GW, P_GS, P_GZ,
       P_DW, P_DS, P_DZ, P_LN1, P_LN2, P_COS, P_SIN, P_CACHE, P_KN, P_VN,
       P_HW, P_HS, P_HZ, P_NW, P_LOGITS, P_SCALES, P_POS };
enum { N_L0, N_NL, N_L, N_H, N_I, N_NQ, N_NKV, N_T, N_LEN, N_VOCAB, N_ROUND,
       N_MD, N_CD, N_BIAS, N_W3, N_MODE, N_PLAN };

struct Plan { int grid, ws_split; size_t smem; long long ws; };

template <typename CT, int MODE>
int plan_for(const int* n, Plan* p) {
  const int H = n[N_H], I = n[N_I], nq = n[N_NQ], nkv = n[N_NKV];
  const int maxic = H > I ? H : I;
  const int xfloats = maxic / 2 + maxic / MK_G;        // xa + xsum
  p->smem = (size_t)(MK_THREADS + (xfloats > ATT_FLOATS ? xfloats : ATT_FLOATS)) * sizeof(float);
  const int err = coop_grid(token_kernel<CT, MODE>, p->smem, &p->grid, MAX_PER_SM);
  if (err) return err;
  // the workspace holds the attention slices of any length up to N_PLAN
  // (the host length, or the bound on a position read from device memory):
  // attn_split's slice count grows with the length and is at most its
  // target there
  int split_len;
  attn_split(n[N_PLAN] + 1, p->grid, nkv, &p->ws_split, &split_len, true);
  const long long grp = nq / nkv;
  p->ws = 2LL * H + (long long)(nq + 2 * nkv) * MK_HD + nkv * p->ws_split * grp * (2 + MK_HD) + 4
          + (long long)nq * MK_HD + I;
  return 0;
}

// The instance a launch with these arguments runs: the cache dtype (K13
// reads no cache and has the one bf16 instance) and the mode.
template <int MODE>
const void* kernel_for(int cd) {
  switch (cd) {
    case 0: return (const void*)token_kernel<float, MODE>;
    case 1: return (const void*)token_kernel<bf16, MODE>;
    case 2: return (const void*)token_kernel<__half, MODE>;
    case 3:
      if constexpr (!UNIT_MPT) return (const void*)token_kernel<int8_t, MODE>;
      [[fallthrough]];
    default: return nullptr;
  }
}

template <int MODE>
int plan_mode(const int* n, Plan* p) {
  switch (n[N_CD]) {
    case 0: return plan_for<float, MODE>(n, p);
    case 1: return plan_for<bf16, MODE>(n, p);
    case 2: return plan_for<__half, MODE>(n, p);
    case 3:
      if constexpr (!UNIT_MPT) return plan_for<int8_t, MODE>(n, p);
      [[fallthrough]];
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The MPT units hold K4 over float caches only: no int8 instance, no K12/K13
// (templates, so that the discarded branch instantiates nothing).
template <bool MPT = UNIT_MPT>
int plan(const int* n, Plan* p) {
  if constexpr (MPT) {
    return n[N_MODE] == MODE_LAYERS ? plan_mode<MODE_LAYERS>(n, p)
                                    : static_cast<int>(cudaErrorInvalidValue);
  } else {
    switch (n[N_MODE]) {
      case MODE_LAYERS: return plan_mode<MODE_LAYERS>(n, p);
      case MODE_ATT: return plan_mode<MODE_ATT>(n, p);
      case MODE_MLP: return n[N_CD] == 1 ? plan_for<bf16, MODE_MLP>(n, p)
                                         : static_cast<int>(cudaErrorInvalidValue);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

template <bool MPT = UNIT_MPT>
const void* kernel(const int* n) {
  if constexpr (MPT) {
    return n[N_MODE] == MODE_LAYERS ? kernel_for<MODE_LAYERS>(n[N_CD]) : nullptr;
  } else {
    switch (n[N_MODE]) {
      case MODE_LAYERS: return kernel_for<MODE_LAYERS>(n[N_CD]);
      case MODE_ATT: return kernel_for<MODE_ATT>(n[N_CD]);
      default: return n[N_CD] == 1 ? (const void*)token_kernel<bf16, MODE_MLP> : nullptr;
    }
  }
}

}  // namespace

// Workspace floats the launch with these arguments needs, or -(CUDA error).
extern "C" long long awq_mega_token_ws(const void* const* ptrs, const int* n) {
  (void)ptrs;
  Plan p;
  const int err = plan(n, &p);
  return err ? -static_cast<long long>(err) : p.ws;
}

// Caller guarantees (ops/megakernel.py and ops/megakernel_tp.py check
// them): contiguous operands on one device; g128 stacked weights, W4
// [L, IC/8, OC] or with N_W3 W3 [L, IC*3/32, OC] (every linear and the
// head), with f32 scales and szeros [L, IC/128, OC]; head_dim 128; nq/nkv
// <= 8; every OC a multiple of 32; H, I and nq·128 multiples of 128 (of
// 256 in W3); 0 <= length <= N_PLAN < T; batch 1. An MPT unit
// (AWQ_MEGA_MPT) takes MODE_LAYERS over a float cache, nq a power of two,
// P_GW..P_GZ the up stack [L, H/8, I] and no rope tables (P_COS, P_SIN
// unread). P_POS, where not null,
// points to the position as an int32 in device memory (N_LEN is then not
// read), and P_COS/P_SIN to the rope tables [T', 128] f32 rather than to
// one row each. Cache dtype code 3 is int8 codes
// with f32 scales [L, 2, 1, nkv, T] at P_SCALES, and bf16 k_new/v_new.
// N_MODE: MODE_LAYERS (K4: P_H and P_OUT in the model dtype), MODE_ATT (K12:
// P_OUT the f32 [H] partial, one layer, wo [L, nq·128/8, H]) or MODE_MLP
// (K13: P_H the f32 [H] residual, P_OUT the f32 partial, one layer, no
// cache, N_CD 1).
extern "C" int awq_mega_token(const void* const* ptrs, const int* n, float eps,
                              void* ws, void* stream) {
  Plan p;
  int err = plan(n, &p);
  if (err) return err;
  if (n[N_NQ] % n[N_NKV] || n[N_NQ] / n[N_NKV] > MK_MAXG || n[N_W3] != UNIT_W3 ||
      (UNIT_MPT && (n[N_NQ] & (n[N_NQ] - 1))))   // MPT: in-kernel slopes need nq = 2^k
    return static_cast<int>(cudaErrorInvalidValue);
  TokenArgs a;
  a.h_in = ptrs[P_H]; a.h_out = const_cast<void*>(ptrs[P_OUT]);
  a.qkv_w = static_cast<const int32_t*>(ptrs[P_QW]);
  a.qkv_s = static_cast<const float*>(ptrs[P_QS]);
  a.qkv_z = static_cast<const float*>(ptrs[P_QZ]); a.qkv_b = ptrs[P_QB];
  a.o_w = static_cast<const int32_t*>(ptrs[P_OW]);
  a.o_s = static_cast<const float*>(ptrs[P_OS]); a.o_z = static_cast<const float*>(ptrs[P_OZ]);
  a.gu_w = static_cast<const int32_t*>(ptrs[P_GW]);
  a.gu_s = static_cast<const float*>(ptrs[P_GS]); a.gu_z = static_cast<const float*>(ptrs[P_GZ]);
  a.dn_w = static_cast<const int32_t*>(ptrs[P_DW]);
  a.dn_s = static_cast<const float*>(ptrs[P_DS]); a.dn_z = static_cast<const float*>(ptrs[P_DZ]);
  a.ln1 = ptrs[P_LN1]; a.ln2 = ptrs[P_LN2];
  a.cosr = static_cast<const float*>(ptrs[P_COS]); a.sinr = static_cast<const float*>(ptrs[P_SIN]);
  a.cache = const_cast<void*>(ptrs[P_CACHE]);
  a.k_new = const_cast<void*>(ptrs[P_KN]); a.v_new = const_cast<void*>(ptrs[P_VN]);
  a.hd_w = static_cast<const int32_t*>(ptrs[P_HW]);
  a.hd_s = static_cast<const float*>(ptrs[P_HS]); a.hd_z = static_cast<const float*>(ptrs[P_HZ]);
  a.norm_w = ptrs[P_NW]; a.logits = static_cast<float*>(const_cast<void*>(ptrs[P_LOGITS]));
  a.scales = static_cast<float*>(const_cast<void*>(ptrs[P_SCALES]));
  if (n[N_CD] == 3 && !a.scales) return static_cast<int>(cudaErrorInvalidValue);
  a.ws = static_cast<float*>(ws);
  a.layer0 = n[N_L0]; a.n_layers = n[N_NL]; a.L = n[N_L]; a.H = n[N_H]; a.I = n[N_I];
  a.nq = n[N_NQ]; a.nkv = n[N_NKV]; a.T = n[N_T]; a.length = n[N_LEN];
  a.pos = static_cast<const int*>(ptrs[P_POS]); a.rope_ld = MK_HD;
  a.vocab = n[N_VOCAB]; a.round_res = n[N_ROUND]; a.md = n[N_MD]; a.has_bias = n[N_BIAS];
  a.ws_split = p.ws_split; a.eps = eps;
  void* kargs[] = {&a};
  const void* fn = kernel(n);
  if (!fn) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, p.grid, MK_THREADS, kargs, p.smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
