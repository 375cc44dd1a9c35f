// K2, K8, K9, K14 (flash decode) and K3 (causal flash prefill) for Hopper
// (sm_90a).
//
// All read ONE layer of the stacked cache, the contiguous view
// cache[l] = [2, B, n_kv, T, HD] (K at index 0, V at 1), head-major so
// that each head's [T, HD] slab is contiguous. HD is 128 for K2, K8 and K9;
// K3 and K14 take head_dim 64 or 128 (a template parameter D). The cache is f32,
// bf16 or f16 (a template parameter, E); q, the current token's k/v and
// the output are f32, bf16 or f16 too, each of its own dtype (a runtime
// code: they are read once per block), as the JAX kernels follow q.dtype
// and the cache's dtype apart.
//
// K2 replaces awq_tpu/ops/decode_attn.py::flash_decode_stacked
// (_stacked_decode_kernel): one query position per row, GQA, an online
// softmax over the cache prefix [0, len_b) PLUS the current token's k/v,
// which arrive as operands (not yet in the cache), scale 1/sqrt(HD).
// Bound by device memory: the K and V prefix, 2·n_kv·len·HD·2 bytes per
// layer, is read once and each byte feeds a few FLOPs. At batch 1 one
// block per kv head would use 8 of 132 SMs, so T is split across blocks
// (split-K flash decode): flash_decode_split_kernel gives each block a
// slice of positions of one (row, kv head), stages 32-position K/V tiles in
// shared memory with 16-byte loads, and keeps an online softmax per query
// head of the group (one warp per head; lane j scores position j of the
// tile). Each slice writes (max, sum, unnormalised output) in f32;
// flash_decode_combine_kernel merges the slices in order and folds in the
// current token, as the TPU kernel does after its loop (decode_attn.py:220).
// Only [0, len_b) is read; positions past it are never touched.
//
// K8 replaces flash_decode_paged (_paged_decode_kernel): the same attention
// over a PAGED cache, one layer of the pool [2, NP, n_kv, page, HD] with a
// block table tables [B, MP]; position p of row b lives at
// pool[s, tables[b, p / page], h, p % page]. It is K2's body, not a copy:
// the split kernel takes the address of a position from a functor, ContigKV
// for K2 and PagedKV for K8, and the combine kernel is shared. The TPU
// kernel scalar-prefetched the table; here each load looks up its own
// entry (one int per position, from L1). The wrapper makes the splits whole
// pages, so a block streams contiguous page x HD slabs. Bound by device
// memory as K2: the bytes of the rows' prefixes. Row lengths are clamped to
// [0, MP·page] on the device, so no table entry past MP is read. The TPU
// kernel rounds the softmax weights to the pool dtype before P·V; K8, like
// K2, keeps them in f32.
//
// K9 replaces flash_decode_stacked8 (_stacked_decode_kernel8): K2's
// attention over ONE layer of an int8 KV cache, codes [2, B, n_kv, T, HD]
// int8 and scales [2, B, n_kv, T] f32 (one per position and head), with the
// current token's k/v in q's dtype as operands. It is K2's body again, with the
// Int8KV functor: a 16-byte load brings 16 codes instead of 8 bf16 values,
// the tile of codes sits in shared memory as int8 and its 32 positions'
// K and V scales beside it. As in the TPU kernel, nothing is dequantized
// elementwise: the loads widen the codes to f32, K's scale multiplies a
// position's score after q·k, and V's scale multiplies its softmax weight
// before p·v; the weights stay f32 (the TPU kernel's p is f32 here too).
// Bound by device memory: half K2's bytes plus 8 bytes of scales per
// position and head.
//
// K14 replaces flash_decode (_flash_decode_kernel): the attention of one
// query position per row over positions [0, length) of one layer's k_cache
// and v_cache [B, n_kv, T, D] (two tensors), one length for every row, the
// current token already written (no operand for it), GQA/MQA with up to 128
// query heads per kv head (falcon-7b: 71 at D = 64), scale 1/sqrt(D). The
// TPU kernel's grid (B, n_kv) holds a kv head's whole [g, D] query group
// per program; at falcon's B * n_kv = 1 that is one block on 132 SMs, so
// K14 splits the positions across blocks as K2 does and merges the slices
// with K2's combine kernel (without a current token). A block takes a chunk
// of 8 heads of the group, one warp each, with their queries and running
// softmax state in shared memory; the chunks of a group read the same K/V
// slice (from L2 after the first). Bound by device memory: 2 * n_kv * length * D
// cache elements; at falcon-7b's one kv head that is 256 KB of bf16 a layer
// at length 1000 (0.08 us), so it is launch-bound there. Softmax weights stay
// f32 for P.V (the TPU kernel rounds them to the cache dtype).
//
// K3 replaces flash_prefill_stacked (_stacked_prefill_kernel) with its
// online softmax (the TPU-only fixed_max variant is not carried over): the
// chunk at [start, start+S) is already in the cache, query row r attends
// positions j <= start + r, GQA/MQA. Bound by tensor-core operations at
// prompt lengths. Two modes:
// - bf16 and f16 caches (flash_prefill_wgmma_kernel), FlashAttention-3's
//   shape for Hopper. GQA packing: a block owns one (row b, kv head) and
//   128 consecutive (position, head-in-group) query rows, which sit side by
//   side in q (the g heads of a position are adjacent), so each K/V tile it
//   loads serves every head of the group (4 for Llama-3-8B, 71 for
//   Falcon-7B's MQA) and the causal limit is applied per row by its
//   position. One producer warp streams BKV-position K and V tiles of the
//   layer's [T, hd] slab by TMA (128-byte swizzle; a 3-D map whose rows end
//   at start + S, so positions past the chunk read as zeros) into a ring of
//   3 stages; two consumer warpgroups of 64 rows each compute S = Q·K^T
//   with wgmma (both operands K-major in shared memory; Q staged once per
//   block by the consumers' own loads), keep the row max and sum in
//   registers, round P to bf16/f16 in registers as wgmma's A fragments and
//   accumulate O += P·V with wgmma's transposed-B form, V read MN-major
//   straight from its TMA tile. BKV is 64 positions at hd 128 and 128 at
//   hd 64 (S and O together 96 f32 accumulators a thread). Blocks run
//   heavy-first: block 0 takes the last row tile, whose causal frontier is
//   the longest, so the short tiles fill the tail
//   (ops/decode_attn.py::prefill_plan mirrors the order).
// - an f32 cache (flash_prefill_kernel, the earlier mma.sync body, kept as the f32 mode):
//   a block of 4 warps owns 64 query rows of one head (Q in registers as
//   mma.sync A fragments), streams 64-position K/V tiles through shared
//   memory with synchronous loads, rounds the tiles, q and P to bf16
//   (about 3 significant digits) for mma.sync m16n8k16 with f32 sums.
// Both keep f32 accumulators, the online max and sum in f32 and P rounded
// to bf16 (f16 over an f16 cache) for P·V; the [S, T] score matrix never
// exists in memory.
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int HD = 128;
constexpr int DEC_TILE = 32;   // positions per shared-memory tile
constexpr int DEC_WARPS = 4;
constexpr int LAYER_HEADS = 8;         // K14: query heads (and warps) per block
constexpr int DEC_LAYER_THREADS = 32 * LAYER_HEADS;
// -inf as a bit pattern (device code only)
#define NEG_INF (__int_as_float(0xff800000))

// Where the positions of (row b, kv head h) sit in one layer: row(b, h) is
// a cursor whose K and V rows of position t are at k + off(t) and
// v + off(t).
template <typename E>
struct ContigKV {  // K2: cache [2, B, n_kv, T, HD]
  using Elem = E;
  const E* base;
  int B, nkv, T;
  struct Row {
    const E* k;
    const E* v;
    __device__ __forceinline__ size_t off(int t) const { return (size_t)t * HD; }
  };
  __device__ __forceinline__ Row row(int b, int h) const {
    const E* k = base + ((size_t)b * nkv + h) * T * HD;
    return Row{k, k + (size_t)B * nkv * T * HD};
  }
};
template <typename E>
struct PagedKV {   // K8: pool [2, NP, n_kv, page, HD], tables [B, MP]
  using Elem = E;
  const E* base;
  const int* tables;
  int np, nkv, page, mp;
  struct Row {
    const E* k;         // head h of page 0, K plane
    const E* v;         // the same in the V plane
    const int* tab;     // row b's table
    int pstride;        // elements from one page to the next: nkv * page * HD
    int page;
    __device__ __forceinline__ size_t off(int t) const {
      return (size_t)__ldg(tab + t / page) * pstride + (size_t)(t % page) * HD;
    }
  };
  __device__ __forceinline__ Row row(int b, int h) const {
    const E* k = base + (size_t)h * page * HD;
    return Row{k, k + (size_t)np * nkv * page * HD, tables + (size_t)b * mp,
               nkv * page * HD, page};
  }
};
struct Int8KV {    // K9: codes [2, B, n_kv, T, HD] int8, scales [2, B, n_kv, T] f32
  using Elem = int8_t;
  const int8_t* base;
  const float* scales;
  int B, nkv, T;
  struct Row {
    const int8_t* k;
    const int8_t* v;
    const float* ks;    // K scale of position t at ks[t]
    const float* vs;
    __device__ __forceinline__ size_t off(int t) const { return (size_t)t * HD; }
  };
  __device__ __forceinline__ Row row(int b, int h) const {
    const size_t r = ((size_t)b * nkv + h) * T;
    const size_t plane = (size_t)B * nkv * T;
    return Row{base + r * HD, base + (r + plane) * HD, scales + r, scales + r + plane};
  }
};

// The shared-memory tile of DEC_TILE positions: bf16 or f16 rows (K padded
// to 65 words, conflict-free dots), f32 rows (K padded to 129 words), or
// int8 rows (K padded to 33 words) with the positions' K and V scales.
template <typename E> struct DecTile {
  E k[DEC_TILE][HD + 4 / sizeof(E)];
  __align__(16) E v[DEC_TILE][HD];
};
template <> struct DecTile<int8_t> {
  __align__(16) int8_t k[DEC_TILE][HD + 4];
  __align__(16) int8_t v[DEC_TILE][HD];
  float ks[DEC_TILE];
  float vs[DEC_TILE];
};

// Elements d and d + 1 of a K row in the tile, as f32.
__device__ __forceinline__ float2 kpair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 kpair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 kpair(const float* p) { return make_float2(p[0], p[1]); }

// part_ml [B, n_kv, nsplit, g, 2] (max, sum); part_acc [B, n_kv, nsplit, g, HD];
// q of dtype code qdt (0 f32, 1 bf16, 2 f16).
template <int HPW, typename KV>  // query heads per warp: g <= DEC_WARPS * HPW
__global__ void __launch_bounds__(128) flash_decode_split_kernel(
    const void* __restrict__ q, int qdt, const KV kv, const int* __restrict__ lengths,
    int max_len, float* __restrict__ part_ml, float* __restrict__ part_acc,
    int nq, int nkv, int split_len, float scale) {
  using E = typename KV::Elem;
  constexpr bool Q8 = sizeof(E) == 1;
  constexpr int EPV = 16 / sizeof(E);      // elements per 16-byte load
  constexpr int GMAX = DEC_WARPS * HPW;
  __shared__ float qs[GMAX][HD];
  __shared__ DecTile<E> tile;
  __shared__ float ps[GMAX][DEC_TILE];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int g = nq / nkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), max_len);
  const int j0 = split * split_len;
  const int j1 = min(len, j0 + split_len);

  for (int i = tid; i < g * HD; i += 128) {
    const int gi = i / HD, d = i % HD;
    qs[gi][d] = load_act(q, qdt, ((size_t)b * nq + h * g + gi) * HD + d) * scale;
  }

  float m[HPW], l[HPW], acc[HPW][4];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
  const typename KV::Row rows = kv.row(b, h);
  for (int t0 = j0; t0 < j1; t0 += DEC_TILE) {
    const int n = min(DEC_TILE, j1 - t0);
    __syncthreads();  // previous tile fully consumed (and qs written)
    for (int i = tid; i < DEC_TILE * (HD / EPV); i += 128) {
      const int r = i / (HD / EPV), v = i % (HD / EPV);
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (r < n) {
        const size_t o = rows.off(t0 + r) + v * EPV;
        kk = *reinterpret_cast<const uint4*>(rows.k + o);
        vv = *reinterpret_cast<const uint4*>(rows.v + o);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(&tile.k[r][v * EPV]);
      kd[0] = kk.x; kd[1] = kk.y; kd[2] = kk.z; kd[3] = kk.w;
      *reinterpret_cast<uint4*>(&tile.v[r][v * EPV]) = vv;
    }
    if constexpr (Q8) {
      if (tid < DEC_TILE) tile.ks[tid] = tid < n ? rows.ks[t0 + tid] : 0.f;
      else if (tid < 2 * DEC_TILE) tile.vs[tid - DEC_TILE] = tid - DEC_TILE < n ? rows.vs[t0 + tid - DEC_TILE] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int gi = warp + DEC_WARPS * i;
      if (gi >= g) continue;  // warp-uniform
      float s = 0.f;
      if constexpr (Q8) {
#pragma unroll 8
        for (int d = 0; d < HD; d += 4) {
          const char4 kc = *reinterpret_cast<const char4*>(&tile.k[lane][d]);
          s = fmaf(qs[gi][d], static_cast<float>(kc.x), s);
          s = fmaf(qs[gi][d + 1], static_cast<float>(kc.y), s);
          s = fmaf(qs[gi][d + 2], static_cast<float>(kc.z), s);
          s = fmaf(qs[gi][d + 3], static_cast<float>(kc.w), s);
        }
        s *= tile.ks[lane];                      // K's scale on the score
      } else {
#pragma unroll 8
        for (int d = 0; d < HD; d += 2) {
          const float2 kf = kpair(&tile.k[lane][d]);
          s = fmaf(qs[gi][d], kf.x, s);
          s = fmaf(qs[gi][d + 1], kf.y, s);
        }
      }
      if (lane >= n) s = NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(s));  // finite: n >= 1
      const float alpha = __expf(m[i] - m_new);
      const float p = __expf(s - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      ps[gi][lane] = p;
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
      for (int j = 0; j < n; ++j) {
        if constexpr (Q8) {
          const float pj = ps[gi][j] * tile.vs[j];   // V's scale folded into p
          const char4 vc = *reinterpret_cast<const char4*>(&tile.v[j][lane * 4]);
          acc[i][0] = fmaf(pj, static_cast<float>(vc.x), acc[i][0]);
          acc[i][1] = fmaf(pj, static_cast<float>(vc.y), acc[i][1]);
          acc[i][2] = fmaf(pj, static_cast<float>(vc.z), acc[i][2]);
          acc[i][3] = fmaf(pj, static_cast<float>(vc.w), acc[i][3]);
        } else {
          const float pj = ps[gi][j];
          float v4[4];
          load4<E>(&tile.v[j][lane * 4], v4);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(pj, v4[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int gi = warp + DEC_WARPS * i;
    if (gi >= g) continue;
    const size_t slot = (((size_t)b * nkv + h) * nsplit + split) * g + gi;
    if (lane == 0) {
      part_ml[slot * 2] = m[i];
      part_ml[slot * 2 + 1] = l[i];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) part_acc[slot * HD + lane * 4 + e] = acc[i][e];
  }
}

// One block per (query head, row); thread d owns output element d of D.
// With CUR (K2, K8, K9) the current token's k/v fold in after the slices;
// q and out are of dtype code qdt, k_new and v_new of kdt. Without it (K14)
// q, k_new and v_new are not read.
template <int D, bool CUR>
__global__ void __launch_bounds__(D) flash_decode_combine_kernel(
    const void* __restrict__ q, const void* __restrict__ k_new,
    const void* __restrict__ v_new, const float* __restrict__ part_ml,
    const float* __restrict__ part_acc, void* __restrict__ out, int qdt, int kdt,
    int nq, int nkv, int nsplit, float scale) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int g = nq / nkv, h = hq / g, gi = hq % g;

  float s_c = NEG_INF;
  if constexpr (CUR) {
    __shared__ float red[D / 32];
    // score of the current token, (q * scale) . k_new, as in the split kernel
    const float qd = load_act(q, qdt, ((size_t)b * nq + hq) * D + d) * scale;
    float s = warp_sum(qd * load_act(k_new, kdt, ((size_t)b * nkv + h) * D + d));
    if ((d & 31) == 0) red[d >> 5] = s;
    __syncthreads();
    s_c = 0.f;
#pragma unroll
    for (int w = 0; w < D / 32; ++w) s_c += red[w];
  }

  float m_all = s_c;
  for (int sp = 0; sp < nsplit; ++sp) {
    const size_t slot = (((size_t)b * nkv + h) * nsplit + sp) * g + gi;
    m_all = fmaxf(m_all, part_ml[slot * 2]);
  }
  float l_all = 0.f, a = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const size_t slot = (((size_t)b * nkv + h) * nsplit + sp) * g + gi;
    const float ms = part_ml[slot * 2];
    if (ms == NEG_INF) continue;  // an empty slice (past len_b)
    const float w = __expf(ms - m_all);
    l_all = fmaf(part_ml[slot * 2 + 1], w, l_all);
    a = fmaf(part_acc[slot * D + d], w, a);
  }
  if constexpr (CUR) {
    const float p_c = __expf(s_c - m_all);
    l_all += p_c;
    a = fmaf(p_c, load_act(v_new, kdt, ((size_t)b * nkv + h) * D + d), a);
  }
  store_act(out, qdt, ((size_t)b * nq + hq) * D + d, a / l_all);
}

// K14's split kernel: the positions [j0, j1) of one (row, kv head) for a
// chunk of up to LAYER_HEADS query heads of that kv head's group (the
// grid's y is kv head x chunk: falcon-7b's 71 heads are 9 chunks, so each
// warp owns one head and the chunks run side by side; a chunk's blocks
// read the same K/V slice, from L2 after the first). Dynamic shared memory
// holds a DEC_TILE-position K/V tile, the chunk's scaled queries and its
// running state (max, sum, and the unnormalised output [heads][D], in f32).
// Warp w owns heads w, w + nwarps, ... of the chunk: lane j scores position
// j of the tile, then the warp folds the tile's weighted V rows into its
// head's state (lane owns D / 32 output elements).
// Layout [V tile | K tile (padded rows) | q | acc | ml | ps].
template <int D, typename E>
__global__ void __launch_bounds__(DEC_LAYER_THREADS) flash_decode_layer_split_kernel(
    const void* __restrict__ q, int qdt, const E* __restrict__ kc, const E* __restrict__ vc,
    int length, float* __restrict__ part_ml, float* __restrict__ part_acc, int nq, int nkv,
    int T, int split_len, float scale) {
  constexpr int EPV = 16 / sizeof(E);      // elements per 16-byte load
  constexpr int KROW = D + 4 / sizeof(E);  // a K row padded by one word
  constexpr int PL = D / 32;               // output elements per lane
  extern __shared__ __align__(16) unsigned char smem[];
  E* vt = reinterpret_cast<E*>(smem);
  E* kt = vt + DEC_TILE * D;
  const int g = nq / nkv;
  const int nwarps = blockDim.x >> 5;
  float* qs = reinterpret_cast<float*>(kt + DEC_TILE * KROW);
  float* acc = qs + LAYER_HEADS * D;
  float* ml = acc + LAYER_HEADS * D;
  float* ps = ml + 2 * LAYER_HEADS;

  const int nchunk = (g + LAYER_HEADS - 1) / LAYER_HEADS;
  const int split = blockIdx.x, h = blockIdx.y / nchunk, b = blockIdx.z;
  const int g0 = (blockIdx.y % nchunk) * LAYER_HEADS;   // the chunk's first head
  const int gc = min(LAYER_HEADS, g - g0);              // and its heads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = split * split_len;
  const int j1 = min(length, j0 + split_len);
  for (int i = tid; i < gc * D; i += blockDim.x) {
    qs[i] = load_act(q, qdt, ((size_t)b * nq + h * g + g0) * D + i) * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < gc; i += blockDim.x) {
    ml[2 * i] = NEG_INF;
    ml[2 * i + 1] = 0.f;
  }
  const size_t head = ((size_t)b * nkv + h) * T * D;
  for (int t0 = j0; t0 < j1; t0 += DEC_TILE) {
    const int n = min(DEC_TILE, j1 - t0);
    __syncthreads();  // previous tile fully consumed (and qs, acc, ml written)
    for (int i = tid; i < DEC_TILE * (D / EPV); i += blockDim.x) {
      const int r = i / (D / EPV), c = i % (D / EPV);
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (r < n) {
        const size_t o = head + (size_t)(t0 + r) * D + c * EPV;
        kk = *reinterpret_cast<const uint4*>(kc + o);
        vv = *reinterpret_cast<const uint4*>(vc + o);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(kt + r * KROW + c * EPV);
      kd[0] = kk.x; kd[1] = kk.y; kd[2] = kk.z; kd[3] = kk.w;
      *reinterpret_cast<uint4*>(vt + r * D + c * EPV) = vv;
    }
    __syncthreads();
    for (int gi = warp; gi < gc; gi += nwarps) {
      const float* qg = qs + gi * D;
      const E* kr = kt + lane * KROW;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 2) {
        const float2 kf = kpair(kr + d);
        s = fmaf(qg[d], kf.x, s);
        s = fmaf(qg[d + 1], kf.y, s);
      }
      if (lane >= n) s = NEG_INF;
      const float m_old = ml[2 * gi];
      const float m_new = fmaxf(m_old, warp_max(s));  // finite: n >= 1
      const float alpha = __expf(m_old - m_new);
      const float p = __expf(s - m_new);
      const float l_new = ml[2 * gi + 1] * alpha + warp_sum(p);
      ps[warp * DEC_TILE + lane] = p;
      __syncwarp();
      float* ag = acc + gi * D + lane * PL;
      float a[PL];
#pragma unroll
      for (int e = 0; e < PL; ++e) a[e] = ag[e] * alpha;
      for (int j = 0; j < n; ++j) {
        const float pj = ps[warp * DEC_TILE + j];
        float v[PL];
        if constexpr (PL == 4) {
          load4<E>(vt + j * D + lane * PL, v);
        } else {
          const float2 vf = kpair(vt + j * D + lane * PL);
          v[0] = vf.x;
          v[1] = vf.y;
        }
#pragma unroll
        for (int e = 0; e < PL; ++e) a[e] = fmaf(pj, v[e], a[e]);
      }
#pragma unroll
      for (int e = 0; e < PL; ++e) ag[e] = a[e];
      if (lane == 0) {
        ml[2 * gi] = m_new;
        ml[2 * gi + 1] = l_new;
      }
      __syncwarp();  // ps is the warp's next head's
    }
  }
  __syncthreads();
  const size_t slot0 = (((size_t)b * nkv + h) * gridDim.x + split) * g + g0;
  for (int i = tid; i < gc * D; i += blockDim.x) part_acc[slot0 * D + i] = acc[i];
  for (int i = tid; i < 2 * gc; i += blockDim.x) part_ml[slot0 * 2 + i] = ml[i];
}

// Bytes of K14's dynamic shared memory: at most 42 KB (D 128 over an f32
// cache), inside the 48 KB a launch gets without an opt-in attribute.
template <int D, typename E>
constexpr size_t layer_smem(int nwarps) {
  return (size_t)DEC_TILE * D * sizeof(E) + (size_t)DEC_TILE * (D + 4 / sizeof(E)) * sizeof(E)
         + ((size_t)2 * LAYER_HEADS * D + 2 * LAYER_HEADS + (size_t)nwarps * DEC_TILE)
           * sizeof(float);
}
static_assert(layer_smem<128, float>(LAYER_HEADS) <= 48 * 1024, "K14's tile outgrew 48 KB");

template <int D, typename E>
int run_decode_layer(const void* q, int qdt, const void* kc, const void* vc, int length,
                     float* ml, float* acc, void* out, int B, int nq, int nkv, int T,
                     int nsplit, int split_len, float scale, cudaStream_t st) {
  const int g = nq / nkv;
  const int nwarps = min(g, LAYER_HEADS);
  flash_decode_layer_split_kernel<D, E>
      <<<dim3(nsplit, nkv * cdiv(g, LAYER_HEADS), B), nwarps * 32,
         layer_smem<D, E>(nwarps), st>>>(
      q, qdt, static_cast<const E*>(kc), static_cast<const E*>(vc), length, ml, acc, nq, nkv,
      T, split_len, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<D, false><<<dim3(nq, B), D, 0, st>>>(
      nullptr, nullptr, nullptr, ml, acc, out, qdt, 0, nq, nkv, nsplit, 0.f);
  return static_cast<int>(cudaGetLastError());
}

constexpr int PF_BQ = 64, PF_BKV = 64, PF_PAD = 8;

// 8 consecutive cache elements as 8 MT values in one uint4.
template <typename E, typename MT>
__device__ __forceinline__ uint4 load8(const E* p) {
  if constexpr (sizeof(E) == 2) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    return make_uint4(pack2<MT>(a.x, a.y), pack2<MT>(a.z, a.w), pack2<MT>(b.x, b.y),
                      pack2<MT>(b.z, b.w));
  }
}

// q and out of dtype code qdt; the cache of E, staged as MT; head_dim D.
template <typename E, int D>
__global__ void __launch_bounds__(128) flash_prefill_kernel(
    const void* __restrict__ q, const E* __restrict__ cache, void* __restrict__ out,
    int qdt, int B, int S, int nq, int nkv, int T, int start_pos, float scale_log2) {
  using MT = typename MmaOf<E>::type;
  __shared__ __align__(16) MT ks[PF_BKV][D + PF_PAD];
  __shared__ __align__(16) MT vs[PF_BKV][D + PF_PAD];
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = qb * PF_BQ + warp * 16;   // chunk row of this warp's row 0
  const int ra = r0 + gq, rb = ra + 8;     // this thread's two rows

  // Q as A fragments, D / 16 k16 steps over D; rows past S are zeros
  uint32_t qa[D / 16][4];
  const size_t qrow_a = (((size_t)b * S + ra) * nq + h) * D;
  const size_t qrow_b = (((size_t)b * S + rb) * nq + h) * D;
  auto qpair = [&](size_t i) {
    return pack2<MT>(load_act(q, qdt, i), load_act(q, qdt, i + 1));
  };
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * tq;
    qa[kk][0] = ra < S ? qpair(qrow_a + c) : 0u;
    qa[kk][1] = rb < S ? qpair(qrow_b + c) : 0u;
    qa[kk][2] = ra < S ? qpair(qrow_a + c + 8) : 0u;
    qa[kk][3] = rb < S ? qpair(qrow_b + c + 8) : 0u;
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  const int pos_a = start_pos + ra, pos_b = start_pos + rb;

  const int last_row = min(qb * PF_BQ + PF_BQ, S) - 1;
  const int kv_end = min(start_pos + last_row + 1, T);  // causal frontier
  const E* kbase = cache + (((size_t)0 * B + b) * nkv + kvh) * (size_t)T * D;
  const E* vbase = cache + (((size_t)1 * B + b) * nkv + kvh) * (size_t)T * D;

  for (int j0 = 0; j0 < kv_end; j0 += PF_BKV) {
    for (int i = tid; i < PF_BKV * (D / 8); i += 128) {
      const int r = i / (D / 8), v = i % (D / 8);
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < kv_end) {
        kv = load8<E, MT>(kbase + (size_t)(j0 + r) * D + v * 8);
        vv = load8<E, MT>(vbase + (size_t)(j0 + r) * D + v * 8);
      }
      *reinterpret_cast<uint4*>(&ks[r][v * 8]) = kv;
      *reinterpret_cast<uint4*>(&vs[r][v * 8]) = vv;
    }
    __syncthreads();

    float sc[PF_BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < PF_BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const MT* krow = &ks[nt * 8 + gq][kk * 16 + 2 * tq];
        mma_16816<MT>(sc[nt], qa[kk], *reinterpret_cast<const uint32_t*>(krow),
                      *reinterpret_cast<const uint32_t*>(krow + 8));
      }
    }
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < PF_BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j0 + nt * 8 + 2 * tq + e;
        const bool live = key < kv_end;
        sc[nt][e] = (live && key <= pos_a) ? sc[nt][e] * scale_log2 : NEG_INF;
        sc[nt][2 + e] = (live && key <= pos_b) ? sc[nt][2 + e] * scale_log2 : NEG_INF;
        mx_a = fmaxf(mx_a, sc[nt][e]);
        mx_b = fmaxf(mx_b, sc[nt][2 + e]);
      }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row with no live key yet keeps max -inf; use 0 as its reference
    const float ref_a = mn_a == NEG_INF ? 0.f : mn_a;
    const float ref_b = mn_b == NEG_INF ? 0.f : mn_b;
    const float alpha_a = exp2f(m_a - ref_a), alpha_b = exp2f(m_b - ref_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < PF_BKV / 8; ++nt) {
      sc[nt][0] = exp2f(sc[nt][0] - ref_a);
      sc[nt][1] = exp2f(sc[nt][1] - ref_a);
      sc[nt][2] = exp2f(sc[nt][2] - ref_b);
      sc[nt][3] = exp2f(sc[nt][3] - ref_b);
      sum_a += sc[nt][0] + sc[nt][1];
      sum_b += sc[nt][2] + sc[nt][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha_a;
      o[dt][1] *= alpha_a;
      o[dt][2] *= alpha_b;
      o[dt][3] *= alpha_b;
    }
    // P (C layout of two n8 tiles) is the A fragment of one k16 step
#pragma unroll
    for (int kk = 0; kk < PF_BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack2<MT>(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack2<MT>(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack2<MT>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack2<MT>(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const int k_lo = kk * 16 + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int d = dt * 8 + gq;
        const uint32_t b0 = pack_bits<MT>(vs[k_lo][d], vs[k_lo + 1][d]);
        const uint32_t b1 = pack_bits<MT>(vs[k_lo + 8][d], vs[k_lo + 9][d]);
        mma_16816<MT>(o[dt], pa, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * tq;
    if (ra < S) {
      const size_t i = (((size_t)b * S + ra) * nq + h) * D + d;
      store_act(out, qdt, i, o[dt][0] * inv_a);
      store_act(out, qdt, i + 1, o[dt][1] * inv_a);
    }
    if (rb < S) {
      const size_t i = (((size_t)b * S + rb) * nq + h) * D + d;
      store_act(out, qdt, i, o[dt][2] * inv_b);
      store_act(out, qdt, i + 1, o[dt][3] * inv_b);
    }
  }
}

// ---- K3's bf16/f16 mode: wgmma fed by a TMA ring --------------------------

namespace k3 {
constexpr int BQ = 128;         // packed query rows of a block: two warpgroups of 64
constexpr int THREADS = 288;    // two consumer warpgroups and one producer warp
constexpr int STAGES = 3;
template <int D> __host__ __device__ constexpr int bkv() { return D == 128 ? 64 : 128; }
// the dtype code (1 bf16, 2 f16) of a tile type
template <typename MT> __host__ __device__ constexpr int dtype_code() {
  return std::is_same<MT, bf16>::value ? 1 : 2;
}
}  // namespace k3

// 8 consecutive q elements (dtype code qdt) as 8 MT values in one uint4.
template <typename MT>
__device__ __forceinline__ uint4 load8_q(const void* q, int qdt, size_t i) {
  if (qdt == k3::dtype_code<MT>())
    return *reinterpret_cast<const uint4*>(static_cast<const MT*>(q) + i);
  return make_uint4(pack2<MT>(load_act(q, qdt, i), load_act(q, qdt, i + 1)),
                    pack2<MT>(load_act(q, qdt, i + 2), load_act(q, qdt, i + 3)),
                    pack2<MT>(load_act(q, qdt, i + 4), load_act(q, qdt, i + 5)),
                    pack2<MT>(load_act(q, qdt, i + 6), load_act(q, qdt, i + 7)));
}

// Block x takes row tile n_tiles - 1 - x / (B * nkv) of (row b, kv head h)
// = x % (B * nkv): rows [128 tile, 128 tile + 128) of the S * g packed rows
// (position r / g, head-in-group r % g). Shared memory: Q (D / 64 panels of
// 128 rows x 128 bytes), then the ring's stages (K, then V: D / 64 panels of
// BKV rows x 128 bytes each), then the full and empty mbarriers.
template <typename MT, int D>
__global__ void __launch_bounds__(k3::THREADS, 1) flash_prefill_wgmma_kernel(
    const __grid_constant__ CUtensorMap kvmap, const void* __restrict__ q,
    void* __restrict__ out, int qdt, int B, int S, int nq, int nkv, int start_pos,
    int n_tiles, float scale_log2) {
  constexpr int NP = D / 64;                 // 128-byte panels along head_dim
  constexpr int BKV = k3::bkv<D>();
  constexpr int QP = k3::BQ * 128;           // one Q panel
  constexpr int PB = BKV * 128;              // one panel of a K or V tile
  constexpr int TB = NP * PB;                // a K (or V) tile
  constexpr int SB = 2 * TB;                 // a stage
  constexpr int NS = BKV / 2, NO = D / 2;    // S and O accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hop::align1024(smem_raw);
  uint8_t* ring = qs + NP * QP;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + k3::STAGES * SB);
  uint64_t* empty = full + k3::STAGES;

  const int g = nq / nkv, rows = S * g;
  const int bh = blockIdx.x % (B * nkv);
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / (B * nkv);
  const int b = bh / nkv, kvh = bh % nkv;
  const int r0 = tile * k3::BQ;
  const int frontier = start_pos + (min(r0 + k3::BQ, rows) - 1) / g + 1;   // keys [0, frontier)
  const int n_kv = (frontier + BKV - 1) / BKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < k3::STAGES; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], 256);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {   // the producer warp: one lane issues the TMA loads
    if (lane == 0) {
      const int hk = b * nkv + kvh, hv = (B + b) * nkv + kvh;   // planes of K and V
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % k3::STAGES;
        hop::mbar_wait(&empty[st], ((j / k3::STAGES) & 1) ^ 1);
        uint8_t* ks = ring + st * SB;
        hop::mbar_expect_tx(&full[st], SB);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          hop::tma_load_3d(ks + p * PB, &kvmap, &full[st], 64 * p, j * BKV, hk);
          hop::tma_load_3d(ks + TB + p * PB, &kvmap, &full[st], 64 * p, j * BKV, hv);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, t = threadIdx.x & 127, wi = t >> 5;
  // Q: this warpgroup's 64 rows, 16-byte chunks into the swizzled panels
  for (int i = t; i < 64 * NP * 8; i += 128) {
    const int rr = 64 * wg + i / (NP * 8), c = i % (NP * 8), row = r0 + rr;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows)
      v = load8_q<MT>(q, qdt, (((size_t)b * S + row / g) * nq + kvh * g + row % g) * D + 8 * c);
    *reinterpret_cast<uint4*>(qs + (c >> 3) * QP + hop::swz128(rr, 16 * (c & 7))) = v;
  }
  hop::fence_proxy_async();
  hop::bar_sync(1 + wg, 128);

  // this thread's rows 64 wg + 16 wi + lane / 4 (+ 8): the last key each attends
  const int rl = 64 * wg + 16 * wi + (lane >> 2);
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lim[h] = start_pos + min(r0 + rl + 8 * h, rows - 1) / g;
  const int lim_min = start_pos + r0 / g;    // tiles at or below it need no mask
  float o[NO], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % k3::STAGES;
    hop::mbar_wait(&full[st], (j / k3::STAGES) & 1);
    const uint8_t* ks = ring + st * SB;
    const uint8_t* vs = ks + TB;
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    hop::fence_regs<NS>(s);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * QP, koff = (kk >> 2) * PB, sub = (kk & 3) * 32;
      hop::WgmmaSS<MT, BKV>::mma(s, hop::desc_k128(qs + off + 64 * wg * 128 + sub),
                                 hop::desc_k128(ks + koff + sub));
    }
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs<NS>(s);

    const int j0 = j * BKV;
    const bool masked = j0 + BKV - 1 > lim_min;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[4 * jj + 2 * h + e];
          const int key = j0 + 8 * jj + 2 * (lane & 3) + e;
          v = (!masked || key <= lim[h]) ? v * scale_log2 : NEG_INF;
          mx[h] = fmaxf(mx[h], v);
        }
    float ref[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      ref[h] = mn == NEG_INF ? 0.f : mn;   // a row with no live key yet
      alpha[h] = exp2f(m[h] - ref[h]);
      m[h] = mn;
    }
#pragma unroll
    for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[4 * jj + 2 * h + e];
          v = exp2f(v - ref[h]);
          sum[h] += v;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * jj + 2 * h] *= alpha[h];
        o[4 * jj + 2 * h + 1] *= alpha[h];
      }
    // P in S's accumulator layout is wgmma's A fragment: keys 16kk.. of
    // step kk are accumulators 8kk..8kk+7
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack2<MT>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    hop::fence_regs<NO>(o);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      hop::WgmmaRSt<MT, D>::mma(o, pa[kk], hop::desc_mn128(vs + kk * 2048, PB));
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs<NO>(o);
    hop::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = r0 + rl + 8 * h;
    if (row >= rows) continue;
    const float inv = 1.f / l[h];
    const size_t base = (((size_t)b * S + row / g) * nq + kvh * g + row % g) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const size_t i = base + 8 * jj + 2 * (lane & 3);
      const float v0 = o[4 * jj + 2 * h] * inv, v1 = o[4 * jj + 2 * h + 1] * inv;
      if (qdt == k3::dtype_code<MT>()) {
        *reinterpret_cast<uint32_t*>(static_cast<MT*>(out) + i) = pack2<MT>(v0, v1);
      } else {
        store_act(out, qdt, i, v0);
        store_act(out, qdt, i + 1, v1);
      }
    }
  }
}

template <typename MT, int D>
int prefill_wgmma(const void* q, const void* cache, void* out, int B, int S, int nq, int nkv,
                  int T, int start_pos, int n_tiles, float scale_log2, int qdt,
                  cudaStream_t st) {
  static int smem_set = 0;
  constexpr int BKV = k3::bkv<D>();
  const int bytes = 1024 + (D / 64) * k3::BQ * 128 + k3::STAGES * (2 * (D / 64) * BKV * 128 + 16);
  CUtensorMap map;
  int err = hop::make_map3(&map, hop::TmaType<MT>::v, 2, cache, D, start_pos + S, 2ull * B * nkv,
                           D, (uint64_t)T * D, 64, BKV);
  auto kernel = flash_prefill_wgmma_kernel<MT, D>;
  if (!err) err = hop::allow_smem(kernel, bytes, &smem_set);
  if (err) return err;
  kernel<<<n_tiles * B * nkv, k3::THREADS, bytes, st>>>(map, q, out, qdt, B, S, nq, nkv,
                                                        start_pos, n_tiles, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int HPW, typename KV>
void launch_split(const void* q, int qdt, const KV& kv, const int* lengths, int max_len,
                  float* ml, float* acc, int B, int nq, int nkv, int nsplit,
                  int split_len, float scale, cudaStream_t st) {
  const dim3 grid(nsplit, nkv, B);
  flash_decode_split_kernel<HPW, KV><<<grid, 128, 0, st>>>(
      q, qdt, kv, lengths, max_len, ml, acc, nq, nkv, split_len, scale);
}

// The split kernel at the group's warp width, then the combine kernel. An
// f32 tile has room for 16 query heads per kv head (the 48 KB of static
// shared memory), the others for 32.
template <typename KV>
int run_decode(const void* q, const void* k_new, const void* v_new, int qdt, int kdt,
               const KV& kv, const void* lengths, int max_len, void* part_ml,
               void* part_acc, void* out, int B, int nq, int nkv, int nsplit,
               int split_len, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(lengths);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  const int g = nq / nkv;
  if (g <= 4) launch_split<1>(q, qdt, kv, lb, max_len, ml, acc, B, nq, nkv, nsplit, split_len, scale, st);
  else if (g <= 8) launch_split<2>(q, qdt, kv, lb, max_len, ml, acc, B, nq, nkv, nsplit, split_len, scale, st);
  else if (g <= 16) launch_split<4>(q, qdt, kv, lb, max_len, ml, acc, B, nq, nkv, nsplit, split_len, scale, st);
  else if constexpr (sizeof(typename KV::Elem) != 4) {
    if (g <= 32) launch_split<8>(q, qdt, kv, lb, max_len, ml, acc, B, nq, nkv, nsplit, split_len, scale, st);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<HD, true><<<dim3(nq, B), HD, 0, st>>>(
      q, k_new, v_new, ml, acc, out, qdt, kdt, nq, nkv, nsplit, scale);
  return static_cast<int>(cudaGetLastError());
}

// run_decode over the address functor F<E> of the cache dtype code cdt.
template <template <typename> class F, typename Make>
int run_typed(int cdt, Make make, const void* q, const void* k_new, const void* v_new,
              int qdt, int kdt, const void* lengths, int max_len, void* part_ml,
              void* part_acc, void* out, int B, int nq, int nkv, int nsplit,
              int split_len, float scale, void* stream) {
  switch (cdt) {
    case 0: return run_decode(q, k_new, v_new, qdt, kdt, make(F<float>{}), lengths, max_len,
                              part_ml, part_acc, out, B, nq, nkv, nsplit, split_len, scale,
                              stream);
    case 1: return run_decode(q, k_new, v_new, qdt, kdt, make(F<bf16>{}), lengths, max_len,
                              part_ml, part_acc, out, B, nq, nkv, nsplit, split_len, scale,
                              stream);
    case 2: return run_decode(q, k_new, v_new, qdt, kdt, make(F<__half>{}), lengths, max_len,
                              part_ml, part_acc, out, B, nq, nkv, nsplit, split_len, scale,
                              stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int run_prefill(const void* q, const void* cache, void* out, int B, int S, int nq, int nkv,
                int T, int start_pos, int n_tiles, float scale_log2, int qdt, int cdt,
                cudaStream_t st) {
  switch (cdt) {
    case 0: {
      const dim3 grid(cdiv(S, PF_BQ), nq, B);
      flash_prefill_kernel<float, D><<<grid, 128, 0, st>>>(
          q, static_cast<const float*>(cache), out, qdt, B, S, nq, nkv, T, start_pos,
          scale_log2);
      return static_cast<int>(cudaGetLastError());
    }
    case 1: return prefill_wgmma<bf16, D>(q, cache, out, B, S, nq, nkv, T, start_pos, n_tiles,
                                          scale_log2, qdt, st);
    case 2: return prefill_wgmma<__half, D>(q, cache, out, B, S, nq, nkv, T, start_pos,
                                            n_tiles, scale_log2, qdt, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Dtype codes: 0 f32, 1 bf16, 2 f16. q [B, nq, 128] and out of qdt;
// k_new, v_new [B, nkv, 128] of kdt; cache [2, B, nkv, T, 128] contiguous
// of cdt; lengths int32 [B] (each <= T); part_ml f32 [B, nkv, nsplit, g, 2];
// part_acc f32 [B, nkv, nsplit, g, 128]; nsplit * split_len >=
// max(lengths), split_len % 32 == 0; g = nq / nkv <= 32 (16 for an f32
// cache).
extern "C" int awq_flash_decode(const void* q, const void* k_new, const void* v_new,
                                const void* cache, const void* lengths,
                                void* part_ml, void* part_acc, void* out, int B,
                                int nq, int nkv, int T, int nsplit, int split_len,
                                float scale, int qdt, int kdt, int cdt, void* stream) {
  auto make = [&](auto tag) {
    using E = typename decltype(tag)::Elem;
    return ContigKV<E>{static_cast<const E*>(cache), B, nkv, T};
  };
  return run_typed<ContigKV>(cdt, make, q, k_new, v_new, qdt, kdt, lengths, T, part_ml,
                             part_acc, out, B, nq, nkv, nsplit, split_len, scale, stream);
}

// K8: as awq_flash_decode, over one layer of the page pool, pool
// [2, NP, nkv, page, 128] contiguous of cdt, with tables int32 [B, MP] of
// page ids in [0, NP); lengths are clamped to [0, MP * page];
// nsplit * split_len >= max(lengths).
extern "C" int awq_flash_decode_paged(const void* q, const void* k_new,
                                      const void* v_new, const void* pool,
                                      const void* tables, const void* lengths,
                                      void* part_ml, void* part_acc, void* out, int B,
                                      int nq, int nkv, int np, int page, int mp,
                                      int nsplit, int split_len, float scale, int qdt,
                                      int kdt, int cdt, void* stream) {
  auto make = [&](auto tag) {
    using E = typename decltype(tag)::Elem;
    return PagedKV<E>{static_cast<const E*>(pool), static_cast<const int*>(tables), np,
                      nkv, page, mp};
  };
  return run_typed<PagedKV>(cdt, make, q, k_new, v_new, qdt, kdt, lengths, mp * page,
                            part_ml, part_acc, out, B, nq, nkv, nsplit, split_len, scale,
                            stream);
}

// K9: as awq_flash_decode, over one layer of an int8 cache: codes int8
// [2, B, nkv, T, 128] and scales f32 [2, B, nkv, T], both contiguous; q,
// out, k_new and v_new of qdt.
extern "C" int awq_flash_decode_int8(const void* q, const void* k_new, const void* v_new,
                                     const void* codes, const void* scales,
                                     const void* lengths, void* part_ml, void* part_acc,
                                     void* out, int B, int nq, int nkv, int T, int nsplit,
                                     int split_len, float scale, int qdt, void* stream) {
  const Int8KV kv{static_cast<const int8_t*>(codes), static_cast<const float*>(scales), B,
                  nkv, T};
  return run_decode(q, k_new, v_new, qdt, qdt, kv, lengths, T, part_ml, part_acc, out, B,
                    nq, nkv, nsplit, split_len, scale, stream);
}

// q [B, S, nq, hd] contiguous of qdt; cache [2, B, nkv, T, hd] contiguous
// and 16-byte aligned, of cdt, with the chunk already written at
// [start_pos, start_pos + S); out [B, S, nq * hd] of qdt; hd 64 or 128, nq
// a multiple of nkv; n_tiles = ceil(S * nq / nkv / 128), the host plan's
// row tiles (ops/decode_attn.py::prefill_plan; the f32 mode ignores it);
// scale_log2 = log2(e) / sqrt(hd).
extern "C" int awq_flash_prefill(const void* q, const void* cache, void* out, int B,
                                 int S, int nq, int nkv, int T, int start_pos, int hd,
                                 int n_tiles, float scale_log2, int qdt, int cdt,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq % nkv || n_tiles != cdiv(S * (nq / nkv), k3::BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return run_prefill<64>(q, cache, out, B, S, nq, nkv, T, start_pos, n_tiles,
                                    scale_log2, qdt, cdt, st);
    case 128: return run_prefill<128>(q, cache, out, B, S, nq, nkv, T, start_pos, n_tiles,
                                      scale_log2, qdt, cdt, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K14: q [B, nq, hd] contiguous of qdt; k_cache, v_cache [B, nkv, T, hd],
// each contiguous, of cdt; positions [0, length) attended, 1 <= length <= T;
// part_ml f32 [B, nkv, nsplit, g, 2], part_acc f32 [B, nkv, nsplit, g, hd];
// nsplit * split_len >= length, split_len % 32 == 0; out [B, nq, hd] of qdt;
// hd 64 or 128, g = nq / nkv <= 128.
extern "C" int awq_flash_decode_layer(const void* q, const void* k_cache,
                                      const void* v_cache, void* part_ml, void* part_acc,
                                      void* out, int B, int nq, int nkv, int T, int length,
                                      int nsplit, int split_len, int hd, float scale,
                                      int qdt, int cdt, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
#define AWQ_LAYER(D_, E_) \
  return run_decode_layer<D_, E_>(q, qdt, k_cache, v_cache, length, ml, acc, out, B, nq, \
                                  nkv, T, nsplit, split_len, scale, st)
  if (nq % nkv || nq / nkv > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64) {
    switch (cdt) {
      case 0: AWQ_LAYER(64, float);
      case 1: AWQ_LAYER(64, bf16);
      case 2: AWQ_LAYER(64, __half);
    }
  } else if (hd == 128) {
    switch (cdt) {
      case 0: AWQ_LAYER(128, float);
      case 1: AWQ_LAYER(128, bf16);
      case 2: AWQ_LAYER(128, __half);
    }
  }
#undef AWQ_LAYER
  return static_cast<int>(cudaErrorInvalidValue);
}
