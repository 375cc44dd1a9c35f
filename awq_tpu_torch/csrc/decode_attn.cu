// K2, K8, K9, K14 (flash decode), K3 (causal flash prefill) and the window
// mode of K2 and K9 (the batched speculative verify) for Hopper (sm_90a).
//
// K2, K8 and K9 read ONE layer of the stacked cache, the contiguous view
// cache[l] = [2, B, n_kv, T, D] (K at index 0, V at 1), head-major so
// that each head's [T, D] slab is contiguous (K8 a page pool, K9 int8
// codes). K14 reads one layer's k_cache and v_cache [B, n_kv, T, D], two
// tensors. All five take head_dim 64 or 128 (a template parameter D) and
// up to 128 query heads a kv head (K3 any number); the unit decode_attn
// holds K2, K8 and K9 at D = 128 and up to 32 q heads a kv head, the unit
// decode_attn_wide (-DAWQ_DECODE_WIDE=1) their other shapes (Falcon-7B: 71
// q heads over one kv head at D = 64; BLOOM: 64 over 64). The cache is f32, bf16 or f16 (a template
// parameter, E); q, the current token's k/v and the output are f32, bf16
// or f16 too, each of its own dtype (a runtime code: they are read once
// per block), as the JAX kernels follow q.dtype and the cache's dtype apart.
//
// ---- Split flash decode: one body for K2, K8, K9 and K14 ------------------
//
// It replaces four TPU kernels of awq_tpu/ops/decode_attn.py (Pallas rows
// 9-12 of PERF.md's table):
// - K2, flash_decode_stacked (_stacked_decode_kernel): one query position
//   per row, GQA, an online softmax over the cache prefix [0, len_b) PLUS
//   the current token's k/v, which arrive as operands (not yet in the
//   cache), scale 1/sqrt(HD);
// - K8, flash_decode_paged (_paged_decode_kernel): K2's attention over one
//   layer of a page pool [2, NP, n_kv, page, HD] with a block table
//   tables [B, MP]; position p of row b lives at
//   pool[s, tables[b, p / page], h, p % page];
// - K9, flash_decode_stacked8 (_stacked_decode_kernel8): K2's attention
//   over one layer of an int8 cache, codes [2, B, n_kv, T, HD] and scales
//   [2, B, n_kv, T] f32 (one per position and head);
// - K14, flash_decode (_flash_decode_kernel): positions [0, length) of
//   k_cache/v_cache, one length for every row, the current token already
//   written (no operand for it), up to 128 query heads per kv head
//   (falcon-7b: 71 over one kv head at D = 64).
// The four differ only in where a position's K and V rows are (an address
// functor: ContigKV, PagedKV, Int8KV, LayerKV) and in the current token
// (a compile-time flag CUR, set for K2, K8 and K9).
// ALiBi (MPT, BLOOM; K2, K8, K9 and K14, the JAX kernel's has_bias; the
// unit decode_attn_alibi, -DAWQ_ALIBI=1, D 64 or 128, up to 32 q heads a
// kv head): slopes f32 [nq] in device memory, the score of position t
// gains slope * t before the running max (K9: after K's scale), and the
// current token of K2, K8 and K9 slope * len_b, as decode_attn.py:130-140
// and :218-219 add it
// (the row-relative slope * (t - len_b) differs by a constant of the row,
// which the softmax drops). The bias is compiled in, never tested at run
// time: a runtime branch on a null pointer, not taken, cost K2 3-7% and K3's
// head_dim-64 mode 5% against the parent build (scripts/ab_flash_decode.py,
// ab_prefill_attn.py), so the unit without it is the parent's code.
//
// What bounds it: the K and V bytes of the rows' prefixes, read once, at
// 3.35 TB/s (16.4 MB at Llama-3-8B B=1, length 4000: 4.9 us); each byte
// feeds a few FLOPs. At falcon's one kv head the layer is 256 KB at length
// 1000 (0.08 us): there latency and launches bound it, and so they do at
// every length of a call whose cluster merge and barriers are a fixed cost
// of a few microseconds (PERF.md). The design:
// - One launch a call. The positions of one (row b, kv head h) are cut
//   into `cluster` slices of `per` positions (a multiple of the 64-position
//   tile; 256-position units for K2 and K8, so that K8 slices rows as K2
//   does and returns K2's output bit for bit), one block each, and the
//   blocks of a slice set form one thread-block cluster (grid x = cluster
//   size <= 16, so that B * n_kv clusters fill the card). Each block keeps
//   its running (max, sum, unnormalised output) for the kv head's whole
//   query group in its own shared memory; after a cluster barrier each
//   block merges a slice of the g x D outputs over all the cluster's blocks
//   at once, a few blocks a lane, reading its peers' state through
//   distributed shared memory (mapa / ld.shared::cluster) in one round and
//   merging online, then across lanes by shuffles, folds in the current
//   token after the prefix as the TPU kernel does (decode_attn.py:220),
//   and writes the output. No partial buffers, no second launch; a cluster
//   of one block skips the barriers.
// - A ring of 2-4 stages of 64-position K/V tiles filled by 16-byte
//   cp.async copies (through L2; zero-filled past the slice), so that up to
//   three tiles are in flight while one is computed; every thread issues
//   its share, one commit group a stage. A tile's rows come from one
//   address where they are consecutive (K8: one table read a tile when a
//   page holds whole tiles), else row by row. Rows are stored with
//   their 16-byte chunks XOR-swizzled by the row's low three bits, which
//   keeps ldmatrix (and the f32 mode's vector loads) free of bank conflicts
//   (K9's int8 rows at D = 64 have four chunks: the low two bits).
// - The group's heads are the rows of one product. The q heads of the kv
//   head, padded to 16-row tiles (one for g <= 16, five for falcon's 71),
//   are A operands of mma.sync m16n8k16: S = Q.K^T over a warp's 16 (or
//   32) positions of the tile, then O += P.V with V read through
//   ldmatrix.trans, f32 sums. Warps split the tile's positions (4 warps of
//   16 for up to two row tiles, 2 of 32 above) and each keeps its own
//   online softmax; the block merges its warps before the cluster merge.
// - Numerics: q * scale stays f32 as in JAX (decode_attn.py:41, :127) by
//   splitting it into hi and lo halves of the mma type, two products into
//   the same sums; P is rounded to the cache's dtype for P.V as the TPU
//   kernel rounds it (decode_attn.py:81, :209) while the row sums add the
//   f32 weights. K9's codes widen exactly to f16 (byte permutes and one
//   subtraction, its mma type) in a second shared tile; K's scale
//   multiplies a position's score and V's its weight before the rounding,
//   as the TPU kernel does. An f32 cache takes a CUDA-core body
//   in the same fragment layout (q, K, V and P all f32).
// - A launch may split by the length it reads in device memory (DYN, the
//   *_dev entries: a decode step captured into a CUDA graph once and
//   replayed at every position). Its grid is planned for the bound of the
//   lengths; each block reads its row's length first and takes the slice
//   the host plan of that length gives it (dec_split, the formula of
//   decode_plan), the blocks past the length's slices leave, and the live
//   ones merge as a launch of that many blocks: a replay is bit-equal to
//   the launch planned on the host for its length, as K4 splits by the
//   position it reads (megakernel.cu, attn_split). The host-length entries
//   keep the plan's split.
// A block's first tile is copied before its row's length arrives (a
// memory latency less; not under DYN), so positions past len_b may be read there, never
// past T (MP * page for K8); they are masked, and their V rows zeroed
// before use. A row of length 0 returns its current token's v. Row lengths
// are clamped to [0, T] ([0, MP * page] for K8, so no table entry past MP
// is read).
//
// ---- The append, fused into K2, K8 and K9 ----------------------------------
//
// Every CUR launch also writes the current token into the layer's cache, the
// write JAX makes after its layer scan (awq_tpu/models/llama.py:1156,
// :1313-1332) and the port's K7 (csrc/cache_append.cu) made in a launch of
// its own over every layer's stacked [L, 2, B, n_kv, hd]: row b's k/v at
// position min(max(len_b, 0), T - 1) in the cache's dtype (K2), at page
// tables[b, p / page], offset p % page with p clamped to MP * page - 1 (K8;
// freed rows point at page 0, the trash page), or as quantize_kv's codes and
// scale (K9: D / 4 lanes a row, a shuffle max, s = max(absmax, 1e-6) *
// f32(1/127), codes rint(x / s) by a true division, 32-bit words, K7's int8
// arithmetic). The TPU could not fuse it (a single-position bf16 write
// breaks Mosaic's (8, 128) tile, awq_tpu/ops/cache_append.py:9-13); here it
// costs the step no launch and no stacking of every layer's k/v. K2 and K8
// append the current token they attend (k_new, v_new); K9 takes an append
// source of its own (k_app, v_app of dtype code adt: the current token, or
// for the int8 ALiBi step, which attends over its dequantized codes, the
// full-precision k/v it quantizes). Cluster rank 0
// of each (row, kv head) writes, after the cluster's last barrier (or, alone,
// after its own reads have landed): no block of the cluster reads the cache
// after that, so the attention never sees the write, even where a length at
// or past T puts it at position T - 1, inside the prefix read. Rank 0 is
// always live (DYN's dead ranks are the last ones). The write is compiled
// into every CUR instance, not tested at run time (the ALiBi lesson above);
// the destination is its own pointer (dst), the cache itself on the path,
// so that a test can send the write elsewhere and hold the output against
// the one that appended in place.
//
// ---- K3 -------------------------------------------------------------------
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
// exists in memory. ALiBi: with a slopes pointer both add the row-relative
// slope * (j - i) of query position i and key j to the f32 score in the
// exp2 domain (slope * log2(e)), before the running max, as the TPU kernel
// does (decode_attn.py:597-618): the scores stay bounded at long prompts,
// where slope * j would reach 512 at 2048 positions and an f32 ulp there
// is 6e-5.
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

#ifndef AWQ_ALIBI
#define AWQ_ALIBI 0
#endif
#ifndef AWQ_DECODE_WIDE
#define AWQ_DECODE_WIDE 0
#endif
#ifndef AWQ_DECODE_VERIFY
#define AWQ_DECODE_VERIFY 0
#endif
// The unit's mode: decode_attn (every entry without slopes; K2, K8 and K9 at
// head_dim 128 and up to 32 q heads a kv head), decode_attn_wide (K2, K8
// and K9 without slopes at the other shapes: head_dim 64, and up to 128 q
// heads a kv head; entries *_wide, no K3 or K14), decode_attn_alibi (K2,
// K3, K8, K9 and K14 with ALiBi slopes, entries *_alibi, up to 32 q heads a
// kv head), or decode_attn_verify (-DAWQ_DECODE_VERIFY=1: the window mode of
// K2 and K9 alone, entries awq_flash_verify and awq_flash_verify_int8; the
// section at the end of this file). The wide shapes live in a unit of their
// own so that decode_attn's instances stay the code they were.
constexpr bool UNIT_ALIBI = AWQ_ALIBI;
constexpr bool UNIT_WIDE = AWQ_DECODE_WIDE;

namespace {

constexpr int HD = 128;        // the head_dim of decode_attn's K2, K8 and K9
// -inf as a bit pattern (device code only)
#define NEG_INF (__int_as_float(0xff800000))

namespace dec {
constexpr int TILE = 64;             // positions of a ring stage
constexpr int MAX_CLUSTER = 16;      // blocks of a cluster (non-portable above 8)
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may have
}  // namespace dec

// q [B, nq, D] and out of dtype code qdt (0 f32, 1 bf16, 2 f16); k_new,
// v_new [B, nkv, D] of kdt (read with CUR only); `per` positions a block,
// `stages` ring stages. A launch that splits by the length it reads (DYN
// below) takes `want`, `unit` and `maxlen` of dec_split. With CUR, K2 and
// K8 append k_new, v_new to the cache; K9 quantizes and appends k_app,
// v_app [B, nkv, D] of adt (k_new, v_new, or for the int8 ALiBi step the
// full-precision token whose dequantized codes it attends over).
struct DecodeArgs {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* out;
  int qdt, kdt, nq, nkv, per, stages;
  float scale;
  const float* slopes;   // ALiBi slopes [nq] f32, or null
  int want, unit, maxlen;
  const void* k_app;
  const void* v_app;
  int adt;
};

// The append is staged before the tile loop (the values loaded, converted
// and quantized, the address computed while the first tiles fly) and
// stored at the launch's end, so that the store after the last barrier
// waits on no load: Pending holds one thread's share, `at` null for a
// thread without one.
struct Pending {
  uint4 w;
  uint4* at;
  __device__ __forceinline__ void store() const {
    if (at) *at = w;
  }
};
struct Pending8 {   // K9: a lane's 4 codes, and its row's scale from its first lane
  uint32_t w;
  float s;
  uint32_t* at;
  float* sat;
  __device__ __forceinline__ void store() const {
    if (at) *at = w;
    if (sat) *sat = s;
  }
};

// K2's and K8's share of thread threadIdx.x: a 16-byte vector of the current
// token's K (the first D / V threads) or V row (D elements of dtype code
// a.kdt at a.k_new, a.v_new + so) converted to the cache's E (as torch's
// .to: round to nearest even), for k or v. Every block has at least
// 2 D / V threads (128 threads; 2 D / V <= 64).
template <typename E, int D>
__device__ __forceinline__ Pending stage_token(E* k, E* v, const DecodeArgs& a, size_t so) {
  constexpr int V = 16 / (int)sizeof(E), NV = D / V;
  const int i = threadIdx.x;
  if (i >= 2 * NV) return Pending{make_uint4(0u, 0u, 0u, 0u), nullptr};
  const int s = i / NV, c = (i % NV) * V;
  const void* src = s ? a.v_new : a.k_new;
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (sizeof(E) == 4)
      w[e] = __float_as_uint(load_act(src, a.kdt, so + c + e));
    else
      w[e] = pack2<E>(load_act(src, a.kdt, so + c + 2 * e),
                      load_act(src, a.kdt, so + c + 2 * e + 1));
  }
  return Pending{make_uint4(w[0], w[1], w[2], w[3]), reinterpret_cast<uint4*>((s ? v : k) + c)};
}

// K9's share: quantize_kv of the current token's K and V rows, K7's int8
// arithmetic bit for bit (csrc/cache_append.cu): D / 4 lanes a row (threads
// [0, D / 2): two warps at D = 128, one at 64, so every lane of a warp
// takes part in the shuffles), a lane's 4 codes one 32-bit word, the scale
// from the row's first lane.
template <int D>
__device__ __forceinline__ Pending8 stage_token8(int8_t* ck, int8_t* cv, float* sk, float* sv,
                                                 const DecodeArgs& a, size_t so) {
  constexpr int LPR = D / 4;
  if (threadIdx.x >= 2 * LPR) return Pending8{0u, 0.f, nullptr, nullptr};
  const int s = threadIdx.x / LPR, lane = threadIdx.x % LPR;
  const void* src = s ? a.v_app : a.k_app;
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = load_act(src, a.adt, so + lane * 4 + e);
  float am = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
  const float sc = __fmul_rn(fmaxf(am, 1e-6f), 1.f / 127.f);
  uint32_t word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float c = fminf(fmaxf(rintf(x[e] / sc), -127.f), 127.f);
    word |= (static_cast<uint32_t>(static_cast<int>(c)) & 0xFFu) << (8 * e);
  }
  return Pending8{word, sc, reinterpret_cast<uint32_t*>((s ? cv : ck) + lane * 4),
                  lane == 0 ? (s ? sv : sk) : nullptr};
}

// Where the positions of (row b, kv head h) sit in one layer: row(b, h) is
// a cursor whose K and V rows of position t are at k + off(t) and
// v + off(t) (consecutive positions of a 64-position tile that starts on
// a multiple of 64 are consecutive rows where slab() holds); length(b) is
// row b's number of cached positions, and every position below bound() may
// be read whatever the length. stage(b, h, a) (K2, K8, K9) stages the
// current token of (row b, kv head h) for dst, the cache's layout (Pending).
template <typename E, int D>
struct ContigKV {  // K2: cache [2, B, n_kv, T, D]
  using Elem = E;
  const E* base;
  E* dst;
  const int* lengths;
  int B, nkv, T;
  struct Row {
    const E* k;
    const E* v;
    __device__ __forceinline__ size_t off(int t) const { return (size_t)t * D; }
    __device__ __forceinline__ bool slab() const { return true; }
  };
  __device__ __forceinline__ Row row(int b, int h) const {
    const E* k = base + ((size_t)b * nkv + h) * T * D;
    return Row{k, k + (size_t)B * nkv * T * D};
  }
  __device__ __forceinline__ int length(int b) const { return min(max(lengths[b], 0), T); }
  __device__ __forceinline__ int bound() const { return T; }
  using Pend = Pending;
  __device__ __forceinline__ Pending stage(int b, int h, const DecodeArgs& a) const {
    const int p = min(max(lengths[b], 0), T - 1);
    E* k = dst + (((size_t)b * nkv + h) * T + p) * D;
    return stage_token<E, D>(k, k + (size_t)B * nkv * T * D, a, ((size_t)b * nkv + h) * D);
  }
};
template <typename E, int D>
struct PagedKV {   // K8: pool [2, NP, n_kv, page, D], tables [B, MP]
  using Elem = E;
  const E* base;
  E* dst;
  const int* tables;
  const int* lengths;
  int np, nkv, page, mp;
  struct Row {
    const E* k;         // head h of page 0, K plane
    const E* v;         // the same in the V plane
    const int* tab;     // row b's table
    int pstride;        // elements from one page to the next: nkv * page * D
    int page;
    __device__ __forceinline__ size_t off(int t) const {
      return (size_t)__ldg(tab + t / page) * pstride + (size_t)(t % page) * D;
    }
    __device__ __forceinline__ bool slab() const { return page % dec::TILE == 0; }
  };
  __device__ __forceinline__ Row row(int b, int h) const {
    const E* k = base + (size_t)h * page * D;
    return Row{k, k + (size_t)np * nkv * page * D, tables + (size_t)b * mp,
               nkv * page * D, page};
  }
  __device__ __forceinline__ int length(int b) const { return min(max(lengths[b], 0), mp * page); }
  __device__ __forceinline__ int bound() const { return mp * page; }
  using Pend = Pending;
  __device__ __forceinline__ Pending stage(int b, int h, const DecodeArgs& a) const {
    const int p = min(max(lengths[b], 0), mp * page - 1);
    const int pid = tables[(size_t)b * mp + p / page];
    E* k = dst + (((size_t)pid * nkv + h) * page + p % page) * D;
    return stage_token<E, D>(k, k + (size_t)np * nkv * page * D, a, ((size_t)b * nkv + h) * D);
  }
};
template <int D>
struct Int8KV {    // K9: codes [2, B, n_kv, T, D] int8, scales [2, B, n_kv, T] f32
  using Elem = int8_t;
  const int8_t* base;
  const float* scales;
  int8_t* dst;          // the codes and scales the append writes
  float* dst_scales;
  const int* lengths;
  int B, nkv, T;
  struct Row {
    const int8_t* k;
    const int8_t* v;
    const float* ks;    // K scale of position t at ks[t]
    const float* vs;
    __device__ __forceinline__ size_t off(int t) const { return (size_t)t * D; }
    __device__ __forceinline__ bool slab() const { return true; }
  };
  __device__ __forceinline__ Row row(int b, int h) const {
    const size_t r = ((size_t)b * nkv + h) * T;
    const size_t plane = (size_t)B * nkv * T;
    return Row{base + r * D, base + (r + plane) * D, scales + r, scales + r + plane};
  }
  __device__ __forceinline__ int length(int b) const { return min(max(lengths[b], 0), T); }
  __device__ __forceinline__ int bound() const { return T; }
  using Pend = Pending8;
  __device__ __forceinline__ Pending8 stage(int b, int h, const DecodeArgs& a) const {
    const size_t r = ((size_t)b * nkv + h) * T + min(max(lengths[b], 0), T - 1);
    const size_t plane = (size_t)B * nkv * T;
    return stage_token8<D>(dst + r * D, dst + (r + plane) * D, dst_scales + r,
                           dst_scales + r + plane, a, ((size_t)b * nkv + h) * D);
  }
};
template <typename E, int D>
struct LayerKV {   // K14: k_cache, v_cache [B, n_kv, T, D], one length
  using Elem = E;
  const E* k;
  const E* v;
  int nkv, T, len;         // len: the length, or with lenp its host bound
  const int* lenp;         // the length in device memory, or null
  struct Row {
    const E* k;
    const E* v;
    __device__ __forceinline__ size_t off(int t) const { return (size_t)t * D; }
    __device__ __forceinline__ bool slab() const { return true; }
  };
  __device__ __forceinline__ Row row(int b, int h) const {
    const size_t r = ((size_t)b * nkv + h) * T * D;
    return Row{k + r, v + r};
  }
  __device__ __forceinline__ int length(int) const {
    return lenp ? min(max(*lenp, 1), len) : len;
  }
  __device__ __forceinline__ int bound() const { return len; }
  struct Pend {   // K14 appends nothing (its caller wrote the token)
    __device__ __forceinline__ void store() const {}
  };
};

// The split of a row of `length` positions: `n` slices of `per` positions,
// `per` a multiple of `unit`, about `want` slices and at least one
// (ops/decode_attn.py::decode_split mirrors it, and decode_plan plans a host
// length with it). Never more than min(want, ceil(length / unit)) slices,
// so a grid of that many blocks at the largest length covers every shorter
// one.
__host__ __device__ inline void dec_split(int length, int want, int unit, int* per, int* n) {
  int p = (length + want - 1) / want;
  p = (p + unit - 1) / unit * unit;
  p = p < unit ? unit : p;
  const int c = (length + p - 1) / p;
  *per = p;
  *n = c < 1 ? 1 : c;
}

// Shared memory of one block, in bytes (ops/decode_attn.py::decode_plan
// mirrors it): a header (the current token's scores sc[32], or one a q row
// of a wide group's K2, K8 and K9, and its v[D]), then
// the main region: q (hi and lo halves, or f32), the ring, K9's widened
// tile and the f32 mode's P; after the loop the merge's state overlays the
// main region.
struct DecLayout {
  int hdr, q, stage, ring, wide, ps, merge, total;
};
__host__ __device__ constexpr int round128(int x) { return (x + 127) & ~127; }
template <int D, int NPW, typename E, bool CUR>
__host__ __device__ inline DecLayout dec_layout(int g, int stages) {
  const int rows = 16 * ((g + 15) / 16), warps = rows / 16 * (dec::TILE / NPW);
  DecLayout L{};
  L.hdr = round128(((CUR && NPW == 32 ? rows : 32) + D) * 4);
  L.q = round128(rows * D * 4);
  L.stage = round128(2 * dec::TILE * D * (int)sizeof(E) + (sizeof(E) == 1 ? 2 * dec::TILE * 4 : 0));
  L.ring = stages * L.stage;
  L.wide = sizeof(E) == 1 ? 2 * dec::TILE * D * 2 : 0;
  L.ps = sizeof(E) == 4 ? warps * 16 * NPW * 4 : 0;
  L.merge = round128((warps * 16 * (D + 6) + 6 * rows) * 4);
  const int main_region = L.q + L.ring + L.wide + L.ps;
  L.total = L.hdr + (main_region > L.merge ? main_region : L.merge);
  return L;
}

// Four int8 codes (a word, the first in its low byte) as two f16x2 words,
// exactly: code c + 128 in the low byte of f16 1024 + (c + 128), less 1152.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t p[2] = {__byte_perm(u, 0x64646464u, 0x5140), __byte_perm(u, 0x64646464u, 0x7362)};
  const __half2 bias = __half2half2(__ushort_as_half(0x6480));
  const __half2 a = __hsub2(*reinterpret_cast<const __half2*>(&p[0]), bias);
  const __half2 b = __hsub2(*reinterpret_cast<const __half2*>(&p[1]), bias);
  lo = *reinterpret_cast<const uint32_t*>(&a);
  hi = *reinterpret_cast<const uint32_t*>(&b);
}

// Byte offset of 16-byte chunk c of row r in a tile of `rowb`-byte rows
// (at least 8 chunks a row): the chunk index XORed with the row's low bits.
__device__ __forceinline__ int swz(int r, int c, int rowb) { return r * rowb + ((c ^ (r & 7)) << 4); }

// The split-and-merge body. Block (rank, h, b) of a cluster of gridDim.x
// blocks takes positions [rank * per, min(len_b, (rank + 1) * per)) of
// (row b, kv head h). With DYN (a decode step captured once and replayed
// at every length, its grid planned for the bound a.maxlen) the block reads
// the row's length first and splits it as the host plans that length
// (dec_split): ranks past the length's slices return, and the others merge
// as a launch of that many blocks does, so the output is the host-planned
// launch's bit for bit. Warp w owns query-row tile w / PW (16 rows of the
// group, padded) and positions [(w % PW) * NPW, +NPW) of each tile; in
// mma.sync's C layout lane (gq, tq) = (lane / 4, lane % 4) holds rows gq
// and gq + 8, columns 2 tq, 2 tq + 1 of each 8-column piece.
template <int D, int NPW, bool CUR, typename KV, bool DYN>
__global__ void __launch_bounds__(NPW == 16 ? 256 : 512) flash_decode_kernel(const KV kv,
                                                                             const DecodeArgs a) {
  using E = typename KV::Elem;
  // the mma type: f16 over f16 and int8 (codes widen to f16 exactly by byte
  // permutes), else bf16
  using MT = typename std::conditional<sizeof(E) == 1, __half, typename MmaOf<E>::type>::type;
  constexpr bool I8 = sizeof(E) == 1, F32 = sizeof(E) == 4;
  constexpr int TILE = dec::TILE, PW = TILE / NPW;
  constexpr int ROWB = D * (int)sizeof(E);  // a ring row
  constexpr int CPR = ROWB / 16;            // its 16-byte chunks
  constexpr int MROWB = D * 2;              // a 16-bit row (q halves, K9's widened tile)
  static_assert((I8 ? CPR >= 4 : CPR >= 8) && MROWB / 16 >= 8,
                "a swizzled row needs 8 chunks (K9's int8 ring rows 4)");
  // a ring row's chunk c: swz, but K9's head_dim-64 rows (4 chunks) XOR with
  // the row's low two bits (only the widening pass reads them)
  constexpr int RSW = CPR >= 8 ? 7 : CPR - 1;
  auto rswz = [](int r, int c) { return r * ROWB + ((c ^ (r & RSW)) << 4); };
  extern __shared__ __align__(128) uint8_t smem[];

  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  int nsplit = gridDim.x, per = a.per, len_dyn = 0;
  if constexpr (DYN) {
    len_dyn = min(kv.length(b), a.maxlen);
    dec_split(len_dyn, a.want, a.unit, &per, &nsplit);
    if (rank >= nsplit) {   // no slice and no share of the merge; the barriers
      if (nsplit > 1) {     // of the cluster's live blocks
        hop::cluster_sync();
        hop::cluster_sync();
      }
      return;
    }
  }
  const int g = a.nq / a.nkv, rows = 16 * ((g + 15) / 16);
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nw = nthr >> 5;
  const DecLayout L = dec_layout<D, NPW, E, CUR>(g, a.stages);
  float* sc = reinterpret_cast<float*>(smem);        // [32] (or [rows]) the current token's scores
  float* vnew = sc + (CUR && NPW == 32 ? rows : 32);  // [D] the current token's v
  uint8_t* qs = smem + L.hdr;
  uint8_t* ring = qs + L.q;
  uint8_t* wide = ring + L.ring;
  float* ps = reinterpret_cast<float*>(wide + L.wide);
  // after the loop, over the main region: the warps' states, then per query
  // row the block's (max, sum) and its warps' weights
  float* wst = reinterpret_cast<float*>(smem + L.hdr);  // [nw][16][D + 4]
  float* wml = wst + nw * 16 * (D + 4);                  // [nw][16][2]
  float* bml = wml + nw * 16 * 2;                        // [rows][2]
  float* bw = bml + 2 * rows;                            // [rows][4]
  const size_t kvo = ((size_t)b * a.nkv + h) * D;       // this kv head's k_new / v_new
  const float vn = CUR && tid < D ? load_act(a.v_new, a.kdt, kvo + tid) : 0.f;

  const int p0 = rank * per;
  const typename KV::Row kvr = kv.row(b, h);

  // tile i of the slice into its ring stage, positions below `end`: K rows,
  // V rows (and K9's scales), zeros past `end`; a slab's rows from one
  // address (K8: one table read a tile)
  auto issue = [&](int i, int end) {
    uint8_t* st = ring + (i % a.stages) * L.stage;
    const int t0 = p0 + i * TILE;
    const bool slab = kvr.slab();
    const size_t o0 = slab ? kvr.off(t0) : 0;
    for (int c = tid; c < TILE * CPR; c += nthr) {
      const int r = c / CPR, ch = c % CPR, pos = t0 + r;
      const bool ok = pos < end;
      const size_t o =
          ok ? (slab ? o0 + (size_t)r * D : kvr.off(pos)) + ch * (16 / (int)sizeof(E)) : 0;
      hop::cp_async16(st + rswz(r, ch), kvr.k + o, ok);
      hop::cp_async16(st + TILE * ROWB + rswz(r, ch), kvr.v + o, ok);
    }
    if constexpr (I8) {
      float* scl = reinterpret_cast<float*>(st + 2 * TILE * ROWB);
      for (int c = tid; c < 2 * TILE; c += nthr) {
        const int pos = t0 + c % TILE;
        const bool ok = pos < end;
        hop::cp_async4(scl + c, (c < TILE ? kvr.ks : kvr.vs) + (ok ? pos : 0), ok);
      }
    }
  };
  // the first tile before the row's length is known (up to bound(): a
  // memory latency less), the ring's next ones once it is (DYN: known)
  const int spec = DYN ? min(len_dyn, p0 + per) : min(kv.bound(), p0 + per);
  if (spec > p0) issue(0, spec);
  hop::cp_async_commit();
  const int len = DYN ? len_dyn : kv.length(b);   // in flight with the q loads below

  // q * scale of the group's rows (zeros past g), while the first tiles fly:
  // 8 consecutive elements a chunk, a thread's two chunks of a pass loaded
  // before either is stored (the loads are cold: one latency, not sixteen).
  // With CUR each chunk adds its share of (q * scale) . k_new; the 16 (D/8)
  // chunks of a row sit in one half-warp.
  constexpr int QC = 8, CPQ = D / QC;
  const int nqc = rows * CPQ;
  for (int c0 = tid; c0 < nqc; c0 += 2 * nthr) {
    float v[2][QC], kn[2][QC];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = c0 + u * nthr, r = c / CPQ, d = (c % CPQ) * QC;
      const bool live = c < nqc && r < g;
      const size_t qo = ((size_t)b * a.nq + h * g + r) * D + d;
#pragma unroll
      for (int e = 0; e < QC; ++e) {
        v[u][e] = live ? load_act(a.q, a.qdt, qo + e) * a.scale : 0.f;
        kn[u][e] = CUR && live ? load_act(a.k_new, a.kdt, kvo + d + e) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = c0 + u * nthr, r = c / CPQ, d = (c % CPQ) * QC;
      if (c < nqc) {
        if constexpr (F32) {
          *reinterpret_cast<float4*>(qs + swz(r, d / 4, D * 4)) =
              make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
          *reinterpret_cast<float4*>(qs + swz(r, d / 4 + 1, D * 4)) =
              make_float4(v[u][4], v[u][5], v[u][6], v[u][7]);
        } else {
          uint32_t hi[QC / 2], lo[QC / 2];
#pragma unroll
          for (int e = 0; e < QC; e += 2) {
            hi[e / 2] = pack2<MT>(v[u][e], v[u][e + 1]);
            const MT* hp = reinterpret_cast<const MT*>(&hi[e / 2]);
            lo[e / 2] = pack2<MT>(v[u][e] - to_f32<MT>(hp[0]), v[u][e + 1] - to_f32<MT>(hp[1]));
          }
          const int off = swz(r, d / 8, MROWB);
          *reinterpret_cast<uint4*>(qs + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(qs + rows * MROWB + off) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
      if constexpr (CUR) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < QC; ++e) part = fmaf(v[u][e], kn[u][e], part);
#pragma unroll
        for (int o = CPQ / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (c < nqc && c % CPQ == 0 && r < g)
          sc[r] = UNIT_ALIBI ? part + a.slopes[h * g + r] * (float)len : part;
      }
    }
  }
  if (CUR && tid < D) vnew[tid] = vn;
  const int p1 = min(len, p0 + per);
  const int ntiles = p1 > p0 ? (p1 - p0 + TILE - 1) / TILE : 0;
  for (int s = 1; s < a.stages - 1; ++s) {
    if (s < ntiles) issue(s, p1);
    hop::cp_async_commit();
  }

  const int mt = warp / PW, c0 = (warp % PW) * NPW;   // row tile, first column
  const int gq = lane >> 2, tq = lane & 3;
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float slope[2] = {0.f, 0.f};   // ALiBi: rows gq, gq + 8 of row tile mt
  if constexpr (UNIT_ALIBI) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = mt * 16 + gq + 8 * r;
      slope[r] = row < g ? a.slopes[h * g + row] : 0.f;
    }
  }
  // rank 0 stages the append while the first tiles fly and stores it after
  // the cluster's last barrier (a block alone: after its own reads), when no
  // block of the cluster reads the cache any more
  typename KV::Pend pend{};
  if constexpr (CUR)
    if (rank == 0) pend = kv.stage(b, h, a);

  for (int i = 0; i < ntiles; ++i) {
    hop::cp_async_wait_pending(a.stages - 2);   // tile i has landed (this thread's copies)
    __syncthreads();                            // everyone's, and tile i - 1 is consumed
    if (i + a.stages - 1 < ntiles) issue(i + a.stages - 1, p1);
    hop::cp_async_commit();
    uint8_t* st = ring + (i % a.stages) * L.stage;
    const int t0 = p0 + i * TILE;
    if (i == 0 && min(spec, t0 + TILE) > p1) {   // the first tile ran past the row's end:
      const int r0 = p1 - t0;                   // zero V there (0 * NaN is NaN)
      for (int c = tid; c < (TILE - r0) * CPR; c += nthr)
        *reinterpret_cast<uint4*>(st + TILE * ROWB + rswz(r0 + c / CPR, c % CPR)) =
            make_uint4(0u, 0u, 0u, 0u);
      if constexpr (I8)
        for (int c = r0 + tid; c < TILE; c += nthr)
          reinterpret_cast<float*>(st + 2 * TILE * ROWB)[TILE + c] = 0.f;
      __syncthreads();
    }
    const uint8_t* kt = st;
    const uint8_t* vt = st + TILE * ROWB;
    const float* kscale = nullptr;
    const float* vscale = nullptr;
    if constexpr (I8) {   // widen the codes to f16 (exact) in the second tile
      for (int c = tid; c < 2 * TILE * CPR; c += nthr) {
        const int kvs = c / (TILE * CPR), rem = c - kvs * TILE * CPR;
        const int r = rem / CPR, ch = rem % CPR;
        const uint4 w = *reinterpret_cast<const uint4*>(st + kvs * TILE * ROWB + rswz(r, ch));
        uint32_t x[8];
        widen4(w.x, x[0], x[1]);
        widen4(w.y, x[2], x[3]);
        widen4(w.z, x[4], x[5]);
        widen4(w.w, x[6], x[7]);
        uint8_t* dst = wide + kvs * TILE * MROWB;
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * ch, MROWB)) = make_uint4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * ch + 1, MROWB)) =
            make_uint4(x[4], x[5], x[6], x[7]);
      }
      __syncthreads();
      kt = wide;
      vt = wide + TILE * MROWB;
      kscale = reinterpret_cast<const float*>(st + 2 * TILE * ROWB);
      vscale = kscale + TILE;
    }

    // S = (q * scale) . K^T over this warp's NPW columns (the lo half's
    // products in sl: two shorter chains of dependent mma)
    float s[NPW / 8][4], sl[NPW / 8][4];
#pragma unroll
    for (int j = 0; j < NPW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
    if constexpr (F32) {
      const int ra = mt * 16 + gq;
#pragma unroll 4
      for (int c = 0; c < D / 4; ++c) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + swz(ra, c, D * 4));
        const float4 qb = *reinterpret_cast<const float4*>(qs + swz(ra + 8, c, D * 4));
#pragma unroll
        for (int j = 0; j < NPW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 k4 =
                *reinterpret_cast<const float4*>(kt + swz(c0 + 8 * j + 2 * tq + e, c, ROWB));
            s[j][e] = fmaf(qa.w, k4.w, fmaf(qa.z, k4.z, fmaf(qa.y, k4.y, fmaf(qa.x, k4.x, s[j][e]))));
            s[j][2 + e] =
                fmaf(qb.w, k4.w, fmaf(qb.z, k4.z, fmaf(qb.y, k4.y, fmaf(qb.x, k4.x, s[j][2 + e]))));
          }
      }
    } else {
      const int qrow = mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      const int krow = c0 + (lane & 7) + 8 * (lane >> 4);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qh[4], ql[4];
        const int qo = swz(qrow, 2 * kk + (lane >> 4), MROWB);
        hop::ldsm_x4(qh, qs + qo);
        hop::ldsm_x4(ql, qs + rows * MROWB + qo);
#pragma unroll
        for (int np = 0; np < NPW / 16; ++np) {
          uint32_t kb[4];
          hop::ldsm_x4(kb, kt + swz(krow + 16 * np, 2 * kk + ((lane >> 3) & 1), MROWB));
          mma_16816<MT>(s[2 * np], qh, kb[0], kb[1]);
          mma_16816<MT>(sl[2 * np], ql, kb[0], kb[1]);
          mma_16816<MT>(s[2 * np + 1], qh, kb[2], kb[3]);
          mma_16816<MT>(sl[2 * np + 1], ql, kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NPW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += sl[j][e];
    }

    // online softmax of rows gq, gq + 8 (K9: K's scale on the score)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NPW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + 2 * tq + e;
        const bool live = t0 + col < p1;
        float sa = s[j][e], sb = s[j][2 + e];
        if constexpr (I8) {
          sa *= kscale[col];
          sb *= kscale[col];
        }
        if constexpr (UNIT_ALIBI) {
          const float pos = (float)(t0 + col);
          sa += slope[0] * pos;
          sb += slope[1] * pos;
        }
        s[j][e] = live ? sa : NEG_INF;
        s[j][2 + e] = live ? sb : NEG_INF;
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    float ref[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      ref[r] = mn == NEG_INF ? 0.f : mn;   // no live column yet: weights 0
      alpha[r] = __expf(m[r] - ref[r]);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < NPW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = __expf(s[j][e] - ref[0]);
        s[j][2 + e] = __expf(s[j][2 + e] - ref[1]);
        sum[0] += s[j][e];
        sum[1] += s[j][2 + e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P . V
    if constexpr (F32) {
      float* pw = ps + warp * 16 * NPW;
#pragma unroll
      for (int j = 0; j < NPW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pw[gq * NPW + 8 * j + 2 * tq + e] = s[j][e];
          pw[(gq + 8) * NPW + 8 * j + 2 * tq + e] = s[j][2 + e];
        }
      __syncwarp();
      for (int j = 0; j < NPW; ++j) {
        const float pa = pw[gq * NPW + j], pb = pw[(gq + 8) * NPW + j];
        const uint8_t* vrow = vt + (c0 + j) * ROWB;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const int ch = 2 * dn + (tq >> 1);
          const float2 v2 = *reinterpret_cast<const float2*>(
              vrow + ((ch ^ ((c0 + j) & 7)) << 4) + (tq & 1) * 8);
          o[dn][0] = fmaf(pa, v2.x, o[dn][0]);
          o[dn][1] = fmaf(pa, v2.y, o[dn][1]);
          o[dn][2] = fmaf(pb, v2.x, o[dn][2]);
          o[dn][3] = fmaf(pb, v2.y, o[dn][3]);
        }
      }
      __syncwarp();
    } else {
      const int vrow = c0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int kk = 0; kk < NPW / 16; ++kk) {
        float w[4] = {1.f, 1.f, 1.f, 1.f};   // K9: V's scale of columns 2tq, +1, +8, +9
        if constexpr (I8) {
          const int col = c0 + 16 * kk + 2 * tq;
          w[0] = vscale[col];
          w[1] = vscale[col + 1];
          w[2] = vscale[col + 8];
          w[3] = vscale[col + 9];
        }
        uint32_t pa[4];
        pa[0] = pack2<MT>(s[2 * kk][0] * w[0], s[2 * kk][1] * w[1]);
        pa[1] = pack2<MT>(s[2 * kk][2] * w[0], s[2 * kk][3] * w[1]);
        pa[2] = pack2<MT>(s[2 * kk + 1][0] * w[2], s[2 * kk + 1][1] * w[3]);
        pa[3] = pack2<MT>(s[2 * kk + 1][2] * w[2], s[2 * kk + 1][3] * w[3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vb[4];
          hop::ldsm_x4_trans(vb, vt + swz(vrow + 16 * kk, 2 * dp + (lane >> 4), MROWB));
          mma_16816<MT>(o[2 * dp], pa, vb[0], vb[1]);
          mma_16816<MT>(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

  // each warp's state into shared memory (over the ring: all copies
  // landed), rows padded to DP floats so that a store's 8 rows differ in bank
  constexpr int DP = D + 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  hop::cp_async_wait_all();
  __syncthreads();
  float* ws = wst + warp * 16 * DP;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(ws + (gq + 8 * r) * DP + 8 * dn + 2 * tq) =
          make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
  if (tq == 0) {
    *reinterpret_cast<float2*>(wml + (warp * 16 + gq) * 2) = make_float2(m[0], l[0]);
    *reinterpret_cast<float2*>(wml + (warp * 16 + gq + 8) * 2) = make_float2(m[1], l[1]);
  }
  __syncthreads();
  // the block's state: its PW warps of each row tile merged into the first
  // one's slot, the rows' weights computed once (a warp with no live
  // position weighs 0; its output and sum are 0)
  for (int r = tid; r < g; r += nthr) {
    const int rr = r % 16, w0 = (r / 16) * PW;
    float mb = NEG_INF, lb = 0.f;
#pragma unroll
    for (int p = 0; p < PW; ++p) mb = fmaxf(mb, wml[((w0 + p) * 16 + rr) * 2]);
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      const float mw = wml[((w0 + p) * 16 + rr) * 2];
      const float wgt = mw == NEG_INF ? 0.f : __expf(mw - mb);
      lb = fmaf(wml[((w0 + p) * 16 + rr) * 2 + 1], wgt, lb);
      bw[r * 4 + p] = wgt;
    }
    bml[2 * r] = mb;
    bml[2 * r + 1] = lb;
  }
  __syncthreads();
  const int n4 = g * (D / 4);
  for (int i = tid; i < n4; i += nthr) {
    const int r = i / (D / 4), d = (i % (D / 4)) * 4, rr = r % 16, w0 = (r / 16) * PW;
    float4 ob = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      const float4 ow = *reinterpret_cast<const float4*>(wst + ((w0 + p) * 16 + rr) * DP + d);
      const float wgt = bw[r * 4 + p];
      ob = make_float4(fmaf(ow.x, wgt, ob.x), fmaf(ow.y, wgt, ob.y), fmaf(ow.z, wgt, ob.z),
                       fmaf(ow.w, wgt, ob.w));
    }
    *reinterpret_cast<float4*>(wst + (w0 * 16 + rr) * DP + d) = ob;
  }

  // The cluster merge: `le` consecutive lanes (a power of two) take an
  // output float4 of this block's share of the g x D outputs, each reading
  // the (max, sum) and that float4 of its blocks (ranks lane, lane + le,
  // ...) in one round of remote loads and merging them online, then across
  // the lanes by shuffles (as many lanes as the threads allow, so that every
  // remote load is in flight at once); the first lane folds in the current
  // token. A block alone (the same arithmetic) needs no cluster.
  if (nsplit == 1) {
    __syncthreads();
    for (int i = tid; i < n4; i += nthr) {
      const int r = i / (D / 4), d = (i % (D / 4)) * 4;
      const float2 ml = *reinterpret_cast<const float2*>(bml + 2 * r);
      const float s_c = CUR ? sc[r] : NEG_INF;
      const float m_all = fmaxf(ml.x, s_c);
      const float wgt = ml.x == NEG_INF ? 0.f : __expf(ml.x - m_all);
      const float p_c = CUR ? __expf(s_c - m_all) : 0.f;
      const float den = ml.y * wgt + p_c;
      const float4 ov =
          *reinterpret_cast<const float4*>(wst + ((r / 16) * PW * 16 + r % 16) * DP + d);
      const float acc[4] = {ov.x * wgt, ov.y * wgt, ov.z * wgt, ov.w * wgt};
      const size_t oo = ((size_t)b * a.nq + h * g + r) * D + d;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_act(a.out, a.qdt, oo + e,
                  (CUR ? fmaf(p_c, vnew[d + e], acc[e]) : acc[e]) / den);
    }
    pend.store();   // rank 0: the block's reads have all landed
    return;
  }
  const int lo = rank * n4 / nsplit, hi = (rank + 1) * n4 / nsplit;
  int le = 1;
  while (le < nsplit && 2 * le * (hi - lo) <= nthr) le *= 2;
  hop::cluster_sync();
  for (int i = tid; i < ((hi - lo) * le + 31) / 32 * 32; i += nthr) {
    const int item = lo + i / le, p = i % le;
    const bool in = item < hi;
    const int r = in ? item / (D / 4) : 0, d = (item % (D / 4)) * 4;
    const float* op = wst + ((r / 16) * PW * 16 + r % 16) * DP + d;
    float m = NEG_INF, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
    // (m, l, acc) += (mq, lq, oq), online: weights against the larger max
    auto fold = [&](float mq, float lq, const float* oq) {
      const float mn = fmaxf(m, mq), ref = mn == NEG_INF ? 0.f : mn;
      const float wa = __expf(m - ref), wb = __expf(mq - ref);
      l = l * wa + lq * wb;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = acc[e] * wa + oq[e] * wb;
      m = mn;
    };
#pragma unroll
    for (int j0 = 0; j0 < dec::MAX_CLUSTER; j0 += 4) {
      if (j0 * le >= nsplit) break;   // the lanes hold every block already
      float2 ml[4];
      float4 ov[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {   // a slice with no position: max -inf, zeros
        const int q = p + (j0 + j) * le;
        ml[j] = make_float2(NEG_INF, 0.f);
        ov[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in && q < nsplit) {
          ml[j] = hop::ld_cluster_f32x2(hop::cluster_map(bml + 2 * r, q));
          ov[j] = hop::ld_cluster_f32x4(hop::cluster_map(op, q));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float oq[4] = {ov[j].x, ov[j].y, ov[j].z, ov[j].w};
        fold(ml[j].x, ml[j].y, oq);
      }
    }
    for (int x = le / 2; x > 0; x >>= 1) {
      float oq[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) oq[e] = __shfl_xor_sync(~0u, acc[e], x);
      const float mq = __shfl_xor_sync(~0u, m, x), lq = __shfl_xor_sync(~0u, l, x);
      fold(mq, lq, oq);
    }
    if (in && p == 0) {
      const float s_c = CUR ? sc[r] : NEG_INF;
      const float m_all = fmaxf(m, s_c);
      const float wgt = m == NEG_INF ? 0.f : __expf(m - m_all);
      const float p_c = CUR ? __expf(s_c - m_all) : 0.f;
      const float den = l * wgt + p_c;
      const size_t oo = ((size_t)b * a.nq + h * g + r) * D + d;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_act(a.out, a.qdt, oo + e,
                  (CUR ? fmaf(p_c, vnew[d + e], acc[e] * wgt) : acc[e] * wgt) / den);
    }
  }
  hop::cluster_sync();   // the peers are done reading this block's state
  pend.store();          // rank 0: every block of the cluster is done reading the cache
}

// One launch of the body as clusters of `cluster` blocks along x. The
// plan (ops/decode_attn.py::decode_plan) is checked, not adjusted: a plan
// the kernel cannot run, or a cluster the card cannot schedule, returns
// cudaErrorInvalidValue. DYN: the cluster must hold the most slices of any
// length up to a.maxlen.
template <int D, int NPW, bool CUR, bool DYN, typename KV>
int launch_decode(const KV& kv, const DecodeArgs& a, int B, int cluster, int smem,
                  cudaStream_t st) {
  using E = typename KV::Elem;
  static int smem_set = 0, nonportable = 0, checked[dec::MAX_CLUSTER + 1] = {0};
  const int g = a.nq / a.nkv;
  if (a.stages < 2 || a.stages > 4 || cluster < 1 || cluster > dec::MAX_CLUSTER ||
      a.per < dec::TILE || a.per % dec::TILE || smem > dec::SMEM_MAX ||
      smem != dec_layout<D, NPW, E, CUR>(g, a.stages).total)
    return static_cast<int>(cudaErrorInvalidValue);
  if (DYN) {
    const int most = a.unit > 0 && cdiv(a.maxlen, a.unit) < a.want ? cdiv(a.maxlen, a.unit)
                                                                    : a.want;
    if (a.want < 1 || a.unit < dec::TILE || a.unit % dec::TILE || a.maxlen < 0 ||
        cluster < most)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_decode_kernel<D, NPW, CUR, KV, DYN>;
  int err = hop::allow_smem(kernel, smem, &smem_set);
  if (err) return err;
  if (cluster > 8 && !nonportable) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    nonportable = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, a.nkv, B);
  cfg.blockDim = dim3(32 * ((g + 15) / 16) * (dec::TILE / NPW));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem > checked[cluster]) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
    checked[cluster] = smem;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, kv, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// K2, K8 and K9 at head_dim D (the address functor's): one 16-row tile of q
// heads a warp and 4 warps a tile up to 32 q heads a kv head, 2 warps (32
// positions each) up to 128, as K14. Each unit builds its own share
// (UNIT_WIDE, UNIT_ALIBI above); another shape returns cudaErrorInvalidValue
// (the wrappers route it to the unit that has it, or raise first).
template <int D, bool DYN, typename KV>
int run_decode(const KV& kv, const DecodeArgs& a, int B, int cluster, int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = a.nkv > 0 ? a.nq / a.nkv : 0;
  if (g < 1 || a.nq % a.nkv || g > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (g <= 32) {
    // decode_attn's own instances are not rebuilt in the wide unit
    if constexpr (UNIT_WIDE && D == HD) return static_cast<int>(cudaErrorInvalidValue);
    else return launch_decode<D, 16, true, DYN>(kv, a, B, cluster, smem, st);
  }
  if constexpr (UNIT_WIDE) return launch_decode<D, 32, true, DYN>(kv, a, B, cluster, smem, st);
  else return static_cast<int>(cudaErrorInvalidValue);
}

// fn(std::integral_constant<int, D>) for head_dim hd: 128 in decode_attn
// (its instances), 64 or 128 in the wide and ALiBi units.
template <typename Fn>
int by_head_dim(int hd, Fn fn) {
  if (hd == 128) return fn(std::integral_constant<int, 128>{});
  if constexpr (UNIT_WIDE || UNIT_ALIBI)
    if (hd == 64) return fn(std::integral_constant<int, 64>{});
  return static_cast<int>(cudaErrorInvalidValue);
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
    int qdt, int B, int S, int nq, int nkv, int T, int start_pos, float scale_log2,
    const float* __restrict__ slopes) {
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
  // ALiBi: this head's slope in the exp2 domain
  const float sl2 = UNIT_ALIBI ? slopes[h] * 1.4426950408889634f : 0.f;

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
        float va = sc[nt][e] * scale_log2, vb = sc[nt][2 + e] * scale_log2;
        if constexpr (UNIT_ALIBI) {
          va += sl2 * (float)(key - pos_a);
          vb += sl2 * (float)(key - pos_b);
        }
        sc[nt][e] = (live && key <= pos_a) ? va : NEG_INF;
        sc[nt][2 + e] = (live && key <= pos_b) ? vb : NEG_INF;
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
    int n_tiles, float scale_log2, const float* __restrict__ slopes) {
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
  // ALiBi: each row's head's slope in the exp2 domain
  float sl2[2] = {0.f, 0.f};
  if constexpr (UNIT_ALIBI) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sl2[h] = slopes[kvh * g + min(r0 + rl + 8 * h, rows - 1) % g] * 1.4426950408889634f;
  }
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
    if constexpr (UNIT_ALIBI) {   // + slope * (key - query position), key = rel + 8jj + e
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float rel = (float)(j0 + 2 * (lane & 3) - lim[h]);
#pragma unroll
        for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = s[4 * jj + 2 * h + e];
            v = fmaf(v, scale_log2, sl2[h] * (rel + (float)(8 * jj + e)));
          }
      }
    }
#pragma unroll
    for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[4 * jj + 2 * h + e];
          const int key = j0 + 8 * jj + 2 * (lane & 3) + e;
          v = (!masked || key <= lim[h]) ? (UNIT_ALIBI ? v : v * scale_log2) : NEG_INF;
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
                  const float* slopes, cudaStream_t st) {
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
                                                        start_pos, n_tiles, scale_log2, slopes);
  return static_cast<int>(cudaGetLastError());
}

// run_decode at head_dim D over the address functor F<E, D> of the cache
// dtype code cdt.
template <int D, bool DYN, template <typename, int> class F, typename Make>
int run_typed(int cdt, Make make, const DecodeArgs& a, int B, int cluster, int smem,
              void* stream) {
  switch (cdt) {
    case 0: return run_decode<D, DYN>(make(F<float, D>{}), a, B, cluster, smem, stream);
    case 1: return run_decode<D, DYN>(make(F<bf16, D>{}), a, B, cluster, smem, stream);
    case 2: return run_decode<D, DYN>(make(F<__half, D>{}), a, B, cluster, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K14 at head_dim D over a cache of E: one 16-row tile of q heads a warp
// and 4 warps a tile up to 32 heads, 2 warps (32 positions each) above.
template <int D, bool DYN, typename E>
int run_layer(const void* kc, const void* vc, int nkv, int T, int length, const int* lenp,
              const DecodeArgs& a, int B, int cluster, int smem, cudaStream_t st) {
  const LayerKV<E, D> kv{static_cast<const E*>(kc), static_cast<const E*>(vc), nkv, T, length,
                         lenp};
  if (a.nq / nkv <= 32) return launch_decode<D, 16, false, DYN>(kv, a, B, cluster, smem, st);
  // the ALiBi families are MHA: their unit builds no wide-group instance
  if constexpr (UNIT_ALIBI) return static_cast<int>(cudaErrorNotSupported);
  else return launch_decode<D, 32, false, DYN>(kv, a, B, cluster, smem, st);
}

template <int D>
int run_prefill(const void* q, const void* cache, void* out, int B, int S, int nq, int nkv,
                int T, int start_pos, int n_tiles, float scale_log2, int qdt, int cdt,
                const float* slopes, cudaStream_t st) {
  switch (cdt) {
    case 0: {
      const dim3 grid(cdiv(S, PF_BQ), nq, B);
      flash_prefill_kernel<float, D><<<grid, 128, 0, st>>>(
          q, static_cast<const float*>(cache), out, qdt, B, S, nq, nkv, T, start_pos,
          scale_log2, slopes);
      return static_cast<int>(cudaGetLastError());
    }
    case 1: return prefill_wgmma<bf16, D>(q, cache, out, B, S, nq, nkv, T, start_pos, n_tiles,
                                          scale_log2, qdt, slopes, st);
    case 2: return prefill_wgmma<__half, D>(q, cache, out, B, S, nq, nkv, T, start_pos,
                                            n_tiles, scale_log2, qdt, slopes, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#if !AWQ_DECODE_VERIFY
// Dtype codes: 0 f32, 1 bf16, 2 f16. q [B, nq, hd] and out of qdt;
// k_new, v_new [B, nkv, hd] of kdt; cache [2, B, nkv, T, hd] contiguous
// and 16-byte aligned, of cdt; lengths int32 [B] (clamped to [0, T]);
// hd 128 and g = nq / nkv <= 32 in decode_attn (its entries take no hd),
// hd 64 or 128 and g <= 128 in decode_attn_wide (every shape but
// decode_attn's), hd 64 or 128 and g <= 32 with ALiBi slopes.
// The plan (ops/decode_attn.py::decode_plan): `cluster` blocks of `per`
// positions (a multiple of 64, cluster * per >= max(lengths)) for each
// (row, kv head), `stages` ring stages, `smem` bytes of shared memory.
// The entries of the unit decode_attn take no slopes (the signatures the A/B
// scripts call in another tree's build); those of decode_attn_wide
// (AWQ_DECODE_WIDE, *_wide) take the head_dim after T, those of
// decode_attn_alibi (AWQ_ALIBI, *_alibi) the head_dim after T and `slopes`,
// f32 [nq] in device memory, before the stream.
// The *_dev entries (K2, K9 and K14; DYN) split by the length they read
// in device memory, each row its own (a decode step's rows share one):
// `want` and `unit` are the host plan's (decode_plan), `maxlen` the bound
// of the lengths, to which they are clamped; the plan's cluster covers
// min(want, ceil(maxlen / unit)) slices.
// K2 and K8 append k_new, v_new into dst, the cache's layout (the cache
// itself on the path; 16-byte aligned), at each row's position
// min(max(len_b, 0), T - 1) (K8: MP * page - 1), after the attention.
template <bool DYN>
static int decode_entry(const void* q, const void* k_new, const void* v_new,
                        const void* cache, void* dst, const void* lengths, void* out, int B,
                        int nq, int nkv, int T, int hd, int cluster, int per, int stages,
                        int smem, float scale, int qdt, int kdt, int cdt, const void* slopes,
                        void* stream, int want = 0, int unit = 0, int maxlen = 0) {
  const DecodeArgs a{q,      k_new, v_new, out,   qdt,     kdt,     nq,
                     nkv,    per,   stages, scale, static_cast<const float*>(slopes),
                     want,   unit,  maxlen, nullptr, nullptr, 0};
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(hd, [&](auto dtag) {
    constexpr int D = decltype(dtag)::value;
    auto make = [&](auto tag) {
      using E = typename decltype(tag)::Elem;
      return ContigKV<E, D>{static_cast<const E*>(cache), static_cast<E*>(dst),
                            static_cast<const int*>(lengths), B, nkv, T};
    };
    return run_typed<D, DYN, ContigKV>(cdt, make, a, B, cluster, smem, stream);
  });
}

// K8: as decode_entry, over one layer of the page pool, pool
// [2, NP, nkv, page, hd] contiguous of cdt, with tables int32 [B, MP] of
// page ids in [0, NP); lengths are clamped to [0, MP * page]; `per` is a
// whole number of pages.
static int paged_entry(const void* q, const void* k_new, const void* v_new, const void* pool,
                       void* dst, const void* tables, const void* lengths, void* out, int B,
                       int nq, int nkv, int np, int page, int mp, int hd, int cluster, int per,
                       int stages, int smem, float scale, int qdt, int kdt, int cdt,
                       const void* slopes, void* stream) {
  if (page < 1 || mp < 1 || per % page) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q,   k_new, v_new, out,     qdt,     kdt,
                     nq,  nkv,   per,   stages,  scale,   static_cast<const float*>(slopes),
                     0,   0,     0,     nullptr, nullptr, 0};
  return by_head_dim(hd, [&](auto dtag) {
    constexpr int D = decltype(dtag)::value;
    auto make = [&](auto tag) {
      using E = typename decltype(tag)::Elem;
      return PagedKV<E, D>{static_cast<const E*>(pool), static_cast<E*>(dst),
                           static_cast<const int*>(tables), static_cast<const int*>(lengths),
                           np, nkv, page, mp};
    };
    return run_typed<D, false, PagedKV>(cdt, make, a, B, cluster, smem, stream);
  });
}

// K9: as decode_entry, over one layer of an int8 cache: codes int8
// [2, B, nkv, T, hd] (16-byte aligned) and scales f32 [2, B, nkv, T], both
// contiguous; q, out, k_new and v_new of qdt; the append quantizes k_app,
// v_app (adt) into dst_codes, dst_scales (the codes' and scales' layouts).
template <bool DYN>
static int int8_entry(const void* q, const void* k_new, const void* v_new, const void* k_app,
                      const void* v_app, const void* codes, const void* scales,
                      void* dst_codes, void* dst_scales, const void* lengths, void* out, int B,
                      int nq, int nkv, int T, int hd, int cluster, int per, int stages,
                      int smem, float scale, int qdt, int adt, const void* slopes,
                      void* stream, int want = 0, int unit = 0, int maxlen = 0) {
  const DecodeArgs a{q,      k_new, v_new, out,   qdt,   qdt,   nq,
                     nkv,    per,   stages, scale, static_cast<const float*>(slopes),
                     want,   unit,  maxlen, k_app, v_app, adt};
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  return by_head_dim(hd, [&](auto dtag) {
    constexpr int D = decltype(dtag)::value;
    const Int8KV<D> kv{static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
                       static_cast<int8_t*>(dst_codes), static_cast<float*>(dst_scales),
                       static_cast<const int*>(lengths), B, nkv, T};
    return run_decode<D, DYN>(kv, a, B, cluster, smem, stream);
  });
}

#endif  // !AWQ_DECODE_VERIFY

#if !AWQ_ALIBI && !AWQ_DECODE_WIDE && !AWQ_DECODE_VERIFY
extern "C" int awq_flash_decode(const void* q, const void* k_new, const void* v_new,
                                const void* cache, void* dst, const void* lengths, void* out, int B,
                                int nq, int nkv, int T, int cluster, int per, int stages, int smem,
                                float scale, int qdt, int kdt, int cdt, void* stream) {
  return decode_entry<false>(q, k_new, v_new, cache, dst, lengths, out, B, nq, nkv, T, HD, cluster,
                             per, stages, smem, scale, qdt, kdt, cdt, nullptr, stream);
}

extern "C" int awq_flash_decode_paged(const void* q, const void* k_new, const void* v_new,
                                      const void* pool, void* dst, const void* tables,
                                      const void* lengths, void* out, int B, int nq, int nkv,
                                      int np, int page, int mp, int cluster, int per, int stages,
                                      int smem, float scale, int qdt, int kdt, int cdt,
                                      void* stream) {
  return paged_entry(q, k_new, v_new, pool, dst, tables, lengths, out, B, nq, nkv, np, page, mp, HD,
                     cluster, per, stages, smem, scale, qdt, kdt, cdt, nullptr, stream);
}

extern "C" int awq_flash_decode_int8(const void* q, const void* k_new, const void* v_new,
                                     const void* k_app, const void* v_app, const void* codes,
                                     const void* scales, void* dst_codes, void* dst_scales,
                                     const void* lengths, void* out, int B, int nq, int nkv, int T,
                                     int cluster, int per, int stages, int smem, float scale,
                                     int qdt, int adt, void* stream) {
  return int8_entry<false>(q, k_new, v_new, k_app, v_app, codes, scales, dst_codes, dst_scales,
                           lengths, out, B, nq, nkv, T, HD, cluster, per, stages, smem, scale, qdt,
                           adt, nullptr, stream);
}

extern "C" int awq_flash_decode_dev(const void* q, const void* k_new, const void* v_new,
                                    const void* cache, void* dst, const void* lengths, void* out,
                                    int B, int nq, int nkv, int T, int cluster, int per, int stages,
                                    int smem, float scale, int qdt, int kdt, int cdt, int want,
                                    int unit, int maxlen, void* stream) {
  return decode_entry<true>(q, k_new, v_new, cache, dst, lengths, out, B, nq, nkv, T, HD, cluster,
                            per, stages, smem, scale, qdt, kdt, cdt, nullptr, stream, want, unit,
                            maxlen);
}

extern "C" int awq_flash_decode_int8_dev(const void* q, const void* k_new, const void* v_new,
                                         const void* k_app, const void* v_app, const void* codes,
                                         const void* scales, void* dst_codes, void* dst_scales,
                                         const void* lengths, void* out, int B, int nq, int nkv,
                                         int T, int cluster, int per, int stages, int smem,
                                         float scale, int qdt, int adt, int want, int unit,
                                         int maxlen, void* stream) {
  return int8_entry<true>(q, k_new, v_new, k_app, v_app, codes, scales, dst_codes, dst_scales,
                          lengths, out, B, nq, nkv, T, HD, cluster, per, stages, smem, scale, qdt,
                          adt, nullptr, stream, want, unit, maxlen);
}
#endif

#if AWQ_DECODE_WIDE
extern "C" int awq_flash_decode_wide(const void* q, const void* k_new, const void* v_new,
                                     const void* cache, void* dst, const void* lengths, void* out,
                                     int B, int nq, int nkv, int T, int hd, int cluster, int per,
                                     int stages, int smem, float scale, int qdt, int kdt, int cdt,
                                     void* stream) {
  return decode_entry<false>(q, k_new, v_new, cache, dst, lengths, out, B, nq, nkv, T, hd, cluster,
                             per, stages, smem, scale, qdt, kdt, cdt, nullptr, stream);
}

extern "C" int awq_flash_decode_paged_wide(const void* q, const void* k_new, const void* v_new,
                                           const void* pool, void* dst, const void* tables,
                                           const void* lengths, void* out, int B, int nq, int nkv,
                                           int np, int page, int mp, int hd, int cluster, int per,
                                           int stages, int smem, float scale, int qdt, int kdt,
                                           int cdt, void* stream) {
  return paged_entry(q, k_new, v_new, pool, dst, tables, lengths, out, B, nq, nkv, np, page, mp, hd,
                     cluster, per, stages, smem, scale, qdt, kdt, cdt, nullptr, stream);
}

extern "C" int awq_flash_decode_int8_wide(const void* q, const void* k_new, const void* v_new,
                                          const void* k_app, const void* v_app, const void* codes,
                                          const void* scales, void* dst_codes, void* dst_scales,
                                          const void* lengths, void* out, int B, int nq, int nkv,
                                          int T, int hd, int cluster, int per, int stages,
                                          int smem, float scale, int qdt, int adt, void* stream) {
  return int8_entry<false>(q, k_new, v_new, k_app, v_app, codes, scales, dst_codes, dst_scales,
                           lengths, out, B, nq, nkv, T, hd, cluster, per, stages, smem, scale, qdt,
                           adt, nullptr, stream);
}

extern "C" int awq_flash_decode_int8_wide_dev(const void* q, const void* k_new, const void* v_new,
                                              const void* k_app, const void* v_app,
                                              const void* codes, const void* scales,
                                              void* dst_codes, void* dst_scales,
                                              const void* lengths, void* out, int B, int nq,
                                              int nkv, int T, int hd, int cluster, int per,
                                              int stages, int smem, float scale, int qdt, int adt,
                                              int want, int unit, int maxlen, void* stream) {
  return int8_entry<true>(q, k_new, v_new, k_app, v_app, codes, scales, dst_codes, dst_scales,
                          lengths, out, B, nq, nkv, T, hd, cluster, per, stages, smem, scale, qdt,
                          adt, nullptr, stream, want, unit, maxlen);
}
#elif !AWQ_DECODE_VERIFY
// q [B, S, nq, hd] contiguous of qdt; cache [2, B, nkv, T, hd] contiguous
// and 16-byte aligned, of cdt, with the chunk already written at
// [start_pos, start_pos + S); out [B, S, nq * hd] of qdt; hd 64 or 128, nq
// a multiple of nkv; n_tiles = ceil(S * nq / nkv / 128), the host plan's
// row tiles (ops/decode_attn.py::prefill_plan; the f32 mode ignores it);
// scale_log2 = log2(e) / sqrt(hd).
static int prefill_entry(const void* q, const void* cache, void* out, int B, int S, int nq,
                         int nkv, int T, int start_pos, int hd, int n_tiles, float scale_log2,
                         int qdt, int cdt, const void* slopes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sl = static_cast<const float*>(slopes);
  if (nq % nkv || n_tiles != cdiv(S * (nq / nkv), k3::BQ))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return run_prefill<64>(q, cache, out, B, S, nq, nkv, T, start_pos, n_tiles,
                                    scale_log2, qdt, cdt, sl, st);
    case 128: return run_prefill<128>(q, cache, out, B, S, nq, nkv, T, start_pos, n_tiles,
                                      scale_log2, qdt, cdt, sl, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K14: q [B, nq, hd] contiguous of qdt; k_cache, v_cache [B, nkv, T, hd],
// each contiguous and 16-byte aligned, of cdt; positions [0, length)
// attended, 1 <= length <= T; out [B, nq, hd] of qdt; hd 64 or 128,
// g = nq / nkv <= 128; the plan as for awq_flash_decode. With `lengths` (an
// int32 in device memory, for every row) the length is read there, and
// `length` is its host bound, which the plan covers: the host entry keeps
// the plan's split, the *_dev entry splits by the length read.
template <bool DYN>
static int layer_entry(const void* q, const void* k_cache, const void* v_cache, void* out,
                       const void* lengths, int B, int nq, int nkv, int T, int length, int hd,
                       int cluster, int per, int stages, int smem, float scale, int qdt,
                       int cdt, const void* slopes, void* stream, int want = 0, int unit = 0) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DecodeArgs a{q,      nullptr, nullptr, out,  qdt,  0,      nq,
                     nkv,    per,     stages,  scale, static_cast<const float*>(slopes),
                     want,   unit,    length};
  if (nq % nkv || nq / nkv > 128 || length < 1 || length > T || (DYN && !lengths))
    return static_cast<int>(cudaErrorInvalidValue);
#define AWQ_LAYER(D_, E_) \
  return run_layer<D_, DYN, E_>(k_cache, v_cache, nkv, T, length, static_cast<const int*>(lengths), \
                           a, B, cluster, smem, st)
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
#endif

#if AWQ_ALIBI
extern "C" int awq_flash_decode_alibi(const void* q, const void* k_new, const void* v_new,
                                      const void* cache, void* dst, const void* lengths, void* out,
                                      int B, int nq, int nkv, int T, int hd, int cluster, int per,
                                      int stages, int smem, float scale, int qdt, int kdt, int cdt,
                                      const void* slopes, void* stream) {
  return decode_entry<false>(q, k_new, v_new, cache, dst, lengths, out, B, nq, nkv, T, hd, cluster,
                             per, stages, smem, scale, qdt, kdt, cdt, slopes, stream);
}

extern "C" int awq_flash_decode_paged_alibi(const void* q, const void* k_new, const void* v_new,
                                            const void* pool, void* dst, const void* tables,
                                            const void* lengths, void* out, int B, int nq, int nkv,
                                            int np, int page, int mp, int hd, int cluster, int per,
                                            int stages, int smem, float scale, int qdt, int kdt,
                                            int cdt, const void* slopes, void* stream) {
  return paged_entry(q, k_new, v_new, pool, dst, tables, lengths, out, B, nq, nkv, np, page, mp, hd,
                     cluster, per, stages, smem, scale, qdt, kdt, cdt, slopes, stream);
}

extern "C" int awq_flash_decode_int8_alibi(const void* q, const void* k_new, const void* v_new,
                                           const void* k_app, const void* v_app, const void* codes,
                                           const void* scales, void* dst_codes, void* dst_scales,
                                           const void* lengths, void* out, int B, int nq, int nkv,
                                           int T, int hd, int cluster, int per, int stages,
                                           int smem, float scale, int qdt, int adt,
                                           const void* slopes, void* stream) {
  return int8_entry<false>(q, k_new, v_new, k_app, v_app, codes, scales, dst_codes, dst_scales,
                           lengths, out, B, nq, nkv, T, hd, cluster, per, stages, smem, scale, qdt,
                           adt, slopes, stream);
}

extern "C" int awq_flash_decode_alibi_dev(const void* q, const void* k_new, const void* v_new,
                                          const void* cache, void* dst, const void* lengths,
                                          void* out, int B, int nq, int nkv, int T, int hd,
                                          int cluster, int per, int stages, int smem, float scale,
                                          int qdt, int kdt, int cdt, int want, int unit, int maxlen,
                                          const void* slopes, void* stream) {
  return decode_entry<true>(q, k_new, v_new, cache, dst, lengths, out, B, nq, nkv, T, hd, cluster,
                            per, stages, smem, scale, qdt, kdt, cdt, slopes, stream, want, unit,
                            maxlen);
}

extern "C" int awq_flash_decode_int8_alibi_dev(const void* q, const void* k_new, const void* v_new,
                                               const void* k_app, const void* v_app,
                                               const void* codes, const void* scales,
                                               void* dst_codes, void* dst_scales,
                                               const void* lengths, void* out, int B, int nq,
                                               int nkv, int T, int hd, int cluster, int per,
                                               int stages, int smem, float scale, int qdt, int adt,
                                               int want, int unit, int maxlen, const void* slopes,
                                               void* stream) {
  return int8_entry<true>(q, k_new, v_new, k_app, v_app, codes, scales, dst_codes, dst_scales,
                          lengths, out, B, nq, nkv, T, hd, cluster, per, stages, smem, scale, qdt,
                          adt, slopes, stream, want, unit, maxlen);
}

extern "C" int awq_flash_prefill_alibi(const void* q, const void* cache, void* out, int B,
                                       int S, int nq, int nkv, int T, int start_pos, int hd,
                                       int n_tiles, float scale_log2, int qdt, int cdt,
                                       const void* slopes, void* stream) {
  return prefill_entry(q, cache, out, B, S, nq, nkv, T, start_pos, hd, n_tiles, scale_log2,
                       qdt, cdt, slopes, stream);
}

extern "C" int awq_flash_decode_layer_alibi(const void* q, const void* k_cache,
                                            const void* v_cache, void* out,
                                            const void* lengths, int B, int nq, int nkv, int T,
                                            int length, int hd, int cluster, int per,
                                            int stages, int smem, float scale, int qdt,
                                            int cdt, const void* slopes, void* stream) {
  return layer_entry<false>(q, k_cache, v_cache, out, lengths, B, nq, nkv, T, length, hd,
                            cluster, per, stages, smem, scale, qdt, cdt, slopes, stream);
}

extern "C" int awq_flash_decode_layer_alibi_dev(const void* q, const void* k_cache,
                                                const void* v_cache, void* out,
                                                const void* lengths, int B, int nq, int nkv,
                                                int T, int length, int hd, int cluster, int per,
                                                int stages, int smem, float scale, int qdt,
                                                int cdt, int want, int unit, const void* slopes,
                                                void* stream) {
  return layer_entry<true>(q, k_cache, v_cache, out, lengths, B, nq, nkv, T, length, hd,
                           cluster, per, stages, smem, scale, qdt, cdt, slopes, stream, want,
                           unit);
}
#elif !AWQ_DECODE_WIDE && !AWQ_DECODE_VERIFY
extern "C" int awq_flash_prefill(const void* q, const void* cache, void* out, int B,
                                 int S, int nq, int nkv, int T, int start_pos, int hd,
                                 int n_tiles, float scale_log2, int qdt, int cdt,
                                 void* stream) {
  return prefill_entry(q, cache, out, B, S, nq, nkv, T, start_pos, hd, n_tiles, scale_log2,
                       qdt, cdt, nullptr, stream);
}

extern "C" int awq_flash_decode_layer(const void* q, const void* k_cache,
                                      const void* v_cache, void* out, const void* lengths,
                                      int B, int nq, int nkv, int T, int length, int hd,
                                      int cluster, int per, int stages, int smem, float scale,
                                      int qdt, int cdt, void* stream) {
  return layer_entry<false>(q, k_cache, v_cache, out, lengths, B, nq, nkv, T, length, hd,
                            cluster, per, stages, smem, scale, qdt, cdt, nullptr, stream);
}

extern "C" int awq_flash_decode_layer_dev(const void* q, const void* k_cache,
                                          const void* v_cache, void* out, const void* lengths,
                                          int B, int nq, int nkv, int T, int length, int hd,
                                          int cluster, int per, int stages, int smem,
                                          float scale, int qdt, int cdt, int want, int unit,
                                          void* stream) {
  return layer_entry<true>(q, k_cache, v_cache, out, lengths, B, nq, nkv, T, length, hd,
                           cluster, per, stages, smem, scale, qdt, cdt, nullptr, stream, want,
                           unit);
}
#endif

#if AWQ_DECODE_VERIFY
// ---- The window mode of K2 and K9: the batched speculative verify --------
//
// flash_verify (K2's window mode) and flash_verify_int8 (K9's) are the
// attention of one layer of verify_step_batched (awq_tpu/models/llama.py:
// 1345-1502), which the JAX package runs in XLA (xla_attn, :1407-1434): no
// Pallas kernel, so no TPU kernel is replaced. Row b brings a window of W
// <= 32 tokens, q [B, W, nq, D] and the window's k/v [B, W, nkv, D] (post
// rope, in q's dtype, as operands: not yet in the cache); query j of row b
// attends the cache positions t < len_b and the window positions 0..j.
// The cache is one layer [2, B, nkv, T, D] of f32, bf16 or f16, or of int8
// codes with scales [2, B, nkv, T] f32 (K9's); the window's k/v are taken
// in full precision over either, as JAX attends them before its append.
//
// A block takes 64 packed query rows of one (row b, kv head h): row r of
// the (b, h) pair is window position r / g, head-in-group r % g (q's own
// order), so the group's heads share every K/V tile it loads; 71 q heads
// over one kv head at W = 8 are 568 rows, nine blocks (`chunks`). The
// positions of the prefix are cut into `cluster` slices of `per`
// positions, one block each, and the blocks of a slice set are one
// thread-block cluster that merges through distributed shared memory, as
// K2's do. Four warps, a warp a 16-row tile of the chunk, each over all 64
// positions of a K/V tile: S = (q * scale) . K^T by mma.sync m16n8k16 with
// q * scale split into hi and lo halves of the mma type (K2's numerics),
// the online softmax in f32, P rounded to the mma type for P . V. K/V tiles
// come in by 16-byte cp.async into a ring of `stages` tiles (zero-filled
// past the slice, never read past len_b); an int8 tile widens to f16 exactly
// and an f32 tile rounds to bf16 in a 16-bit tile before the products (K9's
// K scale multiplies a score, its V scale a weight before the rounding).
//
// After the loop each block leaves its rows' (max, sum, output) in shared
// memory; after a cluster barrier block `rank` merges the rows rank,
// rank + cluster, ... a warp a row, reading every block's state, then folds
// in the row's causal window on CUDA cores in f32 (the scores of window
// positions 0..j against the f32 window k, their weights times the window
// v) and writes the output. The append: after the cluster's last barrier
// (no block of the cluster reads the cache any more) block rank 0 of chunk 0
// writes the W positions at start_b = min(max(len_b, 0), T - W), where
// JAX's dynamic_update_slice puts them, in the cache's dtype (K2), or as
// quantize_kv's codes and scales (K9: K7's int8 arithmetic, D / 4 lanes a
// row, a true division, round half to even). The other chunks of the pair
// read only [0, len_b), below start_b: a row whose window does not fit
// (len_b + W > T, a freed slot's stale length) is written inside its prefix
// and its outputs are not defined where its rows span several chunks.
namespace {
namespace ver {
constexpr int TILE = 64;       // positions of a ring stage
constexpr int ROWS = 64;       // packed query rows of a block
constexpr int THREADS = 128;   // 4 warps, a 16-row tile each
constexpr int MAX_W = 32;
}  // namespace ver

struct VerifyArgs {
  const void* q;         // [B, W, nq, D] of qdt
  const void* k_new;     // [B, W, nkv, D] of qdt
  const void* v_new;
  void* out;             // [B, W, nq, D] of qdt
  const int* lengths;    // [B]
  const void* cache;     // [2, B, nkv, T, D] of E
  const float* scales;   // [2, B, nkv, T] (int8) or null
  void* dst;             // the append's destination, the cache's layout
  float* dst_scales;
  int qdt, B, W, nq, nkv, T, per, chunks, stages;
  float scale;
};

// Shared memory of a block in bytes (ops/decode_attn.py::verify_plan mirrors
// it): q's hi and lo halves, the ring, the 16-bit tile of int8 and f32
// caches; after the loop the merge state [ROWS][D + 4] and [ROWS][2]
// overlays them.
struct VerLayout {
  int q, stage, ring, wide, merge, total;
};
template <int D>
__host__ __device__ inline VerLayout ver_layout(int esize, int stages) {
  VerLayout L{};
  L.q = 2 * ver::ROWS * D * 2;
  L.stage = round128(2 * ver::TILE * D * esize + (esize == 1 ? 2 * ver::TILE * 4 : 0));
  L.ring = stages * L.stage;
  L.wide = esize != 2 ? 2 * ver::TILE * D * 2 : 0;
  L.merge = round128((ver::ROWS * (D + 4) + 2 * ver::ROWS) * 4);
  const int main_region = L.q + L.ring + L.wide;
  L.total = main_region > L.merge ? main_region : L.merge;
  return L;
}

template <typename E, int D>
__global__ void __launch_bounds__(ver::THREADS) flash_verify_kernel(const VerifyArgs a) {
  using MT = typename std::conditional<sizeof(E) == 1, __half, typename MmaOf<E>::type>::type;
  constexpr bool I8 = sizeof(E) == 1, F32 = sizeof(E) == 4, NARROW = sizeof(E) == 2;
  constexpr int TILE = ver::TILE, ROWS = ver::ROWS;
  constexpr int ROWB = D * (int)sizeof(E), CPR = ROWB / 16, MROWB = D * 2;
  constexpr int RSW = CPR >= 8 ? 7 : CPR - 1;
  auto rswz = [](int r, int c) { return r * ROWB + ((c ^ (r & RSW)) << 4); };
  extern __shared__ __align__(128) uint8_t smem[];

  const int rank = blockIdx.x, nsplit = gridDim.x;
  const int chunk = blockIdx.y % a.chunks, h = blockIdx.y / a.chunks, b = blockIdx.z;
  const int g = a.nq / a.nkv, r0 = chunk * ROWS, nrows = min(ROWS, g * a.W - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const VerLayout L = ver_layout<D>((int)sizeof(E), a.stages);
  uint8_t* qs = smem;
  uint8_t* ring = qs + L.q;
  uint8_t* wide = ring + L.ring;
  float* st_o = reinterpret_cast<float*>(smem);     // after the loop: [ROWS][D + 4]
  float* st_ml = st_o + ROWS * (D + 4);             // [ROWS][2]

  const E* kbase = static_cast<const E*>(a.cache) + ((size_t)b * a.nkv + h) * a.T * D;
  const E* vbase = kbase + (size_t)a.B * a.nkv * a.T * D;
  const float* ksb = I8 ? a.scales + ((size_t)b * a.nkv + h) * a.T : nullptr;
  const float* vsb = I8 ? ksb + (size_t)a.B * a.nkv * a.T : nullptr;
  const int len = min(max(a.lengths[b], 0), a.T);
  const int p0 = rank * a.per, p1 = min(len, p0 + a.per);
  const int ntiles = p1 > p0 ? (p1 - p0 + TILE - 1) / TILE : 0;

  // tile i of the slice into its ring stage: positions below p1, zeros past
  auto issue = [&](int i) {
    uint8_t* st = ring + (i % a.stages) * L.stage;
    const int t0 = p0 + i * TILE;
    for (int c = tid; c < TILE * CPR; c += ver::THREADS) {
      const int r = c / CPR, ch = c % CPR, pos = t0 + r;
      const bool ok = pos < p1;
      const size_t o = ok ? (size_t)pos * D + ch * (16 / (int)sizeof(E)) : 0;
      hop::cp_async16(st + rswz(r, ch), kbase + o, ok);
      hop::cp_async16(st + TILE * ROWB + rswz(r, ch), vbase + o, ok);
    }
    if constexpr (I8) {
      float* scl = reinterpret_cast<float*>(st + 2 * TILE * ROWB);
      for (int c = tid; c < 2 * TILE; c += ver::THREADS) {
        const int pos = t0 + c % TILE;
        const bool ok = pos < p1;
        hop::cp_async4(scl + c, (c < TILE ? ksb : vsb) + (ok ? pos : 0), ok);
      }
    }
  };
  if (ntiles > 0) issue(0);
  hop::cp_async_commit();

  // q * scale of the chunk's rows as hi and lo halves of MT (zeros past
  // nrows), while the first tile flies
  constexpr int QC = 8, CPQ = D / QC;
  for (int c = tid; c < ROWS * CPQ; c += ver::THREADS) {
    const int r = c / CPQ, d = (c % CPQ) * QC, rr = r0 + r;
    float v[QC];
    const size_t qo = (((size_t)b * a.W + rr / g) * a.nq + h * g + rr % g) * D + d;
#pragma unroll
    for (int e = 0; e < QC; ++e) v[e] = r < nrows ? load_act(a.q, a.qdt, qo + e) * a.scale : 0.f;
    uint32_t hi[QC / 2], lo[QC / 2];
#pragma unroll
    for (int e = 0; e < QC; e += 2) {
      hi[e / 2] = pack2<MT>(v[e], v[e + 1]);
      const MT* hp = reinterpret_cast<const MT*>(&hi[e / 2]);
      lo[e / 2] = pack2<MT>(v[e] - to_f32<MT>(hp[0]), v[e + 1] - to_f32<MT>(hp[1]));
    }
    const int off = swz(r, d / 8, MROWB);
    *reinterpret_cast<uint4*>(qs + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(qs + ROWS * MROWB + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  for (int s = 1; s < a.stages - 1; ++s) {
    if (s < ntiles) issue(s);
    hop::cp_async_commit();
  }

  const int gq = lane >> 2, tq = lane & 3;
  const bool live_warp = warp * 16 < nrows;
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int i = 0; i < ntiles; ++i) {
    hop::cp_async_wait_pending(a.stages - 2);   // tile i has landed (this thread's copies)
    __syncthreads();                            // everyone's, and tile i - 1 is consumed
    if (i + a.stages - 1 < ntiles) issue(i + a.stages - 1);
    hop::cp_async_commit();
    uint8_t* st = ring + (i % a.stages) * L.stage;
    const int t0 = p0 + i * TILE;
    const uint8_t* kt = st;
    const uint8_t* vt = st + TILE * ROWB;
    const float* kscale = nullptr;
    const float* vscale = nullptr;
    if constexpr (!NARROW) {   // int8 codes widened to f16 (exact), f32 rounded to bf16
      for (int c = tid; c < 2 * TILE * (D / 8); c += ver::THREADS) {
        const int kvs = c / (TILE * (D / 8)), rem = c - kvs * TILE * (D / 8);
        const int r = rem / (D / 8), c8 = rem % (D / 8);   // 8 elements: one 16-byte MT chunk
        const uint8_t* src = st + kvs * TILE * ROWB;
        uint4 outv;
        if constexpr (I8) {
          const uint2 w = *reinterpret_cast<const uint2*>(src + rswz(r, c8 / 2) + (c8 & 1) * 8);
          widen4(w.x, outv.x, outv.y);
          widen4(w.y, outv.z, outv.w);
        } else {
          const float4 x0 = *reinterpret_cast<const float4*>(src + rswz(r, 2 * c8));
          const float4 x1 = *reinterpret_cast<const float4*>(src + rswz(r, 2 * c8 + 1));
          outv = make_uint4(pack2<MT>(x0.x, x0.y), pack2<MT>(x0.z, x0.w), pack2<MT>(x1.x, x1.y),
                            pack2<MT>(x1.z, x1.w));
        }
        *reinterpret_cast<uint4*>(wide + kvs * TILE * MROWB + swz(r, c8, MROWB)) = outv;
      }
      __syncthreads();
      kt = wide;
      vt = wide + TILE * MROWB;
      if constexpr (I8) {
        kscale = reinterpret_cast<const float*>(st + 2 * TILE * ROWB);
        vscale = kscale + TILE;
      }
    }
    if (!live_warp) continue;

    // S = (q * scale) . K^T over the tile's 64 positions (the lo half's
    // products in sl)
    float s[TILE / 8][4], sl[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
    const int qrow = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int krow = (lane & 7) + 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qh[4], ql[4];
      const int qo = swz(qrow, 2 * kk + (lane >> 4), MROWB);
      hop::ldsm_x4(qh, qs + qo);
      hop::ldsm_x4(ql, qs + ROWS * MROWB + qo);
#pragma unroll
      for (int np = 0; np < TILE / 16; ++np) {
        uint32_t kb[4];
        hop::ldsm_x4(kb, kt + swz(krow + 16 * np, 2 * kk + ((lane >> 3) & 1), MROWB));
        mma_16816<MT>(s[2 * np], qh, kb[0], kb[1]);
        mma_16816<MT>(sl[2 * np], ql, kb[0], kb[1]);
        mma_16816<MT>(s[2 * np + 1], qh, kb[2], kb[3]);
        mma_16816<MT>(sl[2 * np + 1], ql, kb[2], kb[3]);
      }
    }

    // online softmax of rows gq, gq + 8 (K9: K's scale on the score)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * tq + e;
        const bool live = t0 + col < p1;
        float sa = s[j][e] + sl[j][e], sb = s[j][2 + e] + sl[j][2 + e];
        if constexpr (I8) {
          sa *= kscale[col];
          sb *= kscale[col];
        }
        s[j][e] = live ? sa : NEG_INF;
        s[j][2 + e] = live ? sb : NEG_INF;
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    float ref[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      ref[r] = mn == NEG_INF ? 0.f : mn;
      alpha[r] = __expf(m[r] - ref[r]);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = __expf(s[j][e] - ref[0]);
        s[j][2 + e] = __expf(s[j][2 + e] - ref[1]);
        sum[0] += s[j][e];
        sum[1] += s[j][2 + e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P . V (V read through ldmatrix.trans)
    const int vrow = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      float w[4] = {1.f, 1.f, 1.f, 1.f};   // K9: V's scale of columns 2tq, +1, +8, +9
      if constexpr (I8) {
        const int col = 16 * kk + 2 * tq;
        w[0] = vscale[col];
        w[1] = vscale[col + 1];
        w[2] = vscale[col + 8];
        w[3] = vscale[col + 9];
      }
      uint32_t pa[4];
      pa[0] = pack2<MT>(s[2 * kk][0] * w[0], s[2 * kk][1] * w[1]);
      pa[1] = pack2<MT>(s[2 * kk][2] * w[0], s[2 * kk][3] * w[1]);
      pa[2] = pack2<MT>(s[2 * kk + 1][0] * w[2], s[2 * kk + 1][1] * w[3]);
      pa[3] = pack2<MT>(s[2 * kk + 1][2] * w[2], s[2 * kk + 1][3] * w[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        hop::ldsm_x4_trans(vb, vt + swz(vrow + 16 * kk, 2 * dp + (lane >> 4), MROWB));
        mma_16816<MT>(o[2 * dp], pa, vb[0], vb[1]);
        mma_16816<MT>(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // the rows' state into shared memory (over the ring: every copy landed),
  // rows padded to D + 4 floats
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  hop::cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(st_o + (warp * 16 + gq + 8 * r) * (D + 4) + 8 * dn + 2 * tq) =
          make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
  if (tq == 0) {
    *reinterpret_cast<float2*>(st_ml + (warp * 16 + gq) * 2) = make_float2(m[0], l[0]);
    *reinterpret_cast<float2*>(st_ml + (warp * 16 + gq + 8) * 2) = make_float2(m[1], l[1]);
  }
  if (nsplit > 1) hop::cluster_sync();
  else __syncthreads();

  // the merge, a warp a row: the cluster's slices, then the causal window in
  // f32, DPL output columns a lane
  constexpr int DPL = D / 32;
  for (int rr = rank + nsplit * warp; rr < nrows; rr += nsplit * (ver::THREADS / 32)) {
    // (M, Lsum, acc) += each block's (m, l, o), online
    float M = NEG_INF, Lsum = 0.f, acc[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
    const float* op = st_o + rr * (D + 4) + lane * DPL;
    for (int q = 0; q < nsplit; ++q) {
      float2 ml;
      float ov[DPL];
      if (nsplit > 1) {
        ml = hop::ld_cluster_f32x2(hop::cluster_map(st_ml + 2 * rr, q));
        if constexpr (DPL == 4) {
          const float4 v4 = hop::ld_cluster_f32x4(hop::cluster_map(op, q));
          ov[0] = v4.x; ov[1] = v4.y; ov[2] = v4.z; ov[3] = v4.w;
        } else {
          const float2 v2 = hop::ld_cluster_f32x2(hop::cluster_map(op, q));
          ov[0] = v2.x; ov[1] = v2.y;
        }
      } else {
        ml = *reinterpret_cast<const float2*>(st_ml + 2 * rr);
#pragma unroll
        for (int e = 0; e < DPL; ++e) ov[e] = op[e];
      }
      const float mn = fmaxf(M, ml.x), ref = mn == NEG_INF ? 0.f : mn;
      const float wa = __expf(M - ref), wb = __expf(ml.x - ref);
      Lsum = Lsum * wa + ml.y * wb;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[e] = acc[e] * wa + ov[e] * wb;
      M = mn;
    }
    // the window: positions 0..j of the row's own k/v, in f32
    const int row = r0 + rr, j = row / g, head = h * g + row % g;
    const size_t qo = (((size_t)b * a.W + j) * a.nq + head) * D + lane * DPL;
    float qf[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) qf[e] = load_act(a.q, a.qdt, qo + e) * a.scale;
    for (int jj = 0; jj <= j; ++jj) {
      const size_t ko = (((size_t)b * a.W + jj) * a.nkv + h) * D + lane * DPL;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) part = fmaf(qf[e], load_act(a.k_new, a.qdt, ko + e), part);
      const float sw = warp_sum(part);
      const float mn = fmaxf(M, sw);
      const float wa = M == NEG_INF ? 0.f : __expf(M - mn), wb = __expf(sw - mn);
      Lsum = Lsum * wa + wb;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        acc[e] = fmaf(wb, load_act(a.v_new, a.qdt, ko + e), acc[e] * wa);
      M = mn;
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) store_act(a.out, a.qdt, qo + e, acc[e] / Lsum);
  }
  if (nsplit > 1) hop::cluster_sync();   // the peers are done reading this block's state
  if (rank != 0 || chunk != 0) return;

  // the append of the W window positions (every block of the cluster is done
  // reading the cache)
  const int start = min(max(a.lengths[b], 0), a.T - a.W);
  const size_t plane = (size_t)a.B * a.nkv * a.T * D;
  const size_t row0 = (((size_t)b * a.nkv + h) * a.T + start) * D;
  if constexpr (!I8) {
    constexpr int V = 16 / (int)sizeof(E), NV = D / V;
    E* dk = static_cast<E*>(a.dst) + row0;
    for (int c = tid; c < 2 * a.W * NV; c += ver::THREADS) {
      const int s = c / (a.W * NV), jw = (c / NV) % a.W, d = (c % NV) * V;
      const size_t so = (((size_t)b * a.W + jw) * a.nkv + h) * D + d;
      const void* src = s ? a.v_new : a.k_new;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (F32)
          w[e] = __float_as_uint(load_act(src, a.qdt, so + e));
        else
          w[e] = pack2<E>(load_act(src, a.qdt, so + 2 * e), load_act(src, a.qdt, so + 2 * e + 1));
      }
      *reinterpret_cast<uint4*>(dk + s * plane + (size_t)jw * D + d) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    // quantize_kv of each window position's K and V rows: D / 4 lanes a row,
    // a lane's 4 codes one 32-bit word, the scale from the row's first lane
    constexpr int LPR = D / 4, RPP = ver::THREADS / LPR;
    int8_t* dc = static_cast<int8_t*>(a.dst) + row0;
    float* ds = a.dst_scales + ((size_t)b * a.nkv + h) * a.T + start;
    const size_t splane = (size_t)a.B * a.nkv * a.T;
    for (int p = 0; p < (2 * a.W + RPP - 1) / RPP; ++p) {
      const int rw = p * RPP + tid / LPR, ln = tid % LPR;
      const bool ok = rw < 2 * a.W;
      const int s = ok ? rw / a.W : 0, jw = ok ? rw % a.W : 0;
      const size_t so = (((size_t)b * a.W + jw) * a.nkv + h) * D + ln * 4;
      const void* src = s ? a.v_new : a.k_new;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = ok ? load_act(src, a.qdt, so + e) : 0.f;
      float am = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
#pragma unroll
      for (int o2 = LPR / 2; o2 > 0; o2 >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o2));
      const float sc = __fmul_rn(fmaxf(am, 1e-6f), 1.f / 127.f);
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float c = fminf(fmaxf(rintf(x[e] / sc), -127.f), 127.f);
        word |= (static_cast<uint32_t>(static_cast<int>(c)) & 0xFFu) << (8 * e);
      }
      if (ok) {
        *reinterpret_cast<uint32_t*>(dc + s * plane + (size_t)jw * D + ln * 4) = word;
        if (ln == 0) ds[s * splane + jw] = sc;
      }
    }
  }
}

template <typename E, int D>
int launch_verify(const VerifyArgs& a, int cluster, int smem, cudaStream_t st) {
  static int smem_set = 0, nonportable = 0, checked[dec::MAX_CLUSTER + 1] = {0};
  const int g = a.nkv > 0 ? a.nq / a.nkv : 0;
  if (g < 1 || a.nq % a.nkv || a.W < 1 || a.W > ver::MAX_W || a.W > a.T || a.stages < 2 ||
      a.stages > 4 || cluster < 1 || cluster > dec::MAX_CLUSTER || a.per < ver::TILE ||
      a.per % ver::TILE || a.chunks != cdiv(g * a.W, ver::ROWS) || smem > dec::SMEM_MAX ||
      smem != ver_layout<D>((int)sizeof(E), a.stages).total)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_verify_kernel<E, D>;
  int err = hop::allow_smem(kernel, smem, &smem_set);
  if (err) return err;
  if (cluster > 8 && !nonportable) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    nonportable = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, a.chunks * a.nkv, a.B);
  cfg.blockDim = dim3(ver::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem > checked[cluster]) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
    checked[cluster] = smem;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename E>
int verify_hd(const VerifyArgs& a, int hd, int cluster, int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_verify<E, 128>(a, cluster, smem, st);
  if (hd == 64) return launch_verify<E, 64>(a, cluster, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace

// The window mode of K2: q [B, W, nq, hd], k_new, v_new [B, W, nkv, hd]
// and out [B, W, nq, hd], all contiguous of qdt; cache [2, B, nkv, T, hd]
// contiguous and 16-byte aligned, of cdt (0 f32, 1 bf16, 2 f16); dst the
// cache's layout (the cache itself on the path); lengths int32 [B]; hd 64 or
// 128, g = nq / nkv <= 128, 1 <= W <= 32 and W <= T. The plan
// (ops/decode_attn.py::verify_plan): `cluster` blocks of `per` positions (a
// multiple of 64, cluster * per >= max(lengths)) for each (row, kv head,
// chunk of 64 query rows), `stages` ring stages, `smem` bytes.
extern "C" int awq_flash_verify(const void* q, const void* k_new, const void* v_new,
                                const void* cache, void* dst, const void* lengths, void* out,
                                int B, int W, int nq, int nkv, int T, int hd, int cluster,
                                int per, int stages, int smem, float scale, int qdt, int cdt,
                                void* stream) {
  const int chunks = nkv > 0 ? cdiv((nq / nkv) * W, ver::ROWS) : 0;
  const VerifyArgs a{q,  k_new, v_new, out, static_cast<const int*>(lengths), cache, nullptr,
                     dst, nullptr, qdt, B, W, nq, nkv, T, per, chunks, stages, scale};
  switch (cdt) {
    case 0: return verify_hd<float>(a, hd, cluster, smem, stream);
    case 1: return verify_hd<bf16>(a, hd, cluster, smem, stream);
    case 2: return verify_hd<__half>(a, hd, cluster, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The window mode of K9: as awq_flash_verify over one layer of an int8
// cache, codes [2, B, nkv, T, hd] int8 (16-byte aligned) and scales
// [2, B, nkv, T] f32; the append quantizes the window into dst_codes,
// dst_scales (the codes' and scales' layouts).
extern "C" int awq_flash_verify_int8(const void* q, const void* k_new, const void* v_new,
                                     const void* codes, const void* scales, void* dst_codes,
                                     void* dst_scales, const void* lengths, void* out, int B,
                                     int W, int nq, int nkv, int T, int hd, int cluster, int per,
                                     int stages, int smem, float scale, int qdt, void* stream) {
  const int chunks = nkv > 0 ? cdiv((nq / nkv) * W, ver::ROWS) : 0;
  const VerifyArgs a{q,         k_new, v_new, out, static_cast<const int*>(lengths), codes,
                     static_cast<const float*>(scales), dst_codes,
                     static_cast<float*>(dst_scales), qdt, B, W, nq, nkv, T, per, chunks, stages,
                     scale};
  return verify_hd<int8_t>(a, hd, cluster, smem, stream);
}
#endif
