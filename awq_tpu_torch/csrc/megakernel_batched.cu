// K6: the batched whole-token W4A16 decode megakernel for Hopper (sm_90a).
// This source is built once per instance and weight format (_build.UNITS:
// the cache element type AWQ_MEGA_CT, AWQ_MEGA_PAGED and AWQ_MEGA_W3; the
// f32, bf16, f16 and int8 slot caches and the bf16 page pool, each W4 and
// W3), ten units that the build compiles in parallel.
//
// Replaces the Pallas kernel of awq_tpu/ops/megakernel_batched.py:
// w4a16_llama_token_step_batched (_btoken_kernel). One launch runs ALL
// decoder layers for B rows (the slots of a continuous-batching engine),
// one token each, row b at its own position lengths[b]: per layer
//   x = rmsnorm(h)·ln1; qkv = bf16(bf16(x @ W4(wqkv)) + bias); rope(q, k)
//   with the row's own cos/sin; GQA attention of q over the row's cache
//   [0, lengths[b]) plus its current k/v; h1 = h + attn @ W4(wo);
//   gate|up = bf16(rmsnorm(h1)·ln2 @ W4(gate|up));
//   hm = bf16(silu(gate)·up); h = bf16(h1 + hm @ W4(down))
// then optionally the final rmsnorm and a W4 head into f32 logits [B, V].
// The rounding points are the JAX kernel's: every matmul consumes bf16(x)
// with the per-group identity s·Σ bf16(x)·q − sz·Σ bf16(x) in f32; the
// matmul-input scratch (QKV, attention output, gate/up, SiLU·mul) is bf16,
// the residual and the o/down accumulators f32, the residual rounded to
// bf16 between layers.
//
// What bounds it on the H100: device memory. A step streams every W4 code,
// scale and szero once (4.22 GB with the head at Llama-3-8B width) for all
// B rows, plus each row's KV prefix; at B <= 64 the 2·B FLOPs per weight
// stay far under the card's ~295 FLOPs per byte. The first version
// took 6.8x that bound at 8 rows: every 32-column tile re-staged the rows
// group by group through L2, padded them to the m16 side of mma.sync, held
// one group in flight a warp and ended in a block barrier, and eight grid
// barriers a layer waited on norm phases that one block a row computed.
// What this design does:
// - a persistent cooperative grid (cudaLaunchCooperativeKernel, one block
//   an SM: eight consumer warps and one producer warp) with six grid
//   barriers a layer: QKV | attention | combine | o-proj | gate/up | down;
// - the matmul phases take K1's GEMV orientation (w4a16.cuh): the weights
//   are the A operand of mma.sync m16n8k16 (16 output columns by 16
//   channels, decoded by K1's code pairs, pair_codes.cuh, then centred:
//   q - 8 in W4, q in W3, both exact in bf16) and the rows are N, one n8 tile for every 8
//   rows: a decoded A fragment feeds all of them, and no row is padded to
//   16;
// - each block stages its rows once a phase into shared memory (K1's pair
//   layout, with the group sums Σ bf16(x)), over the window of input
//   channels that fits beside the ring (down at 8 rows, every phase at 32:
//   the windows' partial sums go to a block-private f32 buffer in a fixed
//   order); the staging of the QKV, gate/up and head phases folds the
//   rmsnorm in: the phase that writes the residual leaves each block's sum
//   of squares a row (ssp), and every block reads the f32 residual rows and
//   the norm weights and writes bf16 rows, so no norm phase and no norm
//   barrier remains; o-proj's and down's rows, which the combine and the
//   gate/up epilogue store in that layout, arrive by one bulk copy a row;
// - the producer warp streams the code and scale rows through a ring of
//   rounds: a slot holds k chunks of input channels (a W4 group or a W3
//   packing chunk each) of a wave's tiles, one piece for each busy consumer
//   warp, as 3-D TMA boxes (codes, scales, szeros; gate/up: a gate and an up
//   part) completing on the slot's full mbarrier; every consumer warp frees
//   it through its empty mbarrier. It runs up to a ring ahead across the
//   grid barriers, so the next phase's first weights are in flight during a
//   phase's tail, the attention and the combine. One bulk copy a row (64-512
//   bytes) capped a block at a few GB/s (~60-70 ns a copy, PERF.md §6);
// - a phase's tiles (gate/up: a gate and an up tile together, so SiLU·mul
//   stays fused) go to blocks in equal runs of units; the host plan
//   (ops/megakernel_batched.py::batched_plan) gives each phase's wave, warps
//   a tile and windows, and plan_for checks it against this build; a block
//   takes them in waves of up
//   to eight tiles, K warps splitting a tile's chunks, and adds the warps'
//   partial sums in shared memory in warp order: deterministic, no atomics;
// - rope and the cache write at lengths[b] move into the attention phase,
//   whose item for slice 0 of a (row, kv head) writes the roped k and v (the
//   int8 mode: quantize_kv of them), so QKV's columns need not pair up;
// - attention is K4's arithmetic, spread over (row, kv head, position slice)
//   items: a block takes the group's q heads of one kv head of one row over
//   a slice, warps stride the positions with an online softmax each over k/v
//   rows that a cp.async ring a warp brings in 16 positions ahead, two
//   positions' reductions in flight at once, and a combine phase merges
//   warps and slices. The slices are sized from max_length,
//   which the caller knows on the host (the last slice takes whatever lies
//   past it, so a low max_length costs balance, not correctness); a row
//   shorter than a slice's start leaves (-inf, 0, 0) there and the combine
//   gives it weight 0. The current token's k/v come from the QKV workspace,
//   as the JAX kernel keeps them in registers; lengths is read on the device
//   and clamped to [0, T-1], as the JAX append clamps.
// Paged mode (the JAX kernel's `tables`, row 18's paged DMA): the cache is
// a page pool [L, 2, NP, nkv, page, HD] shared by all rows and row b's
// position p lives at page tables[b, p / page], offset p % page. Only the
// two addresses change: the write and the attention's reads (kv_row). The
// row length is clamped to [0, MP·page − 1]; freed slots' table rows are 0,
// the trash page, so their writes land there. The page size is a power of
// two, so the lookup is a shift and a mask. The paged instance is built for
// a bf16 pool only (the engine's pool dtype).
// int8 slot mode (the JAX kernel's cache_scales): the cache holds int8
// codes and f32 scales [L, 2, B, n_kv, T], one per position and head. The
// attention dequantizes a position as K4 does (codes widened to f32 times
// the scale; the current token stays f32), k_new/v_new come back bf16
// (JAX's kv_dt), and the write stores quantize_kv of them (quantize_rows).
// W3 mode (the JAX kernel's dense3, Pallas row 18, in every instance):
// the linears and the head hold pack_int3 codes, decoded by K1's W3 code
// pairs with the 2^7 taken off again (stage_mma says why).
//
// K5, the chunk mode (AWQ_MEGA_CHUNK; replaces the Pallas kernel of
// awq_tpu/ops/megakernel_chunk.py: w4a16_llama_chunk_step, _cchunk_kernel,
// row 17): ALL decoder layers for a window of S = 1..32 tokens of one
// sequence at [hist, hist + S), window row i attending to the cache
// [0, hist) and to window rows 0..i; the window's k/v go into the cache in
// place and come back; no head. The same schedule, ring and stagings, with
// four differences:
// - the grid runs in thread-block clusters of cl blocks (a cooperative
//   launch with a cluster dimension): a phase's units go to clusters, each
//   rank of a cluster takes them over its own run of IC's chunks, so a block
//   stages 1/cl of the rows' channels, and at each wave's end the ranks add
//   their sums in rank order through distributed shared memory (merge_wave),
//   rank q finishing its own rows;
// - codes are exact and centred in both formats (stage_mma);
// - QKV's epilogue adds the bias after the bf16 rounding, with no second
//   rounding (the JAX kernel's bf16 scratch, then + bias);
// - the attention is a tensor-core tile of a kv head's (window row, head)
//   query rows over position slices (attention_chunk), its combine merging
//   the slices.
// The host plan (ops/megakernel_batched.py::batched_plan with a cluster,
// chunk_slices) gives both modes their schedule and shared-memory layout.
#include <string.h>

#include "mega_common.cuh"
#include "hopper.cuh"
#include "pair_codes.cuh"

#ifndef AWQ_MEGA_CHUNK
#define AWQ_MEGA_CHUNK 0
#endif
#if AWQ_MEGA_CHUNK
#define batched_kernel chunk_kernel     // K5's symbol, the name a profile shows
#endif

namespace {

constexpr bool CHUNK = AWQ_MEGA_CHUNK != 0;      // K5: the chunk mode of this body
// Codes as the mma sees them: q - CENTER, centred in W4 (-8..7, K5 and
// K6) and in K5's W3 (-4..3), q itself in K6's W3; stage_mma says why.
constexpr int CENTER = UNIT_W3 ? (CHUNK ? 4 : 0) : 8;

constexpr int K6_WARPS = 8;                       // consumer warps
constexpr int K6_THREADS = 32 * (K6_WARPS + 1);   // and the producer warp
constexpr int PRODUCER = K6_WARPS;
constexpr int CB = 1;                             // the consumers' named barrier
constexpr int SMEM_MAX = 232448;
constexpr int RING_BYTES = 60 * 1024;
constexpr int WARP_ROWS = 32;                     // rows a consumer warp sums
constexpr int RED_FLOATS = K6_WARPS * 16 * WARP_ROWS;
constexpr int RS_FLOATS = 64;
// The attention's ring: KV_RING positions a warp in flight, each slot a k
// row, a v row and (int8) their two scales.
constexpr int KV_RING = sizeof(AWQ_MEGA_CT) == 4 ? 8 : 16;
constexpr int KV_VEC = MK_HD * sizeof(AWQ_MEGA_CT) / 16;      // 16-byte pieces of a row
constexpr int KV_SLOT = (2 * KV_VEC * 16 + 8 + 15) / 16 * 16;
constexpr int KV_RING_BYTES = 8448;               // a warp's ring, the most of any cache type
static_assert(KV_RING * KV_SLOT <= KV_RING_BYTES, "attention ring");
constexpr int ATT_FLOATS = MK_MAXG * MK_HD + 2 * MK_HD + 2 * K6_WARPS * MK_MAXG
                           + K6_WARPS * MK_MAXG * MK_HD + K6_WARPS + K6_WARPS * KV_RING_BYTES / 4;
constexpr int MAXB = 64;         // most rows per launch
constexpr int NPH = 5;           // matmul phases: QKV, o-proj, gate/up, down, head
// K5: a block's sums of a wave that its cluster reads (TOT_FLOATS), and the
// attention's q (hi and lo, 128 rows), the window's k (hi and lo) and v (32
// rows each) and the K (hi and lo) and V tiles of TP positions in two
// stages, 16-bit elements
constexpr int TOT_FLOATS = K6_WARPS * 16 * WARP_ROWS;
constexpr int TP = 32;
constexpr int CATT_BYTES = (2 * 128 + 3 * 32 + 2 * 3 * TP) * MK_HD * 2;
// The shared-memory regions whose byte offsets the host plan gives
// (ops/megakernel_batched.py::REGIONS), in that order.
enum { O_BARS, O_RED, O_RS, O_XS, O_ROWS, O_ATT, O_TOT, NREG };

// A piece: one chunk of input channels of a 16-column tile, its code rows
// and the scale and szero rows of its groups. W4: a group (16 code rows);
// W3: a pack_int3 chunk of two groups (24 rows). A ring slot holds one
// round of a wave: k chunks of its tiles, eight pieces at most, as three
// TMA boxes a part (codes, scales, szeros; gate/up has a gate and an up
// part), each box on a 128-byte boundary.
constexpr int KC = UNIT_W3 ? 256 : 128;
constexpr int SROWS = UNIT_W3 ? 24 : 16;
constexpr int SGROUPS = KC / MK_G;
constexpr int SUB = KC / 64;                      // 64-channel sub-steps
constexpr int PIECE = (SROWS + 2 * SGROUPS) * 16 * 4;
constexpr int SB = K6_WARPS * PIECE + 1024;       // and the boxes' alignment
constexpr int SLOTS = RING_BYTES / SB;

struct PhasePlan { int wave, k, nw; };

struct BatchArgs {
  CUtensorMap maps[NPH][3];  // each phase's codes, scales and szeros ([L, rows, OC])
  const void* h_in; void* h_out;
  const int32_t* qkv_w; const float* qkv_s; const float* qkv_z; const void* qkv_b;
  const int32_t* o_w; const float* o_s; const float* o_z;
  const int32_t* gu_w; const float* gu_s; const float* gu_z;
  const int32_t* dn_w; const float* dn_s; const float* dn_z;
  const void* ln1; const void* ln2; const float* cosr; const float* sinr;
  void* cache; void* k_new; void* v_new; const int32_t* lengths;
  const int32_t* hd_w; const float* hd_s; const float* hd_z; const void* norm_w;
  float* logits;
  const int32_t* tables;   // paged mode: [B, mp] page ids; T = mp·page
  float* scales;           // int8 mode: [L, 2, B, nkv, T]
  float* ws;
  int B, L, H, I, nq, nkv, T, vocab, md, has_bias;
  int np, page, page_shift, mp;
  int nsplit, split_len;
  int wc, rh, bp;          // window chunks, row halves, rows rounded up to 8
  PhasePlan pp[NPH];
  int off[NREG];           // the shared-memory regions (the host plan's layout)
  int cl, hist;            // K5: blocks a cluster, the window's first position
  float eps;
};

// The shared memory of a block, carved at the host plan's offsets
// (ops/megakernel_batched.py::smem_layout, the one source of the layout;
// plan_for checks that each region is aligned and as large as this build
// uses it, and that the fixed ones lie where the build carves them).
struct Smem {
  uint8_t* ring; uint64_t* full; uint64_t* empty; uint64_t* rowbar;
  uint64_t* mready; uint64_t* mfree;      // K5: the cluster merge's barriers
  float* red; float* rs; float* xsum; uint32_t* rows; float* att; float* tot;
  int xp, ng;              // words of a staged row, groups of a window
};

// The regions that sit at an offset fixed by the build: the ring's
// mbarriers after the ring (after up to 128 bytes of its alignment; K5 two
// more), then the warps' partial sums, where the attention's region starts
// too, and the norm factors. The kernel carves them at these constants (a
// base read from the plan cost K6's attention ~20%, PERF.md §6) and
// layout_fits requires the host layout's offsets to equal them.
constexpr int NBAR = 2 * SLOTS + 1 + (CHUNK ? 2 : 0);
constexpr int OFF_BARS = 128 + SLOTS * SB;
constexpr int OFF_RED = (OFF_BARS + 8 * NBAR + 127) / 128 * 128;
constexpr int OFF_RS = OFF_RED + RED_FLOATS * 4;

// Whether the host's region offsets `o` and `smem` bytes fit this build at
// bp rows and windows of wc chunks: the fixed regions where this build puts
// them, every other region 16-byte aligned and as large as the build uses
// it (K5's merge sums beside the rows), all within SMEM_MAX.
inline bool layout_fits(const int* o, int smem, int bp, int wc) {
  const int xs_bytes = bp * (wc * KC / MK_G) * 4, rows_bytes = bp * (wc * KC / 2 + 8) * 4;
  const int att = CHUNK ? CATT_BYTES : ATT_FLOATS * 4;
  bool ok = smem <= SMEM_MAX && o[O_BARS] == OFF_BARS && o[O_RED] == OFF_RED
            && o[O_RS] == OFF_RS && o[O_ATT] == OFF_RED;
  ok = ok && o[O_XS] % 16 == 0 && o[O_XS] >= o[O_RS] + RS_FLOATS * 4;
  ok = ok && o[O_ROWS] % 16 == 0 && o[O_ROWS] >= o[O_XS] + xs_bytes
       && o[O_ROWS] + rows_bytes <= smem;
  ok = ok && o[O_ATT] + att <= smem;
  if (CHUNK)
    ok = ok && o[O_TOT] % 16 == 0 && o[O_TOT] >= o[O_ROWS] + rows_bytes
         && o[O_TOT] + TOT_FLOATS * 4 <= smem;
  return ok;
}

__device__ __forceinline__ Smem carve(uint8_t* base, const BatchArgs& a) {
  Smem s;
  s.ring = base + ((128u - (hop::smem_u32(base) & 127u)) & 127u);   // TMA boxes: 128-byte aligned
  s.full = reinterpret_cast<uint64_t*>(base + OFF_BARS);
  s.empty = s.full + SLOTS;
  s.rowbar = s.empty + SLOTS;
  s.mready = s.rowbar + 1;
  s.mfree = s.mready + 1;
  s.red = reinterpret_cast<float*>(base + OFF_RED);
  s.rs = reinterpret_cast<float*>(base + OFF_RS);
  s.xsum = reinterpret_cast<float*>(base + a.off[O_XS]);
  s.rows = reinterpret_cast<uint32_t*>(base + a.off[O_ROWS]);
  s.att = s.red;
  s.tot = reinterpret_cast<float*>(base + a.off[O_TOT]);
  s.xp = a.wc * KC / 2 + 8;
  s.ng = a.wc * KC / MK_G;
  return s;
}

__device__ __forceinline__ int row_length(const int32_t* lengths, int b, int T) {
  return min(max(lengths[b], 0), T - 1);
}

// Element row (in units of MK_HD) of position p of (layer l, k or v, row b,
// kv head): the slot cache's [L, 2, B, nkv, T] or the pool's page.
template <bool PAGED>
__device__ __forceinline__ size_t kv_row(const BatchArgs& a, int l, int which, int b,
                                         int kvh, int p) {
  if constexpr (PAGED) {
    const int pid = a.tables[(size_t)b * a.mp + (p >> a.page_shift)];
    return ((((size_t)l * 2 + which) * a.np + pid) * a.nkv + kvh) * a.page + (p & (a.page - 1));
  } else {
    return ((((size_t)l * 2 + which) * a.B + b) * a.nkv + kvh) * (size_t)a.T + p;
  }
}

// ---- the matmul phases' schedule ------------------------------------------

// `bytes` (a multiple of 16) global -> shared by the bulk-copy engine,
// completing on `bar`'s transaction count; both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(hop::smem_u32(dst)), "l"(src), "r"(bytes), "r"(hop::smem_u32(bar))
      : "memory");
}

// Wait for the phase of parity `parity` of a ring barrier: try_wait without
// a suspend-time hint, so a waiting warp polls again as soon as it is
// scheduled; traps after about 10 s of the global timer, as hop::mbar_wait.
__device__ __forceinline__ void ring_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = hop::smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t tries = 1;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((tries & 1023u) == 0u) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// A matmul phase of layer l as block blockIdx.x sees it: the weight, its
// columns, the block's run of tile units [t0, ...) (nt tiles; gate/up's
// unit is a pair, tiles 2i and 2i + 1 its gate and up blocks), the plan's
// wave, warps a tile (k) and windows over IC (nw, chunks nch in all).
struct PD {
  const int32_t* qw; const float* sc; const float* sz;
  int oc, nch, ch0, t0, nt, wave, k, nw, pair;
};

__device__ __forceinline__ PD phase_desc(const BatchArgs& a, int ph, int l) {
  PD d;
  const int H = a.H, I = a.I, oq = (a.nq + 2 * a.nkv) * MK_HD;
  int ic = H;
  d.pair = 0;
  if (ph == 0) {
    d.oc = oq;
    d.qw = a.qkv_w + (size_t)l * qrows(H, UNIT_W3) * oq;
    d.sc = a.qkv_s + (size_t)l * (H / MK_G) * oq;
    d.sz = a.qkv_z + (size_t)l * (H / MK_G) * oq;
  } else if (ph == 1) {
    d.oc = H;
    d.qw = a.o_w + (size_t)l * qrows(H, UNIT_W3) * H;
    d.sc = a.o_s + (size_t)l * (H / MK_G) * H;
    d.sz = a.o_z + (size_t)l * (H / MK_G) * H;
  } else if (ph == 2) {
    d.oc = 2 * I;
    d.pair = 1;
    d.qw = a.gu_w + (size_t)l * qrows(H, UNIT_W3) * 2 * I;
    d.sc = a.gu_s + (size_t)l * (H / MK_G) * 2 * I;
    d.sz = a.gu_z + (size_t)l * (H / MK_G) * 2 * I;
  } else if (ph == 3) {
    d.oc = H;
    ic = I;
    d.qw = a.dn_w + (size_t)l * qrows(I, UNIT_W3) * H;
    d.sc = a.dn_s + (size_t)l * (I / MK_G) * H;
    d.sz = a.dn_z + (size_t)l * (I / MK_G) * H;
  } else {
    d.oc = a.vocab;
    d.qw = a.hd_w; d.sc = a.hd_s; d.sz = a.hd_z;
  }
  // K6: the blocks take runs of units over all of IC; K5: the clusters take
  // the runs, and each rank of a cluster its own run of IC's chunks
  const int cl = CHUNK ? a.cl : 1, ci = blockIdx.x / cl, rank = blockIdx.x % cl;
  const int ncl = gridDim.x / cl, units = d.oc / 16 / (1 + d.pair), nch = ic / KC;
  const int u0 = static_cast<int>((long long)ci * units / ncl);
  const int u1 = static_cast<int>((long long)(ci + 1) * units / ncl);
  d.t0 = u0;
  d.nt = (u1 - u0) * (1 + d.pair);
  d.ch0 = rank * nch / cl;
  d.nch = (rank + 1) * nch / cl - d.ch0;
  d.wave = a.pp[ph].wave; d.k = a.pp[ph].k; d.nw = a.pp[ph].nw;
  return d;
}

// First output column of the block's tile i.
__device__ __forceinline__ int tile_col(const PD& d, int i, int I) {
  return d.pair ? ((i & 1) ? I : 0) + 16 * (d.t0 + (i >> 1)) : 16 * (d.t0 + i);
}
__device__ __forceinline__ int win_lo(const PD& d, int w) { return w * d.nch / d.nw; }

// A round's boxes in its slot: for each part (gate/up: the gate tiles' and
// the up tiles' columns) the codes of k chunks over pw columns, then the
// scale rows, then the szero rows; each box starts on 128 bytes.
struct Box { int parts, pw, cbx, sbx, tx; };
__device__ __forceinline__ Box box_of(const PD& d) {
  Box b;
  b.parts = 1 + d.pair;
  b.pw = 16 * d.wave / b.parts;
  b.cbx = d.k * SROWS * b.pw * 4;
  b.sbx = (d.k * SGROUPS * b.pw * 4 + 127) / 128 * 128;
  b.tx = b.parts * (d.k * (SROWS + 2 * SGROUPS) * b.pw * 4);     // bytes the copies bring
  return b;
}

// First tile of wave wv's box: the last wave's box ends at the block's
// last tile (and re-reads tiles of the wave before it) so that no box
// reaches past a full block's run of tiles.
__device__ __forceinline__ int wave_start(const PD& d, int wv) {
  return min(wv * d.wave, max(0, d.nt - d.wave));
}

// Rounds of a window: each of a tile's k warps takes one chunk a round.
__device__ __forceinline__ int rounds(const PD& d, int w) {
  return (win_lo(d, w + 1) - win_lo(d, w) + d.k - 1) / d.k;
}

// Stages (rounds) of a phase for this block, in the producer's order.
__device__ __forceinline__ int phase_stages(const PD& d) {
  if (d.nt == 0) return 0;
  int n = 0;
  for (int w = 0; w < d.nw; ++w) n += rounds(d, w);
  return n * ((d.nt + d.wave - 1) / d.wave);
}

// The producer's place in the step's sequence of stages: layer, phase,
// window, wave, round; idx counts stages. What a stage needs is set once a
// wave (set_wave): the rounds left, this lane's box (which of codes, scales
// and szeros, which part), its place in a slot, its column and first row,
// and the row step a round; a stage then costs a wait, an expect_tx and one
// TMA a lane, no division.
struct Prod {
  PD d;
  const CUtensorMap* map;
  int l, ph, win, wave, nwaves, idx, left, tx, off, col, row, drow, plane;
  bool done, loads;
};

__device__ void set_wave(Prod& p, const BatchArgs& a) {
  const PD& d = p.d;
  const Box bx = box_of(d);
  const int lane = threadIdx.x & 31, st = wave_start(d, p.wave);
  const int which = lane / bx.parts, part = lane - which * bx.parts;
  p.left = rounds(d, p.win);
  p.tx = bx.tx;
  p.loads = lane < 3 * bx.parts;
  p.map = &a.maps[p.ph][p.loads ? which : 0];
  p.off = which == 0 ? part * bx.cbx : bx.parts * bx.cbx + ((which - 1) * bx.parts + part) * bx.sbx;
  p.col = (d.pair ? 16 * (d.t0 + st / 2) : 16 * (d.t0 + st)) + part * a.I;
  p.drow = d.k * (which == 0 ? SROWS : SGROUPS);
  p.row = (d.ch0 + win_lo(d, p.win)) * (which == 0 ? SROWS : SGROUPS);
  p.plane = p.ph == 4 ? 0 : p.l;
}

__device__ void prod_phase(Prod& p, const BatchArgs& a) {
  p.win = p.wave = 0;
  p.nwaves = (p.d.nt + p.d.wave - 1) / p.d.wave;
  set_wave(p, a);
}

__device__ void prod_next_phase(Prod& p, const BatchArgs& a) {
  do {
    if (p.ph == 4) { p.done = true; return; }
    if (p.ph < 3) {
      ++p.ph;
    } else if (++p.l < a.L) {
      p.ph = 0;
    } else if (a.vocab) {
      p.ph = 4;
    } else {
      p.done = true;
      return;
    }
    p.d = phase_desc(a, p.ph, p.l);
  } while (p.d.nt == 0 || p.d.nch == 0);
  prod_phase(p, a);
}

__device__ void prod_begin(Prod& p, const BatchArgs& a) {
  p.l = 0; p.ph = 0; p.idx = 0; p.done = false;
  p.d = phase_desc(a, 0, 0);
  if (p.d.nt == 0 || p.d.nch == 0) prod_next_phase(p, a);
  else prod_phase(p, a);
}

// Start stages until `limit`. Stage idx waits until every consumer warp
// has freed its slot's previous round, then loads round r of the wave: the
// codes of chunks r·k .. r·k + k − 1 of the window over the wave's columns
// (one 3-D TMA box a part) and their scale and szero rows (a box each),
// all completing on the slot's full barrier. A box may reach past the
// window or IC (it reads the next chunks, or zeros past the edge) or past
// the block's tiles; the consumers leave those pieces alone.
__device__ void pump(Prod& p, const BatchArgs& a, const Smem& s, int limit) {
  while (!p.done && p.idx < limit) {
    const int slot = p.idx % SLOTS;
    if (p.idx >= SLOTS) ring_wait(&s.empty[slot], ((p.idx / SLOTS) - 1) & 1);
    if ((threadIdx.x & 31) == 0) hop::mbar_expect_tx(&s.full[slot], p.tx);
    __syncwarp();
    if (p.loads)
      hop::tma_load_3d(s.ring + slot * SB + p.off, p.map, &s.full[slot], p.col, p.row, p.plane);
    ++p.idx;
    p.row += p.drow;
    // the next stage: round, wave, window, phase
    if (--p.left > 0) continue;
    if (++p.wave == p.nwaves) {
      p.wave = 0;
      if (++p.win == p.d.nw) {
        prod_next_phase(p, a);
        continue;
      }
    }
    set_wave(p, a);
  }
}

// ---- the consumers: rows, chunks, merges -----------------------------------

// The elements of one 16-byte vector of a row as f32.
template <typename CT> __device__ __forceinline__ void unpack16(uint4 v, float* o);
template <> __device__ __forceinline__ void unpack16<float>(uint4 v, float* o) {
  o[0] = __uint_as_float(v.x); o[1] = __uint_as_float(v.y);
  o[2] = __uint_as_float(v.z); o[3] = __uint_as_float(v.w);
}
template <> __device__ __forceinline__ void unpack16<bf16>(uint4 v, float* o) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    o[2 * i] = __low2float(t); o[2 * i + 1] = __high2float(t);
  }
}
template <> __device__ __forceinline__ void unpack16<__half>(uint4 v, float* o) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2 t = *reinterpret_cast<const __half2*>(&w[i]);
    o[2 * i] = __low2float(t); o[2 * i + 1] = __high2float(t);
  }
}

// Rows [0, B) of a window [k0, k0 + wlen) into the staged pair layout (K1's:
// each 16-channel block's 8 words as w0 w4 w1 w5 w2 w6 w3 w7, so that lane
// tq's B fragment is one 8-byte word), rows B..bp-1 zero, and the f32 sums
// of each row's bf16 values over each group. From f32 rows `srcf` with the
// rmsnorm folded in (x = bf16(v · rs[r] · w[k]), w of the model dtype md),
// else bf16 rows `srcb`. A thread takes U 16-channel blocks at a time and
// starts all their loads before it uses one (the rows sit in L2).
template <int U, bool F32>
__device__ void stage_rows_u(const Smem& s, const float* srcf, const bf16* srcb, int ld,
                             const void* nw, size_t woff, int md, int k0, int wlen, int B,
                             int bp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb16 = wlen / 16, total = bp * nb16;
  for (int base = warp * 32; base < total; base += 32 * K6_WARPS * U) {
    uint4 raw[U][F32 ? 4 : 2], wt[U][F32 ? 4 : 1];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + 32 * K6_WARPS * u + lane, r = i / nb16, k = k0 + 16 * (i - r * nb16);
      const bool live = i < total && r < B;
#pragma unroll
      for (int v = 0; v < (F32 ? 4 : 2); ++v)
        raw[u][v] = live ? (F32 ? *reinterpret_cast<const uint4*>(srcf + (size_t)r * ld + k + 4 * v)
                                : *reinterpret_cast<const uint4*>(srcb + (size_t)r * ld + k + 8 * v))
                         : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (F32) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const bool has = live && (md == 0 || v < 2);
          const size_t off = woff + k + (md == 0 ? 4 * v : 8 * v);
          wt[u][v] = has ? (md == 0 ? *reinterpret_cast<const uint4*>(static_cast<const float*>(nw) + off)
                                    : *reinterpret_cast<const uint4*>(static_cast<const bf16*>(nw) + off))
                         : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + 32 * K6_WARPS * u + lane, r = i / nb16, blk = i - r * nb16;
      if (base + 32 * K6_WARPS * u >= total) break;          // warp-uniform
      uint32_t w[8];
      float sum = 0.f;
      if constexpr (F32) {
        const float rs = r < B ? s.rs[r] : 0.f;
        float x[16], g[16];
        unpack16<float>(raw[u][0], x); unpack16<float>(raw[u][1], x + 4);
        unpack16<float>(raw[u][2], x + 8); unpack16<float>(raw[u][3], x + 12);
        if (md == 0) {
          unpack16<float>(wt[u][0], g); unpack16<float>(wt[u][1], g + 4);
          unpack16<float>(wt[u][2], g + 8); unpack16<float>(wt[u][3], g + 12);
        } else if (md == 1) {
          unpack16<bf16>(wt[u][0], g); unpack16<bf16>(wt[u][1], g + 8);
        } else {
          unpack16<__half>(wt[u][0], g); unpack16<__half>(wt[u][1], g + 8);
        }
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          x[e] = bf16r(x[e] * rs * g[e]);
          sum += x[e];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = pack_bf16x2(x[2 * e], x[2 * e + 1]);
      } else {
        w[0] = raw[u][0].x; w[1] = raw[u][0].y; w[2] = raw[u][0].z; w[3] = raw[u][0].w;
        w[4] = raw[u][1].x; w[5] = raw[u][1].y; w[6] = raw[u][1].z; w[7] = raw[u][1].w;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
          sum += __low2float(t) + __high2float(t);
        }
      }
      uint4* d = reinterpret_cast<uint4*>(s.rows + (size_t)r * s.xp + 8 * blk);
      d[0] = make_uint4(w[0], w[4], w[1], w[5]);
      d[1] = make_uint4(w[2], w[6], w[3], w[7]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if ((lane & 7) == 0) s.xsum[r * s.ng + blk / 8] = sum;
    }
  }
}

// This thread's stores to global memory become visible to the async proxy
// (another block's bulk copy of them after the grid barrier).
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Word of the staged pair layout that holds channels k, k + 1 (k even) of a
// row: in each 16-channel block the pairs sit in the order 0 4 1 5 2 6 3 7.
__device__ __forceinline__ int perm_word(int k) {
  const int p = (k & 15) >> 1;
  return (k >> 4 << 3) + (p < 4 ? 2 * p : 2 * (p - 4) + 1);
}

// Rows [0, B) of a window of bf16 rows that their writers (the combine,
// the gate/up epilogue) stored in the staged pair layout: one bulk copy a
// row, on the rows barrier (phase `parity`), rows B..bp-1 zero; then the
// group sums of each row from shared memory, as stage_rows adds them.
__device__ void stage_bulk(const Smem& s, const bf16* src, int ld, int k0, int wlen, int B,
                           int bp, uint32_t parity) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, hw = wlen / 2;
  // every thread's accesses to this memory (the last window's rows, the
  // attention's scratch) are ordered before the bulk copies overwrite it
  hop::fence_proxy_async();
  hop::bar_sync(CB, 32 * K6_WARPS);
  if (tid == 0) {
    hop::mbar_expect_tx(s.rowbar, B * wlen * 2);
    for (int r = 0; r < B; ++r)
      bulk_g2s(s.rows + (size_t)r * s.xp, src + (size_t)r * ld + k0, wlen * 2, s.rowbar);
  }
  for (int i = tid; i < (bp - B) * hw; i += 32 * K6_WARPS)
    s.rows[(size_t)(B + i / hw) * s.xp + i % hw] = 0u;
  ring_wait(s.rowbar, parity);
  const int nb16 = wlen / 16, total = bp * nb16;
  for (int base = warp * 32; base < total; base += 32 * K6_WARPS) {
    const int i = base + lane, r = i / nb16, blk = i - r * nb16;
    const uint4* d = reinterpret_cast<const uint4*>(s.rows + (size_t)r * s.xp + 8 * blk);
    const uint4 v0 = d[0], v1 = d[1];
    const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
      sum += __low2float(t) + __high2float(t);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    if ((lane & 7) == 0) s.xsum[r * s.ng + blk / 8] = sum;
  }
}

// A window's rows: from f32 rows with the rmsnorm folded in, else by bulk
// copies of bf16 rows in the staged layout (nbulk counts those, for the
// rows barrier's phase).
__device__ __forceinline__ void stage_rows(const Smem& s, const float* srcf, const bf16* srcb,
                                           int ld, const void* nw, size_t woff, int md, int k0,
                                           int wlen, int B, int bp, int& nbulk) {
  if (srcf) stage_rows_u<2, true>(s, srcf, srcb, ld, nw, woff, md, k0, wlen, B, bp);
  else stage_bulk(s, srcb, ld, k0, wlen, B, bp, (nbulk++) & 1);
}

// The bf16 code pairs of k16 step j of a 64-channel sub-step of one column
// (pc::code_pairs, as K1's GEMV decodes them, 2^7 + q), with 2^7 + CENTER
// taken off again, so that the A operand holds q - CENTER (see stage_mma).
__device__ __forceinline__ void code_pairs(uint32_t lo0, uint32_t lo1, uint32_t hi0, uint32_t hi1,
                                           int j, uint32_t& pl, uint32_t& ph) {
  pc::code_pairs<UNIT_W3 != 0>(lo0, lo1, hi0, hi1, j, 0x43004300u, pl, ph);
  const __nv_bfloat162 c = __float2bfloat162_rn(128.f + CENTER);
  const __nv_bfloat162 l2 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&pl), c);
  const __nv_bfloat162 h2 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&ph), c);
  pl = *reinterpret_cast<const uint32_t*>(&l2);
  ph = *reinterpret_cast<const uint32_t*>(&h2);
}

// One piece (chunk cl of the window) of a warp's tile: its code rows at cw,
// scale and szero rows at sv and zv, rows rw words apart; its 16 columns
// are the A rows (column 2gq + h is row gq + 8h), the NT n8 tiles of its
// rows from `rb` on the B operand; at each group edge the products fold
// into acc as s·Σx·(q − c) − (sz − c·s)·Σx, with the codes centred: c = 8
// in W4 (K5 and K6), 4 in K5's W3, 0 in K6's W3. JAX's identity takes the
// codes biased by 2^7, s·Σx·(2^7 + q) − (2^7·s + sz)·Σx; both are exact in
// bf16, but the tensor core adds a chain of products to about 2^-18.5 of
// its largest term (scripts/exp_mma_precision.py), so with codes biased by
// 2^7 the part that survives taking 2^7·s·Σx off loses 75-500 times as much
// as with q itself. Biased W3 codes moved one ill-conditioned (layer, row)
// of the smoke's W3 model 6-8% at 32 rows, and biased W4 codes one int8
// 32-row window's written cache by 7.9 against 0.05 of its largest 21.0
// (PERF.md §6). With sz near c·s, as AWQ's zero points are on average, the
// two terms no longer cancel, and the chain's rounding stays small against
// the group's value. K6's and K5's rows are the cache that every later
// decode step reads.
template <int NT>
__device__ __forceinline__ void stage_mma(const Smem& s, const uint32_t* cw, const float* sv,
                                          const float* zv, int rw, int cl, int rb,
                                          float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const uint32_t* xrow = s.rows + (size_t)(rb + gq) * s.xp + 2 * tq;
#pragma unroll
  for (int gi = 0; gi < SGROUPS; ++gi) {
    // CH product chains over the k16 steps (two where the n8 tiles are few,
    // so that consecutive products need not wait for each other; one in W3,
    // whose decode holds more registers)
    constexpr int CH = NT <= 2 && !UNIT_W3 ? 2 : 1;
    float d[CH][NT][4];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int nb = 0; nb < NT; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[ch][nb][e] = 0.f;
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
      const int q = 2 * gi + qq;
      uint2 l0, l1, h0 = make_uint2(0u, 0u), h1 = make_uint2(0u, 0u);
      const int r0 = (UNIT_W3 ? 8 * (q >> 1) : 8 * q) + 2 * tq;
      l0 = *reinterpret_cast<const uint2*>(cw + r0 * rw + 2 * gq);
      l1 = *reinterpret_cast<const uint2*>(cw + (r0 + 1) * rw + 2 * gq);
      if constexpr (UNIT_W3) {
        h0 = *reinterpret_cast<const uint2*>(cw + (16 + 2 * tq) * rw + 2 * gq);
        h1 = *reinterpret_cast<const uint2*>(cw + (17 + 2 * tq) * rw + 2 * gq);
        const int ls = 16 * (q & 1), hs = 8 * q;
        l0.x >>= ls; l0.y >>= ls; l1.x >>= ls; l1.y >>= ls;
        h0.x >>= hs; h0.y >>= hs; h1.x >>= hs; h1.y >>= hs;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t a[4];
        code_pairs(l0.x, l1.x, h0.x, h1.x, j, a[0], a[2]);   // column 2gq
        code_pairs(l0.y, l1.y, h0.y, h1.y, j, a[1], a[3]);   // column 2gq + 1
        const int kk = (cl * SUB + q) * 4 + j;
#pragma unroll
        for (int nb = 0; nb < NT; ++nb) {
          const uint2 b = *reinterpret_cast<const uint2*>(xrow + (size_t)nb * 8 * s.xp + 8 * kk);
          mma_bf16_16816(d[j % CH][nb], a, b.x, b.y);
        }
      }
    }
    const float2 sc = *reinterpret_cast<const float2*>(sv + gi * rw + 2 * gq);
    const float2 sz = *reinterpret_cast<const float2*>(zv + gi * rw + 2 * gq);
    const float zc0 = fmaf(-static_cast<float>(CENTER), sc.x, sz.x);
    const float zc1 = fmaf(-static_cast<float>(CENTER), sc.y, sz.y);
    const int g = cl * SGROUPS + gi;
#pragma unroll
    for (int nb = 0; nb < NT; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xs = s.xsum[(rb + 8 * nb + 2 * tq + e) * s.ng + g];
        float d0 = d[0][nb][e], d1 = d[0][nb][2 + e];
        if constexpr (CH == 2) {
          d0 += d[1][nb][e];
          d1 += d[1][nb][2 + e];
        }
        acc[nb][e] += d0 * sc.x - xs * zc0;
        acc[nb][2 + e] += d1 * sc.y - xs * zc1;
      }
    }
  }
}

// A wave's rounds for one warp: every consumer warp passes every round (the
// empty barrier counts all eight); a busy warp takes its piece of each:
// chunk r·K + kp of its tile slot, NT n8 tiles of rows from rb.
template <int NT>
__device__ __forceinline__ void wave_rounds(const Smem& s, const Box& bx, int seq, int nr, int K,
                                            int kp, bool busy, int box, int tcol, int wc, int rb,
                                            float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < nr; ++r) {
    const int idx = seq + r, slot = idx % SLOTS, c = r * K + kp;
    ring_wait(&s.full[slot], (idx / SLOTS) & 1);
    if (busy && c < wc) {
      const uint8_t* base = s.ring + slot * SB;
      const int ro = kp * SGROUPS * bx.pw + tcol;
      stage_mma<NT>(s,
                    reinterpret_cast<const uint32_t*>(base + box * bx.cbx) + kp * SROWS * bx.pw + tcol,
                    reinterpret_cast<const float*>(base + bx.parts * bx.cbx + box * bx.sbx) + ro,
                    reinterpret_cast<const float*>(base + bx.parts * bx.cbx + (bx.parts + box) * bx.sbx) + ro,
                    bx.pw, c, rb, acc);
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&s.empty[slot]);
  }
}

// Where block g's sum of squares of row r lies in ssp: [block][row] in K6,
// [row][block] in K5 (whose norm_factors then read a row's sums in a run).
__device__ __forceinline__ size_t ssp_at(int r, int g) {
  return CHUNK ? (size_t)r * gridDim.x + g : (size_t)g * MAXB + r;
}

// Row sums of squares of this block's columns [c0, c1) of y [B][H], one
// warp a row, into ssp (ssp_at) for the next phase's folded rmsnorm; K5
// takes the rows [r0, r1) that this rank finished and leaves 0 for the rest.
__device__ void row_squares(const float* y, int H, int B, int c0, int c1, float* ssp,
                            int r0, int r1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < B; r += K6_WARPS) {
    float v = 0.f;
    for (int c = c0 + lane; r >= r0 && r < r1 && c < c1; c += 32) {
      const float x = y[(size_t)r * H + c];
      v += x * x;
    }
    v = warp_sum(v);
    if (lane == 0) ssp[ssp_at(r, blockIdx.x)] = v;
  }
}

// Each row's rmsnorm factor rsqrt(mean of squares + eps) from the blocks'
// partial sums, added in block order.
__device__ void norm_factors(const Smem& s, const float* ssp, int B, int H, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < B; r += K6_WARPS) {
    float v = 0.f;
    for (int g = lane; g < static_cast<int>(gridDim.x); g += 32) v += ssp[ssp_at(r, g)];
    v = warp_sum(v);
    if (lane == 0) s.rs[r] = rsqrtf(v / H + eps);
  }
}

// The epilogue of one output element (row r, column c) of phase ph with
// its full sum v.
struct Out {
  float* hres; float* h1; float* qkv; bf16* xw; bf16* hm; float* logits; float* ssp;
};

// ---- K5's cluster merge ------------------------------------------------------

// One arrival on rank `rank`'s copy of this block's mbarrier `bar`,
// releasing this thread's (and, through the barrier before it, the
// block's) earlier writes to the cluster.
__device__ __forceinline__ void arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               ::"r"(hop::cluster_map(bar, rank)) : "memory");
}

// Wait for the phase of parity `parity` of a merge barrier, acquiring what
// the ranks released with their arrivals; traps after about 10 s.
__device__ __forceinline__ void cluster_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = hop::smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t tries = 1;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((tries & 1023u) == 0u) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// The rows [r0, r1) whose outputs rank `rank` of a cluster of `cl` finishes.
__device__ __forceinline__ void rank_rows(int B, int cl, int rank, int& r0, int& r1) {
  r0 = rank * B / cl;
  r1 = (rank + 1) * B / cl;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

// K5's merge of a wave, after each rank has put its sums over its run of IC
// (tiles [lo, hi) of the wave's box, 16 columns, B rows, in that order) in
// tot: the ranks announce their sums (mready), every rank adds all ranks'
// in rank order from distributed shared memory for its own rows
// (rank_rows) and finishes them as K6's epilogue does (QKV: bf16, then +
// bias, no second rounding); then it announces that it has read every
// rank's tot (mfree), which a rank waits for before it writes tot again.
// The nmerge-th merge of the launch.
__device__ void merge_wave(const BatchArgs& a, const Smem& s, const PD& d, int ph, int l,
                           const Out& o, int st, int lo, int hi, int nmerge) {
  const int tid = threadIdx.x, B = a.B, I = a.I, H = a.H, oq = (a.nq + 2 * a.nkv) * MK_HD;
  const int cl = a.cl, rank = blockIdx.x % cl;
  hop::bar_sync(CB, 32 * K6_WARPS);                 // tot is written
  if (cl > 1) {
    if (tid == 0) {
      asm volatile("fence.acq_rel.cluster;" ::: "memory");
      for (int q = 0; q < cl; ++q) arrive_remote(s.mready, q);
    }
    cluster_wait(s.mready, nmerge & 1);             // every rank's tot is written
  }
  int r0, r1;
  rank_rows(B, cl, rank, r0, r1);
  const int nr = r1 - r0, per = 16 * nr, units = d.pair ? (hi - lo) / 2 : hi - lo;
  auto sum = [&](int t, int col, int r) {
    const int idx = ((t - lo) * 16 + col) * B + r;
    float v = 0.f;
    for (int q = 0; q < cl; ++q)
      v += cl > 1 ? ld_cluster_f32(hop::cluster_map(s.tot, q) + 4u * idx) : s.tot[idx];
    return v;
  };
  // thread tid takes (column, row) j = tid, tid + 256, ... of each unit: the
  // divisions once a merge, not once an output
  for (int j = tid; j < per; j += 32 * K6_WARPS) {
    const int col = j / nr, r = r0 + j % nr;
    for (int t = 0; t < units; ++t) {
      if (d.pair) {
        const int tg = lo + 2 * t, cg = tile_col(d, st + tg, I) + col;
        const float gt = bf16r(sum(tg, col, r)), up = bf16r(sum(tg + 1, col, r));
        o.hm[(size_t)r * I + 2 * perm_word(cg & ~1) + (cg & 1)] =
            __float2bfloat16_rn(gt * (1.f / (1.f + expf(-gt))) * up);
        fence_proxy_global();
        continue;
      }
      const int tt = lo + t, c = tile_col(d, st + tt, I) + col;
      const float v = sum(tt, col, r);
      if (ph == 0) {
        float x = bf16r(v);
        if (a.has_bias) x += load_act(a.qkv_b, a.md, (size_t)l * oq + c);
        o.qkv[(size_t)r * oq + c] = x;
      } else if (ph == 1) {
        o.h1[(size_t)r * H + c] = o.hres[(size_t)r * H + c] + v;
      } else {
        o.hres[(size_t)r * H + c] = bf16r(o.h1[(size_t)r * H + c] + v);
      }
    }
  }
  if (cl > 1) {
    hop::bar_sync(CB, 32 * K6_WARPS);               // this rank has read every tot
    if (tid == 0)
      for (int q = 0; q < cl; ++q) arrive_remote(s.mfree, q);
  }
}

// A matmul phase, consumer side: for each window, stage its rows, then for
// each wave of the block's tiles let each warp take its chunks, add the
// warps' sums in warp order and finish (or carry the window's partial sums
// in `part`, a block-private f32 buffer, to the next window).
__device__ void mm_phase(const BatchArgs& a, const Smem& s, const PD& d, int ph, int l,
                         int seq, const Out& o, float* part, int pld, int& nbulk, int& nmerge) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, H = a.H, I = a.I, oq = (a.nq + 2 * a.nkv) * MK_HD;
  const bool fold = ph == 0 || ph == 2 || ph == 4;
  const float* srcf = ph == 2 ? o.h1 : o.hres;
  const bf16* srcb = ph == 1 ? o.xw : o.hm;     // the attention rows, SiLU·mul
  const void* nw = ph == 0 ? a.ln1 : ph == 2 ? a.ln2 : a.norm_w;
  const size_t woff = ph == 4 ? 0 : (size_t)l * H;
  const int ic = ph == 3 ? I : H;
  const int K = d.k, rh = a.rh, nwaves = (d.nt + d.wave - 1) / d.wave;
  // this warp's place in a wave: tile slot, row half, chunk phase
  const int ts = warp / (K * rh), rhalf = (warp / K) % rh, kp = warp % K;
  const int rb = rhalf * WARP_ROWS;
  const int nt = max(0, min(4, (a.bp - rb) / 8));
  if (fold) norm_factors(s, o.ssp, B, H, a.eps);
  for (int win = 0; win < d.nw; ++win) {
    const int c0 = win_lo(d, win), wc = win_lo(d, win + 1) - c0;
    hop::bar_sync(CB, 32 * K6_WARPS);        // the last window's rows are read
    stage_rows(s, fold ? srcf : nullptr, srcb, ic, nw, woff, a.md, (d.ch0 + c0) * KC, wc * KC, B,
               a.bp, nbulk);
    hop::bar_sync(CB, 32 * K6_WARPS);
    const Box bx = box_of(d);
    for (int wv = 0; wv < nwaves; ++wv) {
      // the wave's box holds tiles st .. st + wave − 1; this wave owns [lo, hi)
      const int st = wave_start(d, wv), lo = wv * d.wave - st, hi = min(d.wave, d.nt - st);
      float acc[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
      // every consumer warp passes every round (the empty barrier counts
      // all eight); a busy warp takes its piece: chunk r·K + kp of its tile
      const int nr = (wc + K - 1) / K;
      const bool busy = ts >= lo && ts < hi;
      const int box = d.pair ? (ts & 1) : 0, tcol = d.pair ? 16 * (ts >> 1) : 16 * ts;
      // the n8 tiles of the warp's rows as a constant: no product guarded
      if (nt == 1) wave_rounds<1>(s, bx, seq, nr, K, kp, busy, box, tcol, wc, rb, acc);
      else if (nt == 2) wave_rounds<2>(s, bx, seq, nr, K, kp, busy, box, tcol, wc, rb, acc);
      else if (nt == 3) wave_rounds<3>(s, bx, seq, nr, K, kp, busy, box, tcol, wc, rb, acc);
      else wave_rounds<4>(s, bx, seq, nr, K, kp, busy, box, tcol, wc, rb, acc);
      seq += nr;
      if (busy) {
        const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              s.red[(warp * 16 + 2 * gq + h) * WARP_ROWS + 8 * nb + 2 * tq + e] = acc[nb][2 * h + e];
      }
      hop::bar_sync(CB, 32 * K6_WARPS);
      // the sum of tile slot t's warps at (column col, row r), in warp order
      auto total = [&](int t, int col, int r) {
        float v = 0.f;
        const int w0 = (t * rh + r / WARP_ROWS) * K;
        for (int q = 0; q < K; ++q) v += s.red[((w0 + q) * 16 + col) * WARP_ROWS + r % WARP_ROWS];
        return v;
      };
      const bool last = win == d.nw - 1;
      // carry a window's sum at column c of row r; the full sum on the last
      auto carry = [&](float v, int r, int c) {
        float* p = ph == 4 ? o.logits + (size_t)r * a.vocab + c : part + (size_t)r * pld + c;
        if (d.nw == 1) return v;
        const float t = (win ? *p : 0.f) + v;
        if (!last) *p = t;
        return t;
      };
      if constexpr (CHUNK) {
        // this block's sums over its run of IC into tot (carried over the
        // windows in part, which is the rank's own); the cluster merges them
        if (last && a.cl > 1 && nmerge > 0) cluster_wait(s.mfree, (nmerge - 1) & 1);
        // thread tid takes (column, row) j = tid, tid + 256 of each tile's
        // 16 x B sums, the divisions once a window, not once an output
        for (int j = tid; j < 16 * B; j += 32 * K6_WARPS) {
          const int col = j / B, r = j % B;
          for (int t = lo; t < hi; ++t) {
            const float v = carry(total(t, col, r), r, tile_col(d, st + t, I) + col);
            if (last) s.tot[(t - lo) * 16 * B + j] = v;
          }
        }
        if (last) merge_wave(a, s, d, ph, l, o, st, lo, hi, nmerge++);
        hop::bar_sync(CB, 32 * K6_WARPS);      // red is free
        continue;
      }
      const int per = 16 * B, t0 = d.pair ? lo / 2 : lo;
      const int items = (d.pair ? (hi - lo) / 2 : hi - lo) * per;
      for (int i = tid; i < items; i += 32 * K6_WARPS) {
        const int t = t0 + i / per, col = (i % per) / B, r = i % B;
        if (d.pair) {
          const int cg = tile_col(d, st + 2 * t, I) + col;
          const float g = carry(total(2 * t, col, r), r, cg);
          const float u = carry(total(2 * t + 1, col, r), r, cg + I);
          if (!last) continue;
          const float gt = bf16r(g), up = bf16r(u);
          // stored in the staged pair layout that down's bulk staging copies
          o.hm[(size_t)r * I + 2 * perm_word(cg & ~1) + (cg & 1)] =
              __float2bfloat16_rn(gt * (1.f / (1.f + expf(-gt))) * up);
          fence_proxy_global();
          continue;
        }
        const int c = tile_col(d, st + t, I) + col;
        const float v = carry(total(t, col, r), r, c);
        if (!last) continue;
        if (ph == 0) {
          float x = bf16r(v);
          if (a.has_bias) x = bf16r(x + load_act(a.qkv_b, a.md, (size_t)l * oq + c));
          o.qkv[(size_t)r * oq + c] = x;
        } else if (ph == 1) {
          o.h1[(size_t)r * H + c] = o.hres[(size_t)r * H + c] + v;
        } else if (ph == 3) {
          o.hres[(size_t)r * H + c] = bf16r(o.h1[(size_t)r * H + c] + v);
        } else if (ph == 4) {
          o.logits[(size_t)r * a.vocab + c] = v;
        }
      }
      hop::bar_sync(CB, 32 * K6_WARPS);      // red is free
    }
  }
}

// ---- attention ---------------------------------------------------------------

// quantize_kv_rows (mega_common.cuh) over the consumer warps alone: the
// same arithmetic, bit-equal to quantize_kv, with the consumers' named
// barrier in place of the block's. Called by all 256 consumer threads.
__device__ __forceinline__ void quantize_rows(const float* kc, const float* vc, int8_t* kq,
                                              int8_t* vq, float* ks, float* vs, bf16* kout,
                                              bf16* vout, float* red) {
  const int t = threadIdx.x, d = t & (MK_HD - 1), which = t >> 7;
  const float x = bf16r(which ? vc[d] : kc[d]);
  const float a = warp_max(fabsf(x));
  hop::bar_sync(CB, 32 * K6_WARPS);
  if ((t & 31) == 0) red[t >> 5] = a;
  hop::bar_sync(CB, 32 * K6_WARPS);
  const float* r = red + which * (MK_HD / 32);
  const float sc = __fmul_rn(fmaxf(fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3])), 1e-6f), 1.f / 127.f);
  (which ? vq : kq)[d] = static_cast<int8_t>(fminf(fmaxf(rintf(x / sc), -127.f), 127.f));
  if (d == 0) *(which ? vs : ks) = sc;
  (which ? vout : kout)[d] = __float2bfloat16_rn(x);
  hop::bar_sync(CB, 32 * K6_WARPS);
}

// The attention items (row, kv head, position slice), consumer warps only.
// An item ropes its q heads (scaled) and its current k in shared memory;
// slice 0 writes the current k/v at the row's position. Warps stride the
// positions, each keeping an online softmax (K4's arithmetic) over k/v rows
// that a ring of its own in shared memory brings in by cp.async, 16 (f32: 8)
// positions ahead; the block then merges its warps.
// G: the most q heads a kv head this instance takes (4 or MK_MAXG), so that
// the running states of a group of 4 hold no registers for 8; EXACT: the
// group has G heads, so the heads' chains interleave with no guard.
template <typename CT, bool PAGED, int G, bool EXACT>
__device__ void attention_g(const BatchArgs& a, const Smem& s, int l, const float* qkv,
                            CT* cache) {
  constexpr bool Q8 = sizeof(CT) == 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, nq = a.nq, nkv = a.nkv, grp = nq / nkv;
  const int oq = (nq + 2 * nkv) * MK_HD;
  float* sq = s.att;                              // [MK_MAXG][128] roped q·scale
  float* kc = sq + MK_MAXG * MK_HD;               // [128] current k (roped)
  float* vc = kc + MK_HD;                         // [128] current v
  float* wm = vc + MK_HD;                         // [8][MK_MAXG]
  float* wl = wm + K6_WARPS * MK_MAXG;            // [8][MK_MAXG]
  float* wacc = wl + K6_WARPS * MK_MAXG;          // [8][MK_MAXG][128]
  float* red8 = wacc + K6_WARPS * MK_MAXG * MK_HD;
  float* pml = a.ws + (size_t)B * (2 * a.H + oq);
  const size_t nrows = (size_t)B * nkv * a.nsplit * grp;
  float* pacc = pml + ((nrows * 2 + 3) & ~(size_t)3);
  const float scale = 1.f / sqrtf((float)MK_HD);
  const int items = B * nkv * a.nsplit;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / (nkv * a.nsplit), kvh = (it / a.nsplit) % nkv, sp = it % a.nsplit;
    const int len = row_length(a.lengths, b, a.T);
    const int p0 = sp * a.split_len;
    // position len is the current token; the last slice runs on to it, so
    // max_length only balances the slices and no row depends on it
    const int p1 = sp == a.nsplit - 1 ? len + 1 : min(p0 + a.split_len, len + 1);
    const float* qrow = qkv + (size_t)b * oq;
    const float* cr = a.cosr + b * MK_HD;
    const float* sr = a.sinr + b * MK_HD;
    hop::bar_sync(CB, 32 * K6_WARPS);             // the last item's smem is read
    // rope (HF rotate-half, as JAX's rope with the row's cos/sin): for d <
    // 64, x[d]·c[d] − x[d + 64]·s[d]; else x[d]·c[d] + x[d − 64]·s[d]
    for (int i = tid; i < (grp + 2) * MK_HD; i += 32 * K6_WARPS) {
      const int g = i / MK_HD, d = i % MK_HD;
      const int base = g < grp ? (kvh * grp + g) * MK_HD
                               : (g == grp ? nq + kvh : nq + nkv + kvh) * MK_HD;
      const float x = qrow[base + d];
      if (g == grp + 1) {
        vc[d] = x;
        continue;
      }
      const float y = d < 64 ? x * cr[d] - qrow[base + d + 64] * sr[d]
                             : x * cr[d] + qrow[base + d - 64] * sr[d];
      if (g < grp) sq[i] = y * scale;
      else kc[d] = y;
    }
    hop::bar_sync(CB, 32 * K6_WARPS);
    if (sp == 0) {                 // the row's k/v at its own position
      const size_t orow = (((size_t)l * B + b) * nkv + kvh) * MK_HD;
      const size_t kr = kv_row<PAGED>(a, l, 0, b, kvh, len);
      const size_t vr = kv_row<PAGED>(a, l, 1, b, kvh, len);
      if constexpr (Q8) {
        quantize_rows(kc, vc, cache + kr * MK_HD, cache + vr * MK_HD, a.scales + kr,
                      a.scales + vr, static_cast<bf16*>(a.k_new) + orow,
                      static_cast<bf16*>(a.v_new) + orow, red8);
      } else {
        const int d = tid & (MK_HD - 1), which = tid >> 7;
        const CT v = from_f32<CT>(which ? vc[d] : kc[d]);
        cache[(which ? vr : kr) * MK_HD + d] = v;
        static_cast<CT*>(which ? a.v_new : a.k_new)[orow + d] = v;
      }
    }
    float m[G], lsum[G], acc[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = -INFINITY; lsum[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
    }
    // this warp's positions p0 + warp + 8i before len stream through its
    // ring: position i's k and v rows (and, int8, their scales) by 16-byte
    // cp.async, KV_RING positions ahead, one commit group each
    uint8_t* ring = reinterpret_cast<uint8_t*>(red8 + K6_WARPS) + warp * KV_RING * KV_SLOT;
    const int nown = p1 > p0 + warp ? (p1 - p0 - warp + K6_WARPS - 1) / K6_WARPS : 0;
    const int nload = min(nown, len > p0 + warp ? (len - p0 - warp + K6_WARPS - 1) / K6_WARPS : 0);
    auto fetch = [&](int i) {
      if (i < nload) {
        const int p = p0 + warp + K6_WARPS * i;
        uint8_t* slot = ring + (i % KV_RING) * KV_SLOT;
        const size_t kr = kv_row<PAGED>(a, l, 0, b, kvh, p), vr = kv_row<PAGED>(a, l, 1, b, kvh, p);
#pragma unroll
        for (int c = lane; c < 2 * KV_VEC; c += 32) {
          const int which = c >= KV_VEC, v = c - which * KV_VEC;
          hop::cp_async16(slot + c * 16, reinterpret_cast<const uint8_t*>(
                              cache + (which ? vr : kr) * MK_HD) + v * 16, true);
        }
        if constexpr (Q8) {
          if (lane < 2)
            hop::cp_async4(slot + 2 * KV_VEC * 16 + 4 * lane, a.scales + (lane ? vr : kr), true);
        }
      }
      hop::cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < KV_RING - 2; ++i) fetch(i);
    // two positions an iteration: both scores' reductions are in flight
    // together, then the running states take them in order
    for (int i = 0; i < nown; i += 2) {
      fetch(i + KV_RING - 2);
      fetch(i + KV_RING - 1);
      asm volatile("cp.async.wait_group %0;" ::"n"(KV_RING - 2) : "memory");
      __syncwarp();
      float kv4[2][4], vv4[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (i + u < nload) {
          const uint8_t* slot = ring + ((i + u) % KV_RING) * KV_SLOT;
          load4<CT>(reinterpret_cast<const CT*>(slot) + lane * 4, kv4[u]);
          load4<CT>(reinterpret_cast<const CT*>(slot + KV_VEC * 16) + lane * 4, vv4[u]);
          if constexpr (Q8) {
            const float ks = reinterpret_cast<const float*>(slot + 2 * KV_VEC * 16)[0];
            const float vs = reinterpret_cast<const float*>(slot + 2 * KV_VEC * 16)[1];
#pragma unroll
            for (int e = 0; e < 4; ++e) { kv4[u][e] *= ks; vv4[u][e] *= vs; }
          }
        } else {                      // the current token (or past the slice: unused)
#pragma unroll
          for (int e = 0; e < 4; ++e) { kv4[u][e] = kc[lane * 4 + e]; vv4[u][e] = vc[lane * 4 + e]; }
        }
      }
      __syncwarp();                   // the slots are read before fetch() refills them
      float sc[2][G];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dp = 0.f;
          if (EXACT || g < grp) {
#pragma unroll
            for (int e = 0; e < 4; ++e) dp = fmaf(sq[g * MK_HD + lane * 4 + e], kv4[u][e], dp);
          }
          sc[u][g] = dp;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g) sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], o);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (i + u >= nown) break;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (EXACT || g < grp) {
            const float mn = fmaxf(m[g], sc[u][g]);
            const float alpha = expf(m[g] - mn);
            const float pr = expf(sc[u][g] - mn);
            lsum[g] = lsum[g] * alpha + pr;
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = acc[g][e] * alpha + pr * vv4[u][e];
            m[g] = mn;
          }
        }
      }
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < grp) {
        if (lane == 0) { wm[warp * MK_MAXG + g] = m[g]; wl[warp * MK_MAXG + g] = lsum[g]; }
#pragma unroll
        for (int e = 0; e < 4; ++e) wacc[(warp * MK_MAXG + g) * MK_HD + lane * 4 + e] = acc[g][e];
      }
    }
    hop::bar_sync(CB, 32 * K6_WARPS);
    for (int i = tid; i < grp * MK_HD; i += 32 * K6_WARPS) {
      const int g = i / MK_HD, d = i % MK_HD;
      float mx = -INFINITY;
      for (int w = 0; w < K6_WARPS; ++w) mx = fmaxf(mx, wm[w * MK_MAXG + g]);
      float ls = 0.f, ac = 0.f;
      for (int w = 0; w < K6_WARPS; ++w) {
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
  }
}

template <typename CT, bool PAGED>
__device__ void attention(const BatchArgs& a, const Smem& s, int l, const float* qkv,
                          CT* cache) {
  const int grp = a.nq / a.nkv;
  if (grp == 4) attention_g<CT, PAGED, 4, true>(a, s, l, qkv, cache);
  else if (grp == MK_MAXG) attention_g<CT, PAGED, MK_MAXG, true>(a, s, l, qkv, cache);
  else if (grp < 4) attention_g<CT, PAGED, 4, false>(a, s, l, qkv, cache);
  else attention_g<CT, PAGED, MK_MAXG, false>(a, s, l, qkv, cache);
}

// ---- K5's attention -----------------------------------------------------------

// The 8 elements of 16 bytes of a row of the mma type, from f32.
template <typename MT>
__device__ __forceinline__ uint4 pack8(const float* e) {
  return make_uint4(pack2<MT>(e[0], e[1]), pack2<MT>(e[2], e[3]), pack2<MT>(e[4], e[5]),
                    pack2<MT>(e[6], e[7]));
}

// K5's attention, consumer warps only: the window's k/v first go into the
// cache at [hist, hist + S) and into k_new/v_new (roped k; each element once
// over the grid), then items (kv head, block of 128 query rows, position
// slice) run K3's GQA-packed tile inside the persistent grid. A kv head's
// query rows are the window's (row, head-in-group) pairs, row-major, so
// that one K/V tile serves every head of the group. An item's block stages
// its 128 rows of q (roped and scaled in f32, split into hi and lo halves of
// the mma type: two products into the same sums, so q keeps about f32's
// precision, as K2's q does) and, where its slice reaches the window, the
// window's k and v of its kv head from the QKV workspace, not from the
// cache: the window tail. JAX keeps it in f32 in registers
// (megakernel_chunk.py:208-229); K5 keeps the window's k at f32's precision
// too (hi and lo halves, below) and rounds its v to the mma type, as P is
// rounded, where the cache it writes for later steps holds both rounded to
// the cache's dtype. Warp w takes rows 16w .. 16w + 15 as mma.sync m16n8k16 A
// fragments (ldmatrix). The block brings TP-position K and V tiles of the
// slice into two shared stages (cp.async of 16-byte pieces from the cache,
// an f32 cache's rows converted on the way, the window's rows from its
// staged copy; every row's 16-byte chunks XOR-swizzled by its low three
// bits for ldmatrix). Where a tile holds keys the mma type cannot hold (an
// f32 cache, or the window's own k, both f32 in the plain version and in
// JAX), the tile keeps a lo half beside each key and the scores add
// q_hi·k_lo as a third product: an attention row whose softmax sits on a
// few large scores moves by several % when its keys lose f32's mantissa
// (a random model's rows did, PERF.md §6). V stays in the mma type (an
// f32 cache's rounded to bf16, as K3's f32 mode rounds it). S = Q·K^T, an
// online max and sum in f32 per row, the causal limit per row by its
// position; O += P·V with V through ldmatrix.trans and P as hi and lo
// halves of the mma type (bf16; f16 over an f16 cache), two products into
// f32 sums, where K3 and JAX's TPU kernel round P once: P's rounding alone
// moved one row of the smoke's random model by 2% (PERF.md §6). Each slice
// leaves its (max, sum, unnormalised output) per row for the combine, as
// K6's slices do.
constexpr int CQ_ROWS = 128;                       // query rows an item
template <typename MT>
__device__ __forceinline__ MT* swz_row(MT* base, int row, int ch) {   // 16-byte chunk ch of a row
  return base + row * MK_HD + ((ch ^ (row & 7)) * 8);
}

// Channels 8ch .. 8ch + 7 of a 128-wide f32 row x, roped with the row's
// cos/sin (HF rotate-half, rope_at's arithmetic) where `rope`, by vector
// loads.
__device__ __forceinline__ void row8(const float* x, const float* cr, const float* sr, int ch,
                                     bool rope, float* y) {
  const int d = 8 * ch;
  unpack16<float>(*reinterpret_cast<const uint4*>(x + d), y);
  unpack16<float>(*reinterpret_cast<const uint4*>(x + d + 4), y + 4);
  if (!rope) return;
  const int o = d < MK_HD / 2 ? d + MK_HD / 2 : d - MK_HD / 2;
  float p[8], c[8], sn[8];
  unpack16<float>(*reinterpret_cast<const uint4*>(x + o), p);
  unpack16<float>(*reinterpret_cast<const uint4*>(x + o + 4), p + 4);
  unpack16<float>(*reinterpret_cast<const uint4*>(cr + d), c);
  unpack16<float>(*reinterpret_cast<const uint4*>(cr + d + 4), c + 4);
  unpack16<float>(*reinterpret_cast<const uint4*>(sr + d), sn);
  unpack16<float>(*reinterpret_cast<const uint4*>(sr + d + 4), sn + 4);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const float rot = d < MK_HD / 2 ? -p[u] : p[u];
    y[u] = y[u] * c[u] + rot * sn[u];
  }
}

template <typename CT>
__device__ void attention_chunk(const BatchArgs& a, const Smem& s, int l, const float* qkv,
                                CT* cache) {
  using MT = typename MmaOf<CT>::type;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const int S = a.B, nq = a.nq, nkv = a.nkv, grp = nq / nkv, hist = a.hist;
  const int oq = (nq + 2 * nkv) * MK_HD, R = S * grp, nrb = (R + CQ_ROWS - 1) / CQ_ROWS;
  const size_t T = a.T;
  float* pml = a.ws + (size_t)S * (2 * a.H + oq);
  const size_t nrows = (size_t)S * nq * a.nsplit;
  float* pacc = pml + ((nrows * 2 + 3) & ~(size_t)3);
  const float scale = 1.f / sqrtf((float)MK_HD);
  // the window's k (roped) and v into the cache and k_new/v_new, 8 channels
  // a thread
  for (int i = blockIdx.x * 32 * K6_WARPS + tid; i < 2 * nkv * S * 16;
       i += gridDim.x * 32 * K6_WARPS) {
    const int ch = i % 16, r = (i / 16) % S, kvh = (i / (16 * S)) % nkv, which = i / (16 * S * nkv);
    float y[8];
    row8(qkv + (size_t)r * oq + (nq + which * nkv + kvh) * MK_HD, a.cosr + r * MK_HD,
         a.sinr + r * MK_HD, ch, !which, y);
    CT* c = cache + ((((size_t)l * 2 + which) * nkv + kvh) * T + hist + r) * MK_HD + 8 * ch;
    CT* o = static_cast<CT*>(which ? a.v_new : a.k_new)
            + (((size_t)l * nkv + kvh) * S + r) * MK_HD + 8 * ch;
#pragma unroll
    for (int u = 0; u < 8; ++u) c[u] = o[u] = from_f32<CT>(y[u]);
  }
  MT* qh = reinterpret_cast<MT*>(s.att);            // [128][128] q hi, swizzled
  MT* ql = qh + CQ_ROWS * MK_HD;                    // q lo
  MT* kw = ql + CQ_ROWS * MK_HD;                    // [32][128] the window's k hi
  MT* kwl = kw + 32 * MK_HD;                        // its k lo
  MT* vw = kwl + 32 * MK_HD;                        // and v
  MT* kt = vw + 32 * MK_HD;                         // [2][TP][128] K tiles (hi)
  MT* ktl = kt + 2 * TP * MK_HD;                    // K tiles' lo halves
  MT* vt = ktl + 2 * TP * MK_HD;                    // V tiles
  const int items = nkv * nrb * a.nsplit;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int kvh = it / (nrb * a.nsplit), rb = (it / a.nsplit) % nrb, sp = it % a.nsplit;
    const int p0 = sp * a.split_len, p1 = min(p0 + a.split_len, hist + S);
    const int q0 = rb * CQ_ROWS + warp * 16;        // the warp's first query row
    const bool busy = q0 < R;
    hop::bar_sync(CB, 32 * K6_WARPS);               // the last item's shared memory is read
    // the block's q rows (8 channels a piece), and the window's k/v where
    // the slice reaches it
#pragma unroll 4
    for (int c = tid; c < CQ_ROWS * 16; c += 32 * K6_WARPS) {
      const int qr = c / 16, ch = c % 16, row = rb * CQ_ROWS + qr;
      float y[8];
      if (row < R) {
        const int r = row / grp, g = row % grp;
        row8(qkv + (size_t)r * oq + (kvh * grp + g) * MK_HD, a.cosr + r * MK_HD,
             a.sinr + r * MK_HD, ch, true, y);
#pragma unroll
        for (int u = 0; u < 8; ++u) y[u] *= scale;
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) y[u] = 0.f;
      }
      const uint4 hi = pack8<MT>(y);
      const MT* hv = reinterpret_cast<const MT*>(&hi);
      float lo[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) lo[u] = y[u] - to_f32<MT>(hv[u]);
      *reinterpret_cast<uint4*>(swz_row(qh, qr, ch)) = hi;
      *reinterpret_cast<uint4*>(swz_row(ql, qr, ch)) = pack8<MT>(lo);
    }
    if (p1 > hist) {
      for (int c = tid; c < 2 * S * 16; c += 32 * K6_WARPS) {
        const int which = c / (S * 16), r = (c / 16) % S, ch = c % 16;
        float e[8];
        row8(qkv + (size_t)r * oq + (nq + which * nkv + kvh) * MK_HD, a.cosr + r * MK_HD,
             a.sinr + r * MK_HD, ch, !which, e);
        const uint4 hi = pack8<MT>(e);
        *reinterpret_cast<uint4*>(swz_row(which ? vw : kw, r, ch)) = hi;
        if (!which) {
          const MT* hv = reinterpret_cast<const MT*>(&hi);
#pragma unroll
          for (int u = 0; u < 8; ++u) e[u] -= to_f32<MT>(hv[u]);
          *reinterpret_cast<uint4*>(swz_row(kwl, r, ch)) = pack8<MT>(e);
        }
      }
    }
    hop::bar_sync(CB, 32 * K6_WARPS);
    // a tile's k rows as hi and lo halves of the mma type where a row may
    // need more than the mma type holds: an f32 cache, or the window's own
    // k (f32 in the plain version and in JAX); the scores then take the lo
    // halves as a third product
    auto has_lo = [&](int j) { return sizeof(CT) == 4 || p0 + j * TP + TP > hist; };
    // the 16-byte pieces (chunk ch) of position p of k and v into tile j
    auto load_tile = [&](int j) {
      MT* kb = kt + (j & 1) * TP * MK_HD;
      MT* kl = ktl + (j & 1) * TP * MK_HD;
      MT* vb = vt + (j & 1) * TP * MK_HD;
      const bool lo = has_lo(j);
      for (int c = tid; c < 2 * TP * 16; c += 32 * K6_WARPS) {
        const int which = c / (TP * 16), rr = (c / 16) % TP, ch = c % 16;
        const int p = p0 + j * TP + rr;
        uint4* dst = reinterpret_cast<uint4*>(swz_row(which ? vb : kb, rr, ch));
        uint4* dlo = reinterpret_cast<uint4*>(swz_row(kl, rr, ch));
        const bool klo = lo && !which;
        if (p < hist) {
          const CT* src = cache + ((((size_t)l * 2 + which) * nkv + kvh) * T + p) * MK_HD + ch * 8;
          if constexpr (sizeof(CT) == 2) {
            hop::cp_async16(dst, src, true);
            if (klo) *dlo = make_uint4(0u, 0u, 0u, 0u);   // the cache's k is exact
          } else {
            float e[8];
            unpack16<float>(*reinterpret_cast<const uint4*>(src), e);
            unpack16<float>(*reinterpret_cast<const uint4*>(src + 4), e + 4);
            const uint4 hi = pack8<MT>(e);
            *dst = hi;
            if (klo) {
              const MT* hv = reinterpret_cast<const MT*>(&hi);
#pragma unroll
              for (int u = 0; u < 8; ++u) e[u] -= to_f32<MT>(hv[u]);
              *dlo = pack8<MT>(e);
            }
          }
        } else if (p < hist + S) {
          *dst = *reinterpret_cast<const uint4*>(swz_row(which ? vw : kw, p - hist, ch));
          if (klo) *dlo = *reinterpret_cast<const uint4*>(swz_row(kwl, p - hist, ch));
        } else {
          *dst = make_uint4(0u, 0u, 0u, 0u);
          if (klo) *dlo = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      hop::cp_async_commit();
    };
    int lim[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int qr = q0 + gq + 8 * h2;
      lim[h2] = qr < R ? hist + qr / grp : -1;
    }
    float m[2] = {-INFINITY, -INFINITY}, ls[2] = {0.f, 0.f}, acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    const int ntile = (p1 - p0 + TP - 1) / TP;
    load_tile(0);
    for (int i = 0; i < ntile; ++i) {
      hop::cp_async_wait_all();
      hop::bar_sync(CB, 32 * K6_WARPS);             // tile i is in; tile i - 1 is read
      if (i + 1 < ntile) load_tile(i + 1);
      if (!busy) continue;
      const MT* kb = kt + (i & 1) * TP * MK_HD;
      const MT* kl = ktl + (i & 1) * TP * MK_HD;
      const MT* vb = vt + (i & 1) * TP * MK_HD;
      const int t0 = p0 + i * TP;
      const bool lo = has_lo(i);
      float sc[TP / 8][4];
#pragma unroll
      for (int nb = 0; nb < TP / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        // q's A fragments: rows q0 .. q0 + 15, channels 16kk .. 16kk + 15
        const int ar = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, ac = 2 * kk + (lane >> 4);
        uint32_t ah[4], al[4];
        hop::ldsm_x4(ah, swz_row(qh, ar, ac));
        hop::ldsm_x4(al, swz_row(ql, ar, ac));
#pragma unroll
        for (int nb = 0; nb < TP / 8; nb += 2) {
          // matrices: positions 8nb.. / 8nb + 8.., channels 16kk.. / 16kk + 8..
          const int pr = 8 * (nb + (lane >> 4)) + (lane & 7), ch = 2 * kk + ((lane >> 3) & 1);
          uint32_t b[4];
          hop::ldsm_x4(b, swz_row(kb, pr, ch));
          mma_16816<MT>(sc[nb], ah, b[0], b[1]);
          mma_16816<MT>(sc[nb], al, b[0], b[1]);
          mma_16816<MT>(sc[nb + 1], ah, b[2], b[3]);
          mma_16816<MT>(sc[nb + 1], al, b[2], b[3]);
          if (lo) {
            hop::ldsm_x4(b, swz_row(kl, pr, ch));
            mma_16816<MT>(sc[nb], ah, b[0], b[1]);
            mma_16816<MT>(sc[nb + 1], ah, b[2], b[3]);
          }
        }
      }
      // causal limit per row, the slice's end; online softmax per row
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float mx = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < TP / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = t0 + 8 * nb + 2 * tq + e;
            float& v = sc[nb][2 * h2 + e];
            v = (p < p1 && p <= lim[h2]) ? v : -INFINITY;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[h2], mx);
        const float mb = mn == -INFINITY ? 0.f : mn;
        const float alpha = expf(m[h2] - mb);
        float add = 0.f;
#pragma unroll
        for (int nb = 0; nb < TP / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[nb][2 * h2 + e];
            v = expf(v - mb);
            add += v;
          }
        ls[h2] = ls[h2] * alpha + add;
        m[h2] = mn;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          acc[n][2 * h2] *= alpha;
          acc[n][2 * h2 + 1] *= alpha;
        }
      }
#pragma unroll
      for (int t = 0; t < TP / 16; ++t) {
        // P as hi and lo halves of the mma type, two products into the sums
        uint32_t pa[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* v = sc[2 * t + (e >> 1)] + 2 * (e & 1);
          pa[e] = pack2<MT>(v[0], v[1]);
          const MT* hv = reinterpret_cast<const MT*>(&pa[e]);
          pl[e] = pack2<MT>(v[0] - to_f32<MT>(hv[0]), v[1] - to_f32<MT>(hv[1]));
        }
#pragma unroll
        for (int n = 0; n < 16; n += 2) {
          // matrices: positions 16t.. / 16t + 8.., channels 8n.. / 8n + 8..
          const int pr = 16 * t + 8 * ((lane >> 3) & 1) + (lane & 7), ch = n + (lane >> 4);
          uint32_t b[4];
          hop::ldsm_x4_trans(b, swz_row(vb, pr, ch));
          mma_16816<MT>(acc[n], pa, b[0], b[1]);
          mma_16816<MT>(acc[n], pl, b[0], b[1]);
          mma_16816<MT>(acc[n + 1], pa, b[2], b[3]);
          mma_16816<MT>(acc[n + 1], pl, b[2], b[3]);
        }
      }
    }
    if (busy) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float lt = ls[h2];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const int qr = q0 + gq + 8 * h2;
        if (qr >= R) continue;
        const size_t row = ((size_t)kvh * a.nsplit + sp) * R + qr;
        if (tq == 0) { pml[row * 2] = m[h2]; pml[row * 2 + 1] = lt; }
#pragma unroll
        for (int n = 0; n < 16; ++n)
          *reinterpret_cast<float2*>(pacc + row * MK_HD + 8 * n + 2 * tq) =
              make_float2(acc[n][2 * h2], acc[n][2 * h2 + 1]);
      }
    }
  }
  hop::cp_async_wait_all();
}

// ---- the kernel -------------------------------------------------------------

template <typename CT, bool PAGED>
__global__ void __launch_bounds__(K6_THREADS, 1) batched_kernel(const __grid_constant__ BatchArgs a) {
  extern __shared__ __align__(128) uint8_t smem_k6[];
  cg::grid_group grid = cg::this_grid();
  const Smem s = carve(smem_k6, a);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool producer = warp == PRODUCER;
  const int B = a.B, H = a.H, I = a.I, nq = a.nq, nkv = a.nkv, grp = nq / nkv;
  const int oq = (nq + 2 * nkv) * MK_HD;
  if (tid == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      hop::mbar_init(&s.full[i], 1);           // the producer's arrival with the bytes
      hop::mbar_init(&s.empty[i], K6_WARPS);   // every consumer warp, busy or not
    }
    hop::mbar_init(s.rowbar, 1);               // thread 0's arrival with the rows' bytes
    if (CHUNK) {
      hop::mbar_init(s.mready, a.cl);          // one arrival a rank a merge
      hop::mbar_init(s.mfree, a.cl);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  if (CHUNK && a.cl > 1) hop::cluster_sync();  // every rank's merge barriers are set up
  // the workspace (ops/megakernel_batched.py sizes it from batched_ws)
  Out o;
  o.hres = a.ws;                                      // [B][H] f32 residual
  o.h1 = o.hres + (size_t)B * H;                      // [B][H]
  o.qkv = o.h1 + (size_t)B * H;                       // [B][oq] (bias added, not roped)
  const size_t nrows = (size_t)B * nkv * a.nsplit * grp;
  float* pml = o.qkv + (size_t)B * oq;
  float* pacc = pml + ((nrows * 2 + 3) & ~(size_t)3);
  float* tail = pacc + nrows * MK_HD;
  o.xw = reinterpret_cast<bf16*>(tail);               // [B][H] bf16 attention rows
  o.hm = o.xw + (size_t)B * H;                        // [B][I] bf16
  o.ssp = tail + ((size_t)B * (H + I) + 7) / 2 / 4 * 4;   // [grid][64]
  const int pld = max(max(oq, H), 2 * I);
  // [B][pld] window partial sums (K5: one buffer a rank of a cluster)
  float* part = o.ssp + (size_t)gridDim.x * MAXB
                + (CHUNK ? (size_t)(blockIdx.x % a.cl) * B * pld : 0);
  int r0 = 0, r1 = B;                                 // the rows this block finishes
  if (CHUNK) rank_rows(B, a.cl, blockIdx.x % a.cl, r0, r1);
  int nmerge = 0;                                     // K5's cluster merges so far
  o.logits = a.logits;
  CT* cache = static_cast<CT*>(a.cache);
  int seq = 0;                                        // stages so far, as the producer's idx
  int nbulk = 0;                                      // bulk row stagings so far
  Prod p;
  if (producer) prod_begin(p, a);

  // ---- load: h_in into the f32 residual, each block a slice of columns,
  // and the slice's sums of squares a row for the first rmsnorm
  if (!producer) {
    const int c0 = static_cast<int>((long long)blockIdx.x * H / gridDim.x);
    const int c1 = static_cast<int>((long long)(blockIdx.x + 1) * H / gridDim.x);
    for (int r = warp; r < B; r += K6_WARPS) {
      float v = 0.f;
      for (int c = c0 + lane; c < c1; c += 32) {
        const float x = load_act(a.h_in, a.md, (size_t)r * H + c);
        o.hres[(size_t)r * H + c] = x;
        v += x * x;
      }
      v = warp_sum(v);
      if (lane == 0) o.ssp[ssp_at(r, blockIdx.x)] = v;
    }
  } else {
    pump(p, a, s, SLOTS);
  }
  grid.sync();

  for (int l = 0; l < a.L; ++l) {
    // ---- QKV: rmsnorm(h)·ln1 staged a window at a time; bf16, + bias, bf16
    {
      const PD d = phase_desc(a, 0, l);
      if (!producer && d.nt) mm_phase(a, s, d, 0, l, seq, o, part, pld, nbulk, nmerge);
      seq += phase_stages(d);
      if (producer) pump(p, a, s, seq + SLOTS);
    }
    grid.sync();
    // ---- attention slices: items (row, kv head, position slice); K5: (kv
    // head, query rows, position slice)
    if (!producer) {
      if constexpr (CHUNK) attention_chunk<CT>(a, s, l, o.qkv, cache);
      else attention<CT, PAGED>(a, s, l, o.qkv, cache);
    }
    grid.sync();
    // ---- combine the slices -> bf16 attention rows: a warp per (row, head)
    if (!producer) {
      for (int it = blockIdx.x + warp * gridDim.x; it < B * nq; it += gridDim.x * K6_WARPS) {
        const int b = it / nq, hq = it % nq;
        // K6: a slice's rows are the group's heads of (row, kv head); K5:
        // the kv head's packed (window row, head) rows
        const size_t row0 = CHUNK
            ? (size_t)(hq / grp) * a.nsplit * B * grp + (size_t)b * grp + hq % grp
            : ((size_t)(b * nkv + hq / grp) * a.nsplit) * grp + hq % grp;
        float ac[4];
        combine_row(pml, pacc, row0, CHUNK ? B * grp : grp, a.nsplit, ac);
        // in the staged pair layout that o-proj's bulk staging copies
        uint32_t* xr = reinterpret_cast<uint32_t*>(o.xw + (size_t)b * H);
        const int c = hq * MK_HD + lane * 4;
        xr[perm_word(c)] = pack_bf16x2(ac[0], ac[1]);
        xr[perm_word(c + 2)] = pack_bf16x2(ac[2], ac[3]);
      }
      fence_proxy_global();
    }
    grid.sync();
    // ---- o-proj + residual, and the block's sums of squares of h1
    {
      const PD d = phase_desc(a, 1, l);
      if (!producer) {
        if (d.nt) mm_phase(a, s, d, 1, l, seq, o, part, pld, nbulk, nmerge);
        hop::bar_sync(CB, 32 * K6_WARPS);
        row_squares(o.h1, H, B, 16 * d.t0, 16 * (d.t0 + d.nt), o.ssp, r0, r1);
      }
      seq += phase_stages(d);
      if (producer) pump(p, a, s, seq + SLOTS);
    }
    grid.sync();
    // ---- gate/up: rmsnorm(h1)·ln2 staged; hm = bf16(silu(bf16 gate)·bf16 up)
    {
      const PD d = phase_desc(a, 2, l);
      if (!producer && d.nt) mm_phase(a, s, d, 2, l, seq, o, part, pld, nbulk, nmerge);
      seq += phase_stages(d);
      if (producer) pump(p, a, s, seq + SLOTS);
    }
    grid.sync();
    // ---- down + residual, rounded to bf16 between layers
    {
      const PD d = phase_desc(a, 3, l);
      if (!producer) {
        if (d.nt) mm_phase(a, s, d, 3, l, seq, o, part, pld, nbulk, nmerge);
        hop::bar_sync(CB, 32 * K6_WARPS);
        row_squares(o.hres, H, B, 16 * d.t0, 16 * (d.t0 + d.nt), o.ssp, r0, r1);
      }
      seq += phase_stages(d);
      if (producer) pump(p, a, s, seq + SLOTS);
    }
    grid.sync();
  }
  for (int i = blockIdx.x * K6_THREADS + tid; i < B * H; i += gridDim.x * K6_THREADS)
    store_act(a.h_out, a.md, i, o.hres[i]);
  if (a.vocab) {
    // ---- head: the final rmsnorm staged, the W3/W4 head into f32 logits
    const PD d = phase_desc(a, 4, 0);
    if (!producer && d.nt) mm_phase(a, s, d, 4, 0, seq, o, part, pld, nbulk, nmerge);
    if (producer) pump(p, a, s, 1 << 30);
  }
  // K5: no rank leaves while another may still reach its shared memory
  if (CHUNK && a.cl > 1) hop::cluster_sync();
}

enum { P_H, P_OUT, P_QW, P_QS, P_QZ, P_QB, P_OW, P_OS, P_OZ, P_GW, P_GS, P_GZ,
       P_DW, P_DS, P_DZ, P_LN1, P_LN2, P_COS, P_SIN, P_CACHE, P_KN, P_VN, P_LEN,
       P_HW, P_HS, P_HZ, P_NW, P_LOGITS, P_TABLES, P_SCALES };
// paged mode: N_T is MP·page, N_NP the pool's pages (0: the slot cache);
// N_GRID .. N_WC: the host plan's grid, shared bytes, ring slots and window;
// N_PP: each matmul phase's wave, warps a tile and windows (qkv, o-proj,
// gate/up, down, head); N_OFF: the byte offsets of the shared-memory
// regions (O_BARS ..); N_CL: blocks a cluster (K6: 1); K5 (chunk mode):
// N_HIST, the window's first position, and the attention's slices
// (ops/megakernel_batched.py::chunk_slices; K6 sizes its own from N_MAXLEN)
enum { N_B, N_L, N_H, N_I, N_NQ, N_NKV, N_T, N_MAXLEN, N_VOCAB, N_MD, N_CD, N_BIAS,
       N_NP, N_PAGE, N_MP, N_W3, N_GRID, N_SMEM, N_SLOTS, N_WC, N_PP,
       N_OFF = N_PP + 3 * NPH, N_CL = N_OFF + NREG, N_HIST, N_NSPLIT, N_SPLIT, N_INTS };

struct Plan {
  int grid, nsplit, split_len, wc, rh, bp, smem, cl;
  int off[NREG];
  PhasePlan pp[NPH];
  long long ws;
};

// The grid the current card runs at once in clusters of `cl` blocks (1:
// one block an SM) of K6_THREADS threads with the most shared memory,
// after checking once per card and cluster size that it takes cooperative
// launches (the attribute is set to SMEM_MAX, so that no plan's bytes need
// another call). A cooperative launch with a cluster dimension runs and
// grid.sync()s on an H100 (the smoke's cluster probe, PERF.md §6); clusters
// of 4 or 8 leave SMs of a partly filled GPC idle.
template <typename CT, bool PAGED>
int card_grid(int cl, int* grid) {
  constexpr int CARDS = 64;
  static int cached[CARDS][4], errs[CARDS][4];
  const int ci = cl == 1 ? 0 : cl == 2 ? 1 : cl == 4 ? 2 : cl == 8 ? 3 : -1;
  if (ci < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= CARDS) return static_cast<int>(cudaErrorInvalidDevice);
  if (!cached[dev][ci]) {
    int coop = 0, occ = 0, n = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(batched_kernel<CT, PAGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, batched_kernel<CT, PAGED>,
                                                        K6_THREADS, SMEM_MAX);
    if (e == cudaSuccess && cl > 1) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = cl; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(cl); cfg.blockDim = dim3(K6_THREADS); cfg.dynamicSmemBytes = SMEM_MAX;
      cfg.attrs = at; cfg.numAttrs = 1;
      int ncl = 0;
      e = cudaOccupancyMaxActiveClusters(&ncl, batched_kernel<CT, PAGED>, &cfg);
      n = ncl * cl;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    errs[dev][ci] = !coop ? static_cast<int>(cudaErrorNotSupported)
                    : occ < 1 || n < 1 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
    cached[dev][ci] = n;
  }
  *grid = cached[dev][ci];
  return errs[dev][ci];
}

// The host plan (ops/megakernel_batched.py::batched_plan) as the kernel
// runs it: the grid (one block an SM; K5: whole clusters), the window of
// chunks, the shared bytes and the offsets of its regions, the ring's
// slots, and each matmul phase's wave, warps a tile and windows, taken
// from the ints and refused where they do not fit this build (a region
// misaligned or too small for what this build puts there, too many warps,
// a TMA box over 256, a grid the card does not run at once). K6's
// attention slices come from max_length here, K5's from the ints.
template <typename CT, bool PAGED>
int plan_for(const int* n, Plan* p) {
  const int B = n[N_B], H = n[N_H], I = n[N_I], nq = n[N_NQ], nkv = n[N_NKV];
  const cudaError_t bad = cudaErrorInvalidValue;
  if (B < 1 || B > MAXB || H % KC || I % KC) return static_cast<int>(bad);
  p->bp = (B + 7) / 8 * 8;
  p->rh = (B + WARP_ROWS - 1) / WARP_ROWS;
  p->wc = n[N_WC];
  p->smem = n[N_SMEM];
  p->cl = n[N_CL];
  for (int i = 0; i < NREG; ++i) p->off[i] = n[N_OFF + i];
  if (p->wc < 1 || n[N_SLOTS] != SLOTS || !layout_fits(p->off, p->smem, p->bp, p->wc)
      || (CHUNK ? p->cl < 1 : p->cl != 1))
    return static_cast<int>(bad);
  int grid = 0;
  const int err = card_grid<CT, PAGED>(p->cl, &grid);
  if (err) return err;
  if (n[N_GRID] != grid) return static_cast<int>(bad);      // the grid the card runs at once
  p->grid = grid;
  const int G = p->grid;
  const int oq = (nq + 2 * nkv) * MK_HD;
  const int ics[NPH] = {H, H, H, I, H};
  for (int ph = 0; ph < NPH; ++ph) {
    PhasePlan& q = p->pp[ph];
    q.wave = n[N_PP + 3 * ph]; q.k = n[N_PP + 3 * ph + 1]; q.nw = n[N_PP + 3 * ph + 2];
    const int u2 = ph == 2 ? 2 : 1, nch = ics[ph] / KC, nchq = (nch + p->cl - 1) / p->cl;
    if (ph == 4 && !n[N_VOCAB]) continue;
    if (q.wave < u2 || q.wave % u2 || q.k < 1 || q.wave * q.k * p->rh > K6_WARPS
        || 16 * q.wave / u2 > 256 || q.k * SROWS > 256 || q.nw < 1 || q.nw > nchq
        || nch < p->cl || (nchq + q.nw - 1) / q.nw > p->wc)
      return static_cast<int>(bad);
  }
  if (CHUNK) {
    // K5's items: the host's slices must cover [0, hist + S) with none empty
    const int npos = n[N_HIST] + B;
    p->nsplit = n[N_NSPLIT];
    p->split_len = n[N_SPLIT];
    if (p->nsplit < 1 || p->split_len < 1 || (long long)(p->nsplit - 1) * p->split_len >= npos
        || (long long)p->nsplit * p->split_len < npos)
      return static_cast<int>(bad);
  } else {
    // attention items: about one per block, at least 32 positions each
    const int npos = n[N_MAXLEN] + 1;
    int ns = G / (B * nkv);
    ns = ns < 1 ? 1 : ns;
    const int most = (npos + 31) / 32;
    ns = ns > most ? most : ns;
    p->split_len = (npos + ns - 1) / ns;
    p->nsplit = (npos + p->split_len - 1) / p->split_len;
  }
  const long long nrows = (long long)B * nq * p->nsplit;
  const long long pld = oq > H ? (oq > 2 * I ? oq : 2 * I) : (H > 2 * I ? H : 2 * I);
  p->ws = 2LL * B * H + (long long)B * oq + ((nrows * 2 + 3) & ~3LL) + nrows * MK_HD
          + ((long long)B * (H + I) + 7) / 2 / 4 * 4 + (long long)G * MAXB
          + (long long)p->cl * B * pld;
  return 0;
}

// A [planes, rows, cols] tensor of 4-byte elements, densely packed, read in
// boxes of box_rows x box_cols of one plane, no swizzle; reads past an
// edge return zeros. Returns a cudaError_t code (0 on success).
static int box_map(CUtensorMap* map, CUtensorMapDataType dt, const void* base, uint64_t cols,
                   uint64_t rows, uint64_t planes, uint32_t box_cols, uint32_t box_rows) {
  hop::EncodeTiled fn = hop::encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cols, rows, planes};
  const cuuint64_t strides[2] = {cols * 4, rows * cols * 4};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, dt, 3, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Workspace floats the launch with these arguments needs, or -(CUDA error).
template <typename CT, bool PAGED>
long long batched_ws(const int* n) {
  if (n[N_CD] != cache_code<CT>() || (n[N_NP] != 0) != PAGED)
    return -static_cast<long long>(cudaErrorInvalidValue);
  Plan p;
  const int err = plan_for<CT, PAGED>(n, &p);
  return err ? -static_cast<long long>(err) : p.ws;
}

// Caller guarantees (ops/megakernel_batched.py checks them): as K4's entry,
// with 1 <= B <= 64 rows, a cache of B slots, lengths [B] int32 on the
// device and 0 <= max_length < T, H and I multiples of the stage's chunk
// (128 channels in W4, 256 in W3), every OC a multiple of 16. Paged mode
// (N_NP > 0): a bf16 pool [L, 2, NP, nkv, page, 128] with page a power of
// two, tables int32 [B, MP] of page ids in [0, NP) and T = MP·page. Cache
// dtype code 3 (slot mode only): int8 codes with f32 scales [L, 2, B, nkv,
// T] at P_SCALES, and bf16 k_new/v_new. The cache dtype and the mode must be
// the instance's, and N_GRID on the host plan's (plan_for refuses one that
// does not fit this build).
template <typename CT, bool PAGED>
int batched_launch(const void* const* ptrs, const int* n, float eps, void* ws,
                   void* stream) {
  if (n[N_CD] != cache_code<CT>() || (n[N_NP] != 0) != PAGED)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int err = plan_for<CT, PAGED>(n, &p);
  if (err) return err;
  if (n[N_B] < 1 || n[N_B] > MAXB || n[N_NQ] % n[N_NKV] || n[N_NQ] / n[N_NKV] > MK_MAXG
      || n[N_MAXLEN] < 0 || n[N_MAXLEN] >= n[N_T] || n[N_W3] != UNIT_W3 || n[N_VOCAB] % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // K5: 1..32 window rows at [hist, hist + S) inside the cache, no head, no pages
  if (CHUNK && (n[N_B] > 32 || n[N_HIST] < 0 || n[N_HIST] + n[N_B] > n[N_T] || n[N_VOCAB]
                || n[N_NP] || n[N_CD] == 3))
    return static_cast<int>(cudaErrorInvalidValue);
  BatchArgs a;
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
  a.lengths = static_cast<const int32_t*>(ptrs[P_LEN]);
  a.hd_w = static_cast<const int32_t*>(ptrs[P_HW]);
  a.hd_s = static_cast<const float*>(ptrs[P_HS]); a.hd_z = static_cast<const float*>(ptrs[P_HZ]);
  a.norm_w = ptrs[P_NW]; a.logits = static_cast<float*>(const_cast<void*>(ptrs[P_LOGITS]));
  a.tables = static_cast<const int32_t*>(ptrs[P_TABLES]);
  a.scales = static_cast<float*>(const_cast<void*>(ptrs[P_SCALES]));
  if (n[N_CD] == 3 && !a.scales) return static_cast<int>(cudaErrorInvalidValue);
  a.ws = static_cast<float*>(ws);
  a.B = n[N_B]; a.L = n[N_L]; a.H = n[N_H]; a.I = n[N_I]; a.nq = n[N_NQ]; a.nkv = n[N_NKV];
  a.T = n[N_T]; a.vocab = n[N_VOCAB]; a.md = n[N_MD]; a.has_bias = n[N_BIAS];
  a.np = n[N_NP]; a.page = n[N_PAGE]; a.mp = n[N_MP];
  if (a.np && (a.page < 1 || (a.page & (a.page - 1)) || a.mp < 1 || a.T != a.page * a.mp
               || !a.tables))
    return static_cast<int>(cudaErrorInvalidValue);
  a.page_shift = a.np ? __builtin_ctz(static_cast<unsigned>(a.page)) : 0;
  a.nsplit = p.nsplit; a.split_len = p.split_len; a.eps = eps;
  a.wc = p.wc; a.rh = p.rh; a.bp = p.bp;
  for (int ph = 0; ph < NPH; ++ph) a.pp[ph] = p.pp[ph];
  for (int i = 0; i < NREG; ++i) a.off[i] = p.off[i];
  a.cl = p.cl;
  a.hist = CHUNK ? n[N_HIST] : 0;
  // the TMA maps of each phase's codes, scales and szeros, [planes, rows,
  // OC] (the head: one plane), boxes of a round: pw columns, k chunks
  const int H = a.H, I = a.I, oq = (a.nq + 2 * a.nkv) * MK_HD;
  const void* w[NPH][3] = {{a.qkv_w, a.qkv_s, a.qkv_z}, {a.o_w, a.o_s, a.o_z},
                           {a.gu_w, a.gu_s, a.gu_z}, {a.dn_w, a.dn_s, a.dn_z},
                           {a.hd_w, a.hd_s, a.hd_z}};
  const int ocs[NPH] = {oq, H, 2 * I, H, a.vocab}, ics[NPH] = {H, H, H, I, H};
  for (int ph = 0; ph < NPH; ++ph) {
    if (ph == 4 && !a.vocab) {
      memset(a.maps[ph], 0, sizeof(a.maps[ph]));
      continue;
    }
    const int pw = 16 * p.pp[ph].wave / (ph == 2 ? 2 : 1), k = p.pp[ph].k;
    const uint64_t planes = ph == 4 ? 1 : (uint64_t)a.L;
    err = box_map(&a.maps[ph][0], CU_TENSOR_MAP_DATA_TYPE_INT32, w[ph][0], ocs[ph],
                  (uint64_t)ics[ph] / KC * SROWS, planes, pw, k * SROWS);
    for (int z = 1; z < 3 && !err; ++z)
      err = box_map(&a.maps[ph][z], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w[ph][z], ocs[ph],
                    ics[ph] / MK_G, planes, pw, k * SGROUPS);
    if (err) return err;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p.cl > 1) {
    // K5's clusters: a cooperative launch with a cluster dimension
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[2];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = p.cl; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
    at[1].id = cudaLaunchAttributeCooperative;
    at[1].val.cooperative = 1;
    cfg.gridDim = dim3(p.grid); cfg.blockDim = dim3(K6_THREADS); cfg.dynamicSmemBytes = p.smem;
    cfg.stream = st; cfg.attrs = at; cfg.numAttrs = 2;
    e = cudaLaunchKernelEx(&cfg, batched_kernel<CT, PAGED>, a);
  } else {
    void* kargs[] = {&a};
    e = cudaLaunchCooperativeKernel((const void*)batched_kernel<CT, PAGED>, p.grid, K6_THREADS,
                                    kargs, p.smem, st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#if AWQ_MEGA_CHUNK
#define AWQ_ENTRY(name) awq_mega_chunk##name
#else
#define AWQ_ENTRY(name) awq_mega_batched##name
#endif

// Workspace floats the launch with these arguments needs, or -(CUDA error).
extern "C" long long AWQ_ENTRY(_ws)(const void* const* ptrs, const int* n) {
  (void)ptrs;
  return batched_ws<AWQ_MEGA_CT, AWQ_MEGA_PAGED != 0>(n);
}

extern "C" int AWQ_ENTRY()(const void* const* ptrs, const int* n, float eps, void* ws,
                           void* stream) {
  return batched_launch<AWQ_MEGA_CT, AWQ_MEGA_PAGED != 0>(ptrs, n, eps, ws, stream);
}

// The grid the card runs at once in clusters of `cl` blocks, into *grid
// (the host plan's N_GRID); returns a cudaError_t code.
extern "C" int AWQ_ENTRY(_grid)(int cl, int* grid) {
  return card_grid<AWQ_MEGA_CT, AWQ_MEGA_PAGED != 0>(cl, grid);
}
