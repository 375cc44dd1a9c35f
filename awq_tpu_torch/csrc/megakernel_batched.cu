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
// stay far under the card's ~295 FLOPs per byte. What the design does:
// - K4's launch: a persistent cooperative grid (cudaLaunchCooperativeKernel,
//   grid from the occupancy query taken after the shared-memory attribute
//   is set) with cooperative_groups grid barriers between dependent phases:
//   norm | QKV | attention | combine | o-proj | norm | gate/up | down,
//   eight per layer, and norm | head at the end;
// - the B rows fill the M side of the mma.sync m16n8k16 tile that K4 pads
//   with copies of its one row: the matmul tile is K5's (mega_rows.cuh), 32
//   columns by up to 32 rows over the full IC, so a weight tile is decoded
//   once for all rows; B > 32 takes a second pass over the same tile, which
//   the block just read and finds in L2. Nothing of the TPU kernel's
//   g-major [unit·B + b, 128] rows, its b-major transposes or its B % 8
//   rule is carried over: they served Mosaic's (8, 128) tiles;
// - per-row state: the QKV epilogue ropes row b with cos/sin row b, and
//   writes its k/v into the cache IN PLACE at position lengths[b] of slot b
//   (and into k_new/v_new, which the caller gets back). The attention
//   phase never reads that position from the cache: the current token's
//   k/v come from the f32 workspace, as the JAX kernel keeps them in
//   registers. lengths is read on the device and clamped to [0, T-1], as
//   the JAX append clamps, so no row writes at or past T;
// - attention is K4's, spread over (row, kv head, position slice) items: a
//   block takes the group's q heads of one kv head of one row over a slice,
//   warps stride the positions with an online softmax each, and a combine
//   phase merges warps and slices. The slices are sized from max_length,
//   which the caller knows on the host (the last slice takes whatever lies
//   past it, so a low max_length costs balance, not correctness); a row
//   shorter than a slice's start leaves (-inf, 0, 0) there and the combine
//   gives it weight 0.
// Paged mode (the JAX kernel's `tables`, row 18's paged DMA): the cache is
// a page pool [L, 2, NP, nkv, page, HD] shared by all rows and row b's
// position p lives at page tables[b, p / page], offset p % page. Only the
// two addresses change: the QKV epilogue's write and the attention's reads
// (kv_row). The row length is clamped to [0, MP·page − 1], as row_length
// clamps to T − 1 with T = MP·page; freed slots' table rows are 0, the
// trash page, so their writes land there. The page size is a power of two,
// so the lookup is a shift and a mask, not a division, in the attention
// loop. The paged instance is built for a bf16 pool only (the engine's
// pool dtype).
// int8 slot mode (the JAX kernel's cache_scales): the cache holds int8
// codes and f32 scales [L, 2, B, n_kv, T], one per position and head. The
// attention dequantizes a position as K4 does (codes widened to f32 times
// the scale; the current token stays f32), and k_new/v_new come back bf16
// (JAX's kv_dt). The cache write cannot sit in the QKV epilogue: a block
// there holds columns d and d + 64 of a head, half of the 128 values whose
// absmax quantize_kv needs. So it moves past the grid barrier, into the
// attention phase: the slice-0 item of each (row, kv head) already holds
// the head's current k and v in shared memory, rounds them to bf16 and
// writes 128 codes and one scale each at the row's position
// (quantize_kv_rows). Nothing reads that position from the cache in this
// step. The paged mode stays bf16: the JAX package has no paged int8 pool.
// W3 mode (the JAX kernel's dense3, Pallas row 18, in every instance):
// the linears and the head hold pack_int3 codes, read by the tile of a W3
// unit (mega_rows.cuh).
// A simple first version, like K5: activation rows are read through L2 by
// every tile, there is no TMA and no overlap of a phase's tail with the next
// one's loads.
#include "mega_rows.cuh"

namespace {

struct BatchArgs {
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
  float eps;
};

constexpr int ATT_FLOATS = MK_MAXG * MK_HD + 2 * MK_HD + 2 * MK_WARPS * MK_MAXG
                           + MK_WARPS * MK_MAXG * MK_HD;
constexpr int PB = 4;            // cache positions a warp loads at once
constexpr int MAXB = 64;         // most rows per launch

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

template <typename CT, bool PAGED>
__global__ void __launch_bounds__(MK_THREADS) batched_kernel(BatchArgs a) {
  constexpr bool Q8 = sizeof(CT) == 1;   // int8 codes with f32 scales
  extern __shared__ __align__(16) float sm[];
  cg::grid_group grid = cg::this_grid();
  float* red8 = sm;                         // block_sum scratch
  float* big = sm + MK_WARPS;               // GEMM reduction / attention
  float* red = big;                         // [8][32][32]
  float* tout = big + MK_WARPS * MAXS * TILE;  // [2][32][32]
  uint32_t* stage = reinterpret_cast<uint32_t*>(big + GEMM_FLOATS);  // [8][2][32][72]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, H = a.H, I = a.I, nq = a.nq, nkv = a.nkv, grp = nq / nkv;
  const int oq = (nq + 2 * nkv) * MK_HD;
  const int nrb = (B + MAXS - 1) / MAXS;    // 32-row passes of a matmul tile
  float* hres = a.ws;                       // [B][H]
  float* h1 = hres + (size_t)B * H;         // [B][H]
  float* qkv = h1 + (size_t)B * H;          // [B][oq] (bias added, roped)
  float* pml = qkv + (size_t)B * oq;
  const size_t nrows = (size_t)B * nkv * a.nsplit * grp;   // attention partial rows
  float* pacc = pml + ((nrows * 2 + 3) & ~(size_t)3);      // float4 rows
  // [B][H] and [B][I] bf16 rows in the permuted layout, 16-byte aligned
  const size_t xoff = ((size_t)(pacc - a.ws) + nrows * MK_HD + 3) & ~(size_t)3;
  bf16* xw = reinterpret_cast<bf16*>(a.ws + xoff);
  bf16* hmw = xw + (size_t)B * H;           // [B][I]
  CT* cache = static_cast<CT*>(a.cache);
  const int gsize = gridDim.x * MK_THREADS, gtid = blockIdx.x * MK_THREADS + tid;

  for (int i = gtid; i < B * H; i += gsize) hres[i] = load_act(a.h_in, a.md, i);
  grid.sync();

  for (int l = 0; l < a.L; ++l) {
    // ---- norm1 -> bf16 rows --------------------------------------------------
    norm_rows(xw, H, hres, a.ln1, (size_t)l * H, a.md, B, H, a.eps, red8);
    grid.sync();
    // ---- QKV: a block takes columns d and d + 64 of a head together (two
    // 32-column tiles), so its epilogue rounds to bf16, adds the bias, rounds
    // again, ropes q and k in f32 with the row's cos/sin and appends the
    // row's k/v to the cache at the row's own position ---------------------------
    {
      const int32_t* w = a.qkv_w + (size_t)l * qrows(H, UNIT_W3) * oq;
      const float* s = a.qkv_s + (size_t)l * (H / MK_G) * oq;
      const float* z = a.qkv_z + (size_t)l * (H / MK_G) * oq;
      for (int pt = blockIdx.x; pt < oq / (2 * TILE); pt += gridDim.x) {
        const int head = pt >> 1, c0 = head * MK_HD + (pt & 1) * TILE;
        const bool is_kv = head >= nq, roped = head < nq + nkv;
        const int which = (head - nq) / nkv, kvh = (head - nq) % nkv;   // k or v; kv head
        for (int rb = 0; rb < nrb; ++rb) {
          const int r0 = rb * MAXS, rows = min(MAXS, B - r0);
          const bf16* xr = xw + (size_t)r0 * H;
          mma_tile(xr, H, rows, w, s, z, H, oq, c0, red, tout, stage);
          mma_tile(xr, H, rows, w, s, z, H, oq, c0 + MK_HD / 2, red, tout + MAXS * TILE, stage);
          for (int i = tid; i < rows * TILE; i += MK_THREADS) {
            const int r = r0 + i / TILE, c = c0 + i % TILE, d = c - head * MK_HD;   // d < 64
            float x0 = bf16r(tout[i]), x1 = bf16r(tout[MAXS * TILE + i]);     // d, d + 64
            if (a.has_bias) {
              x0 = bf16r(x0 + load_act(a.qkv_b, a.md, (size_t)l * oq + c));
              x1 = bf16r(x1 + load_act(a.qkv_b, a.md, (size_t)l * oq + c + MK_HD / 2));
            }
            if (roped) {
              const float* cr = a.cosr + r * MK_HD;
              const float* sr = a.sinr + r * MK_HD;
              const float y0 = x0 * cr[d] - x1 * sr[d];
              x1 = x1 * cr[d + 64] + x0 * sr[d + 64];
              x0 = y0;
            }
            qkv[(size_t)r * oq + c] = x0;
            qkv[(size_t)r * oq + c + MK_HD / 2] = x1;
            if (is_kv) {
              const size_t orow = (((size_t)l * B + r) * nkv + kvh) * MK_HD;
              if constexpr (Q8) {      // the codes are written in the attention phase
                bf16* out = static_cast<bf16*>(which ? a.v_new : a.k_new);
                out[orow + d] = __float2bfloat16_rn(x0);
                out[orow + d + 64] = __float2bfloat16_rn(x1);
              } else {
                const int pos = row_length(a.lengths, r, a.T);
                const size_t crow = kv_row<PAGED>(a, l, which, r, kvh, pos) * MK_HD;
                CT* out = static_cast<CT*>(which ? a.v_new : a.k_new);
                cache[crow + d] = out[orow + d] = from_f32<CT>(x0);
                cache[crow + d + 64] = out[orow + d + 64] = from_f32<CT>(x1);
              }
            }
          }
          __syncthreads();
        }
      }
    }
    grid.sync();
    // ---- attention slices: items (row, kv head, position slice) ----------------
    {
      float* sq = big;                              // [MK_MAXG][128] q·scale
      float* kc = sq + MK_MAXG * MK_HD;             // [128] current k (roped)
      float* vc = kc + MK_HD;                       // [128] current v
      float* wm = vc + MK_HD;                       // [8][MK_MAXG]
      float* wl = wm + MK_WARPS * MK_MAXG;          // [8][MK_MAXG]
      float* wacc = wl + MK_WARPS * MK_MAXG;        // [8][MK_MAXG][128]
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
        for (int i = tid; i < grp * MK_HD; i += MK_THREADS)
          sq[i] = qrow[kvh * grp * MK_HD + i] * scale;
        for (int d = tid; d < MK_HD; d += MK_THREADS) {
          kc[d] = qrow[(nq + kvh) * MK_HD + d];
          vc[d] = qrow[(nq + nkv + kvh) * MK_HD + d];
        }
        __syncthreads();
        if constexpr (Q8) {
          if (sp == 0) {               // the row's k/v at its own position
            const size_t kr = kv_row<PAGED>(a, l, 0, b, kvh, len);
            const size_t vr = kv_row<PAGED>(a, l, 1, b, kvh, len);
            quantize_kv_rows(kc, vc, cache + kr * MK_HD, cache + vr * MK_HD, a.scales + kr,
                             a.scales + vr, nullptr, nullptr, red8);
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
            if (p < len && p < p1) {
              load4<CT>(cache + kv_row<PAGED>(a, l, 0, b, kvh, p) * MK_HD + lane * 4, kv4[u]);
              load4<CT>(cache + kv_row<PAGED>(a, l, 1, b, kvh, p) * MK_HD + lane * 4, vv4[u]);
              if constexpr (Q8) {
                const float ks = a.scales[kv_row<PAGED>(a, l, 0, b, kvh, p)];
                const float vs = a.scales[kv_row<PAGED>(a, l, 1, b, kvh, p)];
#pragma unroll
                for (int e = 0; e < 4; ++e) { kv4[u][e] *= ks; vv4[u][e] *= vs; }
              }
            } else {
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
              const float sc = warp_sum(dp);
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
    // ---- combine the slices -> bf16 attention rows: a warp per (row, head)
    for (int it = blockIdx.x + warp * gridDim.x; it < B * nq; it += gridDim.x * MK_WARPS) {
      const int b = it / nq, hq = it % nq;
      const size_t row0 = ((size_t)(b * nkv + hq / grp) * a.nsplit) * grp + hq % grp;
      float ac[4];
      combine_row(pml, pacc, row0, grp, a.nsplit, ac);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xw[(size_t)b * H + perm_pos(hq * MK_HD + lane * 4 + e)] = __float2bfloat16_rn(ac[e]);
    }
    grid.sync();
    // ---- o-proj + residual --------------------------------------------------------
    {
      const int32_t* w = a.o_w + (size_t)l * qrows(H, UNIT_W3) * H;
      const float* s = a.o_s + (size_t)l * (H / MK_G) * H;
      const float* z = a.o_z + (size_t)l * (H / MK_G) * H;
      for (int t = blockIdx.x; t < H / TILE; t += gridDim.x)
        for (int rb = 0; rb < nrb; ++rb) {
          const int r0 = rb * MAXS, rows = min(MAXS, B - r0);
          mma_tile(xw + (size_t)r0 * H, H, rows, w, s, z, H, H, t * TILE, red, tout, stage);
          for (int i = tid; i < rows * TILE; i += MK_THREADS) {
            const size_t o = (size_t)(r0 + i / TILE) * H + t * TILE + i % TILE;
            h1[o] = hres[o] + tout[i];
          }
          __syncthreads();
        }
    }
    grid.sync();
    // ---- norm2 -> bf16 rows ----------------------------------------------------------
    norm_rows(xw, H, h1, a.ln2, (size_t)l * H, a.md, B, H, a.eps, red8);
    grid.sync();
    // ---- gate/up (each rounded to bf16), hm = bf16(silu(gate)·up) ----------------
    {
      const int oc = 2 * I;
      const int32_t* w = a.gu_w + (size_t)l * qrows(H, UNIT_W3) * oc;
      const float* s = a.gu_s + (size_t)l * (H / MK_G) * oc;
      const float* z = a.gu_z + (size_t)l * (H / MK_G) * oc;
      for (int t = blockIdx.x; t < I / TILE; t += gridDim.x)
        for (int rb = 0; rb < nrb; ++rb) {
          const int r0 = rb * MAXS, rows = min(MAXS, B - r0);
          const bf16* xr = xw + (size_t)r0 * H;
          mma_tile(xr, H, rows, w, s, z, H, oc, t * TILE, red, tout, stage);
          mma_tile(xr, H, rows, w, s, z, H, oc, I + t * TILE, red, tout + MAXS * TILE, stage);
          for (int i = tid; i < rows * TILE; i += MK_THREADS) {
            const float gt = bf16r(tout[i]), up = bf16r(tout[MAXS * TILE + i]);
            hmw[(size_t)(r0 + i / TILE) * I + perm_pos(t * TILE + i % TILE)] =
                __float2bfloat16_rn(gt * (1.f / (1.f + expf(-gt))) * up);
          }
          __syncthreads();
        }
    }
    grid.sync();
    // ---- down + residual, rounded to bf16 between layers ----------------------------
    {
      const int32_t* w = a.dn_w + (size_t)l * qrows(I, UNIT_W3) * H;
      const float* s = a.dn_s + (size_t)l * (I / MK_G) * H;
      const float* z = a.dn_z + (size_t)l * (I / MK_G) * H;
      for (int t = blockIdx.x; t < H / TILE; t += gridDim.x)
        for (int rb = 0; rb < nrb; ++rb) {
          const int r0 = rb * MAXS, rows = min(MAXS, B - r0);
          mma_tile(hmw + (size_t)r0 * I, I, rows, w, s, z, I, H, t * TILE, red, tout, stage);
          for (int i = tid; i < rows * TILE; i += MK_THREADS) {
            const size_t o = (size_t)(r0 + i / TILE) * H + t * TILE + i % TILE;
            hres[o] = bf16r(h1[o] + tout[i]);
          }
          __syncthreads();
        }
    }
    grid.sync();
  }
  for (int i = gtid; i < B * H; i += gsize) store_act(a.h_out, a.md, i, hres[i]);
  if (a.vocab) {
    // ---- final rmsnorm + W4 head -> f32 logits ----------------------------------
    norm_rows(xw, H, hres, a.norm_w, 0, a.md, B, H, a.eps, red8);
    grid.sync();
    for (int t = blockIdx.x; t < a.vocab / TILE; t += gridDim.x)
      for (int rb = 0; rb < nrb; ++rb) {
        const int r0 = rb * MAXS, rows = min(MAXS, B - r0);
        mma_tile(xw + (size_t)r0 * H, H, rows, a.hd_w, a.hd_s, a.hd_z, H, a.vocab,
                 t * TILE, red, tout, stage);
        for (int i = tid; i < rows * TILE; i += MK_THREADS)
          a.logits[(size_t)(r0 + i / TILE) * a.vocab + t * TILE + i % TILE] = tout[i];
        __syncthreads();
      }
  }
}

enum { P_H, P_OUT, P_QW, P_QS, P_QZ, P_QB, P_OW, P_OS, P_OZ, P_GW, P_GS, P_GZ,
       P_DW, P_DS, P_DZ, P_LN1, P_LN2, P_COS, P_SIN, P_CACHE, P_KN, P_VN, P_LEN,
       P_HW, P_HS, P_HZ, P_NW, P_LOGITS, P_TABLES, P_SCALES };
// paged mode: N_T is MP·page, N_NP the pool's pages (0: the slot cache)
enum { N_B, N_L, N_H, N_I, N_NQ, N_NKV, N_T, N_MAXLEN, N_VOCAB, N_MD, N_CD, N_BIAS,
       N_NP, N_PAGE, N_MP, N_W3 };

struct Plan { int grid, nsplit, split_len; size_t smem; long long ws; };

template <typename CT, bool PAGED>
int plan_for(const int* n, Plan* p) {
  const int B = n[N_B], H = n[N_H], I = n[N_I], nq = n[N_NQ], nkv = n[N_NKV];
  p->smem = (size_t)(MK_WARPS + (GEMM_FLOATS + STAGE_FLOATS > ATT_FLOATS
                                  ? GEMM_FLOATS + STAGE_FLOATS : ATT_FLOATS)) * sizeof(float);
  const int err = coop_grid(batched_kernel<CT, PAGED>, p->smem, &p->grid);
  if (err) return err;
  // attention items: about one per block, at least 32 positions each
  const int npos = n[N_MAXLEN] + 1;
  int ns = p->grid / (B * nkv);
  ns = ns < 1 ? 1 : ns;
  const int most = (npos + 31) / 32;
  ns = ns > most ? most : ns;
  p->split_len = (npos + ns - 1) / ns;
  p->nsplit = (npos + p->split_len - 1) / p->split_len;
  const long long oq = (long long)(nq + 2 * nkv) * MK_HD;
  const long long nrows = (long long)B * nq * p->nsplit;
  p->ws = 2LL * B * H + B * oq + nrows * (2 + MK_HD) + 8
          + ((long long)B * H + (long long)B * I + 1) / 2;
  return 0;
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
// device and 0 <= max_length < T. Paged mode (N_NP > 0): a bf16 pool
// [L, 2, NP, nkv, page, 128] with page a power of two, tables int32
// [B, MP] of page ids in [0, NP) and T = MP·page. Cache dtype code 3 (slot
// mode only): int8 codes with f32 scales [L, 2, B, nkv, T] at P_SCALES, and
// bf16 k_new/v_new. The cache dtype and the mode must be the instance's.
template <typename CT, bool PAGED>
int batched_launch(const void* const* ptrs, const int* n, float eps, void* ws,
                   void* stream) {
  if (n[N_CD] != cache_code<CT>() || (n[N_NP] != 0) != PAGED)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int err = plan_for<CT, PAGED>(n, &p);
  if (err) return err;
  if (n[N_B] < 1 || n[N_B] > MAXB || n[N_NQ] % n[N_NKV] || n[N_NQ] / n[N_NKV] > MK_MAXG
      || n[N_MAXLEN] < 0 || n[N_MAXLEN] >= n[N_T] || n[N_W3] != UNIT_W3)
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
  void* kargs[] = {&a};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)batched_kernel<CT, PAGED>,
                                                    p.grid, MK_THREADS, kargs, p.smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Workspace floats the launch with these arguments needs, or -(CUDA error).
extern "C" long long awq_mega_batched_ws(const void* const* ptrs, const int* n) {
  (void)ptrs;
  return batched_ws<AWQ_MEGA_CT, AWQ_MEGA_PAGED != 0>(n);
}

extern "C" int awq_mega_batched(const void* const* ptrs, const int* n, float eps, void* ws,
                                void* stream) {
  return batched_launch<AWQ_MEGA_CT, AWQ_MEGA_PAGED != 0>(ptrs, n, eps, ws, stream);
}
