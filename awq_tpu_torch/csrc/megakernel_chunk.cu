// K5: the chunked-prefill megakernel for Hopper (sm_90a). This source is
// built once per cache dtype and weight format (_build.UNITS: the cache
// element type AWQ_MEGA_CT, and AWQ_MEGA_W3), six units that the build
// compiles in parallel.
//
// Replaces the Pallas kernel of awq_tpu/ops/megakernel_chunk.py:
// w4a16_llama_chunk_step (_cchunk_kernel). One launch runs ALL decoder
// layers for a window of S = 1..32 tokens of one sequence at
// [hist, hist + S): window row i attends to the cache [0, hist) and to
// window rows 0..i. The window's k/v are written into the cache in place
// and returned; the caller runs the final norm and head.
//
// What bounds it on the H100: at S <= 32 each matmul is a skinny GEMM
// (2·S·IC·OC FLOPs on IC·OC/2 code bytes, at most 128 FLOPs per byte, under
// the card's ~295), so the weight stream bounds it as it bounds K4; CUDA-
// core FMAs at 32 rows would make it compute-bound instead. Design:
// - the persistent cooperative grid of K4 (one launch, grid-wide barriers
//   between dependent phases: norm | QKV | attention | combine | o-proj |
//   norm | gate/up | down, eight per layer);
// - each matmul tile is 32 columns by all S rows over the full IC: the 8
//   warps take whole quantization groups; per 64-channel chunk a lane loads
//   two pack_int4 words per 8-column slice, whose nibbles ARE the bf16
//   operand of mma.sync m16n8k16 (codes 0..15 are exact in bf16, so a
//   weight tile is decoded once and applied to every row), with f32
//   accumulators per group; the JAX kernel's s·Σ bf16(x)·q − sz·Σ bf16(x)
//   per group is applied at each group's end, the row sums taken from the
//   A fragments themselves;
// - the A operand (bf16 activation rows) is read from the device workspace
//   through L2 by every tile: simple, at the price of L2 traffic that a
//   later, pipelined version should stage in shared memory;
// - attention items are (kv head, 32 query rows, position slice), a warp
//   owning 4 query rows with their online softmax; the window's own k/v
//   stay f32 in shared memory (JAX's in-register causal tail), and a
//   combine phase merges the slices.
// W3 mode (the JAX kernel's dense3, Pallas row 17): the tile of a W3 unit
// reads pack_int3 codes (mega_rows.cuh); everything else is the W4 path.
#include "mega_rows.cuh"

namespace {

struct ChunkArgs {
  const void* h_in; void* h_out;
  const int32_t* qkv_w; const float* qkv_s; const float* qkv_z; const void* qkv_b;
  const int32_t* o_w; const float* o_s; const float* o_z;
  const int32_t* gu_w; const float* gu_s; const float* gu_z;
  const int32_t* dn_w; const float* dn_s; const float* dn_z;
  const void* ln1; const void* ln2; const float* cosr; const float* sinr;
  void* cache; void* k_new; void* v_new;
  float* ws;
  int S, L, H, I, nq, nkv, T, hist, md, has_bias;
  int nrb, nsplit, split_len;
  float eps;
};

constexpr int QROWS = 32;        // query rows per attention item
constexpr int ATT_FLOATS = QROWS * MK_HD + 2 * MAXS * MK_HD;
constexpr int PB = 4;            // cache positions a warp scores at once

template <typename CT>
__global__ void __launch_bounds__(MK_THREADS) chunk_kernel(ChunkArgs a) {
  extern __shared__ __align__(16) float sm[];
  cg::grid_group grid = cg::this_grid();
  float* red8 = sm;                         // block_sum scratch
  float* big = sm + MK_WARPS;               // GEMM reduction / attention
  float* red = big;                         // [8][32][32]
  float* tout = big + MK_WARPS * MAXS * TILE;  // [2][32][32]
  uint32_t* stage = reinterpret_cast<uint32_t*>(big + GEMM_FLOATS);  // [8][2][32][72]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.S, H = a.H, I = a.I, nq = a.nq, nkv = a.nkv, grp = nq / nkv;
  const int oq = (nq + 2 * nkv) * MK_HD;
  const int rq = grp * S;                   // query rows per kv head
  float* hres = a.ws;                       // [S][H]
  float* h1 = hres + (size_t)S * H;         // [S][H]
  float* qkv = h1 + (size_t)S * H;          // [S][oq] (bf16-rounded)
  float* pml = qkv + (size_t)S * oq;
  float* pacc = pml + (((size_t)nkv * a.nsplit * rq * 2 + 3) & ~(size_t)3);  // float4 rows
  // [32][H] and [32][I] bf16 rows in the permuted layout, 16-byte aligned
  const size_t xoff = ((size_t)(pacc - a.ws) + (size_t)nkv * a.nsplit * rq * MK_HD + 3) & ~(size_t)3;
  bf16* xw = reinterpret_cast<bf16*>(a.ws + xoff);
  bf16* hmw = xw + (size_t)MAXS * H;        // [32][I]
  CT* cache = static_cast<CT*>(a.cache);
  const size_t T = a.T;
  const int gsize = gridDim.x * MK_THREADS, gtid = blockIdx.x * MK_THREADS + tid;

  for (int i = gtid; i < S * H; i += gsize) hres[i] = load_act(a.h_in, a.md, i);
  grid.sync();

  for (int l = 0; l < a.L; ++l) {
    // ---- norm1 -> bf16 rows --------------------------------------------------
    norm_rows(xw, H, hres, a.ln1, (size_t)l * H, a.md, S, H, a.eps, red8);
    grid.sync();
    // ---- QKV: a block takes columns d and d + 64 of a head together (two
    // 32-column tiles), so its epilogue rounds to bf16, adds the bias, ropes
    // q and k in f32 and appends the window's k/v to the cache ----------------
    {
      const int32_t* w = a.qkv_w + (size_t)l * qrows(H, UNIT_W3) * oq;
      const float* s = a.qkv_s + (size_t)l * (H / MK_G) * oq;
      const float* z = a.qkv_z + (size_t)l * (H / MK_G) * oq;
      for (int pt = blockIdx.x; pt < oq / (2 * TILE); pt += gridDim.x) {
        const int head = pt >> 1, c0 = head * MK_HD + (pt & 1) * TILE;
        mma_tile(xw, H, S, w, s, z, H, oq, c0, red, tout, stage);
        mma_tile(xw, H, S, w, s, z, H, oq, c0 + MK_HD / 2, red, tout + MAXS * TILE, stage);
        const bool is_kv = head >= nq, roped = head < nq + nkv;
        const int which = (head - nq) / nkv, kvh = (head - nq) % nkv;   // k or v; kv head
        for (int i = tid; i < S * TILE; i += MK_THREADS) {
          const int r = i / TILE, c = c0 + i % TILE, d = c - head * MK_HD;   // d < 64
          float x0 = bf16r(tout[i]), x1 = bf16r(tout[MAXS * TILE + i]);     // d, d + 64
          if (a.has_bias) {
            x0 += load_act(a.qkv_b, a.md, (size_t)l * oq + c);
            x1 += load_act(a.qkv_b, a.md, (size_t)l * oq + c + MK_HD / 2);
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
            const size_t crow = ((((size_t)l * 2 + which) * nkv + kvh) * T + a.hist + r) * MK_HD;
            const size_t orow = (((size_t)l * nkv + kvh) * S + r) * MK_HD;
            CT* out = static_cast<CT*>(which ? a.v_new : a.k_new);
            cache[crow + d] = out[orow + d] = from_f32<CT>(x0);
            cache[crow + d + 64] = out[orow + d + 64] = from_f32<CT>(x1);
          }
        }
        __syncthreads();
      }
    }
    grid.sync();
    // ---- attention slices ------------------------------------------------------
    {
      float* sq = big;                         // [32][128] q rows · scale
      float* kw = sq + QROWS * MK_HD;          // [S][128] window k (roped, f32)
      float* vw = kw + MAXS * MK_HD;           // [S][128] window v
      const float scale = 1.f / sqrtf((float)MK_HD);
      const int items = nkv * a.nrb * a.nsplit;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int kvh = it / (a.nrb * a.nsplit);
        const int rb = (it / a.nsplit) % a.nrb, sp = it % a.nsplit;
        // this kv head's window k/v and 32 query rows (g-major: row g·S + r)
#pragma unroll 4
        for (int i = tid * 4; i < S * MK_HD; i += MK_THREADS * 4) {
          const size_t o = (size_t)(i / MK_HD) * oq + i % MK_HD;
          *reinterpret_cast<float4*>(kw + i) =
              *reinterpret_cast<const float4*>(qkv + o + (nq + kvh) * MK_HD);
          *reinterpret_cast<float4*>(vw + i) =
              *reinterpret_cast<const float4*>(qkv + o + (nq + nkv + kvh) * MK_HD);
        }
#pragma unroll 4
        for (int i = tid * 4; i < QROWS * MK_HD; i += MK_THREADS * 4) {
          const int qr = rb * QROWS + i / MK_HD;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (qr < rq)
            v = *reinterpret_cast<const float4*>(
                qkv + (size_t)(qr % S) * oq + (kvh * grp + qr / S) * MK_HD + i % MK_HD);
          *reinterpret_cast<float4*>(sq + i) =
              make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
        }
        __syncthreads();
        const size_t krow = (((size_t)l * 2 + 0) * nkv + kvh) * T;
        const size_t vrow = (((size_t)l * 2 + 1) * nkv + kvh) * T;
        const int p0 = sp * a.split_len;
        const int p1 = min(p0 + a.split_len, a.hist + S);
        // warp w owns query rows 4w .. 4w+3 of the item; lane l channels 4l..
        float m[4], ls[4], acc[4][4], q[4][4];
        int wrow[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m[j] = -INFINITY; ls[j] = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[j][e] = 0.f;
            q[j][e] = sq[(warp * 4 + j) * MK_HD + lane * 4 + e];
          }
          const int qr = rb * QROWS + warp * 4 + j;
          wrow[j] = qr < rq ? qr % S : -1;     // window row, -1 if none
        }
        // PB positions at a time: their k/v loads, then their 4·PB scores
        // (independent warp sums), then one online-softmax update per row
        for (int pb = p0; pb < p1; pb += PB) {
          float k4[PB][4], v4[PB][4], sc[PB][4];
#pragma unroll
          for (int u = 0; u < PB; ++u) {
            const int p = pb + u;
            if (p < a.hist && p < p1) {
              load4<CT>(cache + (krow + p) * MK_HD + lane * 4, k4[u]);
              load4<CT>(cache + (vrow + p) * MK_HD + lane * 4, v4[u]);
            } else {
              const int wp = min(max(p - a.hist, 0), S - 1);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                k4[u][e] = kw[wp * MK_HD + lane * 4 + e];
                v4[u][e] = vw[wp * MK_HD + lane * 4 + e];
              }
            }
          }
#pragma unroll
          for (int u = 0; u < PB; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float dp = 0.f;
#pragma unroll
              for (int e = 0; e < 4; ++e) dp = fmaf(q[j][e], k4[u][e], dp);
              sc[u][j] = warp_sum(dp);
            }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float mx = m[j];
#pragma unroll
            for (int u = 0; u < PB; ++u) {
              const int p = pb + u;
              const bool seen = p < p1 && wrow[j] >= 0 && p - a.hist <= wrow[j];
              sc[u][j] = seen ? sc[u][j] : -INFINITY;
              mx = fmaxf(mx, sc[u][j]);
            }
            if (mx == -INFINITY) continue;       // nothing seen by this row yet
            const float alpha = expf(m[j] - mx);
            ls[j] *= alpha;
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] *= alpha;
#pragma unroll
            for (int u = 0; u < PB; ++u) {
              const float pr = expf(sc[u][j] - mx);
              ls[j] += pr;
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(pr, v4[u][e], acc[j][e]);
            }
            m[j] = mx;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (wrow[j] < 0) continue;
          const int qr = rb * QROWS + warp * 4 + j;
          const size_t row = ((size_t)kvh * a.nsplit + sp) * rq + qr;
          if (lane == 0) { pml[row * 2] = m[j]; pml[row * 2 + 1] = ls[j]; }
          *reinterpret_cast<float4*>(pacc + row * MK_HD + lane * 4) =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        }
        __syncthreads();
      }
    }
    grid.sync();
    // ---- combine the slices -> bf16 attention rows: a warp per (head, row)
    for (int it = blockIdx.x + warp * gridDim.x; it < nq * S; it += gridDim.x * MK_WARPS) {
      const int hq = it / S, r = it % S;
      const size_t row0 = (size_t)(hq / grp) * a.nsplit * rq + (hq % grp) * S + r;
      float ac[4];
      combine_row(pml, pacc, row0, rq, a.nsplit, ac);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xw[(size_t)r * H + perm_pos(hq * MK_HD + lane * 4 + e)] = __float2bfloat16_rn(ac[e]);
    }
    grid.sync();
    // ---- o-proj + residual --------------------------------------------------------
    {
      const int32_t* w = a.o_w + (size_t)l * qrows(H, UNIT_W3) * H;
      const float* s = a.o_s + (size_t)l * (H / MK_G) * H;
      const float* z = a.o_z + (size_t)l * (H / MK_G) * H;
      for (int t = blockIdx.x; t < H / TILE; t += gridDim.x) {
        mma_tile(xw, H, S, w, s, z, H, H, t * TILE, red, tout, stage);
        for (int i = tid; i < S * TILE; i += MK_THREADS) {
          const size_t o = (size_t)(i / TILE) * H + t * TILE + i % TILE;
          h1[o] = hres[o] + tout[i];
        }
        __syncthreads();
      }
    }
    grid.sync();
    // ---- norm2 -> bf16 rows ----------------------------------------------------------
    norm_rows(xw, H, h1, a.ln2, (size_t)l * H, a.md, S, H, a.eps, red8);
    grid.sync();
    // ---- gate/up (each rounded to bf16), hm = bf16(silu(gate)·up) ----------------
    {
      const int oc = 2 * I;
      const int32_t* w = a.gu_w + (size_t)l * qrows(H, UNIT_W3) * oc;
      const float* s = a.gu_s + (size_t)l * (H / MK_G) * oc;
      const float* z = a.gu_z + (size_t)l * (H / MK_G) * oc;
      for (int t = blockIdx.x; t < I / TILE; t += gridDim.x) {
        mma_tile(xw, H, S, w, s, z, H, oc, t * TILE, red, tout, stage);
        mma_tile(xw, H, S, w, s, z, H, oc, I + t * TILE, red, tout + MAXS * TILE, stage);
        for (int i = tid; i < S * TILE; i += MK_THREADS) {
          const float gt = bf16r(tout[i]), up = bf16r(tout[MAXS * TILE + i]);
          hmw[(size_t)(i / TILE) * I + perm_pos(t * TILE + i % TILE)] =
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
      for (int t = blockIdx.x; t < H / TILE; t += gridDim.x) {
        mma_tile(hmw, I, S, w, s, z, I, H, t * TILE, red, tout, stage);
        for (int i = tid; i < S * TILE; i += MK_THREADS) {
          const size_t o = (size_t)(i / TILE) * H + t * TILE + i % TILE;
          hres[o] = bf16r(h1[o] + tout[i]);
        }
        __syncthreads();
      }
    }
    grid.sync();
  }
  for (int i = gtid; i < S * H; i += gsize) store_act(a.h_out, a.md, i, hres[i]);
}

enum { P_H, P_OUT, P_QW, P_QS, P_QZ, P_QB, P_OW, P_OS, P_OZ, P_GW, P_GS, P_GZ,
       P_DW, P_DS, P_DZ, P_LN1, P_LN2, P_COS, P_SIN, P_CACHE, P_KN, P_VN };
enum { N_S, N_L, N_H, N_I, N_NQ, N_NKV, N_T, N_HIST, N_MD, N_CD, N_BIAS, N_W3 };

struct Plan { int grid, nrb, nsplit, split_len; size_t smem; long long ws; };

template <typename CT>
int plan_for(const int* n, Plan* p) {
  const int S = n[N_S], H = n[N_H], I = n[N_I], nq = n[N_NQ], nkv = n[N_NKV];
  p->smem = (size_t)(MK_WARPS + (GEMM_FLOATS + STAGE_FLOATS > ATT_FLOATS
                                  ? GEMM_FLOATS + STAGE_FLOATS : ATT_FLOATS)) * sizeof(float);
  const int err = coop_grid(chunk_kernel<CT>, p->smem, &p->grid);
  if (err) return err;
  const int rq = nq / nkv * S;
  p->nrb = (rq + QROWS - 1) / QROWS;
  const int npos = n[N_HIST] + S;
  int ns = p->grid / (nkv * p->nrb);
  ns = ns < 1 ? 1 : ns;
  const int most = (npos + 31) / 32;
  ns = ns > most ? most : ns;
  p->split_len = (npos + ns - 1) / ns;
  p->nsplit = (npos + p->split_len - 1) / p->split_len;
  const int oq = (nq + 2 * nkv) * MK_HD;
  p->ws = 2LL * S * H + (long long)S * oq + (long long)nkv * p->nsplit * rq * (2 + MK_HD)
          + 8 + ((long long)MAXS * H + (long long)MAXS * I + 1) / 2;
  return 0;
}

// Workspace floats the launch with these arguments needs, or -(CUDA error).
template <typename CT>
long long chunk_ws(const int* n) {
  if (n[N_CD] != cache_code<CT>()) return -static_cast<long long>(cudaErrorInvalidValue);
  Plan p;
  const int err = plan_for<CT>(n, &p);
  return err ? -static_cast<long long>(err) : p.ws;
}

// Caller guarantees (ops/megakernel_chunk.py checks them): as K4's entry,
// with 1 <= S <= 32 window rows and hist + S <= T, and the instance's
// cache dtype.
template <typename CT>
int chunk_launch(const void* const* ptrs, const int* n, float eps, void* ws, void* stream) {
  if (n[N_CD] != cache_code<CT>()) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int err = plan_for<CT>(n, &p);
  if (err) return err;
  if (n[N_S] < 1 || n[N_S] > MAXS || n[N_NQ] % n[N_NKV] || n[N_W3] != UNIT_W3)
    return static_cast<int>(cudaErrorInvalidValue);
  ChunkArgs a;
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
  a.ws = static_cast<float*>(ws);
  a.S = n[N_S]; a.L = n[N_L]; a.H = n[N_H]; a.I = n[N_I]; a.nq = n[N_NQ]; a.nkv = n[N_NKV];
  a.T = n[N_T]; a.hist = n[N_HIST]; a.md = n[N_MD]; a.has_bias = n[N_BIAS];
  a.nrb = p.nrb; a.nsplit = p.nsplit; a.split_len = p.split_len; a.eps = eps;
  void* kargs[] = {&a};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)chunk_kernel<CT>, p.grid,
                                                    MK_THREADS, kargs, p.smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Workspace floats the launch with these arguments needs, or -(CUDA error).
extern "C" long long awq_mega_chunk_ws(const void* const* ptrs, const int* n) {
  (void)ptrs;
  return chunk_ws<AWQ_MEGA_CT>(n);
}

extern "C" int awq_mega_chunk(const void* const* ptrs, const int* n, float eps, void* ws,
                              void* stream) {
  return chunk_launch<AWQ_MEGA_CT>(ptrs, n, eps, ws, stream);
}
