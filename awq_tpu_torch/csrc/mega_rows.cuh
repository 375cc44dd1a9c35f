// The many-row W4/W3 matmul tile shared by the chunk megakernel K5
// (megakernel_chunk.cu) and the batched whole-token megakernel K6
// (megakernel_batched.cu): up to 32 bf16 activation rows, kept in device
// memory in a fragment-permuted layout, against one 32-column tile of a
// pack_int4 or (in a W3 unit, UNIT_W3) pack_int3 weight over the full IC,
// and the row-wise RMSNorm that writes such rows.
#pragma once

#include "mega_common.cuh"

constexpr int TILE = 32;         // columns per matmul tile
constexpr int MAXS = 32;         // most window rows
constexpr int AROW = 72;         // u32 per staged row: one group (64) + 8 pad
constexpr int ABUF = MAXS * AROW;                 // u32 per staged group
constexpr int GEMM_FLOATS = MK_WARPS * MAXS * TILE + 2 * MAXS * TILE;
constexpr int STAGE_FLOATS = MK_WARPS * 2 * ABUF;

// Position of channel k in an activation row in the fragment-permuted
// layout the matmuls read: in each 64-channel chunk, channel 8u + 2tq + h
// (u < 8, tq < 4, h < 2) is the low (u < 4) or high (u >= 4) half of u32
// slot ((u % 4)·4 + tq)·2 + h. Lane (gq, tq) then finds the A fragment
// pair of k16 step t, matching K4's code pairs, in one 8-byte word.
__device__ __forceinline__ int perm_pos(int k) {
  const int j = k & 63, u = j >> 3, tq = (j >> 1) & 3, h = j & 1;
  return (k & ~63) + ((((u & 3) * 4 + tq) * 2 + h) * 2 + (u >> 2));
}

// Copy group g of rows [0, rows) of x (rows past S zero-filled) into this
// warp's staging buffer, asynchronously: one commit group.
__device__ __forceinline__ void stage_group(uint32_t* dst, const bf16* x, int ldx, int S,
                                            int rows, int g) {
  const int lane = threadIdx.x & 31;
  for (int q = lane; q < rows * 16; q += 32) {
    const int r = q >> 4, pc = q & 15;
    const bool ok = r < S;
    cp_async16(dst + r * AROW + pc * 4, x + (size_t)(ok ? r : 0) * ldx + g * MK_G + pc * 8,
               ok ? 16 : 0);
  }
  cp_async_commit();
}

// out[r][c] (r < S, c < 32) = row r of x (bf16 rows in the permuted layout,
// stride ldx) @ W for columns n0..n0+31, over the full IC. Warp w takes
// groups w, w+8, ...; the group's rows are staged in shared memory by
// cp.async one group ahead, and its code words loaded one group ahead, so
// neither the L2 nor the HBM latency is paid once per group. Lane (gq, tq)
// loads columns n0 + 4gq .. 4gq+3 of its group's word rows (load_group, as
// K4): n8 tile j's column gq is column 4gq + j, and its accumulator (row,
// 2tq + e) is column n0 + 8tq + 4e + j.
__device__ void mma_tile(const bf16* __restrict__ x, int ldx, int S,
                         const int32_t* __restrict__ qw, const float* __restrict__ sc,
                         const float* __restrict__ sz, int IC, int OC, int n0,
                         float* red, float* out, uint32_t* stage) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mtn = (S + 15) / 16;
  uint32_t* abuf = stage + warp * 2 * ABUF;
  const int32_t* base = qw + (size_t)(2 * tq) * OC + n0 + 4 * gq;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const int ng = IC / MK_G;
  uint4 wc[4];
  if (warp < ng) {
    stage_group(abuf, x, ldx, S, mtn * 16, warp);
    load_group<UNIT_W3>(wc, base, warp, OC);
  }
  for (int g = warp, it = 0; g < ng; g += MK_WARPS, ++it) {
    const int gn = g + MK_WARPS;
    uint4 wn[4];
    if (gn < ng) {
      stage_group(abuf + ((it + 1) & 1) * ABUF, x, ldx, S, mtn * 16, gn);
      load_group<UNIT_W3>(wn, base, gn, OC);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const uint32_t* ab = abuf + (it & 1) * ABUF;
    float part[2][4][4];
    float xs[2][2];   // this lane's share of the row sums of (gq, gq+8)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      xs[mt][0] = xs[mt][1] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
    }
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      uint32_t p0[4], p1[4], q0[4], q1[4];
      group_words<UNIT_W3>(wc, g, cc, p0, p1, q0, q1);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt >= mtn) break;
          const int o = cc * 32 + (t * 4 + tq) * 2;
          const uint2 v0 = *reinterpret_cast<const uint2*>(ab + (mt * 16 + gq) * AROW + o);
          const uint2 v1 = *reinterpret_cast<const uint2*>(ab + (mt * 16 + gq + 8) * AROW + o);
          a[mt][0] = v0.x; a[mt][1] = v1.x; a[mt][2] = v0.y; a[mt][3] = v1.y;
          const __nv_bfloat162* p0 = reinterpret_cast<const __nv_bfloat162*>(&v0);
          const __nv_bfloat162* p1 = reinterpret_cast<const __nv_bfloat162*>(&v1);
          xs[mt][0] += __low2float(p0[0]) + __high2float(p0[0]) + __low2float(p0[1]) + __high2float(p0[1]);
          xs[mt][1] += __low2float(p1[0]) + __high2float(p1[0]) + __low2float(p1[1]) + __high2float(p1[1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b0 = code_pair<UNIT_W3>(p0[j], q0[j], t);
          const uint32_t b1 = code_pair<UNIT_W3>(p1[j], q1[j], t);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (mt < mtn) mma_bf16_16816(part[mt][j], a[mt], b0, b1);
        }
      }
    }
    __syncwarp();    // every lane has read this buffer before it is refilled
    // full-group row sums: add the four lanes of a quad (tq = 0..3)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = xs[mt][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        xs[mt][h] = v;
      }
    const size_t o = (size_t)g * OC + n0 + 8 * tq;
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(sc + o));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(sc + o + 4));
    const float4 z0 = __ldg(reinterpret_cast<const float4*>(sz + o));
    const float4 z1 = __ldg(reinterpret_cast<const float4*>(sz + o + 4));
    const float ss[2][4] = {{s0.x, s0.y, s0.z, s0.w}, {s1.x, s1.y, s1.z, s1.w}};
    const float zz[2][4] = {{z0.x, z0.y, z0.z, z0.w}, {z1.x, z1.y, z1.z, z1.w}};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][j][e] += part[mt][j][e] * ss[e & 1][j] - xs[mt][e >> 1] * zz[e & 1][j];
#pragma unroll
    for (int r = 0; r < 4; ++r) wc[r] = wn[r];
  }
  // sum the warps' partials in a fixed order
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + gq + (e >> 1) * 8;
        red[(warp * MAXS + r) * TILE + 8 * tq + 4 * (e & 1) + j] = acc[mt][j][e];
      }
  __syncthreads();
  for (int i = threadIdx.x; i < S * TILE; i += MK_THREADS) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < MK_WARPS; ++w) v += red[w * MAXS * TILE + i];
    out[i] = v;
  }
  __syncthreads();
}

// x[i][perm_pos(k)] = bf16(src[i][k] · rsqrt(mean(src[i]²) + eps) · w[k]),
// one block per row; loads are issued SU at a time (the row sits in L2).
constexpr int SU = 8;
__device__ void norm_rows(bf16* x, int ldx, const float* src, const void* w,
                          size_t woff, int md, int S, int H, float eps, float* red) {
  for (int i = blockIdx.x; i < S; i += gridDim.x) {
    const float* row = src + (size_t)i * H;
    float ss = 0.f;
#pragma unroll 4
    for (int k = threadIdx.x * 4; k < H; k += MK_THREADS * 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + k);
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    const float rs = rsqrtf(block_sum(ss, red) / H + eps);
    for (int k0 = threadIdx.x; k0 < H; k0 += SU * MK_THREADS) {
      float v[SU], wv[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int k = k0 + u * MK_THREADS;
        v[u] = k < H ? row[k] : 0.f;
        wv[u] = k < H ? load_act(w, md, woff + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int k = k0 + u * MK_THREADS;
        if (k < H) x[(size_t)i * ldx + perm_pos(k)] = __float2bfloat16_rn(v[u] * rs * wv[u]);
      }
    }
    __syncthreads();
  }
}
