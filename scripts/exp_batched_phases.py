#!/usr/bin/env python3
"""Where a step of K6 (``csrc/megakernel_batched.cu``) spends its time: a
copy of the source with ``%globaltimer`` stamps at every phase boundary of
every block (thread 0), built into ``build/exp_batched_phases/`` (not part
of the port) and run through ``w4a16_llama_token_step_batched`` at
Llama-3-8B width (32 layers and a W4 head, random weights from a seed) at
the smoke's ragged lengths: row i at 700 + (97 i mod 600), row 1 empty.

    python3 scripts/exp_batched_phases.py [--rows 8,32] [--reps 5] [--unit bf16] [--w3]
        [--other OTHER/megakernel_batched.cu] [--variants base,nomma,nocopy,compute,hint]
        [--check | --smoke]

Stamps go before and after every grid barrier of the kernel, before and
after every call that stages a matmul phase's rows (``stage_rows(`` in the
phase function, by its ``ph``), and one at the kernel's end. Each block adds the time since its previous stamp to the
segment the stamp closes, over the whole step; a segment is named after the
last ``// ---- name`` comment before it: ``work`` ends at a barrier,
``barrier`` is the wait in it (for the slowest block), ``stage`` is a
staging of rows, ``pre`` the time before a staging. The script prints,
per segment, the median over the grid's blocks of its time in a layer
(the step's total over the layers; the head's segments once) in
microseconds, and the step's time without stamps (``chip_smoke.Timer``),
with the card's name and power limit. ``--other`` does the same for
another tree's source (e.g. the parent's, ``git archive HEAD~
awq_tpu_torch/csrc | tar -x -C build/parent``), built with that tree's
headers, and times both unstamped builds in turns. ``--variants`` adds
stamped what-if builds of the checkout (``variant``; ``a+b`` applies both).

``--check`` builds the variants without stamps and holds each (and the
checkout's build) to the plain version row by row and layer by layer, two
calls each (``check_rows``), with what the checking variants record:
``xcheck`` (each group's sum of x as the mma sees it, an all-ones A,
against the staged sum), ``xbias``/``xacc``/``xmax`` (after ``biased``:
each group's value and each warp's partial sums from codes biased by 128
against exact codes, on the same staged rows) and ``xrs`` (each block's
staged sums and norm factors, which must agree across blocks).
``--smoke`` does the same inside chip_smoke.py's phase 2 megakernel cases,
on the smoke's own data, with the bf16 slot and paged units replaced by the
first variant.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NSTAMP = 96
STAMP_DEF = r"""
__device__ unsigned long long mk_acc[1024][%d];
__device__ unsigned long long mk_prev[1024];
__device__ __forceinline__ unsigned long long mk_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define MK_T(k) if (threadIdx.x == 0) { const unsigned long long t_ = mk_now(); \
  mk_acc[blockIdx.x][k] += t_ - mk_prev[blockIdx.x]; mk_prev[blockIdx.x] = t_; }
""" % NSTAMP
# the matmul phases of a body whose phase function stages rows (its `ph`)
STAGED = ("qkv", "o-proj", "gate/up", "down", "head")
STAMP_GET = r"""
extern "C" int awq_mk_acc(void* host) {
  return (int)cudaMemcpyFromSymbol(host, mk_acc, sizeof(mk_acc));
}
extern "C" int awq_mk_zero(const void* host) {
  return (int)cudaMemcpyToSymbol(mk_acc, host, sizeof(mk_acc));
}
"""
KERNEL = "batched_kernel("
GRID = "cg::grid_group grid = cg::this_grid();"


def variant(src: str, name: str) -> str:
    """A variant of the source for a what-if clock (results are wrong):
    ``base`` as it is; ``nomma`` with the consumers' products left out (each
    stage still waited for and freed: the weight stream alone); ``nocopy``
    with the producer's copies left out (each stage still announced: the
    consumers alone); ``compute`` with neither copies nor ring waits (the
    consumers' products alone); ``hint`` with the ring's waits suspended by
    ``hop::mbar_wait``'s time hint."""
    if "+" in name:
        for part in name.split("+"):
            src = variant(src, part)
        return src

    def sub(old, new):
        assert old in src, (name, old)
        return src.replace(old, new)

    if name == "nomma":
        src = sub("      stage_mma<NT>(s,\n", "      if (0) stage_mma<NT>(s,\n")
    elif name == "nocopy":
        src = sub("if ((threadIdx.x & 31) == 0) hop::mbar_expect_tx(&s.full[slot], p.tx);",
                  "if ((threadIdx.x & 31) == 0) hop::mbar_arrive(&s.full[slot]);")
        src = sub("    if (p.loads)\n", "    if (false)\n")
    elif name == "compute":       # no ring waits and no copies: the consumers' work alone
        src = sub("    ring_wait(&s.full[slot], (idx / SLOTS) & 1);\n", "")
        src = sub("    if (p.idx >= SLOTS) ring_wait(&s.empty[slot], ((p.idx / SLOTS) - 1) & 1);\n", "")
        src = sub("if ((threadIdx.x & 31) == 0) hop::mbar_expect_tx(&s.full[slot], p.tx);", "")
        src = sub("    if (p.loads)\n", "    if (false)\n")
    elif name == "runoff":        # the fixed regions carved from the plan's offsets instead
        for o, n in (("  s.full = reinterpret_cast<uint64_t*>(base + OFF_BARS);",
                      "  s.full = reinterpret_cast<uint64_t*>(base + a.off[O_BARS]);"),
                     ("  s.red = reinterpret_cast<float*>(base + OFF_RED);",
                      "  s.red = reinterpret_cast<float*>(base + a.off[O_RED]);"),
                     ("  s.rs = reinterpret_cast<float*>(base + OFF_RS);",
                      "  s.rs = reinterpret_cast<float*>(base + a.off[O_RS]);"),
                     ("  s.att = s.red;", "  s.att = reinterpret_cast<float*>(base + a.off[O_ATT]);")):
            src = sub(o, n)
    elif name == "hint":
        src = sub("ring_wait(&", "hop::mbar_wait(&")
    elif name == "biased":        # every unit's codes biased by 128 (JAX's identity), as
                                  # K6's W4 took them before its codes were centred
        src = sub("  const __nv_bfloat162 c = __float2bfloat162_rn(128.f + CENTER);",
                  "  const __nv_bfloat162 c = __float2bfloat162_rn(0.f);")
        src = sub("const float zc0 = fmaf(-static_cast<float>(CENTER), sc.x, sz.x);",
                  "const float zc0 = fmaf(128.f, sc.x, sz.x);")
        src = sub("const float zc1 = fmaf(-static_cast<float>(CENTER), sc.y, sz.y);",
                  "const float zc1 = fmaf(128.f, sc.y, sz.y);")
    elif name == "xcheck":        # results right; records group sums that disagree
        src = sub("// ---- the matmul phases' schedule", XCHECK_DEF + "\n// ---- the matmul phases' schedule")
        src = sub("    const int c0 = win_lo(d, win), wc = win_lo(d, win + 1) - c0;\n",
                  "    const int c0 = win_lo(d, win), wc = win_lo(d, win + 1) - c0;\n"
                  "    if (tid == 0) xc_ctx[blockIdx.x] = (l << 16) | (ph << 8) | win;\n")
        src = sub("    for (int qq = 0; qq < 2; ++qq) {\n      const int q = 2 * gi + qq;\n",
                  "    float dx[NT][4];\n    for (int nb = 0; nb < NT; ++nb) for (int e = 0; e < 4; ++e) "
                  "dx[nb][e] = 0.f;\n    const uint32_t ONE[4] = {0x3F803F80u, 0x3F803F80u, "
                  "0x3F803F80u, 0x3F803F80u};\n"
                  "    for (int qq = 0; qq < 2; ++qq) {\n      const int q = 2 * gi + qq;\n")
        src = sub("          mma_bf16_16816(d[j % CH][nb], a, b.x, b.y);\n",
                  "          mma_bf16_16816(d[j % CH][nb], a, b.x, b.y);\n"
                  "          mma_bf16_16816(dx[nb], ONE, b.x, b.y);\n")
        src = sub("        const float xs = s.xsum[(rb + 8 * nb + 2 * tq + e) * s.ng + g];\n",
                  "        const float xs = s.xsum[(rb + 8 * nb + 2 * tq + e) * s.ng + g];\n"
                  "        xc_test(s, rb + 8 * nb + 2 * tq + e, g, cl, gi, xs, dx[nb][e]);\n")
        src += XCHECK_GET
    elif name == "xbias":         # after biased: each group also with exact codes
        src = sub("// ---- the matmul phases' schedule", XBIAS_DEF + "\n// ---- the matmul phases' schedule")
        src = sub("    const int c0 = win_lo(d, win), wc = win_lo(d, win + 1) - c0;\n",
                  "    const int c0 = win_lo(d, win), wc = win_lo(d, win + 1) - c0;\n"
                  "    if (tid == 0) xb_ctx[blockIdx.x] = (l << 16) | (ph << 8) | win;\n")
        src = sub("    for (int qq = 0; qq < 2; ++qq) {\n      const int q = 2 * gi + qq;\n",
                  "    float d2[NT][4];\n    for (int nb = 0; nb < NT; ++nb) for (int e = 0; e < 4; ++e) "
                  "d2[nb][e] = 0.f;\n"
                  "    for (int qq = 0; qq < 2; ++qq) {\n      const int q = 2 * gi + qq;\n")
        src = sub("          mma_bf16_16816(d[j % CH][nb], a, b.x, b.y);\n",
                  "          mma_bf16_16816(d[j % CH][nb], a, b.x, b.y);\n"
                  "          { uint32_t ae[4]; for (int i = 0; i < 4; ++i) { __nv_bfloat162 t = "
                  "__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a[i]), "
                  "__float2bfloat162_rn(128.f)); ae[i] = *reinterpret_cast<uint32_t*>(&t); }\n"
                  "            mma_bf16_16816(d2[nb], ae, b.x, b.y); }\n")
        src = sub("        acc[nb][e] += d0 * sc.x - xs * zc0;\n",
                  "        xb_test(s, rb + 8 * nb + 2 * tq + e, g, xs, d0 * sc.x - xs * zc0, "
                  "d2[nb][e] * sc.x - xs * sz.x);\n"
                  "        xb_test(s, rb + 8 * nb + 2 * tq + e, g, xs, d1 * sc.y - xs * zc1, "
                  "d2[nb][2 + e] * sc.y - xs * sz.y);\n"
                  "        acc[nb][e] += d0 * sc.x - xs * zc0;\n")
        src += XBIAS_GET
    elif name == "xacc":          # after biased: a warp's partial sums, biased - exact
        src = variant(src, "xbias")
        src = sub("// ---- the matmul phases' schedule", XACC_DEF + "\n// ---- the matmul phases' schedule")
        src = sub("        xb_test(s, rb + 8 * nb + 2 * tq + e, g, xs, d0 * sc.x - xs * zc0, "
                  "d2[nb][e] * sc.x - xs * sz.x);\n",
                  "        xa_acc[blockIdx.x][threadIdx.x][nb * 4 + e] += (d0 * sc.x - xs * zc0) - "
                  "(d2[nb][e] * sc.x - xs * sz.x);\n")
        src = sub("        xb_test(s, rb + 8 * nb + 2 * tq + e, g, xs, d1 * sc.y - xs * zc1, "
                  "d2[nb][2 + e] * sc.y - xs * sz.y);\n",
                  "        xa_acc[blockIdx.x][threadIdx.x][nb * 4 + 2 + e] += (d1 * sc.y - xs * zc1) - "
                  "(d2[nb][2 + e] * sc.y - xs * sz.y);\n")
        src = sub("      const int nr = (wc + K - 1) / K;\n",
                  "      for (int z = 0; z < 16; ++z) xa_acc[blockIdx.x][threadIdx.x][z] = 0.f;\n"
                  "      const int nr = (wc + K - 1) / K;\n")
        src = sub("      seq += nr;\n",
                  "      seq += nr;\n"
                  "      if (busy) xa_record(warp, rb, acc);\n")
    elif name == "xrs":           # results right; each block's staged sums and norm factors
        src = sub("// ---- the matmul phases' schedule", XRS_DEF + "\n// ---- the matmul phases' schedule")
        src = sub("               nbulk);\n    hop::bar_sync(CB, 32 * K6_WARPS);\n",
                  "               nbulk);\n    hop::bar_sync(CB, 32 * K6_WARPS);\n"
                  "    xr_dump(s, l, ph, win, B, wc, fold);\n")
        src += XRS_GET
    elif name == "xmax":          # after biased: largest |biased - exact| and |x| per (layer, phase, row)
        src = variant(src, "xacc")
        src = sub("// ---- the matmul phases' schedule", XMAX_DEF + "\n// ---- the matmul phases' schedule")
        src = sub("      if (busy) xa_record(warp, rb, acc);\n",
                  "      if (busy) xm_record(rb, l, ph);\n")
        src = sub("               nbulk);\n    hop::bar_sync(CB, 32 * K6_WARPS);\n",
                  "               nbulk);\n    hop::bar_sync(CB, 32 * K6_WARPS);\n"
                  "    xm_rows(s, l, ph, B, wc);\n")
        src += XMAX_GET
    else:
        assert name == "base", name
    return src


# xmax: per (layer, phase, row) the largest |biased - exact| of any warp's
# partial sum (xacc's) and the largest |x| the phase staged
XMAX_DEF = r"""
__device__ unsigned int xm_diff[33][5][64];
__device__ unsigned int xm_x[33][5][64];
__device__ __noinline__ void xm_record(int rb, int l, int ph) {
  const int lane = threadIdx.x & 31, L = ph == 4 ? 32 : l;
  for (int z = 0; z < 16; ++z) {
    const int r = rb + 8 * (z / 4) + 2 * (lane & 3) + (z & 1);
    if (r < 64) atomicMax(&xm_diff[L][ph][r], __float_as_uint(fabsf(xa_acc[blockIdx.x][threadIdx.x][z])));
  }
}
__device__ void xm_rows(const Smem& s, int l, int ph, int B, int wc) {
  const int L = ph == 4 ? 32 : l, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < B; r += K6_WARPS) {
    float mx = 0.f;
    for (int w = lane; w < wc * KC / 2; w += 32) {
      const uint32_t u = s.rows[(size_t)r * s.xp + w];
      mx = fmaxf(mx, fmaxf(fabsf(__uint_as_float(u << 16)), fabsf(__uint_as_float(u & 0xffff0000u))));
    }
    mx = warp_max(mx);
    if (lane == 0) atomicMax(&xm_x[L][ph][r], __float_as_uint(mx));
  }
}
"""
XMAX_GET = r"""
extern "C" int awq_xm_get(void* diff, void* x) {
  cudaMemcpyFromSymbol(diff, xm_diff, sizeof(xm_diff));
  return (int)cudaMemcpyFromSymbol(x, xm_x, sizeof(xm_x));
}
extern "C" int awq_xm_zero() {
  static unsigned z[33 * 5 * 64];
  cudaMemcpyToSymbol(xm_diff, z, sizeof(z));
  return (int)cudaMemcpyToSymbol(xm_x, z, sizeof(z));
}
"""


# xrs: every block stages the same rows in a phase, so each row's staged
# group sums (added over the window) and its norm factor must be equal bit
# for bit across the blocks; dumped per (layer, phase, window, block, row)
XRS_DEF = r"""
__device__ float xr_sum[33][5][8][132][64];
__device__ float xr_rs[33][5][132][64];
__device__ void xr_dump(const Smem& s, int l, int ph, int win, int B, int wc, bool fold) {
  const int r = threadIdx.x;
  if (r >= B || blockIdx.x >= 132 || win >= 8) return;
  const int L = ph == 4 ? 32 : l;
  float v = 0.f;
  for (int g = 0; g < wc * KC / MK_G; ++g) v += s.xsum[r * s.ng + g];
  xr_sum[L][ph][win][blockIdx.x][r] = v;
  if (win == 0) xr_rs[L][ph][blockIdx.x][r] = fold ? s.rs[r] : 0.f;
}
"""
XRS_GET = r"""
extern "C" int awq_xr_get(void* sums, void* rs) {
  cudaMemcpyFromSymbol(sums, xr_sum, sizeof(xr_sum));
  return (int)cudaMemcpyFromSymbol(rs, xr_rs, sizeof(xr_rs));
}
"""


# xacc: each busy warp's partial sums of a wave, biased codes minus exact
# codes (both on the tensor cores, summed over the warp's chunks); a
# difference over 0.05 records (layer/phase/window, block, warp, row, the
# difference, the partial sum)
XACC_DEF = r"""
__device__ float xa_acc[1024][288][16];
__device__ __noinline__ void xa_record(int warp, int rb, const float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31;
  for (int z = 0; z < 16; ++z) {
    const float v = xa_acc[blockIdx.x][threadIdx.x][z];
    if (fabsf(v) <= 0.05f) continue;
    const unsigned k = atomicAdd(&xb_n, 1u);
    if (k < 512) {
      float* o = xb_rec[k];
      o[0] = (float)xb_ctx[blockIdx.x]; o[1] = blockIdx.x; o[2] = warp; o[3] = 1;
      o[4] = z; o[5] = rb + 8 * (z / 4) + 2 * (lane & 3) + (z & 1); o[6] = 0.f;
      o[7] = acc[z / 4][z % 4]; o[8] = acc[z / 4][z % 4] - v; o[9] = 0.f;
    }
  }
}
"""


# xbias: a group's value s·Σx·q − sz·Σx from the biased codes (128·Σx taken
# off) against the same from exact codes, both on the tensor cores; a
# difference over 1e-2 records (layer/phase/window, block, row, group, the
# staged sum, both values, the largest |x| of the group and its Σ|x|)
XBIAS_DEF = r"""
__device__ unsigned int xb_n;
__device__ float xb_rec[512][10];
__device__ int xb_ctx[1024];
__device__ void xb_test(const Smem& s, int r, int g, float xs, float vb, float ve) {
  if (fabsf(vb - ve) <= 1e-2f) return;
  float mx = 0.f, sa = 0.f;
  for (int w = 0; w < 64; ++w) {
    const uint32_t u = s.rows[(size_t)r * s.xp + g * 64 + w];
    const float lo = __uint_as_float(u << 16), hi = __uint_as_float(u & 0xffff0000u);
    mx = fmaxf(mx, fmaxf(fabsf(lo), fabsf(hi))); sa += fabsf(lo) + fabsf(hi);
  }
  const unsigned k = atomicAdd(&xb_n, 1u);
  if (k < 512) {
    float* o = xb_rec[k];
    o[0] = (float)xb_ctx[blockIdx.x]; o[1] = blockIdx.x; o[2] = threadIdx.x >> 5; o[3] = 0;
    o[4] = g; o[5] = r; o[6] = xs; o[7] = vb; o[8] = ve; o[9] = mx; (void)sa;
  }
}
"""
XBIAS_GET = r"""
extern "C" int awq_xb_get(void* n, void* rec) {
  cudaMemcpyFromSymbol(n, xb_n, sizeof(unsigned));
  return (int)cudaMemcpyFromSymbol(rec, xb_rec, sizeof(xb_rec));
}
extern "C" int awq_xb_zero() {
  const unsigned z = 0;
  return (int)cudaMemcpyToSymbol(xb_n, &z, sizeof(unsigned));
}
"""


# xcheck: each group's sum of the rows as the mma sees them (an all-ones A)
# against the staged group sum; a disagreement records (layer/phase/window,
# block, warp, chunk, group, row, staged sum, mma sum, the sum read back from
# shared memory then, and the sum of |x|)
XCHECK_DEF = r"""
__device__ unsigned int xc_n;
__device__ float xc_rec[512][10];
__device__ int xc_ctx[1024];
__device__ void xc_test(const Smem& s, int r, int g, int cl, int gi, float xs, float m) {
  if (fabsf(m - xs) <= 2e-3f + 1e-4f * fabsf(xs)) return;
  float dsum = 0.f, dabs = 0.f;
  for (int w = 0; w < 64; ++w) {
    const uint32_t u = s.rows[(size_t)r * s.xp + g * 64 + w];
    const float lo = __uint_as_float(u << 16), hi = __uint_as_float(u & 0xffff0000u);
    dsum += lo + hi; dabs += fabsf(lo) + fabsf(hi);
  }
  const unsigned k = atomicAdd(&xc_n, 1u);
  if (k < 512) {
    float* o = xc_rec[k];
    o[0] = (float)xc_ctx[blockIdx.x]; o[1] = blockIdx.x; o[2] = threadIdx.x >> 5; o[3] = cl;
    o[4] = gi; o[5] = r; o[6] = xs; o[7] = m; o[8] = dsum; o[9] = dabs;
  }
}
"""
XCHECK_GET = r"""
extern "C" int awq_xc_get(void* n, void* rec) {
  cudaMemcpyFromSymbol(n, xc_n, sizeof(unsigned));
  return (int)cudaMemcpyFromSymbol(rec, xc_rec, sizeof(xc_rec));
}
extern "C" int awq_xc_zero() {
  const unsigned z = 0;
  return (int)cudaMemcpyToSymbol(xc_n, &z, sizeof(unsigned));
}
"""




def stamped(src: str):
    """The source with stamps, and the label of each stamp id."""
    k0 = src.index(KERNEL)
    body0 = src.index("{", k0)
    depth, i = 0, body0
    while True:                       # the kernel's closing brace
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            break
        i += 1
    body = src[body0:i]
    labels, out, pos, phase = [], [], 0, "load"

    def stamp(label):
        labels.append(label)
        return f"MK_T({len(labels) - 1}); "

    events = sorted([(m.start(), "sync") for m in re.finditer(r"grid\.sync\(\);", body)]
                    + [(m.start(), "stage") for m in re.finditer(r"stage_rows\(", body)]
                    + [(m.start(), "phase") for m in re.finditer(r"// ---- ([^\n]*)", body)])
    for at, kind in events:
        if kind == "phase":
            text = body[at + 8:body.index("\n", at)]
            phase = re.split(r":| ->| \(| \+|,|;", text)[0].strip()[:24]
            continue
        line0 = body.rindex("\n", 0, at) + 1
        out.append(body[pos:line0])
        indent = body[line0:at]
        if kind == "sync":
            end = at + len("grid.sync();")
            out.append(indent + stamp(f"{phase} work") + body[at:end] + " "
                       + stamp(f"{phase} barrier"))
        else:
            end = body.index(";", at) + 1
            out.append(indent + stamp(f"{phase} pre") + body[line0 + len(indent):end] + " "
                       + stamp(f"{phase} stage"))
        pos = end
    out.append(body[pos:])
    body = "".join(out)
    body = body.replace(GRID, GRID + " if (threadIdx.x == 0) mk_prev[blockIdx.x] = mk_now();",
                        1)
    body += "  " + stamp("head work") + "\n"
    head = src[:body0]
    calls = [m.start() for m in re.finditer(r"(?<!void )stage_rows\(", head)]
    if calls:                 # stamps around the stagings of the phase function
        s0 = len(labels)
        for name in STAGED:
            labels += [f"{name} pre", f"{name} stage"]
        for at in reversed(calls):
            end = head.index(";", at) + 1
            head = (head[:at] + f"MK_T({s0} + 2 * ph); " + head[at:end]
                    + f" MK_T({s0} + 2 * ph + 1);" + head[end:])
    assert len(labels) <= NSTAMP, len(labels)
    src = head + body + src[i:]
    j = src.index("namespace {")
    return src[:j] + STAMP_DEF + src[j:] + STAMP_GET, labels


def build(out: Path, name: str, source: Path, defines, stamps: bool, var: str = "base"):
    """Start nvcc on (a stamped copy of a variant of) ``source`` with its
    tree's headers copied beside it; returns (process, library path, labels)."""
    from awq_tpu_torch import _build

    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for f in source.parent.glob("*.cuh"):
        (d / f.name).write_text(f.read_text())
    src = variant(source.read_text(), var)
    src, labels = stamped(src) if stamps else (src, [])
    (d / "k6.cu").write_text(src)
    lib = d / "k6.so"
    proc = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS,
                             *(f"-D{x}" for x in defines), "-I", str(d), "-o", str(lib),
                             str(d / "k6.cu")], stdout=open(d / "build.log", "w"),
                            stderr=subprocess.STDOUT)
    return proc, lib, labels


def check_rows(torch, np, mkb, _build, unit, libs, step, kw, b, L):
    """``--check``: each build against the plain version on its own copy of
    the cache, two calls each: the whole tensors' error over their largest
    magnitude (the smoke's measure), the worst rows of the logits and of h,
    the worst (layer, row) of the k/v written, whether the two calls agree
    bit for bit, and the group sums the xcheck variant recorded."""
    cache = step[9]
    ref_cache = cache.clone()
    ref = mkb.w4a16_llama_token_step_batched_plain(*step[:9], ref_cache, *step[10:], **kw)
    names = ("h", "k", "v", "logits")
    # how far the plain version itself moves when every matmul output is
    # perturbed at f32 rounding size (2^-20 relative): the conditioning of
    # each (layer, row) the kernel is held to
    qdot = mkb.qdot_layer
    gen = torch.Generator(device=cache.device).manual_seed(7)

    def noisy(*a, **k):
        y = qdot(*a, **k)
        return y * (1 + 2.0 ** -20 * torch.randn(y.shape, generator=gen, device=y.device))

    mkb.qdot_layer = noisy
    try:
        alt = mkb.w4a16_llama_token_step_batched_plain(*step[:9], cache.clone(), *step[10:], **kw)
    finally:
        mkb.qdot_layer = qdot
    for k in (1, 2):
        g, r = alt[k].float(), ref[k].float()
        per = ((g - r).abs().amax(dim=(2, 3)) / r.abs().amax(dim=(1, 2, 3))[:, None]).cpu().numpy()
        worst = np.argsort(-per.ravel())[:4]
        print(f"  plain, matmuls perturbed by 2^-20: {names[k]} per (layer, row) over max|ref| "
              "of the layer: " + ", ".join(f"l{i // b} r{i % b} {per.ravel()[i]:.3e}"
                                          for i in worst), flush=True)
    del alt
    for name, lib in libs.items():
        if name.endswith("_plain") and name != "checkout_plain":
            continue
        _build._LIBS[unit] = lib
        outs, recs, xb = [], None, None
        for _ in range(2):
            c = cache.clone()
            if hasattr(lib, "awq_xc_zero"):
                lib.awq_xc_zero()
            if hasattr(lib, "awq_xb_zero"):
                lib.awq_xb_zero()
            if hasattr(lib, "awq_xm_zero"):
                lib.awq_xm_zero()
            got = mkb.w4a16_llama_token_step_batched(*step[:9], c, *step[10:], **kw)
            torch.cuda.synchronize()
            outs.append([x.float() for x in got])
            if hasattr(lib, "awq_xc_get"):
                n = ctypes.c_uint(0)
                rec = np.zeros((512, 10), dtype=np.float32)
                lib.awq_xc_get(ctypes.byref(n), ctypes.c_void_p(rec.ctypes.data))
                recs = (recs or []) + [(n.value, rec[:min(n.value, 512)].copy())]
            if hasattr(lib, "awq_xb_get"):
                n = ctypes.c_uint(0)
                rec = np.zeros((512, 10), dtype=np.float32)
                lib.awq_xb_get(ctypes.byref(n), ctypes.c_void_p(rec.ctypes.data))
                xb = (n.value, rec[:min(n.value, 512)].copy())
            del c
        same = all(torch.equal(x, y) for x, y in zip(*outs))
        got = outs[0]
        whole = " ".join(f"{k} {((g - r.float()).abs().max() / r.float().abs().max()).item():.3e}"
                         for k, g, r in zip(names, got, ref))
        print(f"  {name} B={b}: rel err (max|diff|/max|ref|) {whole}; two calls "
              f"{'bit-equal' if same else 'DIFFER'}", flush=True)
        for k, g, r in ((3, got[3], ref[3]), (0, got[0], ref[0])):
            r = r.float()
            per = ((g - r).abs().amax(dim=1) / r.abs().amax(dim=1)).cpu().numpy()
            top = np.argsort(-per)[:4]
            print(f"    {names[k]} per row (max|diff| / max|ref| of the row): "
                  + ", ".join(f"row {i} {per[i]:.3e}" for i in top)
                  + f"; median {np.median(per):.3e}", flush=True)
        for k in (1, 2):
            g, r = got[k], ref[k].float()          # [L, B, nkv, hd]
            per = ((g - r).abs().amax(dim=(2, 3)) / r.abs().amax(dim=(1, 2, 3))[:, None]).cpu().numpy()
            worst = np.argsort(-per.ravel())[:4]
            first = [l for l in range(L) if per[l].max() > 0.02]
            print(f"    {names[k]} per (layer, row) over max|ref| of the layer: "
                  + ", ".join(f"l{i // b} r{i % b} {per.ravel()[i]:.3e}" for i in worst)
                  + f"; layers over 0.02: {first[:8]}", flush=True)
            l, r_ = divmod(int(worst[0]), b)
            worst_kv = int(worst[0])
            e = (g[l, r_] - r[l, r_]).abs()                 # [nkv, hd]
            cols = torch.nonzero(e > 0.5 * e.max()).cpu().numpy()
            print(f"      l{l} r{r_}: max err by kv head "
                  + " ".join(f"{x:.3g}" for x in e.amax(dim=1).tolist())
                  + f"; (head, dim) over half the max: {cols[:12].tolist()}", flush=True)
        for n, rec in recs or []:
            print(f"    xcheck: {n} group sums disagree", flush=True)
            for row in rec[np.argsort(-np.abs(rec[:, 7] - rec[:, 6]))][:16]:
                ctx = int(row[0])
                print(f"      layer {ctx >> 16} phase {(ctx >> 8) & 255} window {ctx & 255} "
                      f"block {int(row[1])} warp {int(row[2])} chunk {int(row[3])} group "
                      f"{int(row[4])} row {int(row[5])}: staged {row[6]:.5g} mma {row[7]:.5g} "
                      f"smem now {row[8]:.5g} sum|x| {row[9]:.5g}", flush=True)
        if hasattr(lib, "awq_xm_get"):
            diff = np.zeros((33, 5, 64), dtype=np.uint32)
            xmax = np.zeros((33, 5, 64), dtype=np.uint32)
            lib.awq_xm_get(ctypes.c_void_p(diff.ctypes.data), ctypes.c_void_p(xmax.ctypes.data))
            diff, xmax = diff.view(np.float32)[..., :b], xmax.view(np.float32)[..., :b]
            l, r_ = divmod(int(worst_kv), b)
            print(f"    xmax: row {r_}, layers 0..{min(l + 1, L - 1)}: largest |biased - exact| of "
                  "a warp's partial sum (and the median over rows), largest |x| staged (median), "
                  "by phase qkv/o/gateup/down", flush=True)
            for ll in range(0, min(l + 2, L)):
                print(f"      layer {ll}: " + "; ".join(
                    f"{nm} {diff[ll, ph, r_]:.3g} ({np.median(diff[ll, ph]):.3g}) x {xmax[ll, ph, r_]:.3g} "
                    f"({np.median(xmax[ll, ph]):.3g})"
                    for ph, nm in enumerate(("qkv", "o", "gateup", "down"))), flush=True)
        if hasattr(lib, "awq_xr_get"):
            sums = np.zeros((33, 5, 8, 132, 64), dtype=np.float32)
            rs = np.zeros((33, 5, 132, 64), dtype=np.float32)
            lib.awq_xr_get(ctypes.c_void_p(sums.ctypes.data), ctypes.c_void_p(rs.ctypes.data))
            grid = torch.cuda.get_device_properties(0).multi_processor_count
            sums, rs = sums[..., :grid, :b], rs[..., :grid, :b]
            bad_s = np.argwhere((sums != sums[..., :1, :]).any(axis=-2))    # (l, ph, win, row)
            bad_r = np.argwhere((rs != rs[..., :1, :]).any(axis=-2))        # (l, ph, row)
            print(f"    xrs: staged sums differing across blocks at {len(bad_s)} (layer, phase, "
                  f"window, row); norm factors at {len(bad_r)} (layer, phase, row)", flush=True)
            for l, ph, w, r_ in bad_s[:8]:
                col = sums[l, ph, w, :, r_]
                vals, cnt = np.unique(col, return_counts=True)
                odd = np.nonzero(col != vals[np.argmax(cnt)])[0]
                print(f"      sums l{l} ph{ph} win{w} row {r_}: {len(vals)} values, blocks "
                      f"{odd[:8].tolist()} differ from the common {vals[np.argmax(cnt)]:.7g} "
                      f"(e.g. {col[odd[0]]:.7g})", flush=True)
            for l, ph, r_ in bad_r[:8]:
                col = rs[l, ph, :, r_]
                vals, cnt = np.unique(col, return_counts=True)
                odd = np.nonzero(col != vals[np.argmax(cnt)])[0]
                print(f"      rs l{l} ph{ph} row {r_}: blocks {odd[:8].tolist()} "
                      f"{col[odd[0]]:.7g} against {vals[np.argmax(cnt)]:.7g}", flush=True)
        if xb is not None:
            n, rec = xb
            print(f"    xbias: {n} group values differ by more than 1e-2 between biased and "
                  "exact codes", flush=True)
            for row in rec[np.argsort(-np.abs(rec[:, 7] - rec[:, 8]))][:16]:
                ctx = int(row[0])
                print(f"      layer {ctx >> 16} phase {(ctx >> 8) & 255} window {ctx & 255} "
                      f"block {int(row[1])} group {int(row[4])} row {int(row[5])}: biased "
                      f"{row[7]:.6g} exact {row[8]:.6g} staged sum {row[6]:.6g} max|x| "
                      f"{row[9]:.6g}", flush=True)
    del ref, ref_cache


def smoke_cases(args, torch, np) -> int:
    """``--smoke``: chip_smoke's phase 2 megakernel cases on its own data
    (W4, then W3; W3 alone with ``--w3``), the bf16 slot and paged K6 units
    replaced by builds of the first variant (the paged outputs must equal
    the slot mode's); the first slot-cache K6 call at each row count is also
    held to the plain version row by row and layer by layer
    (``check_rows``). The smoke's own checks run as they do there; a failed
    one is printed and the run goes on with the next format."""
    import chip_smoke as cs
    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import megakernel_batched as mkb

    var = args.variants.split(",")[0]
    out = ROOT / "build" / "exp_batched_phases"
    formats = (True,) if args.w3 else (False, True)
    units = {(w3, m): f"megakernel_batched_{m}" + ("_w3" if w3 else "")
             for w3 in formats for m in ("bf16", "paged")}
    procs = {k: build(out, f"smoke_{u}_{var.replace('+', '_')}",
                      _build.CSRC / "megakernel_batched.cu", _build.UNITS[u][1], False, var)
             for k, u in units.items()}
    _build.build_all()
    own = {k: _build.load(u) for k, u in units.items()}
    libs = {}
    for k, (proc, path, _) in procs.items():
        if proc.wait():
            print((path.parent / "build.log").read_text()[-4000:])
            return 1
        lib = ctypes.CDLL(str(path))
        lib.awq_error_string.restype = ctypes.c_char_p
        lib.awq_error_string.argtypes = [ctypes.c_int]
        libs[k] = lib
        _build._LIBS[units[k]] = lib
    orig = mkb.w4a16_llama_token_step_batched
    seen = set()

    def wrapped(*a, **kw):
        w3 = a[1].w_bit == 3
        key = (a[0].shape[0], w3)
        if (a[9].dtype == torch.bfloat16 and kw.get("tables") is None
                and kw.get("cache_scales") is None and key not in seen):
            seen.add(key)
            u = units[(w3, "bf16")]
            check_rows(torch, np, mkb, _build, u, {"checkout": own[(w3, "bf16")],
                                                   var: libs[(w3, "bf16")]}, a, kw,
                       a[0].shape[0], a[1].qweight.shape[0])
            _build._LIBS[u] = libs[(w3, "bf16")]
        return orig(*a, **kw)

    mkb.w4a16_llama_token_step_batched = wrapped
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch, reps=5)
    for w3 in formats:
        try:
            cs.phase_megakernels(torch, timer, [], w3=w3)
        except AssertionError as e:
            print(f"  smoke check failed ({'W3' if w3 else 'W4'}): {e}", flush=True)
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="8,32")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--unit", default="bf16", help="bf16 (the slot cache), int8 or paged")
    ap.add_argument("--w3", action="store_true", help="a W3 model (pack_int3) and the W3 unit")
    ap.add_argument("--other", type=Path, help="another tree's csrc/megakernel_batched.cu")
    ap.add_argument("--variants", default="base", help="base,nomma,nocopy,compute,hint (checkout only)")
    ap.add_argument("--check", action="store_true",
                    help="no clocks: hold each variant (built without stamps) to the plain "
                         "version row by row and layer by layer, two calls each")
    ap.add_argument("--smoke", action="store_true",
                    help="no clocks: run chip_smoke.py's phase 2 megakernel cases (W4, then "
                         "W3) with the bf16 K6 units replaced by the first variant, each K6 "
                         "call at a new row count held to the plain version as --check does")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exp_batched_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from awq_tpu_torch import _build
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import megakernel_batched as mkb
    from awq_tpu_torch.ops.w4a16 import QLinear

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    if args.smoke:
        return smoke_cases(args, torch, np)
    unit = f"megakernel_batched_{args.unit}" + ("_w3" if args.w3 else "")
    defines = _build.UNITS[unit][1]
    out = ROOT / "build" / "exp_batched_phases"
    trees = {"checkout": _build.CSRC / "megakernel_batched.cu"}
    if args.other:
        trees["other"] = args.other.resolve()
    procs = {}
    for var in args.variants.split(","):
        if var != "base" or args.check:
            procs[var] = build(out, var.replace("+", "_"), trees["checkout"], defines,
                               not args.check, var)
    for name, source in trees.items():
        if args.check:
            break
        procs[name] = build(out, name, source, defines, True)
        if name == "other":
            procs["other_plain"] = build(out, "other_plain", source, defines, False)
    _build.build_all([unit])
    libs, labels = {"checkout_plain": _build.load(unit)}, {}
    for name, (p, path, lab) in procs.items():
        if p.wait():
            print((path.parent / "build.log").read_text()[-4000:])
            return 1
        lib = ctypes.CDLL(str(path))
        lib.awq_error_string.restype = ctypes.c_char_p
        lib.awq_error_string.argtypes = [ctypes.c_int]
        libs[name] = lib
        if lab:
            labels[name] = lab
        print(f"{name}: built ({len(lab)} stamps)", flush=True)
    print("ptxas (checkout): " + " | ".join(
        ln.strip() for ln in _build.build_log(unit).splitlines()
        if "registers" in ln or "spill" in ln), flush=True)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4321)
    cfg = ModelConfig(**cs.LLAMA3_8B)
    H, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    wb = 3 if args.w3 else 4
    params = llama.fuse_linears(llama.init_qparams(cfg, QuantConfig(w_bit=wb, group_size=128),
                                                   gen), cfg)
    s_head = (torch.rand((H // 128, V), generator=gen, device=dev) + 0.5) * 0.005
    whead = QLinear(qweight=torch.randint(-(2**31), 2**31 - 1,
                                          (H * 3 // 32 if args.w3 else H // 8, V),
                                          generator=gen, dtype=torch.int32, device=dev),
                    scales=s_head, szeros=s_head * 2 ** (wb - 1), w_bit=wb, dense3=args.w3)
    la = params["layers"]
    args6 = (la["wqkv"], la["wo"], la["wgateup"], la["down"], la["ln1"], la["ln2"])
    t_b = 2048
    cos, sin = llama.rope_table(cfg, t_b, device=dev)
    timer = cs.Timer(torch, 20)
    zero = np.zeros((1024, NSTAMP), dtype=np.uint64)
    buf = np.zeros_like(zero)
    for b in [int(v) for v in args.rows.split(",")]:
        ragged = [700 + (i * 97) % 600 for i in range(b)]
        ragged[1] = 0
        lens = torch.tensor(ragged, dtype=torch.int32, device=dev)
        cache = llama.init_kv_cache(cfg, b, t_b)
        cache.normal_(generator=gen)
        kw = dict(whead=whead, norm_w=params["norm"], max_length=max(ragged))
        if args.unit == "int8":
            codes, scales = cs.quantize_cache(torch, cache)
            cache, kw["cache_scales"] = codes, scales
        elif args.unit == "paged":
            cache, kw["tables"] = cs.scatter_pages(torch, cache, t_b // 256, 256, gen,
                                                   need=[n // 256 + 1 for n in ragged])
        h = (torch.randn((b, H), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        step = (h, *args6, cos[lens.long()], sin[lens.long()], cache, lens,
                cfg.num_heads, cfg.num_kv_heads, cfg.rms_eps)
        run = lambda: mkb.w4a16_llama_token_step_batched(*step, **kw)
        if args.check:
            check_rows(torch, np, mkb, _build, unit, libs, step, kw, b, L)
            _build._LIBS[unit] = libs["checkout_plain"]
            del cache, kw, step
            torch.cuda.empty_cache()
            continue
        plain = [k for k in ("checkout_plain", "other_plain") if k in libs]
        turns = {k: [] for k in plain}
        for k in plain + plain[::-1]:
            _build._LIBS[unit] = libs[k]
            turns[k].append(timer(run))
        print(f"B={b}, len 0..{max(ragged)}: step " + "; ".join(
            f"{k} {statistics.median(v):.4f} ms ({' '.join(f'{x:.4f}' for x in v)})"
            for k, v in turns.items()) + " (no stamps)", flush=True)
        for name in labels:
            lib = libs[name]
            _build._LIBS[unit] = lib
            runs = []
            for _ in range(args.reps):
                run()
                torch.cuda.synchronize()
                lib.awq_mk_zero(ctypes.c_void_p(zero.ctypes.data))
                cs.Timer(torch, 1)(run, reps=1)      # the flushed L2 as in the timing
                torch.cuda.synchronize()
                lib.awq_mk_acc(ctypes.c_void_p(buf.ctypes.data))
                runs.append(buf.astype(np.float64).copy() / 2)   # two calls a turn
            st = timer(run)
            used = runs[0].sum(axis=1) > 0
            nblk = int(used.sum())
            print(f"  {name}: {st:.4f} ms with stamps, {nblk} blocks; us a layer "
                  "(median over blocks; head segments a step):", flush=True)
            per = {}
            for sid, lab in enumerate(labels[name]):
                per.setdefault(lab, []).append(sid)
            total = 0.0
            for lab, ids in per.items():
                once = lab.startswith(("final", "head")) or lab.startswith("load")
                vals = [np.median(r[used][:, ids].sum(axis=1)) / 1e3 / (1 if once else L)
                        for r in runs]
                v = statistics.median(vals)
                total += v * (1 if once else L)
                print(f"    {lab:<32} {v:10.2f}", flush=True)
            print(f"    (sum of medians over the step {total / 1e3:.3f} ms)", flush=True)
        _build._LIBS[unit] = libs["checkout_plain"]
        del cache, kw, step
        torch.cuda.empty_cache()
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
