#!/usr/bin/env python3
"""Experiment: K10 with 256-token tiles, against the port's 128-token K10 and
K11, on one NVIDIA GPU.

    python3 scripts/exp_k10_tile256.py

The variant is not part of the port. The script writes it into
``build/exp_k10_tile256/`` from ``awq_tpu_torch/csrc/w8a8.cu`` by text
substitution: each consumer warpgroup multiplies two 64-row slabs (128 int32
accumulators a thread) against every requantized stage, so one requant
feeds 256 tokens; the block is 640 threads (a producer warpgroup, two
requant and two consumer warpgroups) with ``setmaxnreg`` moving registers
from the producer (40) and requant (64) warpgroups to the consumers (152);
the rings hold 4 x/B stages and 3 code stages. It builds the variant with
the port's nvcc flags (printing ptxas' registers, spills and C7512
warnings), then at Llama-3-8B's four projections (M 512 and 1000, group
128) checks its output against the plain version and times it beside the
port's K10 (which includes its quantization launch; the variant's time
does not) and K11, medians of 20 calls with the L2 flushed
(``chip_smoke.Timer``). Prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (old, new) substitutions that turn the port's K10 into the 256-token variant
SUBS = [
    ("constexpr int BM = 128;         // tokens of a block: two consumer warpgroups of 64",
     "constexpr int BM = 256;"),
    ("constexpr int THREADS = WORKERS + 64;     // and two producer warps (x, codes)",
     "constexpr int THREADS = WORKERS + 128;"),
    ("constexpr int STAGES = 5;       // x tiles and B tiles in flight", "constexpr int STAGES = 4;"),
    ("constexpr int CSTAGES = 7;      // code tiles in flight", "constexpr int CSTAGES = 3;"),
    ("  if (warp == WORKERS / 32) {   // the x producer",
     "  if (warp >= WORKERS / 32) {\n"
     '    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n" ::: "memory");\n'
     "    if (warp >= WORKERS / 32 + 2) return;\n  }\n"
     "  if (warp == WORKERS / 32) {"),
    ("  if (warp >= 8) {   // the requant warpgroups\n",
     "  if (warp >= 8) {\n"
     '    asm volatile("setmaxnreg.dec.sync.aligned.u32 64;\\n" ::: "memory");\n'),
]
CONSUMERS = r'''  // the consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
  const int wg = warp >> 2, t = threadIdx.x & 127, wi = t >> 5;
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  for (int i = 0; i < nst; ++i) {
    const int st = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    hop::mbar_wait(&xfull[st], ph);
    hop::mbar_wait(&wready[st], ph);
    const uint64_t da0 = hop::desc_k128(xring + st * XB + wg * 128 * 128);
    const uint64_t da1 = hop::desc_k128(xring + st * XB + (wg * 128 + 64) * 128);
    const uint64_t db = hop::desc_k128(bring + st * WB);
    hop::fence_regs<128>(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hop::Wgmma<int8_t, 128>::mma(acc, da0 + 2 * kk, db + 2 * kk);
      hop::Wgmma<int8_t, 128>::mma(acc + 64, da1 + 2 * kk, db + 2 * kk);
    }
    hop::wg_commit();
    hop::wg_wait<1>();
    hop::fence_regs<128>(acc);
    if (i > 0) {
      hop::mbar_arrive(&xempty[(i - 1) % STAGES]);
      hop::mbar_arrive(&bempty[(i - 1) % STAGES]);
    }
  }
  hop::wg_wait<0>();
  hop::fence_regs<128>(acc);
  hop::mbar_wait(scol_bar, 0);
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int j8 = 0; j8 < 16; ++j8)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rr = 16 * wi + (lane >> 2) + 8 * h, c = 8 * j8 + 2 * (lane & 3) + e;
          const int tok = m0 + wg * 128 + sl * 64 + rr, oc = n0 + c;
          if (tok >= M || oc >= OC) continue;
          const int v = acc[64 * sl + 4 * j8 + 2 * h + e];
          if (partial) {
            partial[((size_t)split * M + tok) * OC + oc] = v;
          } else {
            out[(size_t)tok * OC + oc] =
                from_f32<T>(__fmul_rn(__fmul_rn(__int2float_rn(v), scol_s[c]), sx[tok]));
          }
        }
}

'''


def variant_source(csrc: Path) -> str:
    s = (csrc / "w8a8.cu").read_text()
    for old, new in SUBS:
        if old not in s:
            raise RuntimeError(f"the port's K10 changed; update the substitution of {old[:40]!r}")
        s = s.replace(old, new, 1)
    a = s.index("  // the consumer warpgroups\n")
    b = s.index("// One K10 product: the TMA descriptors")
    return s[:a] + CONSUMERS + s[b:]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("exp_k10_tile256: no CUDA device", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import w4a16 as w4
    from awq_tpu_torch.ops import w8a8 as q8
    from chip_smoke import Timer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out = ROOT / "build" / "exp_k10_tile256"
    out.mkdir(parents=True, exist_ok=True)
    for h in ("common.cuh", "hopper.cuh"):
        shutil.copy(_build.CSRC / h, out / h)
    (out / "w8a8.cu").write_text(variant_source(_build.CSRC))
    so = out / "variant.so"
    proc = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                             str(out / "w8a8.cu")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    _build.build_all(["w8a8"])
    log, _ = proc.communicate()
    if proc.returncode:
        print(log[-4000:])
        return 1
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "C7512" in line or ("w4a8_wgmma" in line and "Function properties" in line):
            print(line.strip(), lines[i + 1].strip() if "Function properties" in line else "")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.awq_w4a8_gemm
    fn.argtypes, fn.restype = [P] * 8 + [I] * 6 + [P], I
    timer = Timer(torch, reps=20)
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = 128
    for m in (512, 1000):
        for ic, oc in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
            qw = torch.randint(-(2**31), 2**31 - 1, (ic // 8, oc), generator=gen,
                               dtype=torch.int32, device="cuda")
            s = (torch.rand((ic // g, oc), generator=gen, device="cuda") + 0.5) * 0.005
            sz = s * 8
            x = (torch.randn((m, ic), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
            xq, sx = q8.quant_per_token(x, perm=True)
            w8, scol = w4.requant_w8(qw, s, sz, g)
            o = torch.empty((m, oc), dtype=torch.bfloat16, device="cuda")

            def call(m=m, ic=ic, oc=oc, qw=qw, s=s, sz=sz, xq=xq, sx=sx, o=o):
                return fn(xq.data_ptr(), sx.data_ptr(), qw.data_ptr(), s.data_ptr(),
                          sz.data_ptr(), o.data_ptr(), None, None, m, ic, oc, g, 1, 1,
                          torch.cuda.current_stream().cuda_stream)

            err = call()
            torch.cuda.synchronize()
            same = err == 0 and torch.equal(o, w4.w4a8_matmul_plain(x, qw, s, sz, g))
            res = {"variant": timer(call),
                   "K10 (+quant)": timer(lambda: w4.w4a8_matmul(x, qw, s, sz, g)),
                   "K11 (+quant)": timer(lambda: w4.w8a8_matmul(x, w8, scol))}
            print(f"M={m} {ic}->{oc}: variant output "
                  + ("equals the plain version" if same else f"DIFFERS (error code {err})")
                  + "; " + ", ".join(f"{k} {v:.4f} ms" for k, v in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
