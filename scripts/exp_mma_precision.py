#!/usr/bin/env python3
"""How exactly ``mma.sync.m16n8k16`` (bf16 in, f32 accumulate) adds its
products on the card: the question behind K6's W3 decode
(``csrc/megakernel_batched.cu::code_pairs``). A chain of eight k16 steps
(one 128-channel group) of code columns against rows of bf16(x) is run on
the tensor cores and held to the same sum in float64, once with the codes
as ``q`` and once biased as ``128 + q`` with ``128 · Σx`` taken off
afterwards in f32 (the identity the kernels use). Both decodes are exact
in bf16 and every product is exact, so any difference from float64 is how
the tensor core rounds its sums.

    python3 scripts/exp_mma_precision.py [--trials 1024] [--bits 3]

Rows of x are N(0, 1) with, in some cases, one element per row replaced by
an outlier of magnitude 8 or 64 (rmsnorm'd rows of a residual with one
large channel look so). Prints, per case, the largest and median error of
the group's Σ x·q over the largest |x·q| term, for both decodes, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
// a [n][8 k16][16 rows][16 k] and b [n][8 k16][8 cols][16 k] as bf16 bits;
// d [n][16][8] f32: one warp a chain, the fragments as mma.sync m16n8k16
// row.col lays them out (low half of a word = the lower k)
__global__ void chain(const uint16_t* a, const uint16_t* b, float* d, int n) {
  const int lane = threadIdx.x & 31, w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (w >= n) return;
  const int gq = lane >> 2, tq = lane & 3;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < 8; ++s) {
    const uint16_t* A = a + ((size_t)w * 8 + s) * 256;
    const uint16_t* B = b + ((size_t)w * 8 + s) * 128;
    auto pk = [](const uint16_t* p) { return (uint32_t)p[0] | ((uint32_t)p[1] << 16); };
    const uint32_t a0 = pk(A + gq * 16 + 2 * tq), a1 = pk(A + (gq + 8) * 16 + 2 * tq);
    const uint32_t a2 = pk(A + gq * 16 + 2 * tq + 8), a3 = pk(A + (gq + 8) * 16 + 2 * tq + 8);
    const uint32_t b0 = pk(B + gq * 16 + 2 * tq), b1 = pk(B + gq * 16 + 2 * tq + 8);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float* D = d + (size_t)w * 128;
  D[gq * 8 + 2 * tq] = c[0]; D[gq * 8 + 2 * tq + 1] = c[1];
  D[(gq + 8) * 8 + 2 * tq] = c[2]; D[(gq + 8) * 8 + 2 * tq + 1] = c[3];
}
extern "C" int run_chain(const void* a, const void* b, void* d, int n) {
  chain<<<(n + 3) / 4, 128>>>((const uint16_t*)a, (const uint16_t*)b, (float*)d, n);
  return (int)cudaDeviceSynchronize();
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=1024)
    ap.add_argument("--bits", type=int, default=3, help="code width: 3 (W3) or 4 (W4)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exp_mma_precision: no CUDA device", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    out = ROOT / "build" / "exp_mma_precision"
    out.mkdir(parents=True, exist_ok=True)
    (out / "chain.cu").write_text(SRC)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / "chain.so"),
                    str(out / "chain.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "chain.so"))
    n = args.trials
    rng = np.random.default_rng(0)

    def bf16(x):
        return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(torch.bfloat16)

    def mma(a, b):
        ta, tb = bf16(a).cuda(), bf16(b).cuda()
        d = torch.empty((n, 16, 8), dtype=torch.float32, device="cuda")
        err = lib.run_chain(ctypes.c_void_p(ta.data_ptr()), ctypes.c_void_p(tb.data_ptr()),
                            ctypes.c_void_p(d.data_ptr()), n)
        assert err == 0, err
        return d.cpu().double().numpy()

    print(f"nvidia-smi: {smi}; {n} chains of 8 k16 steps, {args.bits}-bit codes")
    q = rng.integers(0, 2 ** args.bits, size=(n, 8, 16, 16)).astype(np.float64)
    for outlier in (0.0, 8.0, 64.0):
        x = rng.standard_normal((n, 8, 8, 16))
        if outlier:
            s, k = rng.integers(0, 8, size=(n, 8)), rng.integers(0, 16, size=(n, 8))
            for c in range(8):
                x[np.arange(n), s[:, c], c, k[:, c]] = outlier * rng.choice([-1, 1], size=n)
        x = bf16(x).double().numpy()
        # exact Σ_k A[i, k] x[j, k] over the chain, in float64
        ref = np.einsum("nsik,nsjk->nij", q, x)
        xsum = np.float32(x.sum(axis=(1, 3)))[:, None, :].astype(np.float64)   # [n, 1, 8]
        big = np.abs(np.einsum("nsik,nsjk->nsijk", q, x)).max(axis=(1, 4))
        d_exact = mma(q, x)
        d_biased = mma(128.0 + q, x)
        e1 = np.abs(d_exact - ref) / big
        e2 = np.abs(np.float32(d_biased - 128.0 * xsum) - ref) / big
        e3 = np.abs(d_biased - (ref + 128.0 * x.sum(axis=(1, 3))[:, None, :]))
        bigb = np.abs(np.einsum("nsik,nsjk->nsijk", 128.0 + q, x)).max(axis=(1, 4))
        print(f"  outlier {outlier:g}: codes q: err/max|term| max {e1.max():.3e} median "
              f"{np.median(e1):.3e}; codes 128+q, 128·Σx off: max {e2.max():.3e} median "
              f"{np.median(e2):.3e}; the biased chain itself: err/max|term| max "
              f"{(e3 / bigb).max():.3e} (2^{np.log2((e3 / bigb).max() + 1e-30):.1f})", flush=True)
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
