#!/usr/bin/env python3
"""A/B of the prefill GEMMs between builds on one NVIDIA GPU: K1's GEMM
entry (W4 and W3, ``csrc/w4a16.cuh``), K11 and K10 (``csrc/w8a8.cu``).

    python3 scripts/ab_prefill_gemm.py OTHER/w4a16.cuh OTHER/w8a8.cu [--reps 20] [--rounds 2]

OTHER is another tree's ``awq_tpu_torch/csrc`` (e.g. the parent commit's,
``git archive`` into ``build/parent``). Its ``w4a16.cu``, ``w3a16.cu`` and
``w8a8.cu`` are built beside the checkout's, with the port's nvcc flags
and each tree's own headers (one nvcc each, all in parallel), into
``build/ab_prefill_gemm/``. Either build's C entries may have the
single-stage signatures (no plan) or the wgmma ones (token tile and split
count from ``ops/w4a16.py::gemm_plan``; K10's wgmma entry also takes its x
codes in its own channel order, ``ops/w8a8.py::permute64``); the script
reads which from the source.

Shapes: Llama-3-8B's four projections (bf16 x, group 128) with K1 W4 at
M = 16, 32, 64, 200, 1000, K1 W3 at 32, 200, 1000, K11 at 32, 40, 200,
1000 and K10 at 40, 512, 1000. K10 and K11 get the same int8 x (the
quantization launch is left out of their times). Each K10 row also times
the two-launch composition that K10 fuses, the checkout's ``requant_w8``
on the card and then its K11 over that cache (a yardstick, not a path of
the program). The builds run in turns
(in order, then in reverse, ``--rounds`` times), each turn the median of
``--reps`` calls with the L2 flushed before each (``chip_smoke.Timer``).
The script prints each shape's turns, the medians and the ratio, with the
card's name and power limit, and checks that K11's and K10's outputs are
bit-equal across the builds and K1's within 2^-6 of the largest output
magnitude. It exits 1 if an output check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

G = 128
SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgateup": (4096, 28672),
          "down": (14336, 4096)}
ROWS = {"w4a16_gemm": (16, 32, 64, 200, 1000), "w3a16_gemm": (32, 200, 1000),
        "w8a8_gemm": (32, 40, 200, 1000), "w4a8_gemm": (40, 512, 1000)}


def build(src: Path, out: Path):
    from awq_tpu_torch import _build

    log = open(out.with_suffix(".log"), "w")
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src.parent),
                             "-o", str(out), str(src)], stdout=log, stderr=subprocess.STDOUT)


class Build:
    """One tree's three libraries and how to call their GEMM entries."""

    def __init__(self, csrc: Path, out_dir: Path, tag: str):
        self.csrc, self.tag = csrc, tag
        self.so = {u: out_dir / f"{tag}-{u}.so" for u in ("w4a16", "w3a16", "w8a8")}
        # the wgmma entries take the plan's token tile and split count
        w8a8 = (csrc / "w8a8.cu").read_text()
        self.planned = {
            "k1": "int nt" in (csrc / "w4a16.cu").read_text(),
            "k11": "int nt" in w8a8, "k10": "void* scol_out" in w8a8}

    def start(self):
        return [build(self.csrc / f"{u}.cu", so) for u, so in self.so.items()]

    def load(self):
        P, I = ctypes.c_void_p, ctypes.c_int
        libs = {u: ctypes.CDLL(str(so)) for u, so in self.so.items()}
        self.fn = {}
        for fmt in ("w4a16", "w3a16"):
            fn = getattr(libs[fmt], f"awq_{fmt}_gemm")
            fn.argtypes = ([P] * 7 + [I] * 7 if self.planned["k1"] else [P] * 6 + [I] * 5) + [P]
            fn.restype = I
            self.fn[f"{fmt}_gemm"] = fn
        fn = libs["w8a8"].awq_w8a8_gemm
        fn.argtypes = ([P] * 6 + [I] * 6 if self.planned["k11"] else [P] * 5 + [I] * 4) + [P]
        fn.restype = I
        self.fn["w8a8_gemm"] = fn
        fn = libs["w8a8"].awq_w4a8_gemm
        fn.argtypes = ([P] * 8 + [I] * 6 if self.planned["k10"] else [P] * 6 + [I] * 5) + [P]
        fn.restype = I
        self.fn["w4a8_gemm"] = fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("w4a16_cuh", type=Path, help="the other tree's csrc/w4a16.cuh")
    ap.add_argument("w8a8_cu", type=Path, help="the other tree's csrc/w8a8.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if args.w4a16_cuh.resolve().parent != args.w8a8_cu.resolve().parent:
        ap.error("both files must come from one csrc directory")

    import torch

    if not torch.cuda.is_available():
        print("ab_prefill_gemm: no CUDA device", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import w4a16 as w4
    from awq_tpu_torch.ops.w8a8 import permute64
    from chip_smoke import Timer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out_dir = ROOT / "build" / "ab_prefill_gemm"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {"other": Build(args.w4a16_cuh.resolve().parent, out_dir, "other"),
              "checkout": Build(_build.CSRC, out_dir, "checkout")}
    procs = [p for b in builds.values() for p in b.start()]
    if any(p.wait() for p in procs):
        print("ab_prefill_gemm: a build failed (logs in build/ab_prefill_gemm/)", flush=True)
        return 1
    for b in builds.values():
        b.load()

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(4321)
    timer = Timer(torch, reps=args.reps)
    bf16 = 1                                  # the entries' dtype code of bf16
    stream = lambda: torch.cuda.current_stream().cuda_stream
    failed, rows = False, []
    for wname, (ic, oc) in SHAPES.items():
        qw = torch.randint(-(2**31), 2**31 - 1, (ic // 8, oc), generator=gen,
                           dtype=torch.int32, device="cuda")
        q3 = torch.randint(-(2**31), 2**31 - 1, (ic * 3 // 32, oc), generator=gen,
                           dtype=torch.int32, device="cuda")
        s = (torch.rand((ic // G, oc), generator=gen, device="cuda") + 0.5) * 0.005
        sz = s * 8
        w8, scol = w4.requant_w8(qw, s, sz, G)
        for entry, ms in ROWS.items():
            for m in ms:
                x = torch.randn((m, ic), generator=gen, device="cuda").to(torch.bfloat16)
                xq, sx = w4.quant_per_token_plain(x)
                xq_perm = permute64(xq)
                outs = {k: torch.empty((m, oc), dtype=torch.bfloat16, device="cuda")
                        for k in builds}
                kind = {"w4a16_gemm": "w4a16", "w3a16_gemm": "w3a16",
                        "w4a8_gemm": "w4a8"}.get(entry, "w8a8")
                plan = w4.gemm_plan(m, ic, oc, kind, n_sm)
                part = torch.empty((plan.splits, m, oc), device="cuda",
                                   dtype=torch.int32 if kind in ("w8a8", "w4a8")
                                   else torch.float32)
                scol_buf = torch.empty((oc,), device="cuda", dtype=torch.float32)

                def call(k, entry=entry, x=x, xq=xq, sx=sx, plan=plan, part=part):
                    b, o = builds[k], outs[k]
                    fn = b.fn[entry]
                    pp = part.data_ptr() if plan.splits > 1 else None
                    if entry in ("w4a16_gemm", "w3a16_gemm"):
                        codes, zz = (qw, sz) if entry == "w4a16_gemm" else (q3, sz * 0.5)
                        head = (x.data_ptr(), codes.data_ptr(), s.data_ptr(), zz.data_ptr(),
                                None, o.data_ptr())
                        err = (fn(*head, pp, m, ic, oc, G, plan.tile_m, plan.splits, bf16,
                                  stream()) if b.planned["k1"]
                               else fn(*head, m, ic, oc, G, bf16, stream()))
                    elif entry == "w8a8_gemm":
                        head = (xq.data_ptr(), sx.data_ptr(), w8.data_ptr(), scol.data_ptr(),
                                o.data_ptr())
                        err = (fn(*head, pp, m, ic, oc, plan.tile_m, plan.splits, bf16,
                                  stream()) if b.planned["k11"]
                               else fn(*head, m, ic, oc, bf16, stream()))
                    elif b.planned["k10"]:
                        err = fn(xq_perm.data_ptr(), sx.data_ptr(), qw.data_ptr(), s.data_ptr(),
                                 sz.data_ptr(), o.data_ptr(), pp,
                                 scol_buf.data_ptr() if plan.splits > 1 else None, m, ic, oc, G,
                                 plan.splits, bf16, stream())
                    else:
                        err = fn(xq.data_ptr(), sx.data_ptr(), qw.data_ptr(), s.data_ptr(),
                                 sz.data_ptr(), o.data_ptr(), m, ic, oc, G, bf16, stream())
                    if err:
                        raise RuntimeError(f"{k} {entry}: CUDA error {err}")

                times = {k: [] for k in builds}
                for _ in range(args.rounds):
                    for k in list(builds) + list(builds)[::-1]:
                        times[k].append(timer(lambda: call(k)))
                torch.cuda.synchronize()
                a, b = outs["other"].float(), outs["checkout"].float()
                if entry in ("w8a8_gemm", "w4a8_gemm"):
                    same = torch.equal(outs["other"], outs["checkout"])
                    verdict = "outputs bit-equal" if same else "outputs DIFFER"
                else:
                    err = (a - b).abs().max().item()
                    same = err <= 2 ** -6 * a.abs().max().item()
                    verdict = (f"outputs within 2^-6 (max diff {err:.3e})" if same
                               else f"outputs DIFFER (max diff {err:.3e})")
                failed |= not same
                med = {k: statistics.median(ts) for k, ts in times.items()}
                ratio = med["checkout"] / med["other"]
                comp = ""
                if entry == "w4a8_gemm":
                    def composed(x=x):
                        return w4.w8a8_matmul(x, *w4.requant_w8(qw, s, sz, G))
                    same_c = torch.equal(composed(), outs["checkout"])
                    failed |= not same_c
                    comp = (f"; requant_w8 + K11 {timer(composed):.4f} ms ("
                            + ("bit-equal" if same_c else "DIFFERS") + ")")
                rows.append((entry, wname, m, med["other"], med["checkout"], ratio))
                split = f"swap nt={plan.tile_m}" if plan.swap else "128x128"
                print(f"{entry} {wname} M={m} ({split}, splits={plan.splits}): "
                      + "; ".join(f"{k} median {med[k]:.4f} ms ("
                                  + " ".join(f"{t:.4f}" for t in ts) + ")"
                                  for k, ts in times.items())
                      + f"; checkout/other {ratio:.3f}; {verdict}{comp}", flush=True)
        del qw, q3, s, sz, w8, scol
        torch.cuda.empty_cache()
    slower = [r for r in rows if r[5] > 1.0]
    print(f"summary: {len(rows)} shapes, {len(slower)} slower than the other build"
          + "".join(f"; {e} {w} M={m} {r:.3f}" for e, w, m, _, _, r in slower), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
