#!/usr/bin/env python3
"""A/B of K1's GEMV entry (M <= 8, W4 and W3, ``csrc/w4a16.cuh``) between
two builds on one NVIDIA GPU, ``torch.matmul`` on the dequantized weight
beside it.

    python3 scripts/ab_gemv.py OTHER/w4a16.cuh [--reps 20] [--rounds 2]

OTHER is another tree's ``awq_tpu_torch/csrc`` (e.g. the parent commit's,
``git archive HEAD~ awq_tpu_torch/csrc | tar -x -C build/parent``). Its
``w4a16.cu`` and ``w3a16.cu`` are built beside the checkout's, with the
port's nvcc flags and each tree's own headers (one nvcc each, all in
parallel), into ``build/ab_gemv/``. Either build's GEMV entry may be the
split-K one (an f32 partial buffer, a reduce launch: ``int split_k``) or the
planned one (``int splits, int stages`` from ``ops/w4a16.py::gemv_plan``);
the script reads which from the source.

Shapes: Llama-3-8B's five (wqkv, wo, wgateup, down, head; bf16 x, group
128) at M = 1 and 8, W4 and W3 (pack_int3), and Falcon-7B's four and its
head at M = 1, W4 at group 64. The builds and ``torch.matmul`` run in turns
(in order, then in reverse, ``--rounds`` times), each turn the median of
``--reps`` calls with the L2 flushed before each (``chip_smoke.Timer``).
The script prints each shape's turns, medians, ratios, the bound and the
kernels one call launches (from a ``torch.profiler`` trace), with the
card's name and power limit. It exits 1 if the builds' outputs differ by
more than 2^-6 of the largest output magnitude, or if two calls of the
checkout's build on the same inputs differ by a bit.
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

LLAMA = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgateup": (4096, 28672),
         "down": (14336, 4096), "head": (4096, 128256)}
FALCON = {"wqkv": (4544, 4672), "wo": (4544, 4544), "up": (4544, 18176),
          "down": (18176, 4544), "head": (4544, 65024)}
HBM = 3.35e12


def build(src: Path, out: Path):
    from awq_tpu_torch import _build

    log = open(out.with_suffix(".log"), "w")
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src.parent),
                             "-o", str(out), str(src)], stdout=log, stderr=subprocess.STDOUT)


class Build:
    """One tree's two K1 libraries and how to call their GEMV entries."""

    def __init__(self, csrc: Path, out_dir: Path, tag: str):
        self.csrc, self.tag = csrc, tag
        self.so = {u: out_dir / f"{tag}-{u}.so" for u in ("w4a16", "w3a16")}
        self.planned = "int splits, int stages" in (csrc / "w4a16.cu").read_text()

    def start(self):
        return [build(self.csrc / f"{u}.cu", so) for u, so in self.so.items()]

    def load(self):
        P, I = ctypes.c_void_p, ctypes.c_int
        self.fn = {}
        for fmt, so in self.so.items():
            fn = getattr(ctypes.CDLL(str(so)), f"awq_{fmt}_gemv")
            fn.argtypes = ([P] * 6 + [I] * 8 if self.planned else [P] * 7 + [I] * 7) + [P]
            fn.restype = I
            self.fn[fmt] = fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("w4a16_cuh", type=Path, help="the other tree's csrc/w4a16.cuh")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ab_gemv: no CUDA device", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import w4a16 as w4
    from chip_smoke import Timer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out_dir = ROOT / "build" / "ab_gemv"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {"other": Build(args.w4a16_cuh.resolve().parent, out_dir, "other"),
              "checkout": Build(_build.CSRC, out_dir, "checkout")}
    procs = [p for b in builds.values() for p in b.start()]
    if any(p.wait() for p in procs):
        print("ab_gemv: a build failed (logs in build/ab_gemv/)", flush=True)
        return 1
    for b in builds.values():
        b.load()

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(2468)
    timer = Timer(torch, reps=args.reps)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    bf16 = 1
    cases = [("llama", w, "w4a16", m, 128) for m in (1, 8) for w in LLAMA]
    cases += [("llama", w, "w3a16", m, 128) for m in (1, 8) for w in LLAMA]
    cases += [("falcon", w, "w4a16", 1, 64) for w in FALCON]
    failed, rows = False, []
    for model, wname, fmt, m, g in cases:
        ic, oc = (LLAMA if model == "llama" else FALCON)[wname]
        dense3 = fmt == "w3a16"
        rows_q = ic * 3 // 32 if dense3 else ic // 8
        qw = torch.randint(-(2**31), 2**31 - 1, (rows_q, oc), generator=gen,
                           dtype=torch.int32, device="cuda")
        s = (torch.rand((ic // g, oc), generator=gen, device="cuda") + 0.5) * 0.005
        sz = s * (4 if dense3 else 8)
        x = torch.randn((m, ic), generator=gen, device="cuda").to(torch.bfloat16)
        w = w4.dequantize(qw, s, sz, g, torch.bfloat16, dense3)
        outs = {k: torch.empty((m, oc), dtype=torch.bfloat16, device="cuda") for k in builds}
        part = torch.empty((-(-ic // 512), m, oc), dtype=torch.float32, device="cuda")
        plan = w4.gemv_plan(m, ic, oc, g, fmt, n_sm)

        def call(k, o=None):
            b = builds[k]
            o = outs[k] if o is None else o
            head = (x.data_ptr(), qw.data_ptr(), s.data_ptr(), sz.data_ptr(), None, o.data_ptr())
            if b.planned:
                err = b.fn[fmt](*head, m, ic, oc, g, plan.splits, plan.stages, 1, bf16, stream())
            else:
                err = b.fn[fmt](*head[:6], part.data_ptr(), m, ic, oc, g, 512, 1, bf16, stream())
            if err:
                raise RuntimeError(f"{k} {fmt} gemv: CUDA error {err}")

        times = {k: [] for k in list(builds) + ["matmul"]}
        order = list(builds) + ["matmul"]
        for _ in range(args.rounds):
            for k in order + order[::-1]:
                fn = (lambda: torch.matmul(x, w)) if k == "matmul" else (lambda k=k: call(k))
                times[k].append(timer(fn))
        torch.cuda.synchronize()
        a, c = outs["other"].float(), outs["checkout"].float()
        err = (a - c).abs().max().item()
        ok = err <= 2 ** -6 * a.abs().max().item()
        again = torch.empty_like(outs["checkout"])
        call("checkout", again)
        torch.cuda.synchronize()
        same = torch.equal(again, outs["checkout"])
        failed |= not (ok and same)
        kernels = {}
        for k in builds:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call(k)
                torch.cuda.synchronize()
            kernels[k] = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        med = {k: statistics.median(ts) for k, ts in times.items()}
        nbytes = m * ic * 2 + rows_q * oc * 4 + 2 * (ic // g) * oc * 4 + m * oc * 2
        bound_ms = nbytes / HBM * 1e3
        rows.append((model, wname, fmt, m, med["other"], med["checkout"], med["matmul"], bound_ms))
        print(f"{model} {wname} {fmt} M={m} {ic}->{oc} g{g} [{plan.tiles} tiles x "
              f"{plan.splits} splits, {plan.stages} slots]: "
              + "; ".join(f"{k} median {med[k]:.4f} ms (" + " ".join(f"{t:.4f}" for t in ts)
                          + ")" for k, ts in times.items())
              + f"; checkout/other {med['checkout'] / med['other']:.3f}, checkout/matmul "
              f"{med['checkout'] / med['matmul']:.3f}, checkout/bound "
              f"{med['checkout'] / bound_ms:.2f} (bound {bound_ms:.4f}); kernels a call "
              f"other {kernels['other']} checkout {kernels['checkout']}; "
              + (f"outputs within 2^-6 (max diff {err:.3e})" if ok
                 else f"outputs DIFFER (max diff {err:.3e})")
              + ("; two calls bit-equal" if same else "; two calls DIFFER"), flush=True)
        del qw, s, sz, w, part
        torch.cuda.empty_cache()
    print(f"{'case':<34} {'other':>8} {'checkout':>9} {'matmul':>8} {'bound':>8}")
    for model, wname, fmt, m, o, c, mm, bd in rows:
        print(f"{model + ' ' + wname + ' ' + fmt + ' M=' + str(m):<34} {o:8.4f} {c:9.4f} "
              f"{mm:8.4f} {bd:8.4f}")
    print(f"nvidia-smi: {smi}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
