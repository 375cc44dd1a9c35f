#!/usr/bin/env python3
"""A/B of the per-token int8 quantization (``quant_per_token``,
``csrc/w8a8.cu``) between builds on one NVIDIA GPU.

    python3 scripts/ab_quant_per_token.py OTHER/w8a8.cu [--reps 20] [--rounds 2]

OTHER is another tree's ``awq_tpu_torch/csrc`` (e.g. the parent commit's,
``git archive`` into ``build/parent``). Its ``w8a8.cu`` and the checkout's
are built with the port's nvcc flags and each tree's own headers (one nvcc
each, in parallel) into ``build/ab_quant_per_token/``; both export
``awq_quant_per_token(x, xq, sx, M, IC, dtype, perm, stream)``. Shapes: bf16
rows of Llama-3-8B's two input widths (IC 4096 and 14336) at M = 32, 40,
200, 512 and 1000, the natural channel order (K11's codes) and ``perm``
(K10's); f32 and f16 at M = 1000, IC 4096. The builds run in turns (in
order, then in reverse, ``--rounds`` times), each turn the median of
``--reps`` calls with the L2 flushed before each (``chip_smoke.Timer``),
beside the bound (each x byte read once, each code and scale written once,
at 3.35 TB/s) and the plain version's time. Every build's codes and scales
must equal the plain version's bit for bit; the script prints the card's
name and power limit and exits 1 otherwise.

With ``--floor`` it then asks what holds the checkout's kernel from its
bound, at M = 32 and 1000 of both widths (bf16, natural order): beside the
kernel it times a PyTorch cast of the same x into an int8 tensor (``copy_``:
one elementwise launch that reads the same x and writes the same bytes of
codes, with no reduction and no division) and an empty launch
(``torch.cuda._sleep(0)``), each by CUDA events (as above, L2 flushed) and
by its kernel's duration in a ``torch.profiler`` device trace (the median
over ``--reps`` calls, the L2 flushed before each, the flush's own kernel
left out). Where the cast takes what the kernel takes, the gap to the bound
is what one launch moving these bytes costs on this card, not the kernel's
reduction or division.
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

ROWS = (32, 40, 200, 512, 1000)
WIDTHS = (4096, 14336)


def build(src: Path, out: Path):
    from awq_tpu_torch import _build

    log = open(out.with_suffix(".log"), "w")
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src.parent),
                             "-o", str(out), str(src)], stdout=log, stderr=subprocess.STDOUT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="+", help="w8a8.cu sources to compare")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--floor", action="store_true",
                    help="then time the kernel beside a cast of the same bytes and an empty "
                         "launch, by events and in a device trace")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_quant_per_token: no CUDA device", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import w8a8 as q8
    from chip_smoke import HBM_BYTES_PER_S, Timer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out_dir = ROOT / "build" / "ab_quant_per_token"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {f"{i}:{src.parent.name}/{src.name}": (src.resolve(), out_dir / f"other{i}.so")
            for i, src in enumerate(args.other)}
    srcs["checkout"] = (_build.CSRC / "w8a8.cu", out_dir / "checkout.so")
    procs = [build(src, so) for src, so in srcs.values()]
    if any(p.wait() for p in procs):
        return 1
    fns = {}
    for name, (_, so) in srcs.items():
        fn = ctypes.CDLL(str(so)).awq_quant_per_token
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(5)
    timer = Timer(torch, reps=args.reps)
    cases = [(m, ic, torch.bfloat16, perm) for ic in WIDTHS for m in ROWS
             for perm in (False, True)]
    cases += [(1000, 4096, dt, perm) for dt in (torch.float32, torch.float16)
              for perm in (False, True)]
    bad = False
    for m, ic, dtype, perm in cases:
        x = (torch.randn((m, ic), generator=gen, device="cuda") * 3).to(dtype)
        qp, sp = q8.quant_per_token_plain(x)
        if perm:
            qp = q8.permute64(qp)
        outs = {n: (torch.empty((m, ic), dtype=torch.int8, device="cuda"),
                    torch.empty((m, 1), dtype=torch.float32, device="cuda")) for n in fns}

        def run(n):
            xq, sx = outs[n]
            err = fns[n](x.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, ic,
                         q8.DTYPE_CODE[dtype], int(perm),
                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{n}: CUDA error {err}")

        for n in fns:
            run(n)
        torch.cuda.synchronize()
        equal = {n: torch.equal(o[0], qp) and torch.equal(o[1], sp) for n, o in outs.items()}
        times = {n: [] for n in fns}
        order = list(fns)
        for _ in range(args.rounds):
            for n in order + order[::-1]:
                times[n].append(timer(lambda: run(n)))
        plain_ms = timer(lambda: q8.quant_per_token_plain(x), reps=5)
        bound = (m * ic * (x.element_size() + 1) + m * 4) / HBM_BYTES_PER_S * 1e3
        med = {n: statistics.median(ts) for n, ts in times.items()}
        print(f"M={m} IC={ic} {str(dtype).split('.')[-1]} {'perm' if perm else 'natural'}: "
              + "; ".join(f"{n} median {med[n]:.4f} ms (" + " ".join(f"{t:.4f}" for t in ts)
                          + f"), {'bit-equal' if equal[n] else 'DIFFERS'}"
                          for n, ts in times.items())
              + f"; checkout / other {med['checkout'] / med[order[0]]:.3f}; bound {bound:.4f} ms"
              f"; plain {plain_ms:.4f} ms", flush=True)
        bad |= not all(equal.values())
    if args.floor:
        floor(torch, q8, timer, gen, args.reps, HBM_BYTES_PER_S)
    return 1 if bad else 0


def traced_us(torch, fn, pattern: str, reps: int, flush) -> float:
    """Median duration (us) of the device-trace kernels whose name matches
    ``pattern`` over ``reps`` calls of ``fn``, the L2 flushed before each."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and re.search(pattern, e.name)]
    return statistics.median(us) if us else float("nan")


def floor(torch, q8, timer, gen, reps: int, hbm: float) -> None:
    """The kernel beside a cast moving the same bytes and an empty launch."""
    for ic in WIDTHS:
        for m in (32, 1000):
            x = (torch.randn((m, ic), generator=gen, device="cuda") * 3).to(torch.bfloat16)
            codes = torch.empty((m, ic), dtype=torch.int8, device="cuda")
            runs = {"kernel": (lambda: q8.quant_per_token(x), r"quant_per_token_kernel"),
                    "cast": (lambda: codes.copy_(x), r"copy"),
                    "empty": (lambda: torch.cuda._sleep(0), r"spin")}
            cells = []
            for name, (fn, pat) in runs.items():
                ev = timer(fn)
                dev = traced_us(torch, fn, pat, reps, timer.flush)
                cells.append(f"{name} {ev:.4f} ms by events, {dev:.2f} us in the trace")
            bound = (m * ic * 3 + m * 4) / hbm * 1e3
            print(f"floor M={m} IC={ic} bf16: " + "; ".join(cells) + f"; bound {bound:.4f} ms",
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
