#!/usr/bin/env python3
"""A/B of K2 (flash decode), K8 (paged flash decode) and K9 (int8 flash
decode) between builds of ``csrc/decode_attn.cu`` on one NVIDIA GPU.

    python3 scripts/ab_flash_decode.py OTHER.cu [OTHER2.cu ...] [--reps 20] [--rounds 3]

Builds each OTHER.cu and the checkout's ``awq_tpu_torch/csrc/decode_attn.cu``
with the port's nvcc flags (one nvcc each, in parallel) into
``build/ab_flash_decode/``, then times K2 from each library at the smoke
script's shapes: batch 1 at 1000 and 4000 cached positions, and 8 rows of
ragged lengths 0..1200; and K8 on those 8 rows over a permuted pool of
pages of 256 (``chip_smoke.scatter_pages``); and K9 at batch 1 at 1000
cached positions over int8 codes and scales. The builds run in turns (each in order, then in
reverse, ``--rounds`` times), each turn the median of ``--reps`` calls
with the L2 flushed before each (``chip_smoke.Timer``); the script prints
every turn and the medians, with the card's name and power limit. All
builds get the same inputs and must give the same output bit for bit.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build(src: Path, out: Path):
    from awq_tpu_torch import _build

    log = open(out.with_suffix(".log"), "w")
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                             "-o", str(out), str(src)], stdout=log, stderr=subprocess.STDOUT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="+",
                    help="decode_attn.cu sources to compare with the checkout's")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_flash_decode: no CUDA device", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import decode_attn as da
    from chip_smoke import Timer, scatter_pages

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out_dir = ROOT / "build" / "ab_flash_decode"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {f"{i}:{src.parent.name}/{src.name}": (src.resolve(), out_dir / f"other{i}.so")
            for i, src in enumerate(args.other)}
    libs["checkout"] = (_build.CSRC / "decode_attn.cu", out_dir / "checkout.so")
    procs = [build(src, so) for src, so in libs.values()]
    if any(p.wait() for p in procs):
        return 1
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns, fns8, fns9 = {}, {}, {}
    for name, (_, so) in libs.items():
        lib = ctypes.CDLL(str(so))
        for table, entry, types in (
                (fns, "awq_flash_decode", [P] * 8 + [I] * 6 + [F] + [I] * 3 + [P]),
                (fns8, "awq_flash_decode_paged", [P] * 9 + [I] * 8 + [F] + [I] * 3 + [P]),
                (fns9, "awq_flash_decode_int8", [P] * 9 + [I] * 6 + [F, I, P])):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = types, ctypes.c_int
            table[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(1234)
    nq, nkv, hd, t, page = 32, 8, 128, 2048, 256
    ragged = [1000, 0, 930, 1100, 1015, 850, 1200, 977]
    cases = {"K2 B=1 len=1000": ([1000], ""), "K2 B=1 len=4000": ([4000], ""),
             "K2 B=8 ragged 0..1200": (ragged, ""),
             "K8 B=8 ragged 0..1200, pages of 256": (ragged, "paged"),
             "K9 B=1 len=1000, int8": ([1000], "int8")}
    timer = Timer(torch, reps=args.reps)
    bf16 = 1                          # the kernels' dtype code of bf16
    for label, (lens_l, mode) in cases.items():
        paged = mode == "paged"
        b, mx = len(lens_l), max(lens_l)
        tt = max(t, mx)
        cache = torch.randn((2, b, nkv, tt, hd), generator=gen, device="cuda").to(torch.bfloat16)
        q = torch.randn((b, nq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        kn, vn = (torch.randn((b, nkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        nsplit, split_len = da._split(mx, b * nkv)
        if paged:     # as flash_decode_paged: whole pages per split
            pool, tables = scatter_pages(torch, cache[None], tt // page, page, gen)
            split_len = -(-split_len // page) * page
            nsplit = max(1, -(-mx // split_len))
        ml = torch.empty((b, nkv, nsplit, nq // nkv, 2), dtype=torch.float32, device="cuda")
        acc = torch.empty((b, nkv, nsplit, nq // nkv, hd), dtype=torch.float32, device="cuda")
        outs = {name: torch.empty_like(q) for name in fns}

        if mode == "int8":
            codes = torch.randint(-127, 128, cache.shape, generator=gen, device="cuda",
                                  dtype=torch.int8)
            scales = torch.rand(cache.shape[:4], generator=gen, device="cuda") * 0.02

        def call(name):
            stream = torch.cuda.current_stream().cuda_stream
            if paged:
                err = fns8[name](q.data_ptr(), kn.data_ptr(), vn.data_ptr(), pool[0].data_ptr(),
                                 tables.data_ptr(), lens.data_ptr(), ml.data_ptr(),
                                 acc.data_ptr(), outs[name].data_ptr(), b, nq, nkv,
                                 pool.shape[2], page, tt // page, nsplit, split_len,
                                 1.0 / math.sqrt(hd), bf16, bf16, bf16, stream)
            elif mode == "int8":
                err = fns9[name](q.data_ptr(), kn.data_ptr(), vn.data_ptr(), codes.data_ptr(),
                                 scales.data_ptr(), lens.data_ptr(), ml.data_ptr(),
                                 acc.data_ptr(), outs[name].data_ptr(), b, nq, nkv, tt,
                                 nsplit, split_len, 1.0 / math.sqrt(hd), bf16, stream)
            else:
                err = fns[name](q.data_ptr(), kn.data_ptr(), vn.data_ptr(), cache.data_ptr(),
                                lens.data_ptr(), ml.data_ptr(), acc.data_ptr(),
                                outs[name].data_ptr(), b, nq, nkv, tt, nsplit, split_len,
                                1.0 / math.sqrt(hd), bf16, bf16, bf16, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        times = {name: [] for name in fns}
        order = list(fns)
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                times[name].append(timer(lambda: call(name)))
        torch.cuda.synchronize()
        same = all(torch.equal(o, outs["checkout"]) for o in outs.values())
        print(f"{label}: " + "; ".join(
            f"{name} median {statistics.median(ts):.4f} ms ("
            + " ".join(f"{x:.4f}" for x in ts) + ")" for name, ts in times.items())
            + f"; outputs {'equal' if same else 'DIFFER'}", flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
