#!/usr/bin/env python3
"""A/B of the split flash decode, K2, K8, K9 and K14, between builds of
``csrc/decode_attn.cu`` on one NVIDIA GPU.

    python3 scripts/ab_flash_decode.py OTHER.cu [OTHER2.cu ...] [--reps 20] [--rounds 3] [--ptxas]

Builds each OTHER.cu and the checkout's ``awq_tpu_torch/csrc/decode_attn.cu``
with the port's nvcc flags (one nvcc each, in parallel) into
``build/ab_flash_decode/`` and reads from each source which C signatures it
has: the planned one-launch entries (``ops/decode_attn.py::decode_plan``),
those that also append the current token (K2, K8 and K9 with the append's
destination, here the cache itself: every case's rows end before T, so the
write lands past what any launch reads; K9 also with its append source
``k_app``, ``v_app``, here the token again),
or the earlier split-and-combine entries with their partial buffers, whose
split rule this script keeps (``_old_split``). Then it times, at the smoke
script's shapes: K2 at batch 1 at 1, 1000 and 4000 cached positions and on
8 rows of ragged lengths 0..1200; K8 on those 8 rows over a permuted pool
of pages of 256 (``chip_smoke.scatter_pages``); K9 at batch 1 at 1000 and
4000 positions over int8 codes and scales; K14 at Falcon-7B's shape (71 q
heads over one kv head, head_dim 64) at 1, 1000 and 2047 positions and at
Llama-3-8B's (32 over 8, head_dim 128) at 1000 and 4000, and at 8 rows of
1000. The builds run in turns (each in order, then in reverse, ``--rounds``
times), each turn the median of ``--reps`` calls with the L2 flushed before
each (``chip_smoke.Timer``), with SDPA on the same positions beside them;
the script prints every turn and the medians with the card's name and power
limit. Every build's output must lie within 2^-6 of the largest magnitude
of its plain version's; the builds' mutual max difference is printed (the
numerics differ on purpose between designs) with whether every build's
output equals the first's bit for bit, and inside each build K8's output
must equal K2's bit for bit on the same rows. With ``--ptxas`` it first
builds every source as each of the three units (``decode_attn``,
``decode_attn_wide``, ``decode_attn_alibi``: the defines of ``_build.UNITS``)
and prints each kernel instance's registers and spill bytes per build, and
the instances where they differ.
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

TOL = 2.0 ** -6


def build(src: Path, out: Path, defines=()):
    from awq_tpu_torch import _build

    log = open(out.with_suffix(".log"), "w")
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                             "-I", str(_build.CSRC), "-o", str(out), str(src)], stdout=log,
                            stderr=subprocess.STDOUT)


def ptxas_usage(log: str) -> dict:
    """{kernel instance: (registers, spill stores, spill loads)} from a
    ``-Xptxas -v`` log, the instance's mangled name with its anonymous
    namespace (a hash of the file) cut out, so that builds compare."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", m.group(1))
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn] = out.get(fn, (0, 0, 0))[:1] + (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn] = (int(m.group(1)),) + out.get(fn, (0, 0, 0))[1:]
    return out


def compare_ptxas(srcs: dict, out_dir: Path) -> None:
    """Build every source as each decode unit and print the instances'
    registers and spills side by side."""
    from awq_tpu_torch import _build

    units = {u: _build.UNITS[u][1]
             for u in ("decode_attn", "decode_attn_wide", "decode_attn_alibi")}
    jobs = {(name, u): (src, out_dir / f"ptxas-{name.split(':')[0]}-{u}.so", d)
            for name, (src, _) in srcs.items() for u, d in units.items()}
    procs = {k: build(src, so, d) for k, (src, so, d) in jobs.items()}
    for k, proc in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {k}")
    names = list(srcs)
    for u in units:
        use = {n: ptxas_usage(jobs[(n, u)][1].with_suffix(".log").read_text()) for n in names}
        keys = sorted(set().union(*use.values()))
        differ = 0
        for key in keys:
            cells = [use[n].get(key) for n in names]
            same = all(c == cells[0] for c in cells)
            differ += not same
            print(f"ptxas {u} {key[:120]}: " + "; ".join(
                f"{n} " + (f"{c[0]} registers, spills {c[1]}/{c[2]} B" if c else "absent")
                for n, c in zip(names, cells)) + ("" if same else "  <- differs"), flush=True)
        print(f"ptxas {u}: {len(keys)} instances, {differ} differ across the builds", flush=True)


def _old_split(max_length: int, rows: int) -> tuple:
    """The split-and-combine kernels' (nsplit, split_len): 264 blocks, at
    least 64 positions a split, 32-position tiles."""
    want = max(1, -(-264 // rows))
    split_len = max(64, -(-max_length // want))
    split_len = -(-split_len // 32) * 32
    return max(1, -(-max_length // split_len)), split_len


class Build:
    """One library's four entries behind one call signature per kernel."""

    def __init__(self, so: Path, planned: bool, dev_len: bool = False, fused: bool = False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib, self.planned, self.dev_len = ctypes.CDLL(str(so)), planned, dev_len
        self.fused = fused
        sigs = ({"awq_flash_decode": [P] * 7 + [I] * 8 + [F] + [I] * 3 + [P],
                 "awq_flash_decode_paged": [P] * 8 + [I] * 10 + [F] + [I] * 3 + [P],
                 "awq_flash_decode_int8": [P] * 11 + [I] * 8 + [F, I, I, P],
                 "awq_flash_decode_layer": [P] * 5 + [I] * 10 + [F, I, I, P]}
                if fused else
                {"awq_flash_decode": [P] * 6 + [I] * 8 + [F] + [I] * 3 + [P],
                 "awq_flash_decode_paged": [P] * 7 + [I] * 10 + [F] + [I] * 3 + [P],
                 "awq_flash_decode_int8": [P] * 7 + [I] * 8 + [F, I, P],
                 "awq_flash_decode_layer": [P] * (4 + dev_len) + [I] * 10 + [F, I, I, P]}
                if planned else
                {"awq_flash_decode": [P] * 8 + [I] * 6 + [F] + [I] * 3 + [P],
                 "awq_flash_decode_paged": [P] * 9 + [I] * 8 + [F] + [I] * 3 + [P],
                 "awq_flash_decode_int8": [P] * 9 + [I] * 6 + [F, I, P],
                 "awq_flash_decode_layer": [P] * 6 + [I] * 8 + [F, I, I, P]})
        for name, types in sigs.items():
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = types, ctypes.c_int

    def run(self, torch, da, case, out, bufs):
        """Launch ``case`` (see main) into ``out``; ``bufs`` caches the
        earlier design's partial buffers."""
        mode, a = case["mode"], case["args"]
        q = a["q"]
        b, nq, hd = q.shape
        stream = torch.cuda.current_stream().cuda_stream
        scale, bf16 = 1.0 / math.sqrt(hd), 1
        if mode == "layer":
            k, v, length = a["k"], a["v"], a["length"]
            nkv, t = k.shape[1], k.shape[2]
            if self.planned:
                p = da.decode_plan(b, nq, nkv, hd, length, 2, da.PLAN_UNIT["flash_decode_layer"],
                                   cur=False)
                # a build whose K14 can read its length on the device takes a
                # null pointer for a host length
                ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()) + (
                    (None,) if self.dev_len else ())
                err = self.lib.awq_flash_decode_layer(
                    *ptrs, b, nq, nkv, t, length, hd, p.cluster, p.per, p.stages, p.smem,
                    scale, bf16, bf16, stream)
            else:
                ns, sl = _old_split(length, b * nkv * -(-(nq // nkv) // 8))
                ml, acc = self._parts(torch, bufs, b, nkv, ns, nq // nkv, hd)
                err = self.lib.awq_flash_decode_layer(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), ml.data_ptr(), acc.data_ptr(),
                    out.data_ptr(), b, nq, nkv, t, length, ns, sl, hd, scale, bf16, bf16,
                    stream)
        else:
            kn, vn, lens, mx = a["kn"], a["vn"], a["lens"], a["mx"]
            # a build that appends takes the cache itself as the destination
            # (K9 also the token again as its append source)
            app = (kn.data_ptr(), vn.data_ptr()) if self.fused else ()
            if mode == "paged":
                pool, tables, page = a["pool"], a["tables"], a["page"]
                nkv, mp = pool.shape[3], tables.shape[1]
                dst = (pool[0].data_ptr(),) if self.fused else ()
                head = (q.data_ptr(), kn.data_ptr(), vn.data_ptr(), pool[0].data_ptr(), *dst,
                        tables.data_ptr(), lens.data_ptr())
                dims = (b, nq, nkv, pool.shape[2], page, mp)
                tail = (scale, bf16, bf16, bf16, stream)
                fn, esize, unit = self.lib.awq_flash_decode_paged, 2, "flash_decode_paged"
            elif mode == "int8":
                codes, scales = a["codes"], a["scales"]
                nkv = codes.shape[2]
                dst = (codes.data_ptr(), scales.data_ptr()) if self.fused else ()
                head = (q.data_ptr(), kn.data_ptr(), vn.data_ptr(), *app, codes.data_ptr(),
                        scales.data_ptr(), *dst, lens.data_ptr())
                dims = (b, nq, nkv, codes.shape[3])
                tail = (scale, bf16, *((bf16,) if self.fused else ()), stream)
                fn, esize, unit = self.lib.awq_flash_decode_int8, 1, "flash_decode_int8"
                page = 0
            else:
                cache = a["cache"]
                nkv = cache.shape[2]
                dst = (cache.data_ptr(),) if self.fused else ()
                head = (q.data_ptr(), kn.data_ptr(), vn.data_ptr(), cache.data_ptr(), *dst,
                        lens.data_ptr())
                dims = (b, nq, nkv, cache.shape[3])
                tail = (scale, bf16, bf16, bf16, stream)
                fn, esize, unit, page = self.lib.awq_flash_decode, 2, "flash_decode", 0
            if self.planned:
                p = da.decode_plan(b, nq, nkv, hd, mx, esize, da.PLAN_UNIT[unit], page)
                err = fn(*head, out.data_ptr(), *dims, p.cluster, p.per, p.stages, p.smem, *tail)
            else:
                ns, sl = _old_split(mx, b * nkv)
                if mode == "paged" and page % 32 == 0:   # whole pages a split
                    sl = -(-sl // page) * page
                    ns = max(1, -(-mx // sl))
                ml, acc = self._parts(torch, bufs, b, nkv, ns, nq // nkv, hd)
                err = fn(*head, ml.data_ptr(), acc.data_ptr(), out.data_ptr(), *dims, ns, sl,
                         *tail)
        if err:
            raise RuntimeError(f"{case['label']}: CUDA error {err}")

    @staticmethod
    def _parts(torch, bufs, b, nkv, ns, g, hd):
        key = (b, nkv, ns, g, hd)
        if key not in bufs:
            bufs[key] = (torch.empty((b, nkv, ns, g, 2), device="cuda"),
                         torch.empty((b, nkv, ns, g, hd), device="cuda"))
        return bufs[key]


def make_cases(torch, gen):
    """The smoke script's K2/K8/K9/K14 shapes, each with its plain version
    and its SDPA call."""
    import torch.nn.functional as F

    from awq_tpu_torch.ops import cache_append as ca
    from awq_tpu_torch.ops import decode_attn as da
    from chip_smoke import RAGGED, scatter_pages

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def sdpa(q, k_all, v_all, mask=None):
        m = None if mask is None else mask[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(q[:, :, None], k_all, v_all,
                                                      attn_mask=m, enable_gqa=True)

    cases = []
    nq, nkv, hd = 32, 8, 128
    for lens_l in ([1], [1000], [4000], RAGGED):
        b, mx = len(lens_l), max(lens_l)
        t = 4096 if b == 1 else 2048
        cache, q, kn, vn = rnd(2, b, nkv, t, hd), rnd(b, nq, hd), rnd(b, nkv, hd), rnd(b, nkv, hd)
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        k_all = torch.cat([cache[0, :, :, :mx], kn[:, :, None]], dim=2)
        v_all = torch.cat([cache[1, :, :, :mx], vn[:, :, None]], dim=2)
        mask = torch.arange(mx + 1, device="cuda")[None, :] < lens[:, None]
        mask[:, mx] = True
        what = f"B=1 len={mx}" if b == 1 else f"B={b} ragged 0..{mx}"
        args = dict(q=q, kn=kn, vn=vn, lens=lens, mx=mx, cache=cache)
        cases.append(dict(label=f"K2 {what}", mode="contig", args=args,
                          plain=lambda a=args: da.flash_decode_plain(
                              a["q"], a["kn"], a["vn"], a["cache"], a["lens"], max_length=a["mx"]),
                          sdpa=sdpa(q, k_all, v_all, mask)))
        if b > 1:   # K8 on the same rows over a permuted pool of pages of 256
            pool, tables = scatter_pages(torch, cache[None], t // 256, 256, gen)
            argp = dict(args, pool=pool, tables=tables, page=256)
            cases.append(dict(label=f"K8 {what}, pages of 256", mode="paged", args=argp,
                              same_as=len(cases) - 1,
                              plain=lambda a=argp: da.flash_decode_paged_plain(
                                  a["q"], a["kn"], a["vn"], a["pool"], a["tables"], 0, a["lens"],
                                  max_length=a["mx"]),
                              sdpa=sdpa(q, k_all, v_all, mask)))
    for mx in (1000, 4000):
        codes, scales = ca.quantize_kv(torch.randn((2, 1, nkv, 4096, hd), generator=gen,
                                                   device="cuda"))
        deq = ca.dequantize_kv(codes, scales, torch.bfloat16)
        q, kn, vn = rnd(1, nq, hd), rnd(1, nkv, hd), rnd(1, nkv, hd)
        lens = torch.tensor([mx], dtype=torch.int32, device="cuda")
        args = dict(q=q, kn=kn, vn=vn, lens=lens, mx=mx, codes=codes, scales=scales)
        k_all = torch.cat([deq[0, :, :, :mx], kn[:, :, None]], dim=2)
        v_all = torch.cat([deq[1, :, :, :mx], vn[:, :, None]], dim=2)
        cases.append(dict(label=f"K9 B=1 len={mx}, int8", mode="int8", args=args,
                          plain=lambda a=args: da.flash_decode_int8_plain(
                              a["q"], a["kn"], a["vn"], a["codes"], a["scales"], a["lens"],
                              max_length=a["mx"]),
                          sdpa=sdpa(q, k_all, v_all)))
    for b, nq_l, nkv_l, hd_l, t, lengths, name in (
            (1, 71, 1, 64, 2048, (1, 1000, 2047), "Falcon-7B"),
            (1, 32, 8, 128, 4096, (1000, 4000), "Llama-3-8B"),
            (8, 32, 8, 128, 4096, (1000,), "Llama-3-8B")):
        kv, q = rnd(2, b, nkv_l, t, hd_l), rnd(b, nq_l, hd_l)
        for length in lengths:
            args = dict(q=q, k=kv[0], v=kv[1], length=length)
            k_l, v_l = kv[0, :, :, :length].contiguous(), kv[1, :, :, :length].contiguous()
            cases.append(dict(label=f"K14 {name} B={b} len={length}", mode="layer", args=args,
                              plain=lambda a=args: da.flash_decode_layer_plain(
                                  a["q"], a["k"], a["v"], a["length"]),
                              sdpa=sdpa(q, k_l, v_l)))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="+",
                    help="decode_attn.cu sources to compare with the checkout's")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true",
                    help="first compare the three decode units' registers and spills")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_flash_decode: no CUDA device", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import decode_attn as da
    from chip_smoke import Timer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out_dir = ROOT / "build" / "ab_flash_decode"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {f"{i}:{src.parent.name}/{src.name}": (src.resolve(), out_dir / f"other{i}.so")
            for i, src in enumerate(args.other)}
    srcs["checkout"] = (_build.CSRC / "decode_attn.cu", out_dir / "checkout.so")
    if args.ptxas:
        compare_ptxas(srcs, out_dir)
    procs = [build(src, so) for src, so in srcs.values()]
    if any(p.wait() for p in procs):
        return 1
    builds = {name: Build(so, "part_ml" not in src.read_text(),
                          "const int* lenp" in src.read_text(), "k_app" in src.read_text())
              for name, (src, so) in srcs.items()}
    print("builds: " + "; ".join(
        f"{n} ({'planned, one launch' if b.planned else 'split + combine'}"
        f"{', appends' if b.fused else ''})" for n, b in builds.items()), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    timer = Timer(torch, reps=args.reps)
    cases = make_cases(torch, gen)
    outs = []
    bad = False
    for case in cases:
        q = case["args"]["q"]
        ref = case["plain"]().float()
        scale = ref.abs().max().item()
        out = {name: torch.empty_like(q) for name in builds}
        bufs = {name: {} for name in builds}
        for name, bld in builds.items():
            bld.run(torch, da, case, out[name], bufs[name])
        torch.cuda.synchronize()
        errs = {name: (o.float() - ref).abs().max().item() for name, o in out.items()}
        mutual = max((out[a].float() - out[c].float()).abs().max().item()
                     for a in builds for c in builds)
        first = next(iter(out.values()))
        equal = all(torch.equal(o, first) for o in out.values())
        times = {name: [] for name in builds}
        order = list(builds)
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                times[name].append(timer(lambda: builds[name].run(torch, da, case, out[name],
                                                                  bufs[name])))
        sdpa_ms = timer(case["sdpa"])
        torch.cuda.synchronize()
        line = f"{case['label']}: " + "; ".join(
            f"{name} median {statistics.median(ts):.4f} ms ("
            + " ".join(f"{x:.4f}" for x in ts) + f"), max err {errs[name]:.3e}"
            for name, ts in times.items())
        line += (f"; SDPA {sdpa_ms:.4f} ms; builds' max diff {mutual:.3e} (tol {TOL:g}*{scale:.3e})"
                 f"; outputs {'bit-equal across builds' if equal else 'DIFFER across builds'}")
        if "same_as" in case:
            same = {name: torch.equal(out[name], outs[case["same_as"]][name]) for name in builds}
            line += "; K8 = K2 " + ", ".join(f"{n} {'equal' if e else 'DIFFERS'}"
                                             for n, e in same.items())
            bad |= not all(same.values())
        print(line, flush=True)
        bad |= any(e > TOL * scale for e in errs.values())
        outs.append(out)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
