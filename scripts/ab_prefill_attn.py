#!/usr/bin/env python3
"""A/B of K3 (causal flash prefill, ``csrc/decode_attn.cu``) between builds
on one NVIDIA GPU.

    python3 scripts/ab_prefill_attn.py OTHER/decode_attn.cu [--reps 20] [--rounds 2]

OTHER is another tree's ``awq_tpu_torch/csrc`` (e.g. the parent commit's,
``git archive`` into ``build/parent``). Its ``decode_attn.cu`` is built
beside the checkout's, with the port's nvcc flags and each tree's own
headers (two nvcc processes in parallel), into ``build/ab_prefill_attn/``.
Either build's ``awq_flash_prefill`` may take the host plan's row-tile
count (``ops/decode_attn.py::prefill_plan``) or not; the script reads
which from the source.

Shapes: Llama-3-8B (32 q heads over 8 kv heads, head_dim 128) and
Falcon-7B (71 q heads over one, head_dim 64), bf16 q and cache of 4096 /
2048 positions, B = 1: S = 512 from 0 and from 700, and S = 1000 from 0
(the 1000-token prompt), and the same over an f32 q and cache (K3's
``mma.sync`` mode). The builds run in turns (in order, then in
reverse, ``--rounds`` times), each turn the median of ``--reps`` calls
with the L2 flushed before each (``chip_smoke.Timer``); SDPA on the same
positions is timed once per shape as the library column. The script
prints each shape's turns, the medians and the ratio, whether the two
builds' outputs are equal bit for bit, with the card's name
and power limit, and checks that each build's output is within 2^-6 of
the largest magnitude of ``flash_prefill_plain``'s. It exits 1 if a check
fails.
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

# name -> (q heads, kv heads, head_dim, cache positions)
MODELS = {"llama3-8b": (32, 8, 128, 4096), "falcon-7b": (71, 1, 64, 2048)}
CHUNKS = ((512, 0), (512, 700), (1000, 0))     # (S, start)


class Build:
    """One tree's decode_attn library and how to call its K3 entry."""

    def __init__(self, src: Path, out_dir: Path, tag: str):
        self.src, self.so = src, out_dir / f"{tag}-decode_attn.so"
        self.planned = "int n_tiles" in src.read_text()

    def start(self):
        from awq_tpu_torch import _build

        log = open(self.so.with_suffix(".log"), "w")
        return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                                 str(self.src.parent), "-o", str(self.so), str(self.src)],
                                stdout=log, stderr=subprocess.STDOUT)

    def load(self):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.fn = ctypes.CDLL(str(self.so)).awq_flash_prefill
        self.fn.argtypes = [P] * 3 + [I] * (8 if self.planned else 7) + [F, I, I, P]
        self.fn.restype = I


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("decode_attn_cu", type=Path, help="the other tree's csrc/decode_attn.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ab_prefill_attn: no CUDA device", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import decode_attn as da
    from chip_smoke import Timer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out_dir = ROOT / "build" / "ab_prefill_attn"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {"other": Build(args.decode_attn_cu.resolve(), out_dir, "other"),
              "checkout": Build(_build.CSRC / "decode_attn.cu", out_dir, "checkout")}
    procs = [b.start() for b in builds.values()]
    if any(p.wait() for p in procs):
        print("ab_prefill_attn: a build failed (logs in build/ab_prefill_attn/)", flush=True)
        return 1
    for b in builds.values():
        b.load()

    gen = torch.Generator(device="cuda").manual_seed(2468)
    timer = Timer(torch, reps=args.reps)
    failed, rows = False, []
    for (model, (nq, nkv, hd, t)), dtype in [(m, torch.bfloat16) for m in MODELS.items()] + [
            (m, torch.float32) for m in MODELS.items()]:
        code = 1 if dtype == torch.bfloat16 else 0
        for s, start in CHUNKS:
            cache = torch.randn((2, 1, nkv, t, hd), generator=gen, device="cuda").to(dtype)
            q = torch.randn((1, s, nq, hd), generator=gen, device="cuda").to(dtype)
            ref = da.flash_prefill_plain(q, cache, start).float()
            plan = da.prefill_plan(1, s, nq, nkv, t, start, hd)
            outs = {k: torch.empty((1, s, nq * hd), dtype=dtype, device="cuda")
                    for k in builds}

            def call(k, q=q, cache=cache, start=start, s=s, plan=plan, code=code):
                b = builds[k]
                tiles = (plan.n_tiles,) if b.planned else ()
                err = b.fn(q.data_ptr(), cache.data_ptr(), outs[k].data_ptr(), 1, s, nq, nkv, t,
                           start, hd, *tiles, math.log2(math.e) / math.sqrt(hd), code, code,
                           torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{k} K3: CUDA error {err}")

            times = {k: [] for k in builds}
            for _ in range(args.rounds):
                for k in list(builds) + list(builds)[::-1]:
                    times[k].append(timer(lambda: call(k)))
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            errs = {k: (o.float() - ref).abs().max().item() for k, o in outs.items()}
            ok = all(e <= 2 ** -6 * scale for e in errs.values())
            failed |= not ok
            end = start + s
            k_all = cache[0, :, :, :end].contiguous()
            v_all = cache[1, :, :, :end].contiguous()
            qt = q.transpose(1, 2).contiguous()
            mask = (torch.arange(end, device="cuda")[None, :]
                    <= (start + torch.arange(s, device="cuda"))[:, None])
            lib = timer(lambda: F.scaled_dot_product_attention(qt, k_all, v_all, attn_mask=mask,
                                                               enable_gqa=True))
            med = {k: statistics.median(ts) for k, ts in times.items()}
            ratio = med["checkout"] / med["other"]
            rows.append((model, s, start, ratio))
            same = torch.equal(outs["checkout"], outs["other"])
            print(f"K3 {model} {str(dtype)[6:]} S={s} start={start} (blocks {plan.blocks}): "
                  + "; ".join(f"{k} median {med[k]:.4f} ms ("
                              + " ".join(f"{x:.4f}" for x in ts) + f"), err {errs[k]:.2e}"
                              for k, ts in times.items())
                  + f"; SDPA {lib:.4f}; checkout/other {ratio:.3f}; "
                  + ("within 2^-6 of the plain version" if ok else "OUTSIDE 2^-6")
                  + ("; the builds bit-equal" if same else "; the builds differ"), flush=True)
            del cache, q, k_all, v_all
            torch.cuda.empty_cache()
    slower = [r for r in rows if r[3] > 1.0]
    print(f"summary: {len(rows)} shapes, {len(slower)} slower than the other build"
          + "".join(f"; {m} S={s} start={st} {r:.3f}" for m, s, st, r in slower), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
