#!/usr/bin/env python3
"""Where one layer of K4 (``csrc/megakernel.cu``) spends its time: a copy of
the checkout's source with ``%globaltimer`` stamps at every phase boundary
of every block (thread 0), built into ``build/exp_mega_phases/`` (not part
of the port) and run through the layer entry at Llama-3-8B width.

    python3 scripts/exp_mega_phases.py [--lengths 0,1000] [--reps 5] [--variants base,nofence]
        [--token] [--other OTHER/megakernel.cu]

For each phase (QKV, attention, o-proj, gate/up, down) it prints the
medians over the grid's blocks, in microseconds, of: staging the input row
(for the attention, nothing), the phase's work, and the grid barrier after
it (the wait for the slowest block; after the attention, the combine phase
and both its barriers); and the time from the first block's
entry to the first phase and to the last barrier. The layer entry without
stamps is timed beside it (``chip_smoke.Timer``), and with ``--token`` the
token entry (32 layers and a W4 head at length 1000) of the checkout and of
each variant, with the card's name and power limit. Variants (joined by
``+``): ``base``; ``exact`` with exact codes (a bf16 subtract a pair) instead of codes
biased by 128; ``tworms`` with the rmsnorm staged in two passes. ``--other`` builds another tree's
``megakernel.cu`` (e.g. the parent's, ``git archive HEAD~
awq_tpu_torch/csrc | tar -x -C build/parent``) with its own headers and
times its layer and token entries in turns with the checkout's.
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

STAMP_DEF = r"""
__device__ unsigned long long mk_stamps[1024][24];
#define MK_STAMP(k) if (threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); mk_stamps[blockIdx.x][k] = t_; }
"""
STAMP_GET = r"""
extern "C" int awq_mk_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, mk_stamps, sizeof(mk_stamps));
}
"""
# (anchor, text inserted before it); anchors are searched in order
POINTS = [
    ("  float* part = static_cast<float*>(a.h_out);", "  MK_STAMP(0);\n"),
    ("  for (int li = 0; li < a.n_layers; ++li) {", "  MK_STAMP(1);\n"),
    ("      for (int t = vb; t < nt; t += gridDim.x) {\n        const float v = gemv_tile(xa, xsum, w, s, z, H, oq,",
     "      MK_STAMP(2);\n"),
    ("    grid.sync();\n    // ---- phase 2", "    MK_STAMP(3);\n"),
    ("    {\n      float* sq = xs;", "    MK_STAMP(4);\n"),
    ("    grid.sync();\n    // ---- phase 3", "    MK_STAMP(5);\n"),
    ("    {\n      const int nt = H / TILE, ic = nq * MK_HD;", "    MK_STAMP(6);\n"),
    ("      for (int t = vb; t < nt; t += gridDim.x) {\n        const float v = gemv_tile(xa, xsum, w, s, z, ic, H,",
     "      MK_STAMP(7);\n"),
    ("    if constexpr (MODE == MODE_LAYERS) grid.sync();\n    }\n    if constexpr (MLP)", "    MK_STAMP(8);\n"),
    ("    // ---- phase 5", "    MK_STAMP(9);\n"),
    ("      for (int t = vb; t < nt; t += gridDim.x) {\n        const float gt", "      MK_STAMP(10);\n"),
    ("    grid.sync();\n    // ---- phase 6", "    MK_STAMP(11);\n"),
    ("      const int32_t* w = a.dn_w", "      MK_STAMP(12);\n"),
    ("      for (int t = vb; t < nt; t += gridDim.x) {\n        const float v = gemv_tile(xa, xsum, w, s, z, I, H,",
     "      MK_STAMP(13);\n"),
    ("    if constexpr (MODE == MODE_LAYERS) grid.sync();\n    }\n  }\n", "    MK_STAMP(14);\n"),
    ("  if constexpr (MODE != MODE_LAYERS) return;", "  MK_STAMP(15);\n"),
]
# (phase, start, work starts, work ends, after the barrier); the attention's
# "barrier" holds the combine phase and its second barrier
PHASES = [("qkv", 1, 2, 3, 4), ("attention", 4, 4, 5, 6), ("o", 6, 7, 8, 9),
          ("gate/up", 9, 10, 11, 12), ("down", 12, 13, 14, 15)]


def variant(src: str, name: str = "base") -> str:
    for part in name.split("+"):
        src = _change(src, part)
    pos = 0
    for anchor, text in POINTS:
        i = src.index(anchor, pos)
        src = src[:i] + text + src[i:]
        pos = i + len(text) + len(anchor)
    i = src.index("namespace {")
    src = src[:i] + STAMP_DEF + src[i:]
    return src + STAMP_GET


def _change(src: str, part: str) -> str:
    def sub(old, new):
        assert old in src, (part, old)
        return src.replace(old, new)

    if part == "base":
        pass
    elif part == "exact":          # exact codes (a bf16 subtract a pair), no 128 bias
        src = sub("biased_pair<UNIT_W3>(p0[j], q0[j], t)", "code_pair<UNIT_W3>(p0[j], q0[j], t)")
        src = sub("biased_pair<UNIT_W3>(p1[j], q1[j], t)", "code_pair<UNIT_W3>(p1[j], q1[j], t)")
        src = sub("xs * fmaf(128.f, ss[e][j], zz[e][j]);", "xs * zz[e][j];")
    elif part == "tworms":         # the rmsnorm staged in two passes
        src = sub("  if (n / 2 > SU * MK_THREADS) {\n    float ss = 0.f;", "  if (true) {\n    float ss = 0.f;")
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lengths", default="0,1000")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", default="base")
    ap.add_argument("--token", action="store_true", help="also time the token entry")
    ap.add_argument("--other", type=Path, help="another tree's csrc/megakernel.cu")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exp_mega_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from awq_tpu_torch import _build
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import megakernel as mk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out = ROOT / "build" / "exp_mega_phases"
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        (out / f.name).write_text(f.read_text())
    names = args.variants.split(",")
    procs = {}
    for name in names:
        (out / f"megakernel_{name}.cu").write_text(
            variant((_build.CSRC / "megakernel.cu").read_text(), name))
        log = open(out / f"build_{name}.log", "w")
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DAWQ_MEGA_W3=0", "-I", str(out), "-o",
             str(out / f"megakernel_{name}.so"), str(out / f"megakernel_{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    if args.other:
        procs["other"] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DAWQ_MEGA_W3=0", "-I",
             str(args.other.resolve().parent), "-o", str(out / "megakernel_other.so"),
             str(args.other.resolve())], stdout=open(out / "build_other.log", "w"),
            stderr=subprocess.STDOUT)
    _build.build_all(["megakernel"])
    plain_lib = _build.load("megakernel")
    libs = {}
    for name, p in procs.items():
        if p.wait():
            print((out / f"build_{name}.log").read_text()[-4000:])
            return 1
        lib = ctypes.CDLL(str(out / f"megakernel_{name}.so"))
        lib.awq_error_string.restype = ctypes.c_char_p
        lib.awq_error_string.argtypes = [ctypes.c_int]
        libs[name] = lib
    other_lib = libs.pop("other", None)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4321)
    cfg = ModelConfig(**cs.LLAMA3_8B)
    params = llama.fuse_linears(llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=128),
                                                   gen), cfg)
    la = params["layers"]
    lins = (la["wqkv"], la["wo"], la["wgateup"], la["down"], la["ln1"], la["ln2"])
    cache = llama.init_kv_cache(cfg, 1, 4160)
    cache.normal_(generator=gen)
    cos, sin = llama.rope_table(cfg, 4160, device=dev)
    timer = cs.Timer(torch, 20)
    buf = np.zeros((1024, 24), dtype=np.uint64)
    for length in [int(v) for v in args.lengths.split(",")]:
        h = (torch.randn((1, cfg.hidden_size), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        step = (h, *lins, cos[length], sin[length], cache, 5, length, cfg.num_heads,
                cfg.num_kv_heads, cfg.rms_eps)
        ab = [("checkout", plain_lib)] + ([("other", other_lib)] if other_lib else [])
        turns = {k: [] for k, _ in ab}
        for k, lib in ab + ab[::-1]:
            _build._LIBS["megakernel"] = lib
            turns[k].append(timer(lambda: mk.w4a16_llama_layer_step(*step)))
        _build._LIBS["megakernel"] = plain_lib
        print(f"len {length}: layer entry " + "; ".join(
            f"{k} {statistics.median(v):.4f} ms ({' '.join(f'{x:.4f}' for x in v)})"
            for k, v in turns.items()) + " (no stamps)", flush=True)
        for name, lib in libs.items():
            _build._LIBS["megakernel"] = lib
            runs = []
            for _ in range(args.reps):
                cs.Timer(torch, 1)(lambda: mk.w4a16_llama_layer_step(*step), reps=1)
                torch.cuda.synchronize()
                lib.awq_mk_stamps(ctypes.c_void_p(buf.ctypes.data))
                runs.append(buf[:132].astype(np.float64).copy())
            stamped = timer(lambda: mk.w4a16_llama_layer_step(*step))
            _build._LIBS["megakernel"] = plain_lib
            med = lambda f: statistics.median(f(r) for r in runs)
            t0 = lambda r: r[:, 0].min()
            line = [f"  {name}: {stamped:.4f} ms with stamps;"]
            for pname, a, b, c, d in PHASES:
                stage = med(lambda r: np.median(r[:, b] - r[:, a]) / 1e3)
                work = med(lambda r: np.median(r[:, c] - r[:, b]) / 1e3)
                barrier = med(lambda r: np.median(r[:, d] - r[:, c]) / 1e3)
                line.append(f"{pname}: stage {stage:.2f}, work {work:.2f}, barrier {barrier:.2f};")
            span = med(lambda r: (np.median(r[:, 15]) - t0(r)) / 1e3)
            start = med(lambda r: (np.median(r[:, 1]) - t0(r)) / 1e3)
            line.append(f"start {start:.2f}; to the last barrier {span:.2f} (us)")
            print(" ".join(line), flush=True)
    if args.token:
        from awq_tpu_torch.ops.w4a16 import QLinear

        H, V = cfg.hidden_size, cfg.vocab_size
        s = (torch.rand((H // 128, V), generator=gen, device=dev) + 0.5) * 0.005
        head = dict(whead=QLinear(qweight=torch.randint(-(2**31), 2**31 - 1, (H // 8, V),
                                                        generator=gen, dtype=torch.int32,
                                                        device=dev),
                                  scales=s, szeros=s * 8), norm_w=params["norm"])
        h = (torch.randn((1, H), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        step = (h, *lins, cos[1000], sin[1000], cache, 1000, cfg.num_heads, cfg.num_kv_heads,
                cfg.rms_eps)
        runs = [("checkout", plain_lib)] + ([("other", other_lib)] if other_lib else [])
        runs += list(libs.items())
        for name, lib in runs + runs[::-1]:
            _build._LIBS["megakernel"] = lib
            print(f"token entry (32 layers + head, len 1000) {name}: "
                  f"{timer(lambda: mk.w4a16_llama_token_step(*step, **head)):.4f} ms", flush=True)
        _build._LIBS["megakernel"] = plain_lib
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
