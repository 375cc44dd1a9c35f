#!/usr/bin/env python3
"""A/B of K4's llama units (``csrc/megakernel.cu``, units ``megakernel`` and
``megakernel_w3``) between builds on one NVIDIA GPU, in one process.

    python3 scripts/ab_k4_units.py OTHER/megakernel.cu [--reps 20] [--rounds 3]

OTHER is another tree's ``awq_tpu_torch/csrc`` (e.g. the parent commit's,
``git archive HEAD awq_tpu_torch/csrc | tar -x -C build/parent``). Its
``megakernel.cu`` is built with its own headers and the port's nvcc flags,
W4 and W3 (``-DAWQ_MEGA_W3``), beside the checkout's units, into
``build/ab_k4_units/`` (four nvcc processes in parallel), and each prints
ptxas' registers and spills per instance. Both builds take the same C entry
(``awq_mega_token``), so the checkout's wrapper launches either library:
at Llama-3-8B width over 32 random layers (``init_qparams``, seed 0) with a
W4 (W3) head, the layer entry at layer 5 over lengths 0, 1000 and 4000, and
the token entry at length 1000 with its position in device memory (the
2048-position bucket), each build in turns (in order, then in reverse,
``--rounds`` times), each turn the median of ``--reps`` calls with the L2
flushed before each (``chip_smoke.Timer``). The script prints every turn,
the medians, the ratio and whether the two builds' outputs (residual, k/v,
logits) are equal bit for bit, with the card's name and power limit. It
exits 1 if the builds' outputs differ.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="another tree's megakernel.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_k4_units: no CUDA device", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import megakernel as mk
    from awq_tpu_torch.ops.w4a16 import QLinear
    from chip_smoke import G, LLAMA3_8B, Timer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out_dir = ROOT / "build" / "ab_k4_units"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = args.other.resolve()
    builds, procs = {}, []
    for w3 in (0, 1):
        unit = "megakernel_w3" if w3 else "megakernel"
        so = out_dir / f"other_{unit}.so"
        log = open(so.with_suffix(".log"), "w")
        procs.append(subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DAWQ_MEGA_W3={w3}", "-I",
             str(src.parent), "-o", str(so), str(src)], stdout=log, stderr=subprocess.STDOUT))
        builds[unit] = so
    _build.build_all(["megakernel", "megakernel_w3"])
    if any(p.wait() for p in procs):
        return 1
    for unit, so in builds.items():
        for tag, text in (("checkout", _build.build_log(unit)),
                          ("other", so.with_suffix(".log").read_text())):
            regs = [line.split("Used")[1].strip() for line in text.splitlines()
                    if "registers" in line]
            spills = [line.strip() for line in text.splitlines()
                      if "spill" in line and not line.strip().startswith("0 bytes stack")]
            print(f"ptxas {unit} {tag}: {regs}; spills: {spills or 'none'}", flush=True)

    def use(unit, which):
        """Point the wrapper's library of ``unit`` at one build."""
        _build._LIBS.pop(unit, None)
        if which == "checkout":
            _build.load(unit)
            return
        lib = ctypes.CDLL(str(builds[unit]))
        lib.awq_error_string.restype = ctypes.c_char_p
        lib.awq_error_string.argtypes = [ctypes.c_int]
        _build._LIBS[unit] = lib

    timer = Timer(torch, reps=args.reps)
    bad = False
    for w3 in (False, True):
        unit = "megakernel_w3" if w3 else "megakernel"
        cfg = ModelConfig(**LLAMA3_8B)
        gen = torch.Generator(device="cuda").manual_seed(0)
        w_bit = 3 if w3 else 4
        params = llama.fuse_linears(llama.init_qparams(
            cfg, QuantConfig(w_bit=w_bit, group_size=G), gen), cfg)
        h_dim, vocab = cfg.hidden_size, cfg.vocab_size
        s_head = (torch.rand((h_dim // G, vocab), generator=gen, device="cuda") + 0.5) * 0.005
        head = QLinear(qweight=torch.randint(-(2**31), 2**31 - 1,
                                             (h_dim * 3 // 32 if w3 else h_dim // 8, vocab),
                                             generator=gen, dtype=torch.int32, device="cuda"),
                       scales=s_head, szeros=s_head * 2 ** (w_bit - 1), w_bit=w_bit, dense3=w3)
        la = params["layers"]
        lw = (la["wqkv"], la["wo"], la["wgateup"], la["down"], la["ln1"], la["ln2"])
        cache = llama.init_kv_cache(cfg, 1, 4096 + 64)
        cache.normal_(generator=gen)
        cos, sin = llama.rope_table(cfg, 4096 + 64, device="cuda")
        h = (torch.randn((1, h_dim), generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        kw = dict(nq=cfg.num_heads, nkv=cfg.num_kv_heads, eps=cfg.rms_eps)
        pos = torch.tensor([1000], dtype=torch.int32, device="cuda")
        cases = [(f"layer 5 len={n}",
                  lambda n=n: mk.w4a16_llama_layer_step(h, *lw, cos[n], sin[n], cache, 5, n,
                                                        **kw))
                 for n in (0, 1000, 4000)]
        cases.append(("32 layers + head, len=1000 (device position, bucket 2048)",
                      lambda: mk.w4a16_llama_token_step(h, *lw, cos, sin, cache, pos,
                                                        max_length=2047, whead=head,
                                                        norm_w=params["norm"], **kw)))
        for label, fn in cases:
            outs, times = {}, {"checkout": [], "other": []}
            for which in ("checkout", "other"):
                use(unit, which)
                outs[which] = [t.clone() for t in fn()]
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(outs["checkout"], outs["other"]))
            bad |= not same
            for _ in range(args.rounds):
                for which in ("checkout", "other", "other", "checkout"):
                    use(unit, which)
                    times[which].append(timer(fn))
            med = {k: statistics.median(v) for k, v in times.items()}
            print(f"K4 {'W3' if w3 else 'W4'} {label}: " + "; ".join(
                f"{k} median {med[k]:.4f} ms (" + " ".join(f"{x:.4f}" for x in v) + ")"
                for k, v in times.items())
                + f"; checkout/other {med['checkout'] / med['other']:.4f}; "
                + ("the builds bit-equal" if same else "the builds DIFFER"), flush=True)
        use(unit, "checkout")
        del params, la, lw, cache, head
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
