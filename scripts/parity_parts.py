#!/usr/bin/env python3
"""Which part of the kernel path carries its logits' gap to the plain path,
on one NVIDIA GPU.

    python3 scripts/parity_parts.py

Builds ``chip_smoke.py``'s phase-4 models: the 2-layer Falcon-7B-width
model (W4-g64 layers and head, seed 1) and the 2-layer Llama-3-8B-width
model (W4-g128, seed 1) on the stacked path, bf16, and feeds each the
phase's tokens (a 100-token prefill, then 16 teacher-forced decode steps,
seed 3) through ``forward`` in these ways:

- ``kernels``: every kernel (K1, K3, and K14 for falcon or K2 for llama);
- ``plain K1`` / ``plain K3`` / ``plain K14`` (``plain K2``): the kernel
  path with that one wrapper swapped for its plain version;
- ``plain``: ``impl="plain"``, phase 4's reference;
- ``f32``: ``impl="plain"`` with f32 activations, norms, embedding and
  cache over the same W4 codes and f32 scales, the yardstick of both.

For each it prints the worst over the 17 steps of max_abs_err / max|ref|
of the last position's logits against ``plain`` (phase 4's figure) and
against ``f32``, the greedy ids' agreement with ``f32``, and the largest
difference of its cache from ``plain``'s; then each step's figure for
``kernels`` and ``plain`` against ``f32``. Prints the card's name and power
limit first.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def run(torch, params, cfg, steps, impl="auto", dtype=None):
    from awq_tpu_torch.models import llama

    cache = llama.init_cache(cfg, 1, 512, dtype or torch.bfloat16)
    pos, out = 0, []
    for toks in steps:
        logits, _ = llama.forward(params, cfg, toks, cache, pos, impl=impl)
        out.append(logits[:, -1].float())
        pos += toks.shape[1]
    return out, cache


def study(torch, label, cfg_dict, group, decode):
    """``decode``: (the decode kernel's name, the module whose global the
    forward path calls it by, that global's name)."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import decode_attn as da
    from awq_tpu_torch.ops import w4a16
    from chip_smoke import to_f32

    cfg = ModelConfig(**{**cfg_dict, "num_layers": 2})
    params = llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=group),
                                torch.Generator(device="cuda").manual_seed(1))
    params = llama.fuse_linears(llama.quantize_head(params, cfg), cfg)
    rng = torch.Generator().manual_seed(3)
    steps = [torch.randint(0, cfg.vocab_size, (1, 100), generator=rng)] + [
        torch.randint(0, cfg.vocab_size, (1, 1), generator=rng) for _ in range(16)]
    steps = [t.cuda() for t in steps]

    runs = {}
    runs["f32"] = run(torch, to_f32(torch, params), dataclasses.replace(cfg, dtype="float32"),
                      steps, impl="plain", dtype=torch.float32)
    runs["plain"] = run(torch, params, cfg, steps, impl="plain")
    runs["kernels"] = run(torch, params, cfg, steps)
    swaps = {"K1": (w4a16, "w4a16_matmul", w4a16.w4a16_matmul_plain),
             "K3": (llama, "flash_prefill", da.flash_prefill_plain),
             decode[0]: (decode[1], decode[2], getattr(da, decode[2] + "_plain"))}
    for name, (mod, attr, plain_fn) in swaps.items():
        kept = getattr(mod, attr)
        setattr(mod, attr, plain_fn)
        try:
            runs[f"plain {name}"] = run(torch, params, cfg, steps)
        finally:
            setattr(mod, attr, kept)

    ref, ref_cache = runs["plain"]
    f32, _ = runs["f32"]
    print(f"[{label}] {'variant':<12} {'vs plain':>10} {'vs f32':>10} {'ids = f32':>10} "
          f"{'cache vs plain':>15}")
    for name, (logits, cache) in runs.items():
        vs_plain = max(rel(a, b) for a, b in zip(logits, ref))
        vs_f32 = max(rel(a, b) for a, b in zip(logits, f32))
        agree = sum(int(a.argmax() == b.argmax()) for a, b in zip(logits, f32))
        cerr = (cache.float() - ref_cache.float()).abs().max().item()
        print(f"[{label}] {name:<12} {vs_plain:10.3e} {vs_f32:10.3e} {agree:>7}/{len(steps)} "
              f"{cerr:15.3e}")
    for name in ("kernels", "plain"):
        per = " ".join(f"{rel(a, b):.2e}" for a, b in zip(runs[name][0], f32))
        print(f"[{label}] {name} vs f32 per step: {per}")
    scale = max(b.abs().max().item() for b in f32)
    print(f"[{label}] largest |logit| (f32) {scale:.3f}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("parity_parts: no CUDA device", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build
    from awq_tpu_torch.models import layers, llama
    from chip_smoke import FALCON_7B, FALCON_G, G, LLAMA3_8B

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    _build.build_all(["decode_attn", "w4a16"])
    os.environ["AWQ_TPU_DISABLE_MEGAKERNEL"] = "1"     # llama on the stacked path
    study(torch, "falcon", FALCON_7B, FALCON_G, ("K14", layers, "flash_decode_layer"))
    study(torch, "llama", LLAMA3_8B, G, ("K2", llama, "flash_decode"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
