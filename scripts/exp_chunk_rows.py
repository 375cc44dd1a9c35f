#!/usr/bin/env python3
"""How far single rows of K5's window move against the plain version, and
which of the attention's roundings moves them: at Llama-3-8B width (32
layers, random W4 weights and a bf16 cache filled at random, the seeds of
``scripts/exp_chunk_phases.py``), one window of S rows at hist, the kernel
and the plain version with the attention's f32 replaced by each rounding in
turn (P to bf16; the window's own v to bf16; the window's own k and v to
bf16). For each, the three (layer, kv head, window row) of k and v that move
most, against the layer's largest value.

    python3 scripts/exp_chunk_rows.py [--skip 11] [--shape 16:700] [--layers 32]

``--skip`` random windows are drawn (and dropped) first, alternately of 32
and 16 rows, so that a window of a longer search can be read again.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def worst(got, ref, i, n=3):
    """The n (layer, kv head, row, relative error) of output i that move most."""
    e = ((got[i].float() - ref[i].float()).abs().amax(dim=3)
         / ref[i].float().abs().amax(dim=(1, 2, 3))[:, None, None])
    top = torch.topk(e.flatten(), n)
    return [(int(j) // (e.shape[1] * e.shape[2]), (int(j) // e.shape[2]) % e.shape[1],
             int(j) % e.shape[2], round(v.item(), 4)) for v, j in zip(top.values, top.indices)]


def rounded_attention(p_round, k_round, v_round):
    """``attend_window`` with P, or the window's own k or v, in bf16."""

    def attend(qs, keys, vals, hist, dtype):
        k, v = keys.clone(), vals.clone()
        if k_round:
            k[:, hist:] = k[:, hist:].to(torch.bfloat16).float()
        if v_round:
            v[:, hist:] = v[:, hist:].to(torch.bfloat16).float()
        s = qs.shape[0]
        causal = torch.arange(s)[None, :] <= torch.arange(s)[:, None]
        mask = torch.cat([torch.ones((s, hist), dtype=torch.bool), causal], dim=1).to(qs.device)
        sc = torch.einsum("ikgh,kth->kgit", qs, k).masked_fill(~mask, float("-inf"))
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        lsum = p.sum(-1, keepdim=True)
        if p_round:
            p = p.to(torch.bfloat16).float()
        return torch.einsum("kgit,kth->ikgh", p / lsum, v)

    return attend


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip", type=int, default=11)
    ap.add_argument("--shape", default="16:700")
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("exp_chunk_rows: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from awq_tpu_torch import _build
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import megakernel_chunk as mkc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    _build.build_all([u for u in _build.UNITS if "chunk" in u])
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4321)
    cfg = ModelConfig(**dict(cs.LLAMA3_8B, num_layers=args.layers))
    params = llama.fuse_linears(llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=128),
                                                   gen), cfg)
    la = params["layers"]
    lins = (la["wqkv"], la["wo"], la["wgateup"], la["down"], la["ln1"], la["ln2"])
    cache = llama.init_kv_cache(cfg, 1, 4160)
    cache.normal_(generator=gen)
    cos, sin = llama.rope_table(cfg, 4160, device=dev)
    for t in range(args.skip):
        torch.randn((32 if t % 2 == 0 else 16, cfg.hidden_size), generator=gen, device=dev)
    s, hist = (int(v) for v in args.shape.split(":"))
    hw = (torch.randn((s, cfg.hidden_size), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    step = (hw, *lins, cos[hist:hist + s], sin[hist:hist + s])
    nn = (cfg.num_heads, cfg.num_kv_heads, cfg.rms_eps)
    got = mkc.w4a16_llama_chunk_step(*step, cache.clone(), hist, *nn)
    ref = mkc.w4a16_llama_chunk_step_plain(*step, cache.clone(), hist, *nn)
    print(f"S={s} hist={hist}: kernel against the plain version: k {worst(got, ref, 1)}, "
          f"v {worst(got, ref, 2)}", flush=True)
    plain = mkc.attend_window
    for p_round, k_round, v_round in ((True, False, False), (False, False, True),
                                      (False, True, True)):
        mkc.attend_window = rounded_attention(p_round, k_round, v_round)
        try:
            alt = mkc.w4a16_llama_chunk_step_plain(*step, cache.clone(), hist, *nn)
        finally:
            mkc.attend_window = plain
        print(f"  plain with P in bf16 {p_round}, the window's k {k_round} and v {v_round} in "
              f"bf16: k {worst(alt, ref, 1)}, v {worst(alt, ref, 2)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
