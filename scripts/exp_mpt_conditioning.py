#!/usr/bin/env python3
"""How well conditioned K4's token step is on the random models the smoke
script builds, MPT shape against llama shape.

    python3 scripts/exp_mpt_conditioning.py [--hidden 1024] [--inter 4096] [--layers 32]
                                            [--device cpu]

``init_qparams`` draws W4 codes uniform in [0, 16) with the zero point at 8:
the mean weight is -s/2, so every output of a linear carries -s/2 times the
sum of its inputs. After a LayerNorm, whose output sums to 0, QKV and up lose
that term, but the GELU's outputs are mostly positive, so every down output
carries about -s/2 * sum(gelu(up)) and the residual stream gathers a common
mode that grows layer by layer. The residual is rounded to bf16 between
layers, and the LayerNorm that reads it subtracts that common mode again:
once it is large against the rest, the rounding steps are a large share of
what is left, and two implementations that round one element differently
part. The script runs K4's plain token step (``ops/megakernel.py``) twice on
each random model, the second time with one element of the input moved by
one bf16 step, and prints how far the outputs part and the final residual's
mean against its spread: for the MPT shape and the llama shape, with the
zero point at 8 (``init_qparams``) and at 7.5 (zero-mean weights, as a
trained model's are near).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--inter", type=int, default=4096)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    import torch

    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import megakernel as mk

    heads = args.hidden // 128
    for shape, family in (("mpt", dict(arch="mpt", norm="layernorm", norm_bias=False,
                                       act="gelu", pos_embed="alibi")),
                          ("llama", dict(arch="llama"))):
        cfg = ModelConfig(vocab_size=512, hidden_size=args.hidden,
                          intermediate_size=args.inter, num_layers=args.layers,
                          num_heads=heads, num_kv_heads=heads, head_dim=128,
                          max_position_embeddings=256, dtype="bfloat16", **family)
        for zero in (8.0, 7.5):
            gen = torch.Generator(device=args.device).manual_seed(0)
            params = llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=128), gen,
                                        device=args.device)
            for p in params["layers"].values():
                if hasattr(p, "szeros"):
                    p.szeros.copy_(p.scales * zero)
            la = llama.fuse_linears(params, cfg)["layers"]
            cache = llama.init_kv_cache(cfg, 1, 256, device=args.device)
            cache.normal_(generator=gen)
            h = (torch.randn((1, args.hidden), generator=gen, device=args.device)
                 * 0.5).to(torch.bfloat16)
            moved = h.clone()
            moved[0, 7:8] = (h[0, 7:8].view(torch.int16) + 1).view(torch.bfloat16)
            cos, sin = llama.rope_table(cfg, 256, device=args.device)
            lins = (la["wqkv"], la["wo"], la["up"] if shape == "mpt" else la["wgateup"],
                    la["down"], la["ln1"], la["ln2"])
            rows = (None, None) if shape == "mpt" else (cos[100], sin[100])
            outs = [mk.w4a16_llama_token_step_plain(x, *lins, *rows, cache.clone(), 100, heads,
                                                    heads, 1e-5, shape=shape)
                    for x in (h, moved)]
            parts = {name: ((a.float() - b.float()).abs().max() / a.float().abs().max()).item()
                     for name, a, b in zip("hkv", *outs)}
            hf = outs[0][0].float()
            print(f"{shape} zero point {zero}: one input element moved by one bf16 step moves "
                  f"h by {parts['h']:.3e}, k by {parts['k']:.3e}, v by {parts['v']:.3e} of "
                  f"their largest; the final residual's mean {hf.mean().item():.2f}, std "
                  f"{hf.std().item():.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
