#!/usr/bin/env python3
"""K6 of this checkout against another tree's build of
``csrc/megakernel_batched.cu`` on the same inputs, bit for bit: the f32,
bf16 and int8 slot caches and the bf16 page pool, W4 and W3, at 8 and 32
ragged rows (8 layers at Llama-3-8B width and a 4096-column head, random
weights from a seed). The other tree's source is built with its own
headers into ``build/ab_k6_bits/`` and called through this checkout's
wrapper (a kernel reads the ints it knows and ignores those appended after
them).

    python3 scripts/ab_k6_bits.py OTHER/awq_tpu_torch/csrc/megakernel_batched.cu
"""
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke as cs
    import exp_batched_phases as ebp
    from awq_tpu_torch import _build
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import megakernel_batched as mkb
    from awq_tpu_torch.ops.w4a16 import QLinear
    parent = Path(sys.argv[1]).resolve()
    units = [f"megakernel_batched_{m}{w}" for w in ("", "_w3")
             for m in ("f32", "bf16", "int8", "paged")]
    procs = {u: ebp.build(ROOT / "build" / "ab_k6_bits", u, parent, _build.UNITS[u][1], False)
             for u in units}
    _build.build_all(units)
    mine = {u: _build.load(u) for u in units}
    old = {}
    for u, (p, path, _) in procs.items():
        assert p.wait() == 0, (path.parent / "build.log").read_text()[-3000:]
        lib = ctypes.CDLL(str(path))
        lib.awq_error_string.restype = ctypes.c_char_p
        lib.awq_error_string.argtypes = [ctypes.c_int]
        old[u] = lib
    dev = "cuda"
    for w3 in (False, True):
        gen = torch.Generator(device=dev).manual_seed(99)
        cfg = ModelConfig(**dict(cs.LLAMA3_8B, num_layers=8))
        wb = 3 if w3 else 4
        params = llama.fuse_linears(
            llama.init_qparams(cfg, QuantConfig(w_bit=wb, group_size=128), gen), cfg)
        H, V = cfg.hidden_size, 4096
        sh = (torch.rand((H // 128, V), generator=gen, device=dev) + 0.5) * 0.005
        head = QLinear(
            qweight=torch.randint(-(2**31), 2**31 - 1, (H * 3 // 32 if w3 else H // 8, V),
                                  generator=gen, dtype=torch.int32, device=dev),
            scales=sh, szeros=sh * 2 ** (wb - 1), w_bit=wb, dense3=w3)
        la = params["layers"]
        args = (la["wqkv"], la["wo"], la["wgateup"], la["down"], la["ln1"], la["ln2"])
        cos, sin = llama.rope_table(cfg, 2048, device=dev)
        for b in (8, 32):
            ragged = [700 + (i * 97) % 600 for i in range(b)]; ragged[1] = 0
            lens = torch.tensor(ragged, dtype=torch.int32, device=dev)
            cache = llama.init_kv_cache(cfg, b, 2048); cache.normal_(generator=gen)
            h = (torch.randn((b, H), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            kw = dict(whead=head, norm_w=params["norm"], max_length=max(ragged))
            for mode in ("f32", "bf16", "int8", "paged"):
                u = f"megakernel_batched_{mode}" + ("_w3" if w3 else "")
                c, extra = cache, {}
                if mode == "f32": c = cache.float()
                if mode == "int8":
                    c, extra["cache_scales"] = cs.quantize_cache(torch, cache)
                if mode == "paged":
                    c, extra["tables"] = cs.scatter_pages(
                        torch, cache, 8, 256, gen, need=[n // 256 + 1 for n in ragged])
                outs = []
                for lib in (mine[u], old[u]):
                    _build._LIBS[u] = lib
                    cc = c.clone()
                    ex = dict(extra)
                    if "cache_scales" in ex: ex["cache_scales"] = ex["cache_scales"].clone()
                    got = mkb.w4a16_llama_token_step_batched(
                        h, *args, cos[lens.long()], sin[lens.long()], cc, lens, cfg.num_heads,
                        cfg.num_kv_heads, cfg.rms_eps, **kw, **ex)
                    torch.cuda.synchronize()
                    outs.append((*got, cc))
                same = all(torch.equal(x, y) for x, y in zip(*outs))
                print(f"K6 {u} B={b}: this checkout and the other build bit-equal: {same}",
                      flush=True)
                _build._LIBS[u] = mine[u]
    return 0


if __name__ == "__main__":
    sys.exit(main())
