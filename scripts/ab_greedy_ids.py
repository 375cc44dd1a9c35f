#!/usr/bin/env python3
"""Greedy ids of the smoke script's single-stream requests in two trees on
one NVIDIA GPU, and the logit gap behind each difference.

    python3 scripts/ab_greedy_ids.py OTHER_TREE [--labels falcon mpt ...]

OTHER_TREE is another checkout's root (e.g. the parent commit's, ``git
archive`` into ``build/parent_full``). Each tree runs, in a process of
its own with its own kernels (built into its ``build/``), the four
requests of ``chip_smoke.py``'s phase 3 (prompts of 16, 200, 1000 and 24
ids, 32 greedy new tokens each, requests 2 and 4 continuing 1 and 3) on
the 32-layer random Llama-3-8B W4A16 model: on the megakernels, on the
stacked path (``AWQ_TPU_DISABLE_MEGAKERNEL=1``) and with
``cfg.prefill_a8`` (phase 3f); on the 32-layer random Falcon-7B
(phase 3h); and with ``--labels`` also on phase 3j's MPT-7B (``mpt`` on
K4's MPT shape, ``mpt_stacked`` on the stacked path). ``--labels`` picks
the configurations (all of the first four by default). The script prints,
per configuration, each request's first
differing step (None: equal). Where a request differs and its dialogue's
earlier requests did not, it replays the checkout's engine up to that
step and prints the two candidate ids' logits at it, with the largest
logit and the runner-up's, from the checkout's kernels and again with
K3 swapped for its plain version (``flash_prefill_plain``): a gap that is
a small fraction of the largest logit is a near-tie. Prints the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LABELS = ("megakernels", "stacked", "prefill_a8", "falcon")
MPT_LABELS = ("mpt", "mpt_stacked")


def _engine(torch, cs, label):
    from awq_tpu_torch.config import ModelConfig, QuantConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import init_qparams
    from awq_tpu_torch.runtime.engine import InferenceEngine

    if label in MPT_LABELS:
        # phase 3j's engine: zero-mean W4-g128 layers, the tied head quantized
        cfg = ModelConfig(**{**cs.MPT_7B, "num_layers": 32})
        params = cs.zero_mean(init_qparams(cfg, QuantConfig(w_bit=4, group_size=cs.G),
                                           torch.Generator(device="cuda").manual_seed(0)), 4)
        params["lm_head"] = params["embed"].T.contiguous()
        return InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=2048, quantize_head=True))
    falcon = label == "falcon"
    cfg = ModelConfig(**{**(cs.FALCON_7B if falcon else cs.LLAMA3_8B), "num_layers": 32})
    params = init_qparams(cfg, QuantConfig(w_bit=4, group_size=cs.FALCON_G if falcon else cs.G),
                          torch.Generator(device="cuda").manual_seed(0))
    if label == "prefill_a8":
        # phase 3f's engine: built from phase 3's, whose head is quantized
        engine = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=2048,
                                                            quantize_head=True))
        return InferenceEngine(dataclasses.replace(cfg, prefill_a8=True), engine.params,
                               RuntimeConfig(max_seq_len=2048))
    return InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=2048, quantize_head=True))


def probe(out_path: str, labels) -> None:
    """In the current tree: each label's greedy ids, as serve_single makes them."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from awq_tpu_torch import _build

    _build.build_all()
    ids = {}
    for label in labels:
        engine = _engine(torch, cs, label)
        _, got, _ = cs.serve_single(torch, engine, engine.cfg, (label,))
        ids[label] = got[label]
        del engine
        torch.cuda.empty_cache()
    json.dump(ids, open(out_path, "w"))


def first_diffs(a, b):
    return [next((i for i, (x, y) in enumerate(zip(p, q)) if x != y), None)
            for p, q in zip(a, b)]


def near_ties(torch, cs, label, mine, other, diffs):
    """Replays the checkout's engine and prints the logits of both trees'
    ids at each independent first difference."""
    from awq_tpu_torch.config import GenConfig
    from awq_tpu_torch.models import llama
    from awq_tpu_torch.ops import decode_attn as da

    engine = _engine(torch, cs, label)
    cs.set_config(cs.SERVE_PATHS[label][0])
    gen = GenConfig(greedy=True, max_new_tokens=32)
    rng = torch.Generator().manual_seed(7)
    dialogue_differs = False
    for i, (n, fresh) in enumerate(cs.REQUESTS):
        if fresh:
            engine.reset()
            dialogue_differs = False
        prompt = torch.randint(0, engine.cfg.vocab_size, (n,), generator=rng).tolist()
        d = diffs[i]
        if d is not None and dialogue_differs:
            print(f"{label} request {i + 1}: differs from step {d}, after a differing "
                  "earlier request of its dialogue", flush=True)
        elif d is not None:
            toks = torch.tensor([engine._pending + prompt + mine[i][:d]], device="cuda")
            saved = [t.clone() for t in llama.cache_tensors(engine.cache)]
            for name, fn in (("kernels", da.flash_prefill), ("K3 plain", da.flash_prefill_plain)):
                llama.flash_prefill = fn
                logits, _ = llama.forward(engine.params, engine.cfg, toks, engine.cache,
                                          engine.start_pos, last_only=True)
                for t, s in zip(llama.cache_tensors(engine.cache), saved):
                    t.copy_(s)
                v = logits[0, -1].float()
                top = torch.topk(v, 2)
                print(f"{label} request {i + 1} step {d} ({name}): logit of this tree's id "
                      f"{mine[i][d]} {v[mine[i][d]].item():.4f}, of the other's "
                      f"{other[i][d]} {v[other[i][d]].item():.4f}, gap "
                      f"{(v[mine[i][d]] - v[other[i][d]]).item():.4f} = "
                      f"{((v[mine[i][d]] - v[other[i][d]]) / v.abs().max()).item():.2e} of "
                      f"max|logit| {v.abs().max().item():.4f}; top two {top.indices.tolist()} "
                      f"{[round(x, 4) for x in top.values.tolist()]}", flush=True)
            llama.flash_prefill = da.flash_prefill
        dialogue_differs |= d is not None
        out = engine.generate(prompt, gen)
        if out["output_ids"].tolist() != mine[i]:
            print(f"{label} request {i + 1}: the replay's ids differ from the run's", flush=True)
    cs.set_config(None)
    del engine
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", type=Path, help="the other tree's root")
    ap.add_argument("--labels", nargs="+", default=list(LABELS),
                    choices=LABELS + MPT_LABELS, help="the configurations to run")
    ap.add_argument("--probe", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.probe:
        probe(args.probe, args.labels)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("ab_greedy_ids: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out_dir = ROOT / "build" / "ab_greedy_ids"
    out_dir.mkdir(parents=True, exist_ok=True)
    ids = {}
    for tag, tree in (("other", args.other.resolve()), ("checkout", ROOT)):
        path = out_dir / f"{tag}.json"
        with open(out_dir / f"{tag}.log", "w") as log:
            subprocess.run([sys.executable, str(Path(__file__).resolve()), "--probe", str(path),
                            "--labels", *args.labels],
                           cwd=tree, check=True, stdout=log, stderr=subprocess.STDOUT)
        ids[tag] = json.load(open(path))

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    for label in args.labels:
        diffs = first_diffs(ids["checkout"][label], ids["other"][label])
        print(f"{label}: first differing step by request {diffs}", flush=True)
        if any(d is not None for d in diffs):
            near_ties(torch, cs, label, ids["checkout"][label], ids["other"][label], diffs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
