#!/usr/bin/env python3
"""Experiment: the split flash decode (K2, K8, K9, K14) under other host
plans than ``decode_plan``'s: the largest cluster and the ring's stages.

    python3 scripts/exp_decode_plan.py [--reps 20]

Times the checkout's kernels at ``scripts/ab_flash_decode.py``'s shapes,
each under plans of at most 16, 8 and 4 blocks a cluster and 2-4 stages
(the plan's shared memory recomputed for each), every output held to the
plain version within 2^-6 of its largest magnitude. Prints the card's name
and power limit, and one line a shape with the median of ``--reps`` calls
(L2 flushed before each, ``chip_smoke.Timer``) for each variant, the
default plan's marked. Not part of the port: it measures what the plan's
rule should be.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

VARIANTS = [(16, 4), (16, 3), (16, 2), (8, 4), (8, 3), (8, 2), (4, 4), (4, 2)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("exp_decode_plan: no CUDA device", file=sys.stderr)
        return 2
    from ab_flash_decode import TOL, Build, make_cases

    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import decode_attn as da
    from chip_smoke import Timer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    _build.build_all(["decode_attn"])
    bld = Build(_build.lib_path("decode_attn"), planned=True)
    default_plan = da.decode_plan
    variant = {"v": None}

    def plan(*a, **k):
        p = default_plan(*a, **k)
        if variant["v"] is None:
            return p
        mc, st = variant["v"]
        p = default_plan(*a, **{**k, "max_cluster": mc})
        return dataclasses.replace(p, stages=min(st, p.per // da.DECODE_TILE + 1))

    da.decode_plan = plan
    timer = Timer(torch, reps=args.reps)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    bad = False
    for case in make_cases(torch, gen):
        q = case["args"]["q"]
        ref = case["plain"]().float()
        out = torch.empty_like(q)
        variant["v"] = None
        base = plan(*_plan_args(case, da))
        parts = [f"default [{base.describe()}]"]
        res = {}
        for v in [None] + VARIANTS:
            variant["v"] = v
            p = plan(*_plan_args(case, da))
            key = (p.cluster, p.per, p.stages)
            if key in res:
                continue
            bld.run(torch, da, case, out, {})
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            bad |= err > TOL * ref.abs().max().item()
            res[key] = timer(lambda: bld.run(torch, da, case, out, {}))
            mark = "*" if v is None else ""
            parts.append(f"{mark}cluster {p.cluster} per {p.per} stages {p.stages} "
                         f"smem {p.smem}: {res[key]:.4f} ms")
        print(f"{case['label']}: " + "; ".join(parts), flush=True)
    return 1 if bad else 0


def _plan_args(case, da):
    """decode_plan's positional arguments for a case, as its wrapper asks."""
    a, mode = case["args"], case["mode"]
    b, nq, hd = a["q"].shape
    if mode == "layer":
        return (b, nq, a["k"].shape[1], hd, a["length"], 2, da.PLAN_UNIT["flash_decode_layer"])
    if mode == "paged":
        return (b, nq, a["pool"].shape[3], hd, a["mx"], 2, da.PLAN_UNIT["flash_decode_paged"],
                a["page"])
    if mode == "int8":
        return (b, nq, a["codes"].shape[2], hd, a["mx"], 1, da.PLAN_UNIT["flash_decode_int8"])
    return (b, nq, a["cache"].shape[2], hd, a["mx"], 2, da.PLAN_UNIT["flash_decode"])


if __name__ == "__main__":
    sys.exit(main())
