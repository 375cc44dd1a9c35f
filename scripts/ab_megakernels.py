#!/usr/bin/env python3
"""A/B of the megakernels K4, K5 and K6 (W4, and with ``w3`` W3) and the
tensor-parallel halves K12 and K13 between two checkouts on one NVIDIA GPU.

    python3 scripts/ab_megakernels.py OTHER_TREE [--rounds 2] [--phases mega,w3,tp]

OTHER_TREE is another checkout of the repository, for example the parent
commit unpacked with ``git archive`` into a git-ignored directory. Each
turn runs, in a process of its own, one tree's ``chip_smoke.phase_megakernels``
over that tree's ``awq_tpu_torch`` (a random W4-g128 model at Llama-3-8B
width, 32 layers and a W4 head: K4's layer and token entries, K5 at 16 and
32 rows, K6's slot, int8 and paged modes at 8 and 32 rows), with ``w3``
the same over a W3 model, and with ``tp`` ``chip_smoke.phase_tp_kernels``
(K12 and K13 on one rank's shards at tp = 1, 2 and 4), each kernel held
against its plain version there and timed by that tree's ``Timer``.
A tree's kernels are built by its own ``_build.build_all`` in its first
turn. The turns go this, other, other, this, ``--rounds`` times; the
script prints every case's kernel ms per turn and the median per tree,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MARK = "AB_CASES "


def child(tree: Path, phases) -> int:
    sys.path.insert(0, str(tree))
    import torch

    from awq_tpu_torch import _build
    import chip_smoke

    assert Path(_build.__file__).resolve().is_relative_to(tree.resolve()), _build.__file__
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    timer = chip_smoke.Timer(torch, reps=20)
    if "mega" in phases:
        chip_smoke.phase_megakernels(torch, timer, cases)
    if "w3" in phases:
        torch.cuda.empty_cache()
        chip_smoke.phase_megakernels(torch, timer, cases, w3=True)
    if "tp" in phases:
        torch.cuda.empty_cache()
        chip_smoke.phase_tp_kernels(torch, timer, cases)
    print(MARK + json.dumps([(c["name"], c["shape"], c["ms"]) for c in cases]), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the checkout to compare with this one")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--phases", default="mega,tp",
                    help="comma-separated: mega (W4 K4-K6), w3 (W3 K4-K6), tp (K12, K13)")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("ab_megakernels: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    trees = {"this": ROOT, "other": args.other.resolve()}
    times = {}       # (name, shape) -> {tree: [ms per turn]}
    for r in range(args.rounds):
        for label in ("this", "other", "other", "this"):
            proc = subprocess.run([sys.executable, __file__, str(args.other), "--child",
                                   str(trees[label]), "--phases", args.phases],
                                  capture_output=True, text=True, cwd=trees[label])
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
            if proc.returncode != 0 or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"ab_megakernels: the {label} tree's turn failed")
            for name, shape, ms in json.loads(lines[-1][len(MARK):]):
                times.setdefault((name, shape), {}).setdefault(label, []).append(ms)
            print(f"round {r} {label}: {len(json.loads(lines[-1][len(MARK):]))} cases",
                  flush=True)
    print(f"{'case':<64} {'this ms':>24} {'other ms':>24} {'this/other':>10}")
    for (name, shape), t in times.items():
        if set(t) != {"this", "other"}:
            continue
        a, b = statistics.median(t["this"]), statistics.median(t["other"])
        print(f"{name + ' ' + shape:<64} {' '.join(f'{x:.4f}' for x in t['this']):>24} "
              f"{' '.join(f'{x:.4f}' for x in t['other']):>24} {a / b:10.4f}")
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
