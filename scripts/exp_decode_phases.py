#!/usr/bin/env python3
"""Experiment: where a call of the split flash decode (K2, K8, K9, K14)
spends its time, phase by phase, on one NVIDIA GPU.

    python3 scripts/exp_decode_phases.py [--reps 12]

Writes two variants of the checkout's ``awq_tpu_torch/csrc/decode_attn.cu``
into ``build/exp_decode_phases/`` and builds them with the port's nvcc
flags: one whose first thread of block (0, 0, 0) reads ``%globaltimer`` at
the kernel's phase edges and writes the intervals over the first output
elements after the last barrier (its output is wrong there, by design), and
one that returns at entry (the floor of a cluster launch under
``chip_smoke.Timer``). At ``scripts/ab_flash_decode.py``'s shapes it
prints the call's time (median of ``--reps`` calls, L2 flushed before each),
the empty launch's and the medians of the intervals in ns: the prologue
(q staging and the first copies), the tile loop, the warps' states and the
block merge, the first cluster barrier, the cluster merge and the outputs,
the last barrier. A call of one block skips the cluster phases
(they print 0). Not part of the port; the variants are built from text
anchors in the source and fail loudly when it changes.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

PHASES = ["prologue", "loop", "states+block merge", "cluster barrier", "cluster merge",
          "last barrier"]


def _sub(s: str, old: str, new: str) -> str:
    if s.count(old) != 1:
        raise SystemExit(f"exp_decode_phases: anchor not found once: {old[:60]!r}")
    return s.replace(old, new)


def variants(src: str) -> dict:
    head = "  const int rank = blockIdx.x, nsplit = gridDim.x, h = blockIdx.y, b = blockIdx.z;"
    s = _sub(src, head, "  unsigned long long T_[7];\n  auto stamp = [&](int k) { asm volatile("
             "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(T_[k])); };\n  stamp(0);\n" + head)
    s = _sub(s, "  for (int i = 0; i < ntiles; ++i) {\n    hop::cp_async_wait_pending(",
             "  stamp(1);\n  for (int i = 0; i < ntiles; ++i) {\n    hop::cp_async_wait_pending(")
    s = _sub(s, "  hop::cp_async_wait_all();\n  __syncthreads();\n  float* ws = wst",
             "  stamp(2);\n  hop::cp_async_wait_all();\n  __syncthreads();\n  float* ws = wst")
    s = _sub(s, "  hop::cluster_sync();\n  for (int i = tid; i < ((hi - lo) * le + 31)",
             "  stamp(3);\n  hop::cluster_sync();\n  stamp(4);\n"
             "  for (int i = tid; i < ((hi - lo) * le + 31)")
    last = "  hop::cluster_sync();   // the peers are done reading this block's state\n}"
    s = _sub(s, last, "  stamp(5);\n" + last[:-1] + "  stamp(6);\n"
             "  if (tid == 0 && rank == 0 && h == 0 && b == 0) {\n"
             "    float* dbg = reinterpret_cast<float*>(a.out);\n"
             "    for (int k = 1; k < 7; ++k) dbg[k - 1] = (float)(T_[k] - T_[0]);\n  }\n}")
    empty = _sub(src, head, "  if (a.per > 0) return;\n" + head)
    return {"stamped": s, "empty": empty}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=12)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("exp_decode_phases: no CUDA device", file=sys.stderr)
        return 2
    from ab_flash_decode import Build, build, make_cases

    from awq_tpu_torch import _build
    from awq_tpu_torch.ops import decode_attn as da
    from chip_smoke import Timer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out_dir = ROOT / "build" / "exp_decode_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    sos = {}
    for name, text in variants((_build.CSRC / "decode_attn.cu").read_text()).items():
        (out_dir / f"{name}.cu").write_text(text)
        sos[name] = out_dir / f"{name}.so"
    procs = [build(out_dir / f"{n}.cu", so) for n, so in sos.items()]
    if any(p.wait() for p in procs):
        return 1
    stamped, empty = Build(sos["stamped"], True), Build(sos["empty"], True)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    timer = Timer(torch, reps=args.reps)
    for case in make_cases(torch, gen):
        out = torch.empty_like(case["args"]["q"])
        rows = []
        for _ in range(args.reps):
            timer.flush.zero_()
            stamped.run(torch, da, case, out, {})
            torch.cuda.synchronize()
            raw = out.view(-1)[:6] if out.dtype == torch.float32 else \
                out.view(-1)[:12].view(torch.float32)
            rows.append(raw.tolist())
        nph = len(PHASES)
        med = [statistics.median(r[k] for r in rows) for k in range(nph)]
        steps = [med[0]] + [med[k] - med[k - 1] for k in range(1, nph)]
        ms = timer(lambda: stamped.run(torch, da, case, out, {}))
        empty_ms = timer(lambda: empty.run(torch, da, case, out, {}))
        print(f"{case['label']}: call {ms * 1e3:.1f} us, empty launch {empty_ms * 1e3:.1f} us; "
              + ", ".join(f"{n} {max(x, 0.0):.0f}" for n, x in zip(PHASES, steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
