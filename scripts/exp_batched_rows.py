#!/usr/bin/env python3
"""Row by row, where K6's outputs part from its plain version, and why: the
card test's small model (``tests/test_torch_megakernel_batched.py::
_card_model``, 3 layers, H 512, I 1024, a head) at ``--rows`` rows goes
through K6 on the card and through three versions on the CPU: the plain
version, the plain version with K6's order of f32 sums
(``tests/test_torch_batched_plan.py::_sched``, the emulation the CPU tests
hold to JAX), and the plain version with every matmul output perturbed at
f32 rounding size (2^-20 relative, ``--perturb`` seeds). For h and the
logits it prints, for the rows farthest from the plain version, each
row's error over its own largest value: K6 against the plain version, the
emulation against the plain version, K6 against the emulation, and the
largest the perturbed runs moved that row.

    python3 scripts/exp_batched_rows.py [--rows 32] [--seed 82] [--w3] [--perturb 4]

A row that K6 and the emulation move alike, and that f32-sized
perturbations move too, is a row the plain version's rounding points make
ill-conditioned; a row where K6 parts from the emulation alone would be a
fault of the kernel.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=32)
    ap.add_argument("--seed", type=int, default=82)
    ap.add_argument("--w3", action="store_true")
    ap.add_argument("--perturb", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cpu: a dry run (K6's wrapper then runs "
                                                      "its plain version)")
    args = ap.parse_args()
    import dataclasses

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("exp_batched_rows: no CUDA device", file=sys.stderr)
        return 2
    from awq_tpu_torch.ops import megakernel_batched as tmb
    from test_torch_batched_plan import _sched
    from test_torch_megakernel_batched import T, _card_model

    smi = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    b, dev = args.rows, args.device
    nq, nkv, H, I, L = 4, 2, 512, 1024, 3
    ws, (ln1, ln2), cache, cos, sin, hd_kw, g = _card_model(dev, nq, nkv, H, I, L, b, True,
                                                            args.seed, w3=args.w3)
    h = (torch.randn((b, H), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    lens = torch.randint(0, T, (b,), generator=g, device=dev).to(torch.int32)
    lens[1] = 0
    step = lambda c, *w: (h.to(c.device), *w, ln1.to(c.device), ln2.to(c.device),
                          cos.to(c.device), sin.to(c.device), c, lens.to(c.device), nq, nkv)
    got = tmb.w4a16_llama_token_step_batched(*step(cache.clone(), *ws), max_length=T - 1,
                                             **hd_kw)
    cpu = lambda q: dataclasses.replace(q, **{f.name: getattr(q, f.name).cpu()
                                              for f in dataclasses.fields(q)
                                              if isinstance(getattr(q, f.name), torch.Tensor)})
    wc = [cpu(q) for q in ws]
    head = dict(whead=cpu(hd_kw["whead"]), norm_w=hd_kw["norm_w"].cpu())
    c_cpu = cache.cpu()
    plain = lambda: tmb.w4a16_llama_token_step_batched_plain(
        *step(c_cpu.clone(), *wc), 1e-5, **head)
    ref = plain()
    grid = 132 if args.device == "cpu" else torch.cuda.get_device_properties(0).multi_processor_count
    plan = tmb.batched_plan(b, H, I, nq, nkv, 1024, args.w3, grid)
    kinds = {id(wc[0]): "qkv", id(wc[1]): "o", id(wc[2]): "gateup", id(wc[3]): "down",
             id(head["whead"]): "head"}
    qdot0, rms0 = tmb.qdot_layer, tmb.rms_rows
    tmb.qdot_layer, tmb.rms_rows = _sched(plan, kinds, grid)
    try:
        emu = plain()
    finally:
        tmb.qdot_layer, tmb.rms_rows = qdot0, rms0
    moved = []
    for s in range(args.perturb):
        gen = torch.Generator().manual_seed(s)

        def noisy(*a, **k):
            y = qdot0(*a, **k)
            return y * (1 + 2.0 ** -20 * torch.randn(y.shape, generator=gen))

        tmb.qdot_layer = noisy
        try:
            moved.append(plain())
        finally:
            tmb.qdot_layer = qdot0

    def rel(x, r):           # each row's largest error over the row's largest value
        x, r = x.float().cpu().flatten(1), r.float().cpu().flatten(1)
        return (x - r).abs().amax(1) / r.abs().amax(1)

    for i, name in ((0, "h"), (3, "logits")):
        kp, ep, ke = rel(got[i], ref[i]), rel(emu[i], ref[i]), rel(got[i], emu[i])
        pp = torch.stack([rel(m[i], ref[i]) for m in moved]).amax(0)
        print(f"{name}: each row's error over its own largest value (median over rows: K6 "
              f"{kp.median():.3e}, emulation {ep.median():.3e}, perturbed {pp.median():.3e})",
              flush=True)
        for r in torch.argsort(-kp)[:6].tolist():
            print(f"  row {r:2d} (length {int(lens[r])}): K6 vs plain {kp[r]:.3e}; emulation vs "
                  f"plain {ep[r]:.3e}; K6 vs emulation {ke[r]:.3e}; plain perturbed by 2^-20 "
                  f"moved it up to {pp[r]:.3e}; row max |h| {ref[0][r].float().abs().max():.4g}",
                  flush=True)
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
