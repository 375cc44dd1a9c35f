#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (awq_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases (each failure ends the run with a non-zero exit):

1. Print the card's name and power limit; build the CUDA kernels from
   ``awq_tpu_torch/csrc`` with nvcc (one process per source, in parallel).
2. Hold every kernel against its plain PyTorch version on the card, at the
   shapes the Llama-3-8B main path gives it, with the tolerance stated;
   time the kernel, the plain version and one PyTorch library call, beside
   the least time the card could take (``bound_ms``).
3. Serve three requests (prompts of 16, 200 and 1000 random ids, 32 greedy
   new tokens each, the second continuing the first's dialogue) through
   ``InferenceEngine`` on a random W4A16-g128 model of Llama-3-8B's widths,
   with a W4 head; every kernel's launch count must grow in this phase.
4. At the same widths and 2 layers, feed the same tokens through
   ``forward`` on the kernel path and on the plain path and compare logits.
5. Print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

It exits non-zero, printing no result, where CUDA is not available or the
port is not beside it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
LLAMA3_8B = dict(arch="llama", vocab_size=128256, hidden_size=4096,
                 intermediate_size=14336, num_layers=32, num_heads=32,
                 num_kv_heads=8, head_dim=128, max_position_embeddings=8192,
                 rope_theta=500000.0, dtype="bfloat16")
G = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median device time of one call: CUDA events around each call, the
    50 MB L2 flushed before it (the main path finds weights and KV cold).

    The device first spins for ~10 ms (``torch.cuda._sleep``) while the host
    enqueues every repeat, so an interval holds the call's kernels only and
    never a wait for the host to launch them."""

    SPIN_CYCLES = 20_000_000

    def __init__(self, torch, reps: int):
        self.torch, self.reps = torch, reps
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps=None) -> float:
        torch = self.torch
        fn()  # warm: first launches load modules
        torch.cuda.synchronize()
        n = reps or self.reps
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        torch.cuda._sleep(self.SPIN_CYCLES)
        for start, end in zip(starts, ends):
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def check(name, got, ref, rel_tol):
    """Max abs / rel error against the plain version; asserts abs <= rel_tol
    * max|ref|."""
    gf, rf = got.float(), ref.float()
    if not bool(gf.isfinite().all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (gf - rf).abs().max().item()
    scale = rf.abs().max().item()
    rel = err / scale if scale else err
    if err > rel_tol * scale:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} > {rel_tol:g} * "
                             f"max|ref| {scale:.3e}")
    return err, rel


def phase_kernels(torch, timer, cases_out):
    """Phase 2: each kernel against its plain version at main-path shapes."""
    import torch.nn.functional as F

    from awq_tpu_torch.ops import decode_attn as da
    from awq_tpu_torch.ops import w4a16 as w4

    gen = torch.Generator(device="cuda").manual_seed(1234)
    cfg = LLAMA3_8B
    h, inter, nq, nkv, hd = (cfg["hidden_size"], cfg["intermediate_size"],
                             cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"])
    shapes = {"wqkv": (h, (nq + 2 * nkv) * hd), "wo": (nq * hd, h),
              "wgateup": (h, 2 * inter), "down": (inter, h),
              "head": (h, cfg["vocab_size"])}
    # bf16 output: 2^-9 relative rounding; the plain version rounds each
    # dequantized weight to bf16 too and both sum IC products in other
    # orders: 2^-6 of the output's largest magnitude bounds all of it.
    k1_tol = 2.0 ** -6

    def k1_case(entry, wname, m):
        ic, oc = shapes[wname]
        x = torch.randn((m, ic), generator=gen, device="cuda").to(torch.bfloat16)
        qw = torch.randint(-(2**31), 2**31 - 1, (ic // 8, oc), generator=gen,
                           dtype=torch.int32, device="cuda")
        s = (torch.rand((ic // G, oc), generator=gen, device="cuda") + 0.5) * 0.005
        sz = s * 8
        got = w4.w4a16_matmul(x, qw, s, sz, G)
        ref = w4.w4a16_matmul_plain(x, qw, s, sz, G)
        torch.cuda.synchronize()
        err, rel = check(f"{entry} {wname} M={m}", got, ref, k1_tol)
        w = w4.dequantize(qw, s, sz, G, torch.bfloat16)
        ms = timer(lambda: w4.w4a16_matmul(x, qw, s, sz, G))
        plain_ms = timer(lambda: w4.w4a16_matmul_plain(x, qw, s, sz, G), reps=5)
        lib_ms = timer(lambda: torch.matmul(x, w))
        nbytes = m * ic * 2 + ic * oc // 2 + 2 * (ic // G) * oc * 4 + m * oc * 2
        b_ms, b_by = bound(nbytes, 2.0 * m * ic * oc)
        del w
        return dict(name=entry, shape=f"{wname} M={m} {ic}->{oc}", max_abs_err=err,
                    max_rel_err=rel, tol=f"{k1_tol:g}*max|ref|", ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms,
                    library="torch.matmul on the bf16-dequantized weight")

    for wname in ("wqkv", "wo", "wgateup", "down", "head"):
        cases_out.append(k1_case("w4a16_gemv", wname, 1))
        log_case(cases_out[-1])
    for m in (16, 200, 1000):
        for wname in ("wqkv", "wgateup", "down"):
            cases_out.append(k1_case("w4a16_gemm", wname, m))
            log_case(cases_out[-1])

    # bf16 output rounding 2^-9; K3 also rounds P to bf16 for P.V.
    attn_tol = 2.0 ** -6
    t_cache = 4096

    def kv_cache():
        return torch.randn((2, 1, nkv, t_cache, hd), generator=gen,
                           device="cuda").to(torch.bfloat16)

    for length in (1, 1000, 4000):
        cache = kv_cache()
        q = torch.randn((1, nq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        kn, vn = (torch.randn((1, nkv, hd), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        lens = torch.full((1,), length, dtype=torch.int32, device="cuda")
        got = da.flash_decode(q, kn, vn, cache, lens, max_length=length)
        ref = da.flash_decode_plain(q, kn, vn, cache, lens, max_length=length)
        torch.cuda.synchronize()
        err, rel = check(f"flash_decode len={length}", got, ref, attn_tol)
        k_all = torch.cat([cache[0, :, :, :length], kn[:, :, None]], dim=2)
        v_all = torch.cat([cache[1, :, :, :length], vn[:, :, None]], dim=2)
        ms = timer(lambda: da.flash_decode(q, kn, vn, cache, lens, max_length=length))
        plain_ms = timer(lambda: da.flash_decode_plain(q, kn, vn, cache, lens,
                                                       max_length=length), reps=5)
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k_all, v_all, enable_gqa=True))
        nbytes = (nq * hd + 2 * nkv * hd + 2 * nkv * length * hd + nq * hd) * 2
        b_ms, b_by = bound(nbytes, 4.0 * nq * (length + 1) * hd)
        cases_out.append(dict(
            name="flash_decode", shape=f"len={length} nq={nq} nkv={nkv} hd={hd}",
            max_abs_err=err, max_rel_err=rel, tol=f"{attn_tol:g}*max|ref|", ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="F.scaled_dot_product_attention(enable_gqa=True)"))
        log_case(cases_out[-1])

    s = 512
    for start in (0, 700):
        cache = kv_cache()
        q = torch.randn((1, s, nq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        got = da.flash_prefill(q, cache, start)
        ref = da.flash_prefill_plain(q, cache, start)
        torch.cuda.synchronize()
        err, rel = check(f"flash_prefill S={s} start={start}", got, ref, attn_tol)
        end = start + s
        k_all = cache[0, :, :, :end].contiguous()
        v_all = cache[1, :, :, :end].contiguous()
        qt = q.transpose(1, 2).contiguous()
        mask = (torch.arange(end, device="cuda")[None, :]
                <= (start + torch.arange(s, device="cuda"))[:, None])
        ms = timer(lambda: da.flash_prefill(q, cache, start))
        plain_ms = timer(lambda: da.flash_prefill_plain(q, cache, start), reps=5)
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            qt, k_all, v_all, attn_mask=mask, enable_gqa=True))
        pairs = s * start + s * (s + 1) // 2    # (row, key) pairs attended
        nbytes = (2 * s * nq * hd + 2 * nkv * end * hd) * 2
        b_ms, b_by = bound(nbytes, 4.0 * nq * hd * pairs)
        cases_out.append(dict(
            name="flash_prefill", shape=f"S={s} start={start} nq={nq} nkv={nkv}",
            max_abs_err=err, max_rel_err=rel, tol=f"{attn_tol:g}*max|ref|", ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library="F.scaled_dot_product_attention(attn_mask, enable_gqa=True)"))
        log_case(cases_out[-1])


def log_case(c):
    log(f"  {c['name']:13s} {c['shape']:34s} max_abs_err={c['max_abs_err']:.3e} "
        f"max_rel_err={c['max_rel_err']:.3e} (tol {c['tol']}) "
        f"kernel_ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
        f"library_ms={c['library_ms']:.4f} bound_ms={c['bound_ms']:.4f} "
        f"({c['bound_by']})")


def weight_bytes(params) -> int:
    from awq_tpu_torch.ops.w4a16 import QLinear

    total = 0
    for p in list(params["layers"].values()) + [params.get("lm_head")]:
        if isinstance(p, QLinear):
            total += sum(t.numel() * t.element_size()
                         for t in (p.qweight, p.scales, p.szeros, p.bias)
                         if t is not None)
    return total


def phase_serve(torch, layers: int):
    """Phase 3: three requests through InferenceEngine; returns launches."""
    from awq_tpu_torch.config import GenConfig, ModelConfig, QuantConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import init_qparams
    from awq_tpu_torch.ops import decode_attn as da
    from awq_tpu_torch.ops import w4a16 as w4
    from awq_tpu_torch.runtime.engine import InferenceEngine

    cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": layers})
    t0 = time.perf_counter()
    params = init_qparams(cfg, QuantConfig(w_bit=4, group_size=G),
                          torch.Generator(device="cuda").manual_seed(0))
    engine = InferenceEngine(cfg, params,
                             RuntimeConfig(max_seq_len=2048, quantize_head=True))
    del params
    torch.cuda.synchronize()
    wbytes = weight_bytes(engine.params)
    log(f"  model: {layers} layers at Llama-3-8B width, W4 weights+head "
        f"{wbytes / 1e9:.3f} GB, embedding {engine.params['embed'].numel() * 2 / 1e9:.3f} GB, "
        f"KV cache {engine.cache.numel() * 2 / 1e9:.3f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    engine.warmup()

    for d in (w4.LAUNCHES, da.LAUNCHES):
        for k in d:
            d[k] = 0
    rng = torch.Generator().manual_seed(7)
    gen = GenConfig(greedy=True, max_new_tokens=32)
    kv_row = 2 * layers * cfg.num_kv_heads * cfg.head_dim * 2   # bytes/position
    results = []
    for i, (n, fresh) in enumerate(((16, True), (200, False), (1000, True))):
        if fresh:
            engine.reset()
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
        start = engine.start_pos
        out = engine.generate(prompt, gen)
        ids = out["output_ids"]
        if len(ids) != 32 or int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab_size:
            raise AssertionError(f"request {i + 1}: bad output ids {ids.tolist()}")
        tm = out["timing"]
        mean_pos = start + n + 16
        gb_tok = (wbytes + kv_row * mean_pos) / 1e9
        ms_tok = tm["ms_per_token"]
        log(f"  request {i + 1}: prompt {n} at start_pos {start}: "
            f"TTFT {tm['ttft_s'] * 1e3:.2f} ms, {ms_tok:.3f} ms/token over 31 "
            f"decode steps, {gb_tok:.3f} GB/token streamed, "
            f"{gb_tok / ms_tok * 1e3:.1f} GB/s effective")
        results.append(dict(prompt=n, start_pos=start, ttft_ms=tm["ttft_s"] * 1e3,
                            ms_per_token=ms_tok, gb_per_token=gb_tok,
                            gbps=gb_tok / ms_tok * 1e3))
    launches = {**w4.LAUNCHES, **da.LAUNCHES}
    log(f"  launches during the three requests: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    profile_decode(torch, engine, results[-1]["ms_per_token"])
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del engine
    torch.cuda.empty_cache()
    return launches, results


def profile_decode(torch, engine, ms_per_token: float, steps: int = 8) -> None:
    """Device time of decode steps by kernel, from a torch.profiler trace of
    ``steps`` forward calls after the last request, against the request's
    unprofiled ms/token: the rest of the step is the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from awq_tpu_torch.models.llama import forward

    tok = torch.zeros((1, 1), dtype=torch.long, device="cuda")
    pos = engine.start_pos
    # host-side rate: forward calls back to back, one sync at the end
    for at in (64, pos):
        forward(engine.params, engine.cfg, tok, engine.cache, at)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            forward(engine.params, engine.cfg, tok, engine.cache, at + 1 + i)
        torch.cuda.synchronize()
        log(f"  {steps} forward calls at position {at + 1}, no sync between: "
            f"{(time.perf_counter() - t0) / steps * 1e3:.3f} ms/step")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            forward(engine.params, engine.cfg, tok, engine.cache, pos + 1 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    ops = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    op_ms = sum(e.self_cpu_time_total for e in ops) / steps / 1e3
    top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:6]
    log(f"  host under the profiler: {wall_ms:.3f} ms/step, of which PyTorch ops "
        f"{op_ms:.3f} ms (top: " + ", ".join(
            f"{e.key} x{e.count // steps} {e.self_cpu_time_total / steps / 1e3:.2f}"
            for e in top) + "); the rest is Python and the ctypes launches")
    groups = {"w4a16_gemv": ("w4a16_gemv", "splitk_reduce"),
              "flash_decode": ("flash_decode",), "w4a16_gemm": ("w4a16_gemm",),
              "flash_prefill": ("flash_prefill",)}
    us = {k: 0.0 for k in groups}
    us["other PyTorch kernels"] = 0.0
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n_kernels += 1
        key = next((k for k, pats in groups.items()
                    if any(p in e.name for p in pats)), "other PyTorch kernels")
        us[key] += e.time_range.elapsed_us()
    if not n_kernels:
        log("  profiler: no device events recorded; no breakdown")
        return
    busy_ms = sum(us.values()) / steps / 1e3
    parts = ", ".join(f"{k} {v / steps / 1e3:.3f}" for k, v in us.items() if v)
    log(f"  decode step device time (torch.profiler, {steps} steps at position "
        f"{pos + 1}): {busy_ms:.3f} ms/step busy [{parts}], "
        f"{n_kernels / steps:.0f} kernels/step; against {ms_per_token:.3f} "
        f"ms/token unprofiled the device is idle {1 - busy_ms / ms_per_token:.1%}")


def phase_model_parity(torch):
    """Phase 4: kernel path vs plain path through forward, 2 layers."""
    import dataclasses

    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama

    cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": 2})
    params = llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=G),
                                torch.Generator(device="cuda").manual_seed(1))
    params = llama.fuse_linears(llama.quantize_head(params, cfg), cfg)
    caches = [llama.init_kv_cache(cfg, 1, 512) for _ in range(2)]
    rng = torch.Generator().manual_seed(3)
    steps = [torch.randint(0, cfg.vocab_size, (1, 100), generator=rng)] + [
        torch.randint(0, cfg.vocab_size, (1, 1), generator=rng) for _ in range(8)]
    # bf16 model: the two paths round differently at every layer; 5e-2 of
    # the largest logit bounds their drift over two layers
    tol = 5e-2
    pos, agree, worst = 0, 0, 0.0
    for toks in steps:
        toks = toks.cuda()
        got, _ = llama.forward(params, cfg, toks, caches[0], pos)
        ref, _ = llama.forward(params, cfg, toks, caches[1], pos, impl="plain")
        err, rel = check(f"forward at start_pos {pos}", got, ref, tol)
        worst = max(worst, rel)
        agree += int(torch.equal(got[:, -1].argmax(-1), ref[:, -1].argmax(-1)))
        pos += toks.shape[1]
    log(f"  logits kernel vs plain: worst max_abs_err/max|ref| {worst:.3e} "
        f"(tol {tol:g}); greedy ids agree on {agree}/{len(steps)} steps")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers of the served model (width is Llama-3-8B's)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from awq_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t0 = time.perf_counter()
    took = _build.build_all()
    log(f"  nvcc ({_build.ARCH}): " + ", ".join(f"{k} {v:.1f} s" for k, v in took.items())
        + f"; wall {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernels against their plain versions (main-path shapes)")
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer(torch, reps=20)
    cases = []
    phase_kernels(torch, timer, cases)
    del timer
    torch.cuda.empty_cache()

    log(f"phase 3: serve three requests, Llama-3-8B width, {args.layers} layers")
    launches, _ = phase_serve(torch, args.layers)

    log("phase 4: forward, kernel path against plain path (2 layers)")
    phase_model_parity(torch)

    sources = {"w4a16_gemv": ("awq_tpu_torch/csrc/w4a16.cu",
                              "awq_tpu/ops/w4a16.py:388"),
               "w4a16_gemm": ("awq_tpu_torch/csrc/w4a16.cu",
                              "awq_tpu/ops/w4a16.py:388"),
               "flash_decode": ("awq_tpu_torch/csrc/decode_attn.cu",
                                "awq_tpu/ops/decode_attn.py:394"),
               "flash_prefill": ("awq_tpu_torch/csrc/decode_attn.cu",
                                 "awq_tpu/ops/decode_attn.py:691")}
    # one representative shape per kernel in the summary; every case is
    # printed above
    pick = {"w4a16_gemv": "wgateup M=1", "w4a16_gemm": "wgateup M=1000",
            "flash_decode": "len=4000", "flash_prefill": "S=512 start=700"}
    kernels = []
    for name, (src, replaces) in sources.items():
        c = next(c for c in cases if c["name"] == name and c["shape"].startswith(pick[name]))
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"], shape=c["shape"]))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
