#!/usr/bin/env python3
"""Host costs of the prefill kernels' launches on one NVIDIA GPU: the TMA
descriptors encoded per launch and the split-K reduce launches.

    python3 scripts/host_costs.py [--layers 32] [--reps 2000]

1. Builds a small program from ``awq_tpu_torch/csrc/hopper.cuh`` with nvcc
   (into ``build/host_costs/``) that times ``hop::make_map`` and
   ``hop::make_map3`` (``cuTensorMapEncodeTiled``) on device buffers of
   Llama-3-8B's shapes, per descriptor kind the prefill kernels encode on
   every launch: K1's GEMM 4 (x, codes, scales, szeros), K10 2 (x, codes),
   K11 2 (x, w8), K3 1 (the cache, 3-D). Median ns per encode over
   ``--reps`` calls.
2. Builds a random W4A16-g128 model of Llama-3-8B's widths (``--layers``
   layers, seed 0) and runs 32- and 1000-token prefills from position 0
   on the stacked per-kernel path (``AWQ_TPU_DISABLE_MEGAKERNEL=1``: K1's
   GEMM, K3) under ``torch.profiler``: launches by kernel, the split-K
   reduce launches and their device time, the mean host time of a kernel
   launch (the ``cudaLaunchKernel`` runtime calls), and the prefill's host
   time (enqueue, and to the end of the device work; medians of 5).

It prints the card's name and power limit, each number, and per prefill
the descriptors' encode time and the reduce launches' host and device time
against the prefill's host time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BENCH_CU = r'''
#include "hopper.cuh"
#include <chrono>
#include <cstdio>
#include <vector>
#include <algorithm>

// Median ns of one encode of `f` over reps calls (batches of 100).
template <typename F> static double med_ns(F f, int reps) {
  std::vector<double> ts;
  for (int r = 0; r < reps / 100; ++r) {
    auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < 100; ++i) f();
    ts.push_back(std::chrono::duration<double, std::nano>(std::chrono::steady_clock::now() - t0).count() / 100);
  }
  std::sort(ts.begin(), ts.end());
  return ts[ts.size() / 2];
}

int main(int argc, char** argv) {
  const int reps = argc > 1 ? atoi(argv[1]) : 2000;
  const int M = 1000, IC = 4096, OC = 28672, G = 128, T = 2048, NKV = 8, HD = 128;
  void *x, *q, *s, *w8, *cache;
  if (cudaMalloc(&x, (size_t)M * IC * 2) || cudaMalloc(&q, (size_t)IC / 8 * OC * 4) ||
      cudaMalloc(&s, (size_t)IC / G * OC * 4) || cudaMalloc(&w8, (size_t)IC * OC) ||
      cudaMalloc(&cache, (size_t)2 * NKV * T * HD * 2)) { printf("{}\n"); return 1; }
  CUtensorMap m;
  int err = 0;
  const double x_bf16 = med_ns([&] { err |= hop::make_map(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, IC, M, 64, 128, true); }, reps);
  const double codes = med_ns([&] { err |= hop::make_map(&m, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, q, OC, IC / 8, 128, 16, false); }, reps);
  const double scales = med_ns([&] { err |= hop::make_map(&m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, s, OC, IC / G, 128, 1, false); }, reps);
  const double x_int8 = med_ns([&] { err |= hop::make_map(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, IC, M, 128, 128, true); }, reps);
  const double w_int8 = med_ns([&] { err |= hop::make_map(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w8, IC, OC, 128, 128, true); }, reps);
  const double kv3 = med_ns([&] { err |= hop::make_map3(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, cache, HD, 1000, 2 * NKV, HD, (uint64_t)T * HD, 64, 64); }, reps);
  printf("{\"err\": %d, \"x_bf16\": %.1f, \"codes\": %.1f, \"scales\": %.1f, \"x_int8\": %.1f, "
         "\"w_int8\": %.1f, \"kv_3d\": %.1f}\n", err, x_bf16, codes, scales, x_int8, w_int8, kv3);
  return err;
}
'''


def encode_costs(reps: int) -> dict:
    from awq_tpu_torch import _build

    out = ROOT / "build" / "host_costs"
    out.mkdir(parents=True, exist_ok=True)
    src, exe = out / "encode_bench.cu", out / "encode_bench"
    src.write_text(BENCH_CU)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.nvcc_path(), *flags, "-I", str(_build.CSRC), "-o", str(exe),
                    str(src)], check=True, capture_output=True, text=True)
    ns = json.loads(subprocess.run([str(exe), str(reps)], check=True, capture_output=True,
                                   text=True).stdout)
    if ns.pop("err"):
        raise RuntimeError("a descriptor failed to encode")
    return {"K1 GEMM": ns["x_bf16"] + ns["codes"] + 2 * ns["scales"],
            "K10": ns["x_int8"] + ns["codes"],
            "K11": ns["x_int8"] + ns["w_int8"], "K3": ns["kv_3d"], "per kind": ns}


def prefill_costs(torch, engine, n: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from awq_tpu_torch.models.llama import forward

    toks = torch.randint(0, engine.cfg.vocab_size, (1, n),
                         generator=torch.Generator().manual_seed(5)).cuda()
    enq, wall = [], []
    for _ in range(6):
        engine.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(engine.params, engine.cfg, toks, engine.cache, 0)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append(t1 - t0)
        wall.append(time.perf_counter() - t0)
    engine.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward(engine.params, engine.cfg, toks, engine.cache, 0)
        torch.cuda.synchronize()
    engine.reset()
    kernels, reduce_n, reduce_us, launch_us = {}, 0, 0.0, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0) + 1
            if "splitk_reduce" in e.name or "splitk_epilogue" in e.name:
                reduce_n += 1
                reduce_us += e.time_range.elapsed_us()
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"):
            launch_us.append(e.time_range.elapsed_us())
    return {"tokens": n, "kernels": sum(kernels.values()),
            "enqueue_ms": statistics.median(enq[1:]) * 1e3,
            "wall_ms": statistics.median(wall[1:]) * 1e3,
            "reduce_launches": reduce_n, "reduce_device_ms": reduce_us / 1e3,
            "launch_host_us": statistics.median(launch_us) if launch_us else None,
            "k1_gemm_launches": sum(v for k, v in kernels.items() if "w4a16_wgmma" in k),
            "k3_launches": sum(v for k, v in kernels.items() if "flash_prefill" in k)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--reps", type=int, default=2000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("host_costs: no CUDA device", file=sys.stderr)
        return 2
    os.environ["AWQ_TPU_DISABLE_MEGAKERNEL"] = "1"
    from awq_tpu_torch.config import ModelConfig, QuantConfig, RuntimeConfig
    from awq_tpu_torch.models.llama import init_qparams
    from awq_tpu_torch.runtime.engine import InferenceEngine
    from chip_smoke import G, LLAMA3_8B

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    enc = encode_costs(args.reps)
    print("descriptor encode, ns per launch: " + ", ".join(
        f"{k} {v:.0f}" for k, v in enc.items() if k != "per kind")
          + "; per descriptor " + json.dumps(enc["per kind"]), flush=True)

    cfg = ModelConfig(**{**LLAMA3_8B, "num_layers": args.layers})
    params = init_qparams(cfg, QuantConfig(w_bit=4, group_size=G),
                          torch.Generator(device="cuda").manual_seed(0))
    engine = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=2048, quantize_head=True))
    del params
    for n in (32, 1000):
        c = prefill_costs(torch, engine, n)
        enc_us = (c["k1_gemm_launches"] * enc["K1 GEMM"] + c["k3_launches"] * enc["K3"]) / 1e3
        red_host = (c["reduce_launches"] * c["launch_host_us"]) if c["launch_host_us"] else 0.0
        print(f"{n}-token stacked prefill, {args.layers} layers: {c['kernels']} kernels, host "
              f"enqueue {c['enqueue_ms']:.3f} ms, to the end of the device work "
              f"{c['wall_ms']:.3f} ms; {c['k1_gemm_launches']} K1 GEMM and "
              f"{c['k3_launches']} K3 launches encode descriptors for {enc_us:.1f} us "
              f"({enc_us / 1e3 / c['enqueue_ms'] * 100:.2f}% of the enqueue); "
              f"{c['reduce_launches']} split-K reduce launches: device "
              f"{c['reduce_device_ms'] * 1e3:.1f} us, host ~{red_host:.1f} us at "
              f"{c['launch_host_us']} us a launch "
              f"({red_host / 1e3 / c['enqueue_ms'] * 100:.2f}% of the enqueue)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
