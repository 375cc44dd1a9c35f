#!/usr/bin/env python3
"""Where a window of K5 (the chunk megakernel) spends its time: a copy of
the unit's source with ``%globaltimer`` stamps at every phase boundary of
every block (thread 0, ``scripts/exp_batched_phases.py``'s ``stamped``),
built into ``build/exp_chunk_phases/`` (not part of the port) and run
through ``w4a16_llama_chunk_step`` at Llama-3-8B width (32 layers, random
weights from a seed, a cache of 4160 positions filled at random).

    python3 scripts/exp_chunk_phases.py [--shapes 16:0,32:0,16:700,32:700] [--reps 3]
        [--cache bf16] [--w3] [--tree OTHER] [--cluster C] [--probe]

A shape is ``S:hist``: S window rows at positions [hist, hist + S). For each
shape the script prints the window's time without stamps (``chip_smoke.Timer``)
and each segment's median over the grid's blocks in microseconds a layer:
``work`` ends at a grid barrier, ``barrier`` is the wait in it,
``stage``/``pre`` a staging of rows and the time before it (where the body
stages rows). ``--tree`` runs another checkout instead (e.g. the parent,
unpacked with ``git archive`` into a git-ignored directory): its own
``awq_tpu_torch`` wrapper, ``chip_smoke`` and K5 source, built with its own
headers. ``--cluster`` sets the checkout's ``megakernel_chunk.CLUSTER``.

``--variants`` adds stamped what-if builds (``exp_batched_phases.variant``:
``nomma`` the weight stream alone, ``compute`` the consumers' products
alone, ``nomerge`` no cluster merge: each rank's own sums; their results
are wrong).

``--probe`` first asks the card whether a cooperative launch with a
thread-block cluster dimension (``cudaLaunchKernelEx`` with
``cudaLaunchAttributeCooperative`` and ``cudaLaunchAttributeClusterDimension``)
runs, ``grid.sync()``s and reads a neighbour's shared memory, for clusters of
1, 2, 4 and 8 blocks of 288 threads and 200 KB, and prints the grid it got.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void probe_kernel(int* out, int rounds) {
  extern __shared__ int sm[];
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) sm[0] = blockIdx.x;
  cl.sync();
  const int peer = *cl.map_shared_rank(sm, (cl.block_rank() + 1) % cl.num_blocks());
  cl.sync();
  for (int r = 0; r < rounds; ++r) {
    if (threadIdx.x == 0) atomicAdd(&out[r], 1);
    grid.sync();
    if (threadIdx.x == 0 && out[r] != (int)gridDim.x) atomicAdd(&out[rounds], 1);
    grid.sync();
  }
  if (threadIdx.x == 0 && peer != (int)(blockIdx.x - cl.block_rank() + (cl.block_rank() + 1) % cl.num_blocks()))
    atomicAdd(&out[rounds], 1);
}
extern "C" int probe(int cluster, int smem, int* grid, int* bad) {
  cudaError_t e = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.blockDim = dim3(288); cfg.gridDim = dim3(cluster); cfg.dynamicSmemBytes = smem;
  cfg.attrs = at; cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, probe_kernel, &cfg);
  if (e) return e;
  *grid = n * cluster;
  cfg.gridDim = dim3(n * cluster); cfg.numAttrs = 2;
  int* out; const int rounds = 4;
  cudaMalloc(&out, (rounds + 1) * sizeof(int));
  cudaMemset(out, 0, (rounds + 1) * sizeof(int));
  e = cudaLaunchKernelEx(&cfg, probe_kernel, out, rounds);
  if (!e) e = cudaDeviceSynchronize();
  int h[rounds + 1];
  cudaMemcpy(h, out, sizeof(h), cudaMemcpyDeviceToHost);
  cudaFree(out);
  *bad = h[rounds];
  return e;
}
"""


# ``fine``: stamps inside a matmul phase's waves, at these ids
FINE0 = 90
FINE = ("wave gap (last wave's end)", "wave rounds", "wave sums into tot", "wave merge")
# ``finer``: stamps inside a wave's end, at these ids
FINER0 = 80
FINER = ("wave rounds, red written", "red barrier", "mfree wait", "tot written", "tot barrier",
         "mready wait", "merge epilogue", "merge end barrier")


def chunk_variant(base_variant, ring=None):
    """``exp_batched_phases.variant`` with K5's own what-if: ``nomerge``, the
    cluster merge without its waits and with each rank's own sums alone
    (results wrong); with ``ring`` every build's ring holds that many KB."""

    def variant(src: str, name: str) -> str:
        old = "constexpr int RING_BYTES = 60 * 1024;"
        if ring and old in src:
            src = src.replace(old, f"constexpr int RING_BYTES = {ring} * 1024;")
        if "+" in name:
            for part in name.split("+"):
                src = variant(src, part)
            return src
        if name == "finer":
            for old, new in (
                    ("      hop::bar_sync(CB, 32 * K6_WARPS);\n      // the sum of tile slot t's warps",
                     "      MK_T(FINER0);\n      hop::bar_sync(CB, 32 * K6_WARPS);\n      MK_T(FINER0 + 1);\n"
                     "      // the sum of tile slot t's warps"),
                    ("        if (last && a.cl > 1 && nmerge > 0) cluster_wait(s.mfree, (nmerge - 1) & 1);\n",
                     "        if (last && a.cl > 1 && nmerge > 0) cluster_wait(s.mfree, (nmerge - 1) & 1);\n"
                     "        MK_T(FINER0 + 2);\n"),
                    ("  hop::bar_sync(CB, 32 * K6_WARPS);                 // tot is written\n",
                     "  MK_T(FINER0 + 3);\n  hop::bar_sync(CB, 32 * K6_WARPS);\n  MK_T(FINER0 + 4);\n"),
                    ("    cluster_wait(s.mready, nmerge & 1);             // every rank's tot is written\n  }\n",
                     "    cluster_wait(s.mready, nmerge & 1);\n  }\n  MK_T(FINER0 + 5);\n"),
                    ("  if (cl > 1) {\n    hop::bar_sync(CB, 32 * K6_WARPS);               // this rank has read every tot\n",
                     "  MK_T(FINER0 + 6);\n  if (cl > 1) {\n    hop::bar_sync(CB, 32 * K6_WARPS);\n    MK_T(FINER0 + 7);\n")):
                assert old in src, old
                src = src.replace(old, new)
            return src.replace("namespace {", f"#define FINER0 {FINER0}\nnamespace {{", 1)
        if name == "fine":
            for old, new in (
                    ("      const int nr = (wc + K - 1) / K;\n",
                     "      MK_T(FINE0);\n      const int nr = (wc + K - 1) / K;\n"),
                    ("      seq += nr;\n", "      seq += nr;\n      MK_T(FINE0 + 1);\n"),
                    ("        if (last) merge_wave(a, s, d, ph, l, o, st, lo, hi, nmerge++);\n",
                     "        MK_T(FINE0 + 2);\n"
                     "        if (last) merge_wave(a, s, d, ph, l, o, st, lo, hi, nmerge++);\n"
                     "        MK_T(FINE0 + 3);\n"),
                    ):
                assert old in src, old
                src = src.replace(old, new)
            return src.replace("namespace {", f"#define FINE0 {FINE0}\nnamespace {{", 1)
        if name in ("noinl", "noinlm"):
            old, new = (("template <typename CT>\n__device__ void attention_chunk(",
                         "template <typename CT>\n__device__ __noinline__ void attention_chunk(")
                        if name == "noinl" else
                        ("__device__ void merge_wave(", "__device__ __noinline__ void merge_wave("))
            assert old in src, old
            return src.replace(old, new)
        if name == "nofence":
            old = "      fence_proxy_global();\n      continue;\n    }\n    const int tt = lo + t"
            assert old in src
            return src.replace(old, "      continue;\n    }\n    const int tt = lo + t")
        if name != "nomerge":
            return base_variant(src, name)
        for old, new in (
                ("    cluster_wait(s.mready, nmerge & 1);", ""),
                ("if (last && a.cl > 1 && nmerge > 0) cluster_wait(s.mfree, (nmerge - 1) & 1);", ""),
                ("v += cl > 1 ? ld_cluster_f32(hop::cluster_map(s.tot, q) + 4u * idx) : s.tot[idx];",
                 "v += s.tot[idx];")):
            assert old in src, old
            src = src.replace(old, new)
        return src

    return variant


def run_probe() -> None:
    from awq_tpu_torch import _build

    d = ROOT / "build" / "exp_chunk_phases"
    d.mkdir(parents=True, exist_ok=True)
    (d / "probe.cu").write_text(PROBE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "probe.so"),
                    str(d / "probe.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "probe.so"))
    for c in (1, 2, 4, 8):
        grid, bad = ctypes.c_int(0), ctypes.c_int(-1)
        err = lib.probe(c, 200 * 1024, ctypes.byref(grid), ctypes.byref(bad))
        print(f"probe: cooperative launch with clusters of {c}: error {err}, grid "
              f"{grid.value} blocks, {bad.value} wrong reads or early passes", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="16:0,32:0,16:700,32:700")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cache", default="bf16", choices=("f32", "bf16", "f16"))
    ap.add_argument("--w3", action="store_true", help="a W3 model and the W3 unit")
    ap.add_argument("--tree", type=Path, default=ROOT, help="the checkout to run")
    ap.add_argument("--cluster", type=int, help="blocks a cluster (the checkout's K5)")
    ap.add_argument("--variants", default="base",
                    help="stamped what-if builds: base,nomma,compute,nomerge,fine,finer,nofence,noinl,noinlm")
    ap.add_argument("--ring", type=int, help="the ring's KB (both the host plan and the source)")
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    tree = args.tree.resolve()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exp_chunk_phases: no CUDA device", file=sys.stderr)
        return 2
    import exp_batched_phases as ebp       # puts the checkout on the path: the tree goes first

    ebp.variant = chunk_variant(ebp.variant, args.ring)

    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from awq_tpu_torch import _build
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    if args.probe:
        run_probe()
    from awq_tpu_torch.ops import megakernel_chunk as mkc

    assert Path(_build.__file__).resolve().is_relative_to(tree), _build.__file__
    if args.cluster:
        mkc.CLUSTER = args.cluster
    if args.ring:
        from awq_tpu_torch.ops import megakernel_batched as mkb

        mkb.RING_BYTES = args.ring * 1024
    unit = f"megakernel_chunk_{args.cache}" + ("_w3" if args.w3 else "")
    stem, defines = _build.UNITS[unit]
    src = _build.CSRC / f"{stem}.cu"
    ebp.KERNEL = "chunk_kernel(" if "chunk_kernel(" in src.read_text() else "batched_kernel("
    out = ROOT / "build" / "exp_chunk_phases" / tree.name
    procs, labels = {}, {}
    for var in args.variants.split(","):
        procs[var] = ebp.build(out, var.replace("+", "_"), src, defines, True, var)
    procs["plain"] = ebp.build(out, "plain", src, defines, False, "base")
    libs = {}
    for name, (p, path, lab) in procs.items():
        if p.wait():
            print((path.parent / "build.log").read_text()[-4000:])
            return 1
        lib = ctypes.CDLL(str(path))
        lib.awq_error_string.restype = ctypes.c_char_p
        lib.awq_error_string.argtypes = [ctypes.c_int]
        libs[name] = lib
        if lab:
            if "finer" in name.split("+"):
                lab = lab + [""] * (FINER0 - len(lab)) + list(FINER)
            if "fine" in name.split("+"):
                lab = lab + [""] * (FINE0 - len(lab)) + list(FINE)
            labels[name] = lab
        regs = " | ".join(ln.strip() for ln in (path.parent / "build.log").read_text().splitlines()
                          if "registers" in ln or "spill" in ln)
        print(f"{tree.name} {name}: built ({len(lab)} stamps); ptxas: {regs}", flush=True)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4321)
    cfg = ModelConfig(**cs.LLAMA3_8B)
    H, L = cfg.hidden_size, cfg.num_layers
    wb = 3 if args.w3 else 4
    params = llama.fuse_linears(llama.init_qparams(cfg, QuantConfig(w_bit=wb, group_size=128),
                                                   gen), cfg)
    la = params["layers"]
    args6 = (la["wqkv"], la["wo"], la["wgateup"], la["down"], la["ln1"], la["ln2"])
    t_cache = 4096 + 64
    cache = llama.init_kv_cache(cfg, 1, t_cache).to(
        {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[args.cache])
    cache.normal_(generator=gen)
    cos, sin = llama.rope_table(cfg, t_cache, device=dev)
    timer = cs.Timer(torch, 20)
    zero = np.zeros((1024, ebp.NSTAMP), dtype=np.uint64)
    buf = np.zeros_like(zero)
    for shape in args.shapes.split(","):
        s, hist = (int(v) for v in shape.split(":"))
        h = (torch.randn((s, H), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        step = (h, *args6, cos[hist:hist + s], sin[hist:hist + s], cache, hist,
                cfg.num_heads, cfg.num_kv_heads, cfg.rms_eps)
        run = lambda: mkc.w4a16_llama_chunk_step(*step)
        _build._LIBS[unit] = libs["plain"]
        print(f"S={s} hist={hist}: window {timer(run):.4f} ms (no stamps)", flush=True)
        for name in labels:
            lib = libs[name]
            _build._LIBS[unit] = lib
            runs = []
            for _ in range(args.reps):
                run()
                torch.cuda.synchronize()
                lib.awq_mk_zero(ctypes.c_void_p(zero.ctypes.data))
                cs.Timer(torch, 1)(run, reps=1)      # the flushed L2 as in the timing
                torch.cuda.synchronize()
                lib.awq_mk_acc(ctypes.c_void_p(buf.ctypes.data))
                runs.append(buf.astype(np.float64).copy() / 2)   # two calls a turn
            st = timer(run)
            used = runs[0].sum(axis=1) > 0
            print(f"  {name}: {st:.4f} ms with stamps, {int(used.sum())} blocks; us a layer "
                  "(median over blocks):", flush=True)
            per = {}
            for sid, lab in enumerate(labels[name]):
                per.setdefault(lab, []).append(sid)
            total = 0.0
            for lab, ids in per.items():
                once = lab.startswith(("load", "head"))
                vals = [np.median(r[used][:, ids].sum(axis=1)) / 1e3 / (1 if once else L)
                        for r in runs]
                v = statistics.median(vals)
                total += v * (1 if once else L)
                print(f"    {lab:<32} {v:10.2f}", flush=True)
            print(f"    (sum of medians over the window {total / 1e3:.3f} ms)", flush=True)
        _build._LIBS.pop(unit, None)
    print(f"nvidia-smi: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
