"""Probe: does a decode step of the port capture into a CUDA graph on this
card, and what does the graph hold?

For a 2-layer random model at Llama-3-8B's head shape (head_dim 128, 4 q
over 2 kv heads) it builds the units the single-stream decode runs, then
per path (K4 whole-token; the stacked path: K1's GEMV, K2; the int8
cache: K9, K7's int8 mode; a falcon-shaped model: K14) it runs 47 greedy
steps through the forward loop (``decode_scan``, a host position) and
through ``DecodeLoop`` (the step captured and replayed), prints the
graph's nodes by type (``cudaGraphGetNodes`` through the runtime, where
PyTorch hands out the graph) and compares the ids: on K4 they must be
equal (K4 splits its attention by the position it reads); the stacked
kernels plan for the burst's bound, so theirs are printed. On K4 it then
tries a sampled step with its generator registered with the graph
(``probe_sampled``). K4 is a cooperative launch from a ctypes unit that links its
own CUDA runtime: its node must be in the graph, or the replay computes
nothing.

    python scripts/probe_decode_graph.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from awq_tpu_torch import _build  # noqa: E402
from awq_tpu_torch.config import GenConfig, ModelConfig, QuantConfig  # noqa: E402
from awq_tpu_torch.models import llama  # noqa: E402
from awq_tpu_torch.runtime.generate import DecodeLoop, decode_scan, plan_bound  # noqa: E402
from awq_tpu_torch.runtime.sampling import sample_logits  # noqa: E402

GEOMS = {
    "llama": dict(arch="llama", vocab_size=1024, hidden_size=512, intermediate_size=1024,
                  num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                  max_position_embeddings=2048, dtype="bfloat16"),
    "falcon": dict(arch="falcon", vocab_size=1024, hidden_size=320, intermediate_size=1280,
                   num_layers=2, num_heads=5, num_kv_heads=1, head_dim=64,
                   max_position_embeddings=2048, dtype="bfloat16", norm="layernorm",
                   act="gelu", parallel_block=True, single_ln=True),
}
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "wait_event", 7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def graph_nodes(g) -> str:
    """The graph's nodes by type, or why they cannot be read."""
    raw = getattr(g, "raw_cuda_graph", None)
    if raw is None:
        return "not read (this PyTorch has no CUDAGraph.raw_cuda_graph)"
    try:
        handle = ctypes.c_void_p(raw())
        rt = ctypes.CDLL("libcudart.so")
    except Exception as e:        # noqa: BLE001 - reported, not hidden
        return f"not read ({type(e).__name__}: {e})"
    n = ctypes.c_size_t(0)
    if rt.cudaGraphGetNodes(handle, None, ctypes.byref(n)):
        return "not read (cudaGraphGetNodes failed)"
    nodes = (ctypes.c_void_p * n.value)()
    rt.cudaGraphGetNodes(handle, nodes, ctypes.byref(n))
    counts = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        name = NODE_TYPES.get(t.value, str(t.value))
        counts[name] = counts.get(name, 0) + 1
    return f"{n.value} nodes {counts}"


def probe_sampled(params, cfg, cache, dev, steps: int = 24) -> None:
    """Whether a sampled decode step (K4, then ``sample_logits`` drawing
    from an explicit CUDA generator registered with the graph) captures,
    and whether its replays draw the ids of the forward loop from the same
    seed. Prints the result or the error; decides nothing."""
    gen = GenConfig(temperature=0.8, top_k=40, top_p=0.9, max_new_tokens=steps + 1)
    first = torch.tensor([11], device=dev)

    def fresh():
        for t in llama.cache_tensors(cache):
            t.zero_()
        return torch.Generator(device=dev).manual_seed(13)

    seen = torch.zeros((1, cfg.vocab_size), dtype=torch.bool, device=dev)
    want = decode_scan(lambda tok, pos: llama.forward(params, cfg, tok[:, None], cache,
                                                      pos)[0][:, -1],
                       first, 100, [], seen, gen, steps, fresh()).tolist()
    rng = fresh()
    tok, pos = first.clone(), torch.tensor([100], dtype=torch.int32, device=dev)
    out = torch.zeros((1, steps), dtype=torch.long, device=dev)
    idx = torch.zeros((1,), dtype=torch.long, device=dev)
    seen = torch.zeros((1, cfg.vocab_size), dtype=torch.bool, device=dev)

    def body():
        logits = llama.decode_step(params, cfg, tok, cache, pos, 255)
        nxt = sample_logits(logits, gen, seen, rng)
        seen.scatter_(1, nxt[:, None], True)
        out.index_copy_(1, idx, nxt[:, None])
        tok.copy_(nxt)
        pos.add_(1)
        idx.add_(1)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        g.register_generator_state(rng)
        with torch.cuda.graph(g):
            body()
        for _ in range(steps - 1):
            g.replay()
        torch.cuda.synchronize()
    except Exception as e:          # noqa: BLE001 - the probe's finding, printed
        print(f"sampled: the step does not capture: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:300]}", flush=True)
        return
    got = out.tolist()
    print(f"sampled: captured with the generator registered; replayed ids "
          f"{'equal' if got == want else 'DIFFER from'} the forward loop's from the same seed "
          f"({got[0][:8]} against {want[0][:8]})", flush=True)


def main() -> int:
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    t0 = time.perf_counter()
    _build.build_all(["megakernel", "decode_attn", "w4a16", "cache_append"])
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    ok = True
    import os

    for path in ("megakernel", "stacked", "int8", "falcon"):
        if path in ("stacked", "int8"):
            os.environ["AWQ_TPU_DISABLE_MEGAKERNEL"] = "1"
        else:
            os.environ.pop("AWQ_TPU_DISABLE_MEGAKERNEL", None)
        cfg = ModelConfig(**GEOMS["falcon" if path == "falcon" else "llama"])
        params = llama.init_qparams(cfg, QuantConfig(w_bit=4, group_size=64 if path == "falcon"
                                                     else 128),
                                    torch.Generator(device=dev).manual_seed(5), device=dev)
        params = llama.fuse_linears(params, cfg)
        if path != "falcon":
            params = llama.quantize_head(params, cfg)
        cache = llama.init_cache(cfg, 1, 2048, "int8" if path == "int8" else torch.bfloat16,
                                 device=dev)
        gen = GenConfig(greedy=True, max_new_tokens=48)
        first = torch.tensor([11], device=dev)
        for t in llama.cache_tensors(cache):
            t.zero_()
        seen = torch.zeros((1, cfg.vocab_size), dtype=torch.bool, device=dev)
        fwd = decode_scan(lambda tok, pos: llama.forward(params, cfg, tok[:, None], cache,
                                                         pos)[0][:, -1],
                          first, 100, [], seen, gen, 47).tolist()
        for t in llama.cache_tensors(cache):
            t.zero_()
        loop = DecodeLoop(params, cfg, cache)
        seen = torch.zeros((1, cfg.vocab_size), dtype=torch.bool, device=dev)
        t1 = time.perf_counter()
        out = loop.run(first, 100, [], seen, gen, 47, plan_bound(2048, 148)).tolist()
        torch.cuda.synchronize()
        # the step once more into a graph that keeps its cudaGraph_t
        # (recorded, not run), to read its nodes
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, pool=loop.pool):
            loop._body()
        print(f"{path}: captured in {loop.capture_s * 1e3:.1f} ms, pool "
              f"{loop.pool_bytes / 2**20:.1f} MiB; graph {graph_nodes(g)}; burst "
              f"{time.perf_counter() - t1:.3f} s", flush=True)
        same = fwd == out
        ok &= same or path != "megakernel"
        print(f"{path}: replayed ids {'equal' if same else 'DIFFER from'} the forward loop's "
              f"({out[0][:8]} ...)", flush=True)
        if path == "megakernel":
            probe_sampled(params, cfg, cache, dev)
    print("probe", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
