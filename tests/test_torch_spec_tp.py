"""Single-stream speculation over a tensor-parallel group on the CPU: two
gloo ranks run ``InferenceEngine.generate_speculative`` on a ``RuntimeConfig
.mesh`` (the host verify loop, every window through ``tp_forward``) and emit
the ids of the one-device engine, as JAX's ``test_engine_speculative_on_mesh``
(``tests/test_mesh_compose.py:121``) holds its mesh engine to its one-chip
engine. Also JAX's refusals under a mesh: ``device_loop`` and a sampled
round.

The model is the port's own tiny llama (hidden 512, 4 q and 2 kv heads of
128, 2 layers, vocabulary 512, f32, W4-g128 from a seeded generator), built
in each rank from the seed. The ranks are spawned processes that meet
through a ``FileStore`` under the test's ``tmp_path`` and are joined with a
timeout, as in ``tests/test_torch_tp_engine.py``.
"""

import numpy as np
import torch

from awq_tpu_torch.config import GenConfig, ModelConfig, QuantConfig, RuntimeConfig

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

TP, JOIN_S = 2, 240
GEOM = dict(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=1024,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
            max_position_embeddings=256, dtype="float32")
PROMPT = [3, 4, 5, 3, 4, 5, 3, 4]
ROUND2 = [9, 10, 9, 10]


def _params():
    from awq_tpu_torch.models.llama import init_params, quantize_params

    cfg = ModelConfig(**GEOM)
    params = init_params(cfg, torch.Generator().manual_seed(15), scale=0.05, device="cpu")
    return cfg, quantize_params(params, QuantConfig(w_bit=4, group_size=128))


def _rounds(engine):
    """Two rounds of one dialogue, k = 3: each round's ids and stats."""
    out = []
    for prompt, n in ((PROMPT, 12), (ROUND2, 8)):
        r = engine.generate_speculative(prompt, n, k=3)
        out.append((r["output_ids"], r["stats"]))
    return out, engine.start_pos, engine._pending


def _rank_main(rank, store_path, out_path):
    import torch.distributed as dist

    from awq_tpu_torch.parallel.distributed import init_distributed
    from awq_tpu_torch.parallel.mesh import make_mesh
    from awq_tpu_torch.runtime.engine import InferenceEngine

    torch.set_num_threads(1)
    init_distributed("gloo", rank=rank, world_size=TP, timeout_s=JOIN_S,
                     store=dist.FileStore(store_path, TP), device="cpu")
    cfg, params = _params()
    eng = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=256, mesh=make_mesh(
        device="cpu")), cache_dtype=torch.float32)
    res = dict(rounds=_rounds(eng))
    errors = []
    for kw in (dict(device_loop=True),
               dict(gen=GenConfig(greedy=False, temperature=0.7, max_new_tokens=4))):
        try:
            eng.generate_speculative(PROMPT, 4, **kw)
        except (ValueError, NotImplementedError) as e:
            errors.append((type(e).__name__, str(e)))
    res["errors"] = errors
    torch.save(res, out_path)
    dist.destroy_process_group()


def test_engine_speculation_on_two_ranks_equals_one_device(tmp_path):
    import torch.multiprocessing as mp

    from awq_tpu_torch.runtime.engine import InferenceEngine

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp_path / "store"),
                                                  str(tmp_path / f"rank{r}.pt")))
             for r in range(TP)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(TP)]

    cfg, params = _params()
    one = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=256), cache_dtype=torch.float32,
                          device="cpu")
    want = _rounds(one)
    plain = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=256),
                            cache_dtype=torch.float32, device="cpu")
    greedy = [plain.generate(p, GenConfig(greedy=True, max_new_tokens=n))["output_ids"].tolist()
              for p, n in ((PROMPT, 12), (ROUND2, 8))]
    for res in ranks:
        (r1, s1), (r2, s2) = res["rounds"][0]
        assert [r1, r2] == [want[0][0][0], want[0][1][0]] == greedy
        for got, ref in ((s1, want[0][0][1]), (s2, want[0][1][1])):
            assert {k: int(np.max(v)) for k, v in got.items()} == \
                {k: int(np.max(v)) for k, v in ref.items()}
        assert res["rounds"][1:] == want[1:]
        assert [name for name, _ in res["errors"]] == ["ValueError", "NotImplementedError"]
        assert "device_loop" in res["errors"][0][1] and "17b" in res["errors"][1][1]
