"""Free-running greedy ids of tensor-parallel serving on the JAX package's
own tp inputs (``tests/test_megakernel_tp.py``): the geometry of
``_flash_cfg`` (f32, hidden 512, 4 q and 2 kv heads, 2 layers, vocabulary
512), its weights at their default init scale from seeds 3 (f32 cache), 11
(qwen2, the q/k/v biases of keys 1, 2, 3 at 0.1) and 5 (int8 cache), its
two 16-token prompts (key 4) and a quantized head.

JAX serves them as its test does, on a dp = 2, tp = 2 mesh of the virtual
CPU devices: ``tp_forward``, then 16 steps of ``tp_decode_scan`` on its
half-layer kernels (rows 19 and 20, interpret mode). The port serves each
prompt through an ``InferenceEngine`` over two gloo ranks on the CPU (K12
and K13's plain versions), and through its single-device engine (K4's
plain version, the path that serves on the card). All three must choose
the same 17 ids (the prefill's and 16 decode steps', each fed back) or
part only at a tie (``_parting``): of the six sequences, one parts, at
the f32 case's first prompt's 15th decode step, where the port's tp
logits of the two ids lie 1.8e-3 apart (PERF.md). The
port's weights are JAX's with the scales and szeros rounded to bf16, the
values JAX's tp deploy layout folds into its qparam rows and its kernels
compute with.

The ranks are spawned processes that meet through a ``FileStore`` under
the test's ``tmp_path``, joined with a timeout, one spawn for the module.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import GenConfig, ModelConfig as TConfig, RuntimeConfig

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

TP, STEPS, JOIN_S = 2, 16, 240
GEOM = dict(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=1024,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
            max_position_embeddings=256, dtype="float32")
# case: (arch, init seed, cache dtype), as test_megakernel_tp.py's three parity tests
CASES = {"f32": ("llama", 3, torch.float32), "qwen2": ("qwen2", 11, torch.float32),
         "int8": ("llama", 5, "int8")}


def _cfg(arch):
    return dict(GEOM, arch=arch, qkv_bias=arch == "qwen2")


def _serve(engine, prompts):
    """Each prompt as a fresh dialogue: its 17 greedy ids."""
    gen = GenConfig(greedy=True, max_new_tokens=STEPS + 1)
    out = []
    for p in prompts:
        engine.reset()
        out.append(engine.generate(p, gen, continue_dialogue=False)["output_ids"].tolist())
    return out


def _replay(engine, cache_dtype, prompt, ids, mesh):
    """The logits from which the tp engine chose each of ``ids``: its
    prefill of ``prompt``, then ``ids[:-1]`` fed one at a time, through
    ``tp_forward`` on the engine's params and a fresh cache (``[17, V]``)."""
    from awq_tpu_torch.models.llama import init_cache
    from awq_tpu_torch.parallel.tp import tp_forward, tp_local_cfg

    cache = init_cache(tp_local_cfg(engine.cfg, TP), 1, 256, cache_dtype, device="cpu")
    steps, pos, out = [prompt] + [[t] for t in ids[:-1]], 0, []
    for toks in steps:
        out.append(tp_forward(engine.params, engine.cfg, torch.tensor([toks]), cache, pos,
                              mesh)[0][0, -1])
        pos += len(toks)
    return torch.stack(out).numpy()


def _rank_main(rank, store_path, data_path, out_path):
    """One rank: per case, the two prompts through an ``InferenceEngine``
    over the group, counting the half-layer kernel calls, then the logits
    each id was chosen from (``_replay``)."""
    import torch.distributed as dist

    from awq_tpu_torch.ops import megakernel_tp as mtp
    from awq_tpu_torch.parallel.distributed import init_distributed
    from awq_tpu_torch.parallel.mesh import make_mesh
    from awq_tpu_torch.runtime.engine import InferenceEngine

    torch.set_num_threads(1)
    os.environ["AWQ_TPU_TP_MEGAKERNEL"] = "1"
    init_distributed("gloo", rank=rank, world_size=TP, timeout_s=JOIN_S,
                     store=dist.FileStore(store_path, TP), device="cpu")
    mesh = make_mesh(device="cpu")
    calls = {"attn": 0, "mlp": 0}
    real = (mtp.w4a16_llama_attn_half, mtp.w4a16_llama_mlp_half)

    def attn(*a, **kw):
        calls["attn"] += 1
        return real[0](*a, **kw)

    def mlp(*a, **kw):
        calls["mlp"] += 1
        return real[1](*a, **kw)

    mtp.w4a16_llama_attn_half, mtp.w4a16_llama_mlp_half = attn, mlp
    data = torch.load(data_path, weights_only=False)
    out = {}
    for name, (arch, _, cache_dtype) in CASES.items():
        cfg = TConfig(**_cfg(arch))
        engine = InferenceEngine(cfg, data["params"][name],
                                 RuntimeConfig(max_seq_len=256, quantize_head=True, mesh=mesh),
                                 cache_dtype=cache_dtype)
        ids = _serve(engine, data["prompts"])
        out[name] = dict(ids=ids, **calls)
        out[name]["logits"] = [_replay(engine, cache_dtype, p, i, mesh)
                               for p, i in zip(data["prompts"], ids)]
        calls.update(attn=0, mlp=0)
    torch.save(out, out_path)
    dist.destroy_process_group()


def _bf16(x):
    import jax.numpy as jnp

    return x.astype(jnp.bfloat16).astype(jnp.float32)


@pytest.fixture(scope="module")
def jax_side():
    """Per case: JAX's plain params (host copies, for the port: scales and
    szeros rounded to bf16) and the 17 ids of each prompt through JAX's
    tp = 2 ``tp_forward`` and ``tp_decode_scan``."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen, ModelConfig, QuantConfig
    from awq_tpu.models import forward, init_kv_cache
    from awq_tpu.models.llama import init_kv_cache8, init_params, quantize_params
    from awq_tpu.ops.w4a16 import QLinear as JQLinear
    from awq_tpu.parallel import MeshConfig, build_tp_params, make_mesh, tp_decode_scan, tp_forward

    mesh = make_mesh(MeshConfig(dp=2, tp=2))
    tokens = jax.random.randint(jax.random.PRNGKey(4), (2, 16), 0, GEOM["vocab_size"])
    out = {"prompts": np.asarray(tokens).tolist(), "params": {}, "ids": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AWQ_TPU_FORCE_FLASH", "1")
        forward.clear_cache()
        for name, (arch, seed, cache_dtype) in CASES.items():
            cfg = ModelConfig(**_cfg(arch))
            params = quantize_params(init_params(cfg, jax.random.PRNGKey(seed)),
                                     QuantConfig(w_bit=4, group_size=128))
            if arch == "qwen2":
                la = dict(params["layers"])
                for n, key in (("wq", 1), ("wk", 2), ("wv", 3)):
                    la[n] = dataclasses.replace(la[n], bias=jax.random.normal(
                        jax.random.PRNGKey(key), la[n].bias.shape, jnp.float32) * 0.1)
                params = dict(params, layers=la)
            cache = (init_kv_cache8(cfg, 2, 256) if cache_dtype == "int8"
                     else init_kv_cache(cfg, 2, 256, jnp.float32))
            dep = build_tp_params(params, cfg, mesh, quantize_head=True)
            logits, cache = tp_forward(dep, cfg, tokens, cache, jnp.int32(0), mesh)
            first = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            mp.setenv("AWQ_TPU_TP_MEGAKERNEL", "1")
            forward.clear_cache()
            toks, _, _ = tp_decode_scan(dep, cfg, cache, first, jnp.int32(16),
                                        jax.random.PRNGKey(0), jnp.asarray([-1], jnp.int32),
                                        jnp.zeros((2, cfg.vocab_size), bool), JGen(greedy=True),
                                        STEPS, mesh)
            mp.delenv("AWQ_TPU_TP_MEGAKERNEL")
            forward.clear_cache()
            out["ids"][name] = [[int(first[b])] + np.asarray(toks)[b].tolist() for b in range(2)]
            out["params"][name] = jax.device_get(jax.tree_util.tree_map(
                lambda x: (dataclasses.replace(x, scales=_bf16(x.scales), szeros=_bf16(x.szeros))
                           if isinstance(x, JQLinear) else x),
                params, is_leaf=lambda x: isinstance(x, JQLinear)))
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """The two ranks' results (one spawn for the module)."""
    import torch.multiprocessing as mp

    from awq_tpu_torch.convert import params_from_jax

    tmp = tmp_path_factory.mktemp("tp_greedy")
    torch.save({"params": {k: params_from_jax(v, device="cpu")
                           for k, v in jax_side["params"].items()},
                "prompts": jax_side["prompts"]}, tmp / "data.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp / "store"), str(tmp / "data.pt"),
                                                  str(tmp / f"rank{r}.pt")))
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
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(TP)]


# Where two ids' logits lie within this share of the largest logit, the
# choice is a tie at the tolerance to which the port's decode logits are
# held against JAX's from one state (test_torch_tp_engine.py: 1e-2, 3.7e-3
# measured): either side may take either id, and the sequences part there.
TIE_TOL = 1e-2


def _parting(got, ref, logits):
    """The first index at which the id sequences ``got`` and ``ref`` differ
    (None where they do not), holding that ``got``'s logits (``[17, V]``,
    the rows its ids were chosen from) put ``ref``'s id there within
    ``TIE_TOL`` of the largest logit: a tie, not a disagreement."""
    for i, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            row = logits[i]
            gap = float(row[a] - row[b])
            assert gap <= TIE_TOL * np.abs(row).max(), (i, a, b, gap)
            print(f"parted at id {i} (decode step {i}): {a} against {b}, "
                  f"logit gap {gap:.3e} ({gap / np.abs(row).max():.3e} of the largest)")
            return i
    assert len(got) == len(ref) == STEPS + 1
    return None


@pytest.mark.parametrize("case", list(CASES))
def test_tp_engine_free_running_ids_equal_jax_tp_decode_scan(jax_side, ranks, case):
    """Both prompts' 17 free-running greedy ids from the port's tp = 2
    engine equal JAX's tp = 2 ``tp_forward`` + ``tp_decode_scan`` ids, on
    both ranks, up to a tie (``_parting``; PERF.md records where one
    occurs); every decode step ran K12 and K13 once per layer, and each id
    is the argmax of the logits it was chosen from."""
    r0 = ranks[0][case]
    assert r0["ids"] == ranks[1][case]["ids"]
    for ids, logits in zip(r0["ids"], r0["logits"]):
        np.testing.assert_array_equal(logits.argmax(-1), ids)
    for got, ref, logits in zip(r0["ids"], jax_side["ids"][case], r0["logits"]):
        _parting(got, ref, logits)
    assert all(len(set(ids)) >= 3 for ids in jax_side["ids"][case]), jax_side["ids"][case]
    for r in range(TP):
        assert ranks[r][case]["attn"] == ranks[r][case]["mlp"] == 2 * 2 * STEPS


@pytest.mark.parametrize("case", list(CASES))
def test_tp_engine_free_running_ids_equal_single_device_engine(jax_side, ranks, case,
                                                                monkeypatch):
    """The port's single-device ``InferenceEngine`` (K4's plain version at
    batch 1) on the same weights chooses the tp = 2 engine's 17 ids, up to
    a tie (``_parting``)."""
    from awq_tpu_torch.convert import params_from_jax
    from awq_tpu_torch.runtime.engine import InferenceEngine

    monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    arch, _, cache_dtype = CASES[case]
    cfg = TConfig(**_cfg(arch))
    engine = InferenceEngine(cfg, params_from_jax(jax_side["params"][case], device="cpu"),
                             RuntimeConfig(max_seq_len=256, quantize_head=True),
                             cache_dtype=cache_dtype, device="cpu")
    r0 = ranks[0][case]
    for got, ref, logits in zip(r0["ids"], _serve(engine, jax_side["prompts"]), r0["logits"]):
        _parting(got, ref, logits)
