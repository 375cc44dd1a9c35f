"""Port parity of tensor-parallel serving (``parallel/tp.py``,
``InferenceEngine`` over a ``RuntimeConfig.mesh``) against the JAX
package: two gloo ranks on the CPU against JAX's ``tp_forward`` and
``tp_decode_scan`` on a tp = 2 mesh of the virtual CPU devices.

The ranks are spawned processes (``torch.multiprocessing``, the ``spawn``
start method) that meet through a ``FileStore`` under the test's
``tmp_path``, so that the test workers never share a port; each spawn is
joined with a timeout, so a hang fails the test. One spawn runs every
rank case of the module, and the JAX references are computed once per
module. Geometry: ``tests/test_megakernel_tp.py::_flash_cfg`` (f32,
hidden 512, 4 q and 2 kv heads, 2 layers, vocabulary 512), weights drawn
at a scale of 0.05, a quantized head, bf16-valued scales (the values JAX's
folded layout holds); JAX runs with
``AWQ_TPU_FORCE_FLASH=1``, its decode with ``AWQ_TPU_TP_MEGAKERNEL=1``
(its half-layer kernels, rows 19 and 20, in interpret mode) as its own
test does; the ranks run K12's and K13's plain versions
(``AWQ_TPU_TP_MEGAKERNEL=1`` on the CPU).
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

TP, PROMPT, ROUND2, STEPS = 2, 11, [9, 10, 11], 16
GEOM = dict(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=1024,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
            max_position_embeddings=256, dtype="float32")
CASES = {"f32": ("llama", torch.float32), "int8": ("llama", "int8"),
         "qwen2": ("qwen2", torch.float32)}
JOIN_S = 240


def _cfg(arch):
    return dict(GEOM, arch=arch, qkv_bias=arch == "qwen2")


def _prompt():
    return np.random.default_rng(4).integers(0, 512, PROMPT).tolist()


def _rank_main(rank, store_path, data_path, out_path):
    """One rank: per case, a prefill through ``tp_forward``; from JAX's
    prefill state (its cache shard), the logits of 16 decode steps fed
    JAX's ids (and 2 steps of ``tp_decode_scan``); and two rounds of an
    ``InferenceEngine`` over the group, then a sampled one. Writes its
    results to ``out_path``."""
    import torch.distributed as dist

    from awq_tpu_torch.models.llama import init_cache
    from awq_tpu_torch.ops import megakernel_tp as mtp
    from awq_tpu_torch.parallel.deploy import build_tp_params
    from awq_tpu_torch.parallel.distributed import init_distributed
    from awq_tpu_torch.parallel.mesh import make_mesh
    from awq_tpu_torch.parallel.shard import shard_cache
    from awq_tpu_torch.parallel.tp import tp_decode_scan, tp_forward, tp_local_cfg
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
    gen = GenConfig(greedy=True, max_new_tokens=STEPS + 1)
    out = {}
    for name, (arch, cache_dtype) in CASES.items():
        cfg = TConfig(**_cfg(arch))
        params = data["params"][arch]
        dep = build_tp_params(params, cfg, mesh, quantize_head=True)
        cache = init_cache(tp_local_cfg(cfg, TP), 1, 256, cache_dtype, device="cpu")
        logits = tp_forward(dep, cfg, torch.tensor([_prompt()]), cache, 0, mesh)[0]
        res = dict(logits=logits.numpy(), prefill_calls=calls["attn"])
        jcache = shard_cache(data["jax_cache"][name], rank, TP)
        feed = data["jax_feed"][name]
        res["from_jax_state"] = np.stack([
            tp_forward(dep, cfg, torch.tensor([[tok]]), jcache, PROMPT + i, mesh)[0][0, -1].numpy()
            for i, tok in enumerate(feed)])
        first = torch.tensor([feed[0]])
        seen = torch.zeros((1, cfg.vocab_size), dtype=torch.bool)
        res["scan"] = tp_decode_scan(dep, cfg, shard_cache(data["jax_cache"][name], rank, TP),
                                     first, PROMPT, (), seen, gen, 2, mesh)[0][0].tolist()
        eng = InferenceEngine(cfg, params, RuntimeConfig(max_seq_len=256, quantize_head=True,
                                                         mesh=mesh), cache_dtype=cache_dtype)
        res["round1"] = eng.generate(_prompt(), gen)["output_ids"].tolist()
        res["round2"] = eng.generate(ROUND2, gen)["output_ids"].tolist()
        res.update(start_pos=eng.start_pos, attn=calls["attn"], mlp=calls["mlp"])
        # a sampled round, each rank with a generator of its own seed: the
        # ranks keep one sequence only because rank 0's draws are broadcast
        sampled = GenConfig(temperature=0.8, top_k=40, top_p=0.9, max_new_tokens=8)
        res["sampled"] = eng.generate(ROUND2, sampled, generator=torch.Generator().manual_seed(
            100 + rank))["output_ids"].tolist()
        calls.update(attn=0, mlp=0)
        out[name] = res
    torch.save(out, out_path)
    dist.destroy_process_group()


def _bf16(x):
    import jax.numpy as jnp

    return x.astype(jnp.bfloat16).astype(jnp.float32)


@pytest.fixture(scope="module")
def jax_side():
    """Per case: the plain JAX params (host copies), JAX's tp = 2 prefill
    logits and the cache it leaves, 16 greedy ids of ``tp_decode_scan``
    from there, and the logits of those 16 steps (``tp_forward`` fed the
    same ids: ``feed``)."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen, ModelConfig, QuantConfig
    from awq_tpu.models import forward, init_kv_cache
    from awq_tpu.models.llama import init_kv_cache8, init_params, quantize_head, quantize_params
    from awq_tpu.ops.w4a16 import QLinear as JQLinear
    from awq_tpu.parallel import MeshConfig, build_tp_params, make_mesh, tp_decode_scan, tp_forward

    rng = np.random.default_rng(1)
    lcfg = ModelConfig(**_cfg("llama"))
    plain = quantize_head(quantize_params(init_params(lcfg, jax.random.PRNGKey(3), scale=0.05),
                                          QuantConfig(w_bit=4, group_size=128)), lcfg)
    # bf16-valued scales and szeros: the JAX deploy layout folds them into
    # bf16 qparam rows, so both packages then compute with the same values
    plain = jax.tree_util.tree_map(
        lambda x: (dataclasses.replace(x, scales=_bf16(x.scales), szeros=_bf16(x.szeros))
                   if isinstance(x, JQLinear) else x),
        plain, is_leaf=lambda x: isinstance(x, JQLinear))
    la = dict(plain["layers"])
    for n in ("wq", "wk", "wv"):     # qwen2: the same weights with a q/k/v bias
        oc = la[n].qweight.shape[-1]
        la[n] = dataclasses.replace(la[n], bias=jnp.asarray(
            rng.standard_normal((GEOM["num_layers"], oc)).astype(np.float32) * 0.1))
    params = {"llama": plain, "qwen2": dict(plain, layers=la)}
    mesh = make_mesh(MeshConfig(dp=1, tp=TP), devices=jax.devices()[:TP])
    tokens = jnp.asarray([_prompt()], jnp.int32)
    out = {"params": {k: jax.device_get(v) for k, v in params.items()}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AWQ_TPU_FORCE_FLASH", "1")
        mp.setenv("AWQ_TPU_FIXED_MAX", "off")      # as tests/test_torch_llama.py
        forward.clear_cache()
        for name, (arch, cache_dtype) in CASES.items():
            cfg = ModelConfig(**_cfg(arch))
            dep = build_tp_params(params[arch], cfg, mesh, quantize_head=True)
            cache = (init_kv_cache8(cfg, 1, 256) if cache_dtype == "int8"
                     else init_kv_cache(cfg, 1, 256, jnp.float32))
            logits, cache = tp_forward(dep, cfg, tokens, cache, jnp.int32(0), mesh)
            first = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            mp.setenv("AWQ_TPU_TP_MEGAKERNEL", "1")
            forward.clear_cache()
            toks, _, _ = tp_decode_scan(dep, cfg, cache, first, jnp.int32(PROMPT),
                                        jax.random.PRNGKey(0), jnp.asarray([-1], jnp.int32),
                                        jnp.zeros((1, cfg.vocab_size), bool), JGen(greedy=True),
                                        STEPS, mesh)
            ids = np.asarray(toks)[0].tolist()
            feed = [int(first[0])] + ids[:-1]
            step_logits, c = [], cache
            for i, tok in enumerate(feed):          # the same steps, one at a time
                lg, c = tp_forward(dep, cfg, jnp.asarray([[tok]], jnp.int32), c,
                                   jnp.int32(PROMPT + i), mesh)
                step_logits.append(np.asarray(lg)[0, -1])
            mp.delenv("AWQ_TPU_TP_MEGAKERNEL")
            forward.clear_cache()
            out[name] = dict(logits=np.asarray(logits), cache=jax.device_get(cache), feed=feed,
                             ids=ids, step_logits=np.stack(step_logits))
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """The two ranks' results (one spawn for the module)."""
    import torch.multiprocessing as mp

    from awq_tpu_torch.convert import kv_cache8_from_jax, params_from_jax

    tmp = tmp_path_factory.mktemp("tp_engine")
    caches = {}
    for name, (_, cache_dtype) in CASES.items():
        c = jax_side[name]["cache"]
        caches[name] = (kv_cache8_from_jax(c, device="cpu") if cache_dtype == "int8"
                        else torch.from_numpy(np.array(c)))
    torch.save({"params": {k: params_from_jax(v, device="cpu")
                           for k, v in jax_side["params"].items()},
                "jax_cache": caches, "jax_feed": {n: jax_side[n]["feed"] for n in CASES}},
               tmp / "data.pt")
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


@pytest.fixture(scope="module")
def single(jax_side, ranks):
    """The port's single-device forward (CPU: the stacked path) over the
    same params, replaying the tp = 2 engine's two rounds with the ids the
    ranks chose: the logits of every step at which the engine picked an
    id (the prefill of each round and its 16 decode steps)."""
    from awq_tpu_torch.convert import params_from_jax
    from awq_tpu_torch.models.llama import forward, fuse_linears, init_cache, quantize_head

    out = {}
    for name, (arch, cache_dtype) in CASES.items():
        cfg = TConfig(**_cfg(arch))
        params = fuse_linears(quantize_head(
            params_from_jax(jax_side["params"][arch], device="cpu"), cfg), cfg)
        cache = init_cache(cfg, 1, 256, cache_dtype, device="cpu")
        r1, r2 = ranks[0][name]["round1"], ranks[0][name]["round2"]

        def run(tokens, pos):
            return forward(params, cfg, torch.tensor([tokens]), cache, pos)[0][0, -1].numpy()

        logits, pos = [run(_prompt(), 0)], PROMPT
        for tok in r1[:-1]:
            logits.append(run([tok], pos))
            pos += 1
        prompt2 = [r1[-1]] + ROUND2          # the engine feeds the pending id first
        logits.append(run(prompt2, pos))
        pos += len(prompt2)
        for tok in r2[:-1]:
            logits.append(run([tok], pos))
            pos += 1
        out[name] = dict(logits=np.stack(logits), ids=r1 + r2, end=pos)
    return out


def _greedy_agrees(ref_logits, ids, tol):
    """Each id is the argmax of ``ref_logits``' row wherever that row's two
    largest logits lie more than ``tol`` of its largest magnitude apart (a
    narrower gap is a tie at the stated tolerance, which either side may
    take: two logits that each move by up to half of it can swap). Returns
    the number of rows that were held."""
    held = 0
    for row, i in zip(ref_logits, ids):
        top2 = np.sort(row)[-2:]
        if top2[1] - top2[0] > tol * np.abs(row).max():
            assert int(row.argmax()) == i, (int(row.argmax()), i, top2)
            held += 1
    return held


@pytest.mark.parametrize("case", list(CASES))
def test_tp_forward_logits_match_jax(jax_side, ranks, single, case):
    """The gathered prefill logits are the same on both ranks, bit for bit;
    they equal the port's single-device forward within JAX's own tolerance
    for its tp parity (``atol = rtol = 2e-3``, test_megakernel_tp.py), and
    JAX's ``tp_forward`` at tp = 2 within 1e-2 of the largest logit: JAX's
    folded prefill kernels round every matmul input to bf16 where the
    port's plain stacked path on an f32 model does not (as between the two
    single-device forwards, tests/test_torch_llama.py; 6.5e-3 measured
    here)."""
    got = ranks[0][case]["logits"]
    np.testing.assert_array_equal(got, ranks[1][case]["logits"])
    ref = jax_side[case]["logits"]
    assert got.shape == ref.shape == (1, 1, GEOM["vocab_size"])
    np.testing.assert_allclose(got[0, 0], single[case]["logits"][0], atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


# K12/K13's plain versions against JAX's half-layer kernels in interpret
# mode differ by up to 2^-8 of a layer's outputs (test_torch_tp_kernels.py:
# a matmul input on a bf16 rounding edge); over 2 layers and a W4 head the
# decode logits from one state differ by up to 3.7e-3 of the largest
# (measured): 1e-2 holds them. Greedy ids are held wherever the top two
# logits lie further apart than that.
DECODE_TOL = 1e-2


@pytest.mark.parametrize("case", list(CASES))
def test_tp_decode_matches_jax_from_its_prefill_state(jax_side, ranks, case):
    """From JAX's prefill state (its cache, kv-head sharded), the port's
    tp = 2 decode steps on K12/K13 fed JAX's 16 greedy ids of
    ``tp_decode_scan`` give the same logits on both ranks, JAX's logits of
    those steps within ``DECODE_TOL``, and JAX's ids wherever the choice is
    not a tie at that tolerance; ``tp_decode_scan`` itself starts the same."""
    j = jax_side[case]
    np.testing.assert_array_equal(j["step_logits"].argmax(-1), j["ids"])   # JAX's own replay
    got = ranks[0][case]["from_jax_state"]
    np.testing.assert_array_equal(got, ranks[1][case]["from_jax_state"])
    np.testing.assert_allclose(got, j["step_logits"], rtol=0,
                               atol=DECODE_TOL * np.abs(j["step_logits"]).max())
    assert _greedy_agrees(j["step_logits"], got.argmax(-1), 2 * DECODE_TOL) >= STEPS // 2
    assert len(set(j["ids"])) >= 4, j["ids"]                     # not a degenerate run
    assert ranks[0][case]["scan"] == ranks[1][case]["scan"] == [int(got[0].argmax()),
                                                                int(got[1].argmax())]


# The single-device stacked path of an f32 model feeds its matmuls f32
# inputs, K12/K13 (K4's arithmetic) bf16 ones: 5e-3 of the largest logit
# measured between the two decodes from one state. 1e-2 holds them.
SINGLE_TOL = 1e-2


@pytest.mark.parametrize("case", list(CASES))
def test_tp_engine_rounds_match_single_device(ranks, single, case):
    """Two dialogue rounds of 17 greedy ids through the tp = 2
    ``InferenceEngine``: both ranks agree, the rounds continue one
    dialogue (the pending id fed first), and the port's single-device
    forward, replaying the rounds, picks the same ids wherever its choice
    is not a tie at ``SINGLE_TOL``."""
    got = ranks[0][case]
    assert (ranks[1][case]["round1"], ranks[1][case]["round2"]) == (got["round1"],
                                                                    got["round2"])
    assert len(got["round1"]) == len(got["round2"]) == STEPS + 1
    assert got["start_pos"] == single[case]["end"]
    ref = single[case]
    assert _greedy_agrees(ref["logits"], ref["ids"], 2 * SINGLE_TOL) >= STEPS


@pytest.mark.parametrize("case", list(CASES))
def test_tp_engine_sampled_round_keeps_ranks_together(ranks, case):
    """A sampled round (temperature, top-k, top-p) with a generator of a
    different seed on each rank: rank 0's draws are broadcast, so both
    ranks return the same 8 ids."""
    assert ranks[0][case]["sampled"] == ranks[1][case]["sampled"]
    assert len(ranks[0][case]["sampled"]) == 8


@pytest.mark.parametrize("case", list(CASES))
def test_tp_engine_ran_the_half_layer_kernels(ranks, case):
    """A probe around K12 and K13 (as ``_with_dispatch_probe`` in JAX's
    test): the prefills took the stacked path (no half-kernel call), and
    every decode step called each half once per layer (2 layers): 16 steps
    fed JAX's ids, 2 of ``tp_decode_scan`` and 16 in each engine round."""
    for r in range(TP):
        got = ranks[r][case]
        assert got["prefill_calls"] == 0
        assert got["attn"] == got["mlp"] == 2 * (STEPS + 2 + 2 * STEPS), got


def test_tp_steps_refuse_the_batched_paths():
    """Under a group, the batched and paged steps and BatchEngine raise,
    naming the ROADMAP item that brings them."""
    from awq_tpu_torch.models import llama as tllama
    from awq_tpu_torch.parallel.mesh import TPGroup
    from awq_tpu_torch.runtime.batch_engine import BatchEngine

    cfg = TConfig(**GEOM)
    mesh = TPGroup(rank=0, size=2, group=None, device=torch.device("cpu"))
    cache = torch.zeros((2, 2, 2, 1, 256, 128))
    tok, lens = torch.zeros(2, dtype=torch.long), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 17b"):
        tllama.decode_step_batched({}, cfg, tok, cache, lens, tp_axis=mesh)
    with pytest.raises(NotImplementedError, match="item 17b"):
        tllama.decode_step_paged({}, cfg, tok, cache, torch.zeros((2, 1), dtype=torch.int32),
                                 lens, tp_axis=mesh)
    with pytest.raises(NotImplementedError, match="item 17b"):
        BatchEngine(cfg, {}, runtime=RuntimeConfig(mesh=mesh), device="cpu")
    with pytest.raises(ValueError, match="dp=1"):
        from awq_tpu_torch.runtime.engine import InferenceEngine

        InferenceEngine(cfg, {}, RuntimeConfig(mesh=TPGroup(0, 2, None, torch.device("cpu"),
                                                            dp=2)))
