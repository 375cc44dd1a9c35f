"""Port parity of the continuous-batching path: ``decode_step_batched``,
the per-row samplers, ``BatchEngine`` and ``BatchWorker`` against the JAX
package's, on the CPU.

The model is tiny and f32 (2 layers, hidden 512, head_dim 128, vocab 512,
W4-g128 weights from ``quantize_params``) with an f32 cache on both sides;
the weights reach the port through ``params_from_jax``. Inputs come from
numpy seeds.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awq_tpu.config import (GenConfig as JGen, ModelConfig as JConfig,
                            QuantConfig as JQuant)
from awq_tpu.models import llama as jllama
from awq_tpu.runtime import sampling as jsampling
from awq_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
from awq_tpu_torch.config import (GenConfig as TGen, ModelConfig as TConfig,
                                  RuntimeConfig as TRuntime)
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.runtime import sampling as tsampling
from awq_tpu_torch.runtime.batch_engine import BatchEngine as TBatchEngine
from awq_tpu_torch.serve.batch_worker import BatchWorker
from awq_tpu_torch.serve.http import post_json, post_stream

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

GEOM = dict(arch="llama", vocab_size=512, hidden_size=512,
            intermediate_size=1024, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=128, max_position_embeddings=256, dtype="float32")
T = 64


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JConfig(**GEOM), TConfig(**GEOM)
    jparams = jllama.quantize_params(
        jllama.init_params(jcfg, jax.random.PRNGKey(2)),
        JQuant(w_bit=4, group_size=128))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _step_inputs(seed, b):
    rng = np.random.default_rng(seed)
    L, nkv, hd = GEOM["num_layers"], GEOM["num_kv_heads"], GEOM["head_dim"]
    cache = rng.standard_normal((L, 2, b, nkv, T, hd)).astype(np.float32) * 0.3
    tokens = rng.integers(0, GEOM["vocab_size"], b)
    return cache, tokens


@pytest.mark.parametrize("lengths", [[5, 0, 40], [T - 1, 17]])
def test_decode_step_batched_matches_jax(model, lengths):
    """Logits and the cache after one step, against JAX's
    ``decode_step_batched`` (its XLA path on the CPU), rows at their own
    lengths including 0 and T-1. Both sides compute in f32 with other
    summation orders: 1e-4 of the largest logit, and 1e-5 absolute on the
    cache rows written (values of size ~1)."""
    jcfg, jparams, tcfg, tparams = model
    b = len(lengths)
    cache, tokens = _step_inputs(sum(lengths), b)
    jlogits, jcache = jllama.decode_step_batched(
        jparams, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(cache),
        jnp.asarray(lengths, jnp.int32))
    tcache = torch.from_numpy(cache.copy())
    tlogits, out = tllama.decode_step_batched(
        tparams, tcfg, torch.from_numpy(tokens), tcache,
        torch.tensor(lengths, dtype=torch.int32))
    assert out is tcache
    jlogits = np.asarray(jlogits)
    assert tlogits.shape == jlogits.shape == (b, GEOM["vocab_size"])
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=0,
                               atol=1e-4 * np.abs(jlogits).max())
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), rtol=0, atol=1e-5)
    # only position lengths[b] of slot b changed
    changed = (tcache.numpy() != cache).any(axis=(0, 1, 3, 5))       # [B, T]
    want = np.zeros((b, T), bool)
    want[np.arange(b), lengths] = True
    np.testing.assert_array_equal(changed, want)


def test_decode_step_batched_matches_forward_per_row(model):
    """The batched step equals the port's own ``forward`` run row by row on
    that row's slice of the cache (f32 on the CPU; the matmuls see 3 rows
    or 1, so sums may be blocked differently: 1e-5 of the largest logit,
    1e-5 absolute on the cache rows written, values of size ~1)."""
    _, _, tcfg, tparams = model
    lengths = [9, 0, 33]
    cache, tokens = _step_inputs(3, 3)
    tcache = torch.from_numpy(cache.copy())
    got, _ = tllama.decode_step_batched(
        tparams, tcfg, torch.from_numpy(tokens), tcache,
        torch.tensor(lengths, dtype=torch.int32))
    for b, n in enumerate(lengths):
        row = torch.from_numpy(cache[:, :, b:b + 1].copy())
        ref, _ = tllama.forward(tparams, tcfg, torch.tensor([[tokens[b]]]), row, n)
        np.testing.assert_allclose(got[b].numpy(), ref[0, 0].numpy(), rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))
        np.testing.assert_allclose(tcache[:, :, b].numpy(), row[:, :, 0].numpy(),
                                   rtol=0, atol=1e-5)


def _requests(seed=4):
    """More requests than slots, prompts of 1..40 tokens (one over the chunk
    kernel's 32), budgets of 4..9 new tokens."""
    rng = np.random.default_rng(seed)
    sizes = [3, 12, 40, 1, 7, 20]
    budgets = [8, 6, 5, 9, 4, 7]
    return [(rng.integers(1, GEOM["vocab_size"], n).tolist(), m)
            for n, m in zip(sizes, budgets)]


def _run(engine, gen_cls, reqs, stops, late=2):
    """Submit all but the last ``late`` requests, step twice, then submit
    the rest: they join while the others decode."""
    rids = []
    for i, (prompt, budget) in enumerate(reqs[:-late]):
        rids.append(engine.submit(prompt, gen_cls(greedy=True, max_new_tokens=budget),
                                  stop_ids=stops.get(i, ())))
    engine.step()
    engine.step()
    for i, (prompt, budget) in enumerate(reqs[-late:], start=len(reqs) - late):
        rids.append(engine.submit(prompt, gen_cls(greedy=True, max_new_tokens=budget),
                                  stop_ids=stops.get(i, ())))
    done = engine.run()
    assert set(done) == set(rids)
    return [done[r] for r in rids]


@pytest.fixture(scope="module")
def jax_batch_ref(model):
    """The JAX engine's side of ``test_batch_engine_greedy_ids_match_jax``,
    run once for both cases: the requests, the stop ids taken from a first
    run's own output, and the run with those stops."""
    jcfg, jparams, _, _ = model
    reqs = _requests()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("AWQ_TPU_FORCE_MEGAKERNEL", raising=False)
        mp.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
        probe = _run(JBatchEngine(jcfg, jparams, n_slots=3, max_seq_len=T,
                                  cache_dtype=jnp.float32), JGen, reqs, {})
        stops = {1: (probe[1].out_ids[3],), 4: (probe[4].out_ids[1],)}
        ref = _run(JBatchEngine(jcfg, jparams, n_slots=3, max_seq_len=T,
                                cache_dtype=jnp.float32), JGen, reqs, stops)
    assert len(ref[1].out_ids) <= 3 and len(ref[4].out_ids) <= 1
    return reqs, stops, ref


@pytest.mark.parametrize("mega", [False, True])
def test_batch_engine_greedy_ids_match_jax(model, jax_batch_ref, mega, monkeypatch):
    """Greedy ids of the port's ``BatchEngine`` equal the JAX engine's bit
    for bit: six requests through three slots (so prompts are admitted into
    slots 1 and 2 and into freed slots while others decode), mixed prompt
    lengths, two of them with a stop id taken from the JAX engine's own
    output. ``mega=False`` is the stacked path. ``mega=True`` sets
    ``AWQ_TPU_FORCE_MEGAKERNEL=1`` for the port only, which then runs the
    plain versions of K4, K5 (prompts up to 32) and K6; the JAX engine has
    no CPU hook for its batched kernel and runs its XLA path, in f32. The
    megakernels round their matmul inputs to bf16, so this holds only while
    no argmax of these requests lies within that rounding: true of this
    seed (the test is deterministic on the CPU)."""
    _, _, tcfg, tparams = model
    monkeypatch.delenv("AWQ_TPU_FORCE_MEGAKERNEL", raising=False)
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    reqs, stops, ref = jax_batch_ref
    if mega:
        monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    eng = TBatchEngine(tcfg, tparams, n_slots=3, max_seq_len=T,
                       cache_dtype=torch.float32, device="cpu")
    if mega:
        from awq_tpu_torch.ops.megakernel_batched import megakernel_batched_supported
        assert megakernel_batched_supported(tcfg, eng.params["layers"], eng.cache, 3)
    got = _run(eng, TGen, reqs, stops)
    slots = set()
    for g, r in zip(got, ref):
        assert g.out_ids == r.out_ids, (g.rid, g.out_ids, r.out_ids)
        assert g.done and g.first_token_at is not None
        slots.add(g.slot)
    assert slots == {0, 1, 2}


def test_batch_engine_rejects_oversized_prompt(model):
    _, _, tcfg, tparams = model
    eng = TBatchEngine(tcfg, tparams, n_slots=1, max_seq_len=16,
                       cache_dtype=torch.float32, device="cpu")
    rid = eng.submit(list(range(1, 15)), TGen(max_new_tokens=10))
    ok = eng.submit([3, 4], TGen(greedy=True, max_new_tokens=2))
    done = eng.run()
    assert done[rid].out_ids == [] and done[rid].done   # prompt + gen > cache
    assert len(done[ok].out_ids) == 2


def test_batch_engine_mixes_greedy_and_sampled_rows(model):
    """A sampled request shares the batch with a greedy one; the greedy
    row's ids stay those of a run on its own."""
    _, _, tcfg, tparams = model
    mk = lambda: TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=T,
                              cache_dtype=torch.float32, device="cpu")
    alone = mk()
    r = alone.submit([3, 5, 7], TGen(greedy=True, max_new_tokens=6))
    ref = alone.run()[r].out_ids
    eng = mk()
    r1 = eng.submit([3, 5, 7], TGen(greedy=True, max_new_tokens=6))
    r2 = eng.submit([11, 13, 17], TGen(greedy=False, temperature=1.5, top_k=0,
                                       top_p=1.0, max_new_tokens=6))
    done = eng.run()
    assert done[r1].out_ids == ref
    assert len(done[r2].out_ids) == 6
    assert all(0 <= t < GEOM["vocab_size"] for t in done[r2].out_ids)


@pytest.mark.parametrize("what,kw", [
    ("item 17", dict(runtime=TRuntime(mesh=object()))),
])
def test_batch_engine_unported_options_raise(model, what, kw):
    _, _, tcfg, tparams = model
    with pytest.raises(NotImplementedError, match=what):
        TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=T, device="cpu", **kw)


def test_batch_engine_takes_spec_k(model):
    """``spec_k`` (ROADMAP A11, once refused here) verifies drafted windows:
    a step returns a list of ids a rid, and the greedy ids equal the plain
    engine's (tests/test_torch_speculative.py holds them to JAX's)."""
    _, _, tcfg, tparams = model
    prompt = [5, 6, 7, 5, 6, 7, 5, 6, 7]
    outs = []
    for k in (0, 4):
        eng = TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=T, spec_k=k,
                           cache_dtype=torch.float32, device="cpu")
        rid = eng.submit(prompt, TGen(greedy=True, max_new_tokens=8))
        first = eng.step()
        assert isinstance(first[rid], list) == bool(k)
        outs.append(eng.run()[rid].out_ids)
    assert outs[0] == outs[1] and len(outs[0]) == 8


def test_batch_engine_defaults_to_the_card(model):
    """No card, no engine: the default device is CUDA and nothing falls back
    to the CPU (the condition is read inside the test, not at import)."""
    _, _, tcfg, tparams = model
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=T)


def test_decode_step_batched_unported_branches_raise(model):
    import dataclasses

    _, _, tcfg, tparams = model
    cache = torch.zeros((2, 2, 2, 2, T, 128))
    toks, lens = torch.tensor([1, 2]), torch.tensor([0, 3], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 17"):
        tllama.decode_step_batched(tparams, tcfg, toks, cache, lens, tp_axis="tp")
    # the int8 cache is a KVCache8 (tests/test_torch_kv8.py): a bare int8
    # tensor has lost its scales
    with pytest.raises(TypeError, match="KVCache8"):
        tllama.decode_step_batched(tparams, tcfg, toks, cache.to(torch.int8), lens)
    for change in (dict(pos_embed="alibi"), dict(pos_embed="learned"),
                   dict(parallel_block=True)):
        with pytest.raises(NotImplementedError, match="item 12"):
            tllama.decode_step_batched(tparams, dataclasses.replace(tcfg, **change),
                                       toks, cache, lens)


class _Tok:
    eos_token_id = 0

    def encode(self, t):
        return [min(ord(c), 127) for c in t]

    def decode(self, ids):
        return "".join(chr(max(i, 32)) for i in ids)


def test_batch_worker_concurrent_streams(model):
    """Two HTTP streams over loopback share the batch; each one's ids equal
    a single-request run of the same engine class."""
    _, _, tcfg, tparams = model
    mk = lambda: TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=T,
                              cache_dtype=torch.float32, device="cpu")
    refs = {}
    for name, prompt in (("a", "hello"), ("b", "worlds!")):
        eng = mk()
        rid = eng.submit(_Tok().encode(prompt), TGen(greedy=True, max_new_tokens=6))
        refs[name] = eng.run()[rid].out_ids
    w = BatchWorker(mk(), _Tok(), "tiny", port=0)
    w.start()
    try:
        results = {}

        def req(name, prompt):
            results[name] = list(post_stream(w.url + "/worker_generate_stream", {
                "prompt": prompt, "max_new_tokens": 6, "greedy": True,
                "stream_interval": 1}))

        threads = [threading.Thread(target=req, args=a)
                   for a in (("a", "hello"), ("b", "worlds!"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert set(results) == {"a", "b"}
        for name in ("a", "b"):
            chunks = results[name]
            assert chunks[-1]["finished"] and chunks[-1]["error_code"] == 0
            assert chunks[-1]["ids"] == refs[name], (name, chunks[-1]["ids"])
        status = post_json(w.url + "/worker_get_status", {})
        assert status["slots"] == 2 and status["active"] == 0
    finally:
        w.stop()


# ---- samplers -----------------------------------------------------------------

def test_process_logits_matches_jax():
    """Row-varying temperature / top-k / top-p masks equal JAX's: the kept
    sets are identical and the kept values agree to 1e-6."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 64)).astype(np.float32) * 3
    temp = np.array([1.0, 0.5, 2.0, 1e-7, 0.8], np.float32)
    top_k = np.array([0, 5, 1, 0, 100], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.3], np.float32)
    ref = np.asarray(jsampling.process_logits(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = tsampling.process_logits(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(top_k.astype(np.int64)), torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    keep = ~np.isinf(ref)
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-6, atol=1e-6)
    # a [B, W, V] block with [B, 1] parameters broadcasts as in JAX
    l3 = rng.standard_normal((2, 3, 32)).astype(np.float32)
    ref3 = np.asarray(jsampling.process_logits(
        jnp.asarray(l3), jnp.asarray(temp[:2, None]), jnp.asarray(top_k[:2, None] + 2),
        jnp.asarray(top_p[:2, None])))
    got3 = tsampling.process_logits(
        torch.from_numpy(l3), torch.from_numpy(temp[:2, None]),
        torch.from_numpy(top_k[:2, None].astype(np.int64) + 2),
        torch.from_numpy(top_p[:2, None])).numpy()
    np.testing.assert_array_equal(np.isinf(got3), np.isinf(ref3))


def test_sample_logits_batched_semantics():
    """Greedy rows and rows with a temperature under 1e-5 take the argmax of
    the raw logits, as JAX's do; sampled rows draw only from their unmasked
    set. (``jax.random`` and ``torch.Generator`` give other draws from the
    same seed, so sampled ids are held to the support, not to JAX's ids.)"""
    logits = np.array([[0.0, 5.0, 1.0, 2.0]] * 4, np.float32)
    temp = np.array([1.0, 1.0, 1e-6, 1.0], np.float32)
    top_k = np.array([0, 1, 0, 2], np.int64)
    top_p = np.ones(4, np.float32)
    greedy = np.array([True, False, False, False])
    jout = jsampling.sample_logits_batched(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temp),
        jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p), jnp.asarray(greedy))
    gen = torch.Generator().manual_seed(0)
    args = [torch.from_numpy(a) for a in (temp, top_k, top_p, greedy)]
    for _ in range(20):
        out = tsampling.sample_logits_batched(torch.from_numpy(logits), *args,
                                              generator=gen)
        assert out[:3].tolist() == [1, 1, 1] == np.asarray(jout)[:3].tolist()
        assert int(out[3]) in (1, 3)                  # top_k=2 support
    # all rows greedy: the argmax only
    out = tsampling.sample_logits_batched(
        torch.from_numpy(logits), args[0], args[1], args[2],
        torch.ones(4, dtype=torch.bool))
    assert out.tolist() == [1, 1, 1, 1]
