"""Port parity of speculative decoding (``runtime/speculative.py``, the
engines' ``spec_k`` and ``generate_speculative``) against the JAX package on
the CPU, greedy ids bit for bit.

The model is JAX's own speculation test model (``tests/test_speculative.py``:
2 layers, hidden 256, 2 heads of 128, vocabulary 64, f32, W4-g128 from
``PRNGKey(2)``), through ``params_from_jax``; prompts repeat a short pattern
so that the n-gram drafter proposes. Held:
- the host loop (``generate_speculative``) and the device-side loops
  (``spec_decode_device``: single stream, and batched) against JAX's: the
  ids and the ``steps``/``drafted``/``accepted`` stats, over 24 new tokens;
  near the cache's end (the loops' tails) and with a stop id;
- ``InferenceEngine.generate_speculative``'s ids equal ``generate``'s
  greedy ids over two rounds of one dialogue, ``start_pos`` and the pending
  id too (the port's pending-id discipline, which JAX's engine lacks);
- ``BatchEngine(spec_k=4)``'s ids equal JAX's ``BatchEngine(spec_k=4)``'s
  and the port's plain engine's, over f32 and int8 caches, with admission
  mid-flight, a stop id and slots near the cache's end; a mixed
  greedy/sampled batch keeps its greedy row's ids;
- single-stream speculation on an ALiBi model, both loops, through
  ``forward``: ``generate``'s greedy ids;
- the routing: an ALiBi model with ``spec_k`` decodes without verifying,
  the paged engine never verifies; ``BatchWorker`` streams each accepted id
  once, in order.
The other families' batched verify runs in ``test_torch_spec_families.py``.
"""

import functools
import threading

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import GenConfig as TGen, ModelConfig as TConfig
from awq_tpu_torch.config import QuantConfig as TQuant, RuntimeConfig as TRuntime
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.runtime import speculative as tspec
from awq_tpu_torch.runtime.batch_engine import BatchEngine as TBatchEngine
from awq_tpu_torch.runtime.engine import InferenceEngine as TEngine

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

GEOM = dict(arch="llama", vocab_size=64, hidden_size=256, intermediate_size=256,
            num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128,
            max_position_embeddings=256, dtype="float32")
PROMPT = list(np.tile([7, 8, 9, 10], 6))
PROMPT2 = list(range(1, 10))      # no repeat at first: its greedy ids vary more
MAX_NEW = 24


@functools.lru_cache(maxsize=None)
def model():
    """``(jax cfg, jax params, port cfg, port params)``, both unfused."""
    import jax
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama
    from awq_tpu_torch.convert import params_from_jax

    cfg = JConfig(**GEOM)
    jparams = jllama.quantize_params(jllama.init_params(cfg, jax.random.PRNGKey(2)),
                                     JQuant(w_bit=4, group_size=128))
    return cfg, jparams, TConfig(**GEOM), params_from_jax(jax.device_get(jparams),
                                                          device="cpu")


def _fused():
    jcfg, jparams, tcfg, tparams = model()
    from awq_tpu.models.llama import fuse_linears

    return jcfg, fuse_linears(jparams, jcfg), tcfg, tllama.fuse_linears(tparams, tcfg)


def _plain_ids(prompt, max_new, t=128):
    """The port engine's greedy ids (the plain decode)."""
    _, _, tcfg, tparams = model()
    eng = TEngine(tcfg, tparams, TRuntime(max_seq_len=t, max_batch_size=1),
                  cache_dtype=torch.float32, device="cpu")
    return eng.generate(prompt, TGen(greedy=True, max_new_tokens=max_new))["output_ids"].tolist()


def _late_stop(prompt, max_new=MAX_NEW, at=8):
    """An id of the greedy continuation whose first appearance is at index
    ``at`` or later: a stop id that ends a round midway."""
    ids = _plain_ids(prompt, max_new)
    return next(t for i, t in enumerate(ids) if i >= at and ids.index(t) == i)


def _both(fn_name, t, prompt, max_new, **kw):
    """JAX's and the port's ``fn_name`` (``generate_speculative`` or
    ``spec_decode_device``) over fresh f32 caches of ``t`` positions:
    ``(jax ids, jax stats, port ids, port stats)``."""
    import jax.numpy as jnp
    from awq_tpu.models import init_kv_cache
    from awq_tpu.runtime import speculative as jspec

    jcfg, jparams, tcfg, tparams = _fused()
    jids, jstats = getattr(jspec, fn_name)(
        jparams, jcfg, jnp.asarray([prompt], jnp.int32), init_kv_cache(jcfg, 1, t, jnp.float32),
        max_new, **kw)
    tids, tstats = getattr(tspec, fn_name)(
        tparams, tcfg, torch.tensor([prompt]), tllama.init_kv_cache(tcfg, 1, t, torch.float32,
                                                                    device="cpu"),
        max_new, **kw)
    return [int(x) for x in jids], jstats, tids, tstats


def _same_stats(jstats, tstats):
    for key in ("steps", "drafted", "accepted"):
        assert int(jstats[key]) == int(tstats[key]), (key, jstats[key], tstats[key])
    assert np.array_equal(np.asarray(jstats["length"]), np.asarray(tstats["length"]))


@pytest.mark.parametrize("fn_name", ["generate_speculative", "spec_decode_device"])
def test_single_stream_matches_jax_and_plain_greedy(fn_name):
    """24 new tokens with k = 5: the ids equal JAX's and the plain greedy
    ids; steps, drafted, accepted and the written length equal JAX's; the
    drafts were accepted (fewer steps than tokens)."""
    jids, jstats, tids, tstats = _both(fn_name, 128, PROMPT, MAX_NEW, k=5)
    assert tids == jids == _plain_ids(PROMPT, MAX_NEW)
    _same_stats(jstats, tstats)
    assert tstats["accepted"] > 0 and tstats["steps"] < MAX_NEW


@pytest.mark.parametrize("fn_name", ["generate_speculative", "spec_decode_device"])
def test_single_stream_near_capacity_and_stop_id_match_jax(fn_name):
    """A cache of 48 positions for a 24-token prompt and 30 new tokens: the
    windows stop fitting (the host loop's draft-less steps, the device
    loop's single-token tail) and the round ends at the cache; then a stop
    id taken from the greedy ids ends a round early. Ids and stats equal
    JAX's; the ids are a prefix of the plain greedy ids."""
    jids, jstats, tids, tstats = _both(fn_name, 48, PROMPT, 30, k=5)
    assert tids == jids and tids == _plain_ids(PROMPT, 30, t=64)[:len(tids)]
    _same_stats(jstats, tstats)
    eos = _late_stop(PROMPT2)
    jids, jstats, tids, tstats = _both(fn_name, 128, PROMPT2, MAX_NEW, k=5, eos=eos)
    assert tids == jids and tids[-1] == eos and 8 < len(tids) < MAX_NEW
    _same_stats(jstats, tstats)


def test_batched_device_loop_matches_jax():
    """``spec_decode_device`` over two rows of one prompt length (the batched
    loop, ``verify_step_batched``) equals JAX's: the rows' ids and stats."""
    import jax.numpy as jnp
    from awq_tpu.models import init_kv_cache
    from awq_tpu.runtime import speculative as jspec

    jcfg, jparams, tcfg, tparams = _fused()
    prompts = [PROMPT, list(np.tile([3, 4, 5], 8))]
    jids, jstats = jspec.spec_decode_device(
        jparams, jcfg, jnp.asarray(prompts, jnp.int32), init_kv_cache(jcfg, 2, 128, jnp.float32),
        MAX_NEW, k=4)
    tids, tstats = tspec.spec_decode_device(
        tparams, tcfg, torch.tensor(prompts),
        tllama.init_kv_cache(tcfg, 2, 128, torch.float32, device="cpu"), MAX_NEW, k=4)
    assert tids == [[int(x) for x in row] for row in jids]
    assert tids[0] == _plain_ids(PROMPT, MAX_NEW)
    _same_stats(jstats, tstats)


@pytest.mark.parametrize("device_loop", [False, True])
def test_engine_rounds_equal_generate(device_loop):
    """Two rounds of one dialogue through ``generate_speculative`` equal two
    through ``generate`` (greedy): the ids, ``start_pos`` and the pending
    id after each round; the first round's stats are JAX's keys."""
    _, _, tcfg, tparams = model()
    rt = TRuntime(max_seq_len=128, max_batch_size=1)
    ref = TEngine(tcfg, tparams, rt, cache_dtype=torch.float32, device="cpu")
    spec = TEngine(tcfg, tparams, rt, cache_dtype=torch.float32, device="cpu")
    for prompt, n in ((PROMPT, 16), ([3, 4, 5, 3, 4], 12)):
        want = ref.generate(prompt, TGen(greedy=True, max_new_tokens=n))["output_ids"].tolist()
        got = spec.generate_speculative(prompt, n, k=5, device_loop=device_loop)
        assert got["output_ids"] == want
        assert set(got["stats"]) == {"steps", "drafted", "accepted", "length"}
        assert (spec.start_pos, spec._pending) == (ref.start_pos, ref._pending)
    # a round that ends on a stop id: ``generate`` feeds the stop id (its
    # scan goes on feeding it), speculation keeps it pending where it was
    # the bonus id; both hold it once, and the next round's ids agree
    spec.reset()
    ref.reset()
    eos = _late_stop(PROMPT2, 16)
    want = ref.generate(PROMPT2, TGen(greedy=True, max_new_tokens=16), stop_ids=[eos])
    got = spec.generate_speculative(PROMPT2, 16, stop_ids=[eos], k=5, device_loop=device_loop)
    n = int(want["n_valid"][0])
    assert got["output_ids"] == want["output_ids"][:n].tolist() and got["output_ids"][-1] == eos
    assert spec.start_pos + len(spec._pending) == ref.start_pos + len(ref._pending)
    want = ref.generate([5, 6, 7], TGen(greedy=True, max_new_tokens=8))["output_ids"].tolist()
    got = spec.generate_speculative([5, 6, 7], 8, k=5, device_loop=device_loop)
    assert got["output_ids"] == want
    assert (spec.start_pos, spec._pending) == (ref.start_pos, ref._pending)


def test_engine_sampled_speculation():
    """A sampled round needs the device loop (JAX's error), and runs through
    the batched loop's rejection sampling: ``max_new`` ids in the vocab."""
    _, _, tcfg, tparams = model()
    eng = TEngine(tcfg, tparams, TRuntime(max_seq_len=128, max_batch_size=1),
                  cache_dtype=torch.float32, device="cpu")
    gen = TGen(greedy=False, temperature=0.7, top_k=20, top_p=0.9, max_new_tokens=12)
    with pytest.raises(ValueError, match="device_loop"):
        eng.generate_speculative(PROMPT, 12, gen=gen, device_loop=False)
    out = eng.generate_speculative(PROMPT, 12, gen=gen,
                                   generator=torch.Generator().manual_seed(5))
    assert len(out["output_ids"]) == 12 and all(0 <= t < 64 for t in out["output_ids"])


def _requests():
    """Four requests for two slots (the last two join mid-flight), greedy,
    16 to 20 new ids, one ended midway by a stop id."""
    return [(PROMPT2, dict(max_new_tokens=20), [_late_stop(PROMPT2, 20)]),
            (list(np.tile([3, 4, 5], 6)), dict(max_new_tokens=18), []),
            ([11, 12, 13, 11, 12, 13, 11], dict(max_new_tokens=16), []),
            (PROMPT, dict(max_new_tokens=20), [])]


def _run(eng, reqs, gen_cls=TGen):
    """Submit ``reqs`` greedy (``gen_cls``: the engine's package's
    ``GenConfig``) and drain the engine: the ids of each."""
    rids = [eng.submit(p, gen_cls(greedy=True, **g), stop_ids=s) for p, g, s in reqs]
    done = eng.run()
    return [list(map(int, done[r].out_ids)) for r in rids]


@pytest.mark.parametrize("cache_dtype", ["f32", "int8"])
def test_batch_engine_spec_ids_match_jax(cache_dtype):
    """``BatchEngine(spec_k=4)``: the ids equal JAX's spec engine's and the
    port's plain engine's."""
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen
    from awq_tpu.runtime.batch_engine import BatchEngine as JBatchEngine

    jcfg, jparams, tcfg, tparams = model()
    jdt, tdt = (jnp.float32, torch.float32) if cache_dtype == "f32" else ("int8", "int8")
    reqs = _requests()
    jspec_ids = _run(JBatchEngine(jcfg, jparams, n_slots=2, max_seq_len=128, cache_dtype=jdt,
                                  spec_k=4), reqs, JGen)
    tspec_ids = _run(TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=128, cache_dtype=tdt,
                                  spec_k=4, device="cpu"), reqs)
    plain = _run(TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=128, cache_dtype=tdt,
                              device="cpu"), reqs)
    assert tspec_ids == jspec_ids == plain
    assert [len(ids) for ids in tspec_ids[1:]] == [18, 16, 20] and 8 <= len(tspec_ids[0]) < 20


def test_batch_engine_spec_near_capacity_matches_jax():
    """Slots of 48 positions: the last steps no longer fit a window and
    decode plainly (``_spec_eligible``), then the slots run out of cache.
    The ids equal JAX's spec engine's and the plain engine's."""
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen
    from awq_tpu.runtime.batch_engine import BatchEngine as JBatchEngine

    jcfg, jparams, tcfg, tparams = model()
    reqs = [(PROMPT, dict(max_new_tokens=24), []),
            (list(np.tile([3, 4, 5], 6)), dict(max_new_tokens=24), [])]
    j = _run(JBatchEngine(jcfg, jparams, n_slots=2, max_seq_len=48, cache_dtype=jnp.float32,
                          spec_k=4), reqs, JGen)
    t = _run(TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=48, cache_dtype=torch.float32,
                          spec_k=4, device="cpu"), reqs)
    p = _run(TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=48, cache_dtype=torch.float32,
                          device="cpu"), reqs)
    assert t == j == p


def test_batch_engine_mixed_greedy_and_sampled_rows():
    """``tests/test_spec_sampling.py:141`` on the port: one greedy and one
    temperature-0.7 row; the greedy row's ids equal the plain engine's, the
    sampled row completes with exactly max_new ids in the vocab."""
    _, _, tcfg, tparams = model()
    gen_g = TGen(greedy=True, max_new_tokens=10)
    gen_s = TGen(greedy=False, temperature=0.7, top_k=20, top_p=0.9, max_new_tokens=10)
    ref = TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=128, cache_dtype=torch.float32,
                       device="cpu")
    r0 = ref.submit(PROMPT, gen_g)
    want = ref.run()[r0].out_ids
    eng = TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=128, cache_dtype=torch.float32,
                       spec_k=3, device="cpu")
    g0, g1 = eng.submit(PROMPT, gen_g), eng.submit([3, 4, 3, 4, 3, 4], gen_s)
    assert eng._spec_eligible([])
    done = eng.run()
    assert done[g0].out_ids == want
    assert len(done[g1].out_ids) == 10 and all(0 <= t < 64 for t in done[g1].out_ids)


def _count_verify(monkeypatch):
    calls = []
    real = tllama.verify_step_batched

    def counted(*a, **kw):
        calls.append(a[2].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tllama, "verify_step_batched", counted)
    return calls


def _alibi_model():
    """A tiny f32 MPT-style model (ALiBi, bias-free LayerNorm, GELU), W4."""
    mcfg = TConfig(arch="mpt", vocab_size=64, hidden_size=256, intermediate_size=256,
                   num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128,
                   max_position_embeddings=256, dtype="float32", norm="layernorm",
                   norm_bias=False, act="gelu", pos_embed="alibi")
    return mcfg, tllama.quantize_params(
        tllama.init_params(mcfg, torch.Generator().manual_seed(2), device="cpu"),
        TQuant(w_bit=4, group_size=128))


@pytest.mark.parametrize("device_loop", [False, True])
def test_alibi_single_stream_speculation_rides_forward(device_loop, monkeypatch):
    """Single-stream speculation on an ALiBi model: both loops verify
    through ``forward`` (K5 on the card, as JAX's single-stream loops), never
    ``verify_step_batched``, and give ``generate``'s greedy ids."""
    calls = _count_verify(monkeypatch)
    mcfg, mparams = _alibi_model()
    prompt = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]
    ids = {}
    for spec in (False, True):
        eng = TEngine(mcfg, mparams, TRuntime(max_seq_len=128, max_batch_size=1),
                      cache_dtype=torch.float32, device="cpu")
        if spec:
            out = eng.generate_speculative(prompt, 16, k=4, device_loop=device_loop)
            ids[spec] = list(out["output_ids"])
            assert out["stats"]["steps"] > 1
        else:
            ids[spec] = eng.generate(prompt, TGen(greedy=True, max_new_tokens=16))[
                "output_ids"].tolist()
    assert ids[True] == ids[False] and len(ids[True]) == 16 and not calls


def test_alibi_and_paged_engines_decode_without_verifying(monkeypatch):
    """Counted calls of ``verify_step_batched``: an ALiBi model with
    ``spec_k`` takes plain decode (JAX's verify step has no ALiBi path) and
    the paged engine never verifies; a llama slot engine does. Ids equal the
    engines' without ``spec_k``."""
    from awq_tpu_torch.runtime.paged import PagedBatchEngine

    calls = _count_verify(monkeypatch)
    mcfg, mparams = _alibi_model()
    gen = TGen(greedy=True, max_new_tokens=6)
    outs = []
    for k in (0, 3):
        eng = TBatchEngine(mcfg, mparams, n_slots=2, max_seq_len=128, spec_k=k,
                           cache_dtype=torch.float32, device="cpu")
        assert not eng._spec_eligible([])
        rid = eng.submit([7, 8, 7, 8, 7, 8], gen)
        outs.append(eng.run()[rid].out_ids)
    assert outs[0] == outs[1] and len(outs[0]) == 6 and not calls
    _, _, tcfg, tparams = model()
    paged = PagedBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=128, page_size=64,
                             cache_dtype=torch.float32, device="cpu")
    paged.spec_k = 4
    rid = paged.submit(PROMPT, gen)
    assert paged.run()[rid].out_ids == _plain_ids(PROMPT, 6) and not calls
    slot = TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=128, spec_k=4,
                        cache_dtype=torch.float32, device="cpu")
    rid = slot.submit(PROMPT, gen)
    assert slot.run()[rid].out_ids == _plain_ids(PROMPT, 6) and calls
    assert all(shape == (2, 5) for shape in calls)


class _Tok:
    eos_token_id = 0

    def encode(self, t):
        return [min(ord(c), 63) for c in t]

    def decode(self, ids):
        return "".join(chr(max(i, 32)) for i in ids)


def test_batch_worker_streams_each_accepted_id_once():
    """Over HTTP on localhost with ``stream_interval=1``: a spec engine's
    step returns several ids a rid, and the stream grows by one id a chunk,
    in order, ending at the engine's ids after the first (which equal the
    plain engine's)."""
    from awq_tpu_torch.serve.batch_worker import BatchWorker
    from awq_tpu_torch.serve.http import post_stream

    _, _, tcfg, tparams = model()
    ids = [int(t) for t in PROMPT]
    w = BatchWorker(TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=128, spec_k=4,
                                 cache_dtype=torch.float32, device="cpu"), _Tok(), "tiny",
                    port=0)
    w.start()
    try:
        chunks = []
        t = threading.Thread(target=lambda: chunks.extend(post_stream(
            w.url + "/worker_generate_stream",
            {"input_ids": ids, "max_new_tokens": 16, "greedy": True, "stream_interval": 1})))
        t.start()
        t.join(60)
        assert chunks and chunks[-1]["finished"] and chunks[-1]["error_code"] == 0
        streamed = [c["ids"] for c in chunks[:-1]]
        assert [len(c) for c in streamed] == list(range(1, len(streamed) + 1))
        assert all(a == b[:-1] for a, b in zip(streamed, streamed[1:]))
        # the stream carries the steps' ids (the admission's first id is in
        # the final chunk only, as in the JAX worker)
        assert chunks[-1]["ids"] == _plain_ids(ids, 16)
        assert streamed[-1] == chunks[-1]["ids"][1:]
    finally:
        w.stop()
