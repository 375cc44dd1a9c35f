"""Port parity of the single-stream decode loops and streaming.

- ``StreamGenerator`` (``engine.stream``) yields JAX's chunks over one
  round, greedy, on a tiny f32 model, with and without a stop id, on the
  stacked path and on the whole-token megakernel (the JAX side forced onto
  its megakernel, as ``test_torch_engine.py`` does). Rounds that continue
  are held to the port's own ``engine.generate``: JAX's stream moves its
  ``new_start_pos`` past an id it never fed, the port feeds that id first.
- The device-position decode step (``llama.decode_step``) driven by
  ``DecodeLoop`` gives the ids of the ``forward``-a-token loop and of JAX's
  ``decode_scan`` over 20 steps, with stop ids and a repetition penalty.
  On the CPU the loop runs the step eagerly; the card tests
  (``test_torch_decode_graph.py``) replay it as a CUDA graph.
- A burst's graph key holds only what the step reads (bound, path,
  repetition penalty, and for sampled rows temperature, top-k and top-p);
  sampled rows through the loop draw the ``forward`` loop's ids from the
  same seed, and a stream of them streams those ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awq_tpu.config import GenConfig as JGen
from awq_tpu_torch.config import GenConfig as TGen, ModelConfig as TConfig
from awq_tpu_torch.config import QuantConfig as TQuant, RuntimeConfig as TRuntime
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.runtime.engine import InferenceEngine as TEngine
from awq_tpu_torch.runtime.generate import DecodeLoop, generate as tgenerate

from test_torch_engine import _engines

torch.set_num_threads(1)

_MEGA_ENV = (("AWQ_TPU_FORCE_FLASH", "1"), ("AWQ_TPU_FIXED_MAX", "off"),
             ("AWQ_TPU_FORCE_MEGAKERNEL", "1"))


def _path(mega, monkeypatch):
    """Both sides on the stacked path, or on the whole-token megakernel for
    decode (prompts over 32 tokens prefill on the stacked path on both)."""
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    if mega:
        for name, val in _MEGA_ENV:
            monkeypatch.setenv(name, val)
    else:
        monkeypatch.delenv("AWQ_TPU_FORCE_MEGAKERNEL", raising=False)
    jax.clear_caches()   # forward's trace reads the env at trace time


def _chunks(stream, ids, start_pos=0):
    return [(c["ids"], c["finished"]) for c in stream(ids, start_pos=start_pos)]


@pytest.mark.parametrize("mega", [False, True])
def test_stream_chunks_equal_jax_over_one_round(mega, monkeypatch):
    """Interval 3, 16 new tokens: every chunk's ids and ``finished`` flag
    equal the JAX StreamGenerator's, bit for bit, without a stop and with a
    stop on the id emitted 7th (a chunk closes on the 6th and the 9th); the
    final ids equal ``engine.generate``'s up to the stop."""
    _path(mega, monkeypatch)
    try:
        jeng, teng = _engines(src_fused=mega)
        prompt = np.random.default_rng(7).integers(0, 512, 40).tolist()
        gen = dict(greedy=True, max_new_tokens=16)
        fresh = jeng.cache
        jchunks = _chunks(jeng.stream(JGen(**gen), stream_interval=3), prompt,
                          jnp.int32(0))
        tchunks = _chunks(teng.stream(TGen(**gen), stream_interval=3),
                          teng.round_ids(prompt, 16))
        assert tchunks == jchunks
        assert len(jchunks[-1][0]) == 16
        stop = jchunks[-1][0][6]
        jeng.cache = fresh
        jstop = _chunks(jeng.stream(JGen(**gen), stop_ids=[stop], stream_interval=3),
                        prompt, jnp.int32(0))
        teng.reset()
        tstop = _chunks(teng.stream(TGen(**gen), stop_ids=[stop], stream_interval=3),
                        teng.round_ids(prompt, 16))
        assert tstop == jstop
        teng.reset()
        ref = teng.generate(prompt, TGen(**gen), stop_ids=[stop])["output_ids"].tolist()
        assert tstop[-1][0] == ref[:-1] and ref[-1] == stop
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("interval", [1, 4])
def test_stream_rounds_continue_as_generate(interval):
    """Three rounds on one port engine through ``stream`` (the worker's
    bookkeeping: ``round_ids``, then ``new_start_pos`` and ``pending`` from
    the last chunk) give the ids, ``start_pos`` and pending id of three
    ``engine.generate`` rounds on another: round 1 runs out of steps (its
    last id pending), round 2 stops on an id it emits 4th, round 3 has a
    single new token."""
    _, a = _engines(src_fused=False, jax_side=False)
    _, b = _engines(src_fused=False, jax_side=False)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).tolist() for n in (9, 5, 6)]
    stops = [(), (), ()]
    news = (12, 12, 1)
    for rnd, prompt in enumerate(prompts):
        gen = TGen(greedy=True, max_new_tokens=news[rnd])
        if rnd == 1:
            probe = b.generate(prompt, gen, continue_dialogue=False)["output_ids"].tolist()
            stops[1] = (probe[3],)
        ref = a.generate(prompt, gen, stop_ids=stops[rnd])
        ids = b.round_ids(prompt, gen.max_new_tokens)
        chunks = list(b.stream(gen, stop_ids=stops[rnd], stream_interval=interval)(
            ids, start_pos=b.start_pos))
        last = chunks[-1]
        b.start_pos, b._pending = last["new_start_pos"], last["pending"]
        want = ref["output_ids"].tolist()
        if stops[rnd] and want[-1] in stops[rnd]:
            want = want[:-1]
        assert last["ids"] == want
        assert (b.start_pos, b._pending) == (a.start_pos, a._pending)


def _scan_ids(teng, prompt, gen, stop_ids, loop):
    teng.reset()
    tokens = torch.tensor([prompt], dtype=torch.long)
    out = tgenerate(teng.params, teng.cfg, tokens, teng.cache, gen, stop_ids=stop_ids,
                    loop=loop)
    return out["output_ids"][0].tolist(), out["n_valid"].tolist(), out["timing"]["loop"]


@pytest.mark.parametrize("mega", [False, True])
def test_device_position_scan_equals_eager_loop_and_jax(mega, monkeypatch):
    """21 new tokens (20 decode steps), repetition penalty 1.3, greedy: the
    device-position step's loop and the ``forward``-a-token loop give the
    same ids, without a stop and with one on the 9th id; with the stop the
    rows repeat it and ``n_valid`` counts it. On the stacked path they
    equal JAX's ``generate`` (prefill, then ``decode_scan``) too. On the
    megakernel path the JAX side runs its interpret-mode megakernel, whose
    sums part from the plain K4's on this model's near-ties (at the 7th id
    without a penalty): there both port loops, which run the same plain K4,
    are held to each other, and JAX's ids to the stacked case."""
    _path(mega, monkeypatch)
    try:
        from awq_tpu.runtime.generate import generate as jgenerate

        jeng, teng = _engines(src_fused=mega)
        prompt = np.random.default_rng(9).integers(0, 512, 36).tolist()
        gen = dict(greedy=True, max_new_tokens=21, repetition_penalty=1.3)
        loop = DecodeLoop(teng.params, teng.cfg, teng.cache)
        fresh = jeng.cache
        stop = None
        for stops in ((), None):
            if stops is None:
                stops = (stop,)
            jout = jgenerate(jeng.params, jeng.cfg, jnp.asarray([prompt], jnp.int32), fresh,
                             JGen(**gen), stop_ids=stops)
            jids = np.asarray(jout["output_ids"])[0].tolist()
            dev_ids, dev_n, which = _scan_ids(teng, prompt, TGen(**gen), stops, loop)
            fwd_ids, fwd_n, fwd_which = _scan_ids(teng, prompt, TGen(**gen), stops, None)
            assert (which, fwd_which) == ("eager", "forward")
            assert dev_ids == fwd_ids and dev_n == fwd_n
            if not mega:
                assert dev_ids == jids and dev_n == np.asarray(jout["n_valid"]).tolist()
            stop = dev_ids[8]
        assert dev_n == [9] and set(dev_ids[8:]) == {stop}
    finally:
        jax.clear_caches()


def test_device_position_step_writes_the_cache_as_forward():
    """Falcon-7B-shaped (5 q heads over one kv head, head_dim 64: K14's path
    with its length on the device) and int8-cache llama models of the port
    (K9 and K7's int8 mode): 12 greedy steps of the device step's loop give
    the ``forward`` loop's ids and cache. Falcon's cache is bit-equal, and so
    are the int8 codes; the int8 scales within 1e-6 relative: the plain
    attention reduces over the prefix its ``max_length`` plans (the burst's
    bucket, or the exact length), which moves the last bit of an f32 sum."""
    for arch, cache_dtype in (("falcon", torch.float32), ("llama", "int8")):
        if arch == "falcon":
            geom = dict(arch="falcon", vocab_size=256, hidden_size=320,
                        intermediate_size=1280, num_layers=2, num_heads=5, num_kv_heads=1,
                        head_dim=64, max_position_embeddings=128, dtype="float32",
                        norm="layernorm", act="gelu", parallel_block=True, single_ln=True)
            q = TQuant(w_bit=4, group_size=64)
        else:
            geom = dict(arch="llama", vocab_size=256, hidden_size=256, intermediate_size=512,
                        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                        max_position_embeddings=128, dtype="float32")
            q = TQuant(w_bit=4, group_size=128)
        cfg = TConfig(**geom)
        params = tllama.init_qparams(cfg, q, torch.Generator().manual_seed(1), device="cpu")
        caches, ids = [], []
        for use_loop in (True, False):
            eng = TEngine(cfg, params, TRuntime(max_seq_len=128), cache_dtype=cache_dtype,
                          device="cpu")
            prompt = list(range(3, 40))
            loop = DecodeLoop(eng.params, eng.cfg, eng.cache) if use_loop else None
            out = tgenerate(eng.params, eng.cfg, torch.tensor([prompt]), eng.cache,
                            TGen(greedy=True, max_new_tokens=13), loop=loop)
            ids.append(out["output_ids"].tolist())
            caches.append(tllama.cache_tensors(eng.cache))
        assert ids[0] == ids[1]
        for x, y in zip(*caches):
            if x.dtype == torch.float32 and cache_dtype == "int8":
                torch.testing.assert_close(x, y, rtol=1e-6, atol=0)
            else:
                assert torch.equal(x, y)


def _tiny_llama():
    cfg = TConfig(arch="llama", vocab_size=256, hidden_size=256, intermediate_size=512,
                  num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                  max_position_embeddings=128, dtype="float32")
    params = tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=128),
                                 torch.Generator().manual_seed(4), device="cpu")
    return cfg, params


def test_graph_key_holds_only_what_the_step_reads():
    """A burst's graph is keyed by its bound, its path and what sampling
    reads: greedy configurations that differ in ``max_new_tokens``,
    ``top_p``, ``top_k`` or temperature share one key (one capture on a
    card); another penalty or bound is another key; sampled configurations
    differ by temperature, top-k and top-p, not by ``max_new_tokens``."""
    cfg, params = _tiny_llama()
    eng = TEngine(cfg, params, TRuntime(max_seq_len=128), device="cpu")
    loop = DecodeLoop(eng.params, eng.cfg, eng.cache)
    keys = {loop.graph_key(g, 63) for g in (
        TGen(greedy=True, max_new_tokens=8),
        TGen(greedy=True, max_new_tokens=40, top_p=0.5, top_k=3, temperature=0.2),
        TGen(greedy=False, temperature=0.0, max_new_tokens=17))}
    assert len(keys) == 1
    key = keys.pop()
    assert loop.graph_key(TGen(greedy=True, repetition_penalty=1.3), 63) != key
    assert loop.graph_key(TGen(greedy=True), 127) != key
    sampled = TGen(temperature=0.8, top_k=40, top_p=0.9, max_new_tokens=8)
    assert loop.graph_key(sampled, 63) == loop.graph_key(
        TGen(temperature=0.8, top_k=40, top_p=0.9, max_new_tokens=99), 63)
    assert len({loop.graph_key(g, 63) for g in (
        sampled, TGen(temperature=0.7, top_k=40, top_p=0.9),
        TGen(temperature=0.8, top_k=20, top_p=0.9), TGen(temperature=0.8, top_k=40, top_p=0.5),
        TGen(greedy=True))}) == 5


def test_sampled_rows_through_the_loop_equal_the_forward_loop():
    """Sampled rows decoded by the loop's step (eager on the CPU) draw the
    ids of the ``forward`` loop from the same generator seed, and leave the
    generator where it leaves it; a stream of the same round through the
    engine (no loop on the CPU: ``_ForwardSteps``) streams them."""
    cfg, params = _tiny_llama()
    gen = TGen(temperature=0.9, top_k=20, top_p=0.9, max_new_tokens=12)
    prompt = list(range(5, 21))
    outs, after = [], []
    for use_loop in (True, False):
        eng = TEngine(cfg, params, TRuntime(max_seq_len=128), device="cpu")
        loop = DecodeLoop(eng.params, eng.cfg, eng.cache) if use_loop else None
        rng = torch.Generator().manual_seed(11)
        out = tgenerate(eng.params, eng.cfg, torch.tensor([prompt]), eng.cache, gen,
                        generator=rng, loop=loop)
        assert out["timing"]["loop"] == ("eager" if use_loop else "forward")
        outs.append(out["output_ids"][0].tolist())
        after.append(torch.rand(4, generator=rng).tolist())
    assert outs[0] == outs[1] and after[0] == after[1]
    eng = TEngine(cfg, params, TRuntime(max_seq_len=128), device="cpu")
    chunks = list(eng.stream(gen, stream_interval=5)(
        prompt, generator=torch.Generator().manual_seed(11)))
    assert chunks[-1]["ids"] == outs[0] and chunks[-1]["timing"]["loop"] == "forward"
