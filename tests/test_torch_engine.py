"""Port parity at engine level: greedy ids of ``InferenceEngine.generate``
equal the JAX engine's bit for bit, over two dialogue rounds of 16 new
tokens each (the second round reuses the first's KV through
``start_pos``), on an f32 model with an f32 cache on both sides.

The JAX engine never feeds the last id of a round that ends without a
stop, and the next round attends over its unwritten KV slot. The port
feeds that id at the start of the next round; the JAX side of these tests
does the same by hand (``_jax_round``), so the two stay comparable.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from awq_tpu.config import (GenConfig as JGen, ModelConfig as JConfig,
                            QuantConfig as JQuant, RuntimeConfig as JRuntime)
from awq_tpu.models import llama as jllama
from awq_tpu.runtime.engine import InferenceEngine as JEngine
from awq_tpu_torch.config import (GenConfig as TGen, ModelConfig as TConfig,
                                  RuntimeConfig as TRuntime)
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.runtime import sampling as tsampling
from awq_tpu_torch.runtime.engine import InferenceEngine as TEngine

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

GEOM = dict(arch="llama", vocab_size=512, hidden_size=512,
            intermediate_size=1024, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=128, max_position_embeddings=256, dtype="float32")


def _jax_round(jeng, prompt, gen, stop_ids, pending):
    """One JAX engine round with the port's repair of the last-token fault
    applied by hand: a pending id (returned last, never fed) steps
    ``start_pos`` back onto its own position and is prepended to the
    prompt. Returns the ids and the id left pending by this round."""
    if pending is not None:
        jeng.start_pos -= 1
        prompt = [pending] + list(prompt)
    ids = np.asarray(jeng.generate(prompt, gen, stop_ids=stop_ids)["output_ids"])
    unfed = len(ids) == max(gen.max_new_tokens, 1)   # the final step's id
    return ids, (int(ids[-1]) if unfed else None)


def _engines(src_fused, jax_side=True):
    """``(JAX engine, port engine)`` over one model; ``jax_side=False``
    builds the port's only (None in the JAX engine's place), from the
    unfused tree."""
    jcfg, tcfg = JConfig(**GEOM), TConfig(**GEOM)
    jparams = jllama.quantize_params(
        jllama.init_params(jcfg, jax.random.PRNGKey(2)),
        JQuant(w_bit=4, group_size=128))
    if not jax_side:
        return None, TEngine(tcfg, params_from_jax(jax.device_get(jparams), device="cpu"),
                             TRuntime(max_seq_len=256), cache_dtype=torch.float32,
                             device="cpu")
    jeng = JEngine(jcfg, jparams, JRuntime(max_seq_len=256),
                   cache_dtype=jnp.float32)
    # the JAX engine fuses and folds; its XLA path computes with the f32
    # scale fields, its megakernel with the folded bf16 ones
    src = jeng.params if src_fused else jparams
    teng = TEngine(tcfg, params_from_jax(jax.device_get(src), device="cpu"),
                   TRuntime(max_seq_len=256), cache_dtype=torch.float32,
                   device="cpu")
    return jeng, teng


def _jax_rounds(jeng, prompts, stop_round2):
    """Rounds 1-3 of ``test_engine_greedy_ids_bit_exact`` on the JAX
    engine: ``[(ids, stop_ids, start_pos after the round, pending)]``."""
    out, pending = [], None
    for rnd, (prompt, n) in enumerate(((prompts[0], 16), (prompts[1], 16), (prompts[0], 4))):
        stop_ids = stop_round2 if rnd == 1 else ()
        ids, pending = _jax_round(jeng, prompt, JGen(greedy=True, max_new_tokens=n),
                                  stop_ids, pending)
        out.append((ids, stop_ids, jeng.start_pos, pending))
    return out


@pytest.fixture(scope="module")
def jax_greedy_rounds():
    """The JAX engine's side of both cases of
    ``test_engine_greedy_ids_bit_exact``, from one engine: three rounds
    without a stop, then the same three again from a fresh cache with
    round 2 stopped on the token it emitted 5th without one (JAX arrays
    are immutable, so a saved cache restores the engine's state)."""
    jeng, _ = _engines(src_fused=False)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, 7).tolist(), rng.integers(0, 512, 5).tolist()]
    fresh = (jeng.cache, jeng.start_pos)
    plain = _jax_rounds(jeng, prompts, ())
    jeng.cache, jeng.start_pos = fresh
    stopped = _jax_rounds(jeng, prompts, (int(plain[1][0][4]),))
    return prompts, {(): plain, (None,): stopped}


@pytest.mark.parametrize("stop", [(), (None,)])
def test_engine_greedy_ids_bit_exact(stop, jax_greedy_rounds):
    """Stacked path (JAX: XLA). Round 1 ends without a stop, so its last id
    is fed at the start of round 2 on both sides (the JAX side by hand).
    With ``stop``, round 2 stops on the token the JAX engine would emit
    5th: this exercises the stop logic and the KV written after the stop,
    which round 3 reads. The round-3 answer depends on the KV of the
    earlier rounds: it agrees as well."""
    prompts, rounds = jax_greedy_rounds
    _, teng = _engines(src_fused=False, jax_side=False)
    for rnd, (jids, stop_ids, jpos, pending) in enumerate(rounds[stop]):
        prompt = prompts[1] if rnd == 1 else prompts[0]
        tg = TGen(greedy=True, max_new_tokens=4 if rnd == 2 else 16)
        tout = teng.generate(prompt, tg, stop_ids=stop_ids)
        np.testing.assert_array_equal(tout["output_ids"].numpy(), jids)
        if rnd < 2:
            assert teng.start_pos == jpos - (pending is not None)
        if stop_ids:
            assert len(tout["output_ids"]) <= 5


@pytest.mark.parametrize("mega", [False, True])
def test_engine_feeds_the_last_id_of_a_round(mega, monkeypatch):
    """Two rounds of 16 greedy steps without a stop, on the stacked path
    and on the megakernels (the JAX side forced onto its megakernel).
    Prompts are longer than CHUNK_S: JAX has no CPU hook for its chunk
    kernel, so both sides prefill on the stacked path and decode with the
    whole-token megakernel. Round 1's last id is never fed by ``generate``;
    the port's engine keeps it pending, and its KV slot (at round 1's
    final position) is written during round 2. The ids equal the JAX
    engine's with the same repair applied by hand, bit for bit."""
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    if mega:
        for name, val in (("AWQ_TPU_FORCE_FLASH", "1"), ("AWQ_TPU_FIXED_MAX", "off"),
                          ("AWQ_TPU_FORCE_MEGAKERNEL", "1")):
            monkeypatch.setenv(name, val)
    else:
        monkeypatch.delenv("AWQ_TPU_FORCE_MEGAKERNEL", raising=False)
    jax.clear_caches()   # forward's trace reads the env at trace time
    try:
        jeng, teng = _engines(src_fused=mega)
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, 512, 40).tolist(), rng.integers(0, 512, 36).tolist()]
        pending = None
        for rnd, prompt in enumerate(prompts):
            gen = dict(greedy=True, max_new_tokens=16)
            slot = teng.start_pos        # a pending id's position
            jids, pending_next = _jax_round(jeng, prompt, JGen(**gen), (), pending)
            tids = teng.generate(prompt, TGen(**gen))["output_ids"].numpy()
            np.testing.assert_array_equal(tids, jids)
            if rnd == 1:
                # round 1's last id sat at `slot`; round 2 wrote its KV
                assert teng.cache[:, :, 0, :, slot].abs().sum(-1).min() > 0
            pending = pending_next
            assert pending is not None
            assert teng.start_pos == jeng.start_pos - 1
            assert float(teng.cache[:, :, 0, :, teng.start_pos].abs().max()) == 0.0
    finally:
        jax.clear_caches()


def test_samplers_match_jax():
    from awq_tpu.runtime import sampling as jsampling

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 64)).astype(np.float32)
    seen = rng.random((3, 64)) < 0.3
    for k in (0, 1, 5):
        np.testing.assert_array_equal(
            tsampling.apply_top_k(torch.from_numpy(logits), k).numpy(),
            np.asarray(jsampling.apply_top_k(jnp.asarray(logits), k)))
    for p in (0.3, 0.9, 1.0):
        np.testing.assert_array_equal(
            tsampling.apply_top_p(torch.from_numpy(logits), p).numpy(),
            np.asarray(jsampling.apply_top_p(jnp.asarray(logits), p)))
    np.testing.assert_array_equal(
        tsampling.apply_repetition_penalty(torch.from_numpy(logits),
                                           torch.from_numpy(seen), 1.3).numpy(),
        np.asarray(jsampling.apply_repetition_penalty(
            jnp.asarray(logits), jnp.asarray(seen), 1.3)))
    gen = TGen(greedy=True, repetition_penalty=1.3)
    got = tsampling.sample_logits(torch.from_numpy(logits), gen,
                                  torch.from_numpy(seen))
    ref = jsampling.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0),
                                  JGen(greedy=True, repetition_penalty=1.3),
                                  jnp.asarray(seen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # sampled draws keep to the top-k support
    g = torch.Generator().manual_seed(0)
    draws = tsampling.sample_logits(torch.from_numpy(logits).repeat(50, 1),
                                    TGen(top_k=2, top_p=1.0, temperature=1.0),
                                    generator=g)
    top2 = np.argsort(-logits, axis=1)[:, :2]
    for row, tok in enumerate(draws.numpy()):
        assert tok in top2[row % 3]


def test_port_imports_no_jax():
    """Importing the whole port loads neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "import awq_tpu_torch, awq_tpu_torch.config, awq_tpu_torch.convert\n"
        "import awq_tpu_torch.quant.core, awq_tpu_torch.quant.packing\n"
        "import awq_tpu_torch.ops.w4a16, awq_tpu_torch.ops.decode_attn\n"
        "import awq_tpu_torch.ops.megakernel, awq_tpu_torch.ops.megakernel_chunk\n"
        "import awq_tpu_torch.models.layers, awq_tpu_torch.models.llama\n"
        "import awq_tpu_torch.runtime.sampling, awq_tpu_torch.runtime.generate\n"
        "import awq_tpu_torch.runtime.engine, awq_tpu_torch.runtime.batch_engine\n"
        "import awq_tpu_torch.runtime.paged\n"
        "import awq_tpu_torch.ops.megakernel_batched, awq_tpu_torch.ops.cache_append\n"
        "import awq_tpu_torch.serve.http, awq_tpu_torch.serve.batch_worker\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'awq_tpu' or m.startswith('awq_tpu.')\n"
        "       or m == 'awq_tpu_torch._build']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
