"""Port parity of a W3 model: ``forward`` logits against JAX ``forward``
and greedy ids of ``InferenceEngine`` and ``BatchEngine`` against the
JAX engines', on a tiny f32 model with dense3 W3-g128 weights from
``quantize_params`` (the W3 kernels' plain versions are held in
``test_torch_w3.py`` and ``test_torch_w3_model.py``).
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.convert import params_from_jax

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


GEOM = dict(arch="llama", vocab_size=256, hidden_size=256,
            intermediate_size=512, num_layers=2, num_heads=2, num_kv_heads=2,
            head_dim=128, max_position_embeddings=256, dtype="float32")


@pytest.fixture(scope="module")
def model():
    """A tiny f32 W3 model: dense3 W3-g128 body from ``quantize_params``,
    the fp head; the JAX tree and the port's from it."""
    import jax
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama
    from awq_tpu_torch.config import ModelConfig as TConfig

    jcfg, tcfg = JConfig(**GEOM), TConfig(**GEOM)
    jparams = jllama.quantize_params(jllama.init_params(jcfg, jax.random.PRNGKey(3)),
                                     JQuant(w_bit=3, group_size=128))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    assert tparams["layers"]["down"].dense3
    return jcfg, jparams, tcfg, tparams


def test_forward_w3_matches_jax(model):
    """A 40-token prefill (over the chunk kernel's 32: the stacked path on
    both sides) and one decode step, f32 model and cache: 1e-4 of the
    largest logit (f32 on both sides, other summation orders)."""
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama
    from awq_tpu_torch.models import llama as tllama

    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(1).integers(0, GEOM["vocab_size"], (1, 41))
    jcache = jllama.init_kv_cache(jcfg, 1, 64, jnp.float32)
    tcache = tllama.init_kv_cache(tcfg, 1, 64, torch.float32, device="cpu")
    for lo, hi in ((0, 40), (40, 41)):
        jl, jcache = jllama.forward(jparams, jcfg, jnp.asarray(toks[:, lo:hi]), jcache, lo)
        tl, _ = tllama.forward(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]), tcache, lo)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4 * np.abs(jl).max())


def test_engines_w3_greedy_ids_match_jax(model, monkeypatch):
    """16 greedy steps through ``InferenceEngine`` and three requests of 16
    through a 2-slot ``BatchEngine`` (one joins when a slot frees), on the
    stacked path of both packages, f32: ids equal bit for bit."""
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen, RuntimeConfig as JRuntime
    from awq_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
    from awq_tpu.runtime.engine import InferenceEngine as JEngine
    from awq_tpu_torch.config import GenConfig as TGen, RuntimeConfig as TRuntime
    from awq_tpu_torch.runtime.batch_engine import BatchEngine as TBatchEngine
    from awq_tpu_torch.runtime.engine import InferenceEngine as TEngine

    monkeypatch.delenv("AWQ_TPU_FORCE_MEGAKERNEL", raising=False)
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, GEOM["vocab_size"], 9).tolist()
    jeng = JEngine(jcfg, jparams, JRuntime(max_seq_len=64), cache_dtype=jnp.float32)
    teng = TEngine(tcfg, tparams, TRuntime(max_seq_len=64), cache_dtype=torch.float32,
                   device="cpu")
    jids = np.asarray(jeng.generate(prompt, JGen(greedy=True, max_new_tokens=16))
                      ["output_ids"])
    tids = teng.generate(prompt, TGen(greedy=True, max_new_tokens=16))["output_ids"]
    assert len(jids) == 16
    np.testing.assert_array_equal(tids.numpy(), jids)

    reqs = [rng.integers(0, GEOM["vocab_size"], n).tolist() for n in (5, 12, 3)]
    outs = []
    for eng, gen in ((JBatchEngine(jcfg, jparams, n_slots=2, max_seq_len=64,
                                   cache_dtype=jnp.float32), JGen),
                     (TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=64,
                                   cache_dtype=torch.float32, device="cpu"), TGen)):
        rids = [eng.submit(p, gen(greedy=True, max_new_tokens=16)) for p in reqs]
        done = eng.run()
        outs.append([list(done[r].out_ids) for r in rids])
    assert all(len(ids) == 16 for ids in outs[0])
    assert outs[1] == outs[0]
