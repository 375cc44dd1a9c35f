"""Port parity of both engines over the int8 KV cache: greedy ids of
``InferenceEngine`` and ``BatchEngine`` with ``cache_dtype="int8"`` equal
the JAX engines' bit for bit, and int8 stays refused where the JAX package
has none. The tiny f32 model and the environment of the JAX flash path
are ``test_torch_kv8_forward.py``'s.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops import megakernel_batched as tmb
from awq_tpu_torch.ops import megakernel_chunk as tmc
from test_torch_kv8_forward import HD, _flash_env, model  # noqa: F401  (fixture)

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


def _jax_round(jeng, prompt, gen, pending):
    """The JAX engine's round with the port's repair of its last-token fault
    applied by hand (``test_torch_engine._jax_round``)."""
    if pending is not None:
        jeng.start_pos -= 1
        prompt = [pending] + list(prompt)
    ids = np.asarray(jeng.generate(prompt, gen)["output_ids"])
    return ids, (int(ids[-1]) if len(ids) == gen.max_new_tokens else None)


def test_engine_kv8_greedy_ids_match_jax(model, monkeypatch):
    """Greedy ids of ``InferenceEngine(cache_dtype="int8")`` equal the JAX
    engine's bit for bit over two dialogue rounds of 16 new tokens (the
    second reuses the first's int8 KV), on the stacked path: JAX runs the
    TPU kernel of K9 in interpret mode, in the deployed order
    (``AWQ_TPU_FORCE_FLASH=1``). The megakernel path is held to JAX's from
    one shared cache below: JAX's megakernels need its folded tree, whose
    prefill rounds every matmul input to bf16, and over an int8 cache that
    moves codes by a step and flips near-tied argmaxes of this random
    model (measured: 1.3e-2 of the largest logit, f32 and int8 caches
    alike)."""
    from awq_tpu.config import GenConfig as JGen, RuntimeConfig as JRuntime
    from awq_tpu.runtime.engine import InferenceEngine as JEngine
    from awq_tpu_torch.config import GenConfig as TGen, RuntimeConfig as TRuntime
    from awq_tpu_torch.runtime.engine import InferenceEngine as TEngine
    import jax

    jcfg, jparams, tcfg, tparams = model
    _flash_env(monkeypatch, mega=False)
    try:
        jeng = JEngine(jcfg, jparams, JRuntime(max_seq_len=256), cache_dtype="int8")
        teng = TEngine(tcfg, tparams, TRuntime(max_seq_len=256), cache_dtype="int8",
                       device="cpu")
        assert isinstance(teng.cache, tllama.KVCache8) and teng.max_seq_len == 256
        rng = np.random.default_rng(11)
        pending = None
        for n in (40, 36):
            prompt = rng.integers(0, 512, n).tolist()
            jids, pending = _jax_round(jeng, prompt, JGen(greedy=True, max_new_tokens=16),
                                       pending)
            tids = teng.generate(prompt, TGen(greedy=True, max_new_tokens=16))["output_ids"]
            np.testing.assert_array_equal(tids.numpy(), jids)
        assert teng.start_pos == jeng.start_pos - 1
        teng.reset()
        assert not any(bool(x.abs().max()) for x in teng.cache)
    finally:
        jax.clear_caches()


def test_batch_engine_kv8_greedy_ids_match_jax(model, monkeypatch):
    """Greedy ids of ``BatchEngine(cache_dtype="int8")`` equal the JAX
    engine's bit for bit: six requests through three slots, joining while
    others decode (``test_torch_batch_engine._run``), each prefilled into a
    one-slot int8 staging cache whose codes and scales are copied into its
    slot. The JAX engine runs its XLA path on the CPU, the current token in
    full precision as on the TPU; so does the port's stacked path (K9's
    plain version, the K7 int8 append). K6's int8 mode rounds its matmul
    inputs to bf16 and is held to JAX's kernel at the step level
    (``test_decode_step_batched_kv8_matches_jax``)."""
    from awq_tpu.config import GenConfig as JGen
    from awq_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
    from awq_tpu_torch.config import GenConfig as TGen
    from awq_tpu_torch.runtime.batch_engine import BatchEngine as TBatchEngine
    from test_torch_batch_engine import _requests, _run

    jcfg, jparams, tcfg, tparams = model
    monkeypatch.delenv("AWQ_TPU_FORCE_FLASH", raising=False)
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    monkeypatch.delenv("AWQ_TPU_FORCE_MEGAKERNEL", raising=False)
    reqs = _requests(9)
    ref = _run(JBatchEngine(jcfg, jparams, n_slots=3, max_seq_len=64, cache_dtype="int8"),
               JGen, reqs, {})
    eng = TBatchEngine(tcfg, tparams, n_slots=3, max_seq_len=64, cache_dtype="int8",
                       device="cpu")
    assert isinstance(eng.cache, tllama.KVCache8)
    got = _run(eng, TGen, reqs, {})
    for g, r in zip(got, ref):
        assert g.out_ids == r.out_ids, (g.rid, g.out_ids, r.out_ids)
    assert isinstance(eng._stage, tllama.KVCache8)


def test_int8_stays_refused_where_jax_has_none(model):
    """No paged int8 pool and no int8 chunk kernel, as in the JAX package."""
    from awq_tpu_torch.runtime.paged import PagedBatchEngine

    _, _, tcfg, tparams = model
    with pytest.raises(NotImplementedError, match="paged.py:107"):
        PagedBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=128, page_size=64,
                         cache_dtype="int8", device="cpu")
    c8 = tllama.init_kv_cache8(tcfg, 2, 64, device="cpu")
    toks, lens = torch.tensor([1, 2]), torch.tensor([0, 3], dtype=torch.int32)
    tables = torch.tensor([[1], [2]], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="paged"):
        tllama.decode_step_paged(tparams, tcfg, toks, c8, tables, lens)
    fused = tllama.fuse_linears(tparams, tcfg)["layers"]
    one = tllama.init_kv_cache8(tcfg, 1, 64, device="cpu")
    import os
    old = os.environ.get("AWQ_TPU_FORCE_MEGAKERNEL")
    os.environ["AWQ_TPU_FORCE_MEGAKERNEL"] = "1"
    try:
        assert tmk.megakernel_supported(tcfg, fused, one)
        assert not tmc.chunk_megakernel_supported(tcfg, fused, one, 16)
        assert not tmb.megakernel_paged_supported(tcfg, fused, c8, 2)
    finally:
        if old is None:
            del os.environ["AWQ_TPU_FORCE_MEGAKERNEL"]
        else:
            os.environ["AWQ_TPU_FORCE_MEGAKERNEL"] = old
    # a bare int8 tensor has lost its scales
    with pytest.raises(TypeError, match="KVCache8"):
        tllama.forward(tparams, tcfg, torch.zeros((1, 1), dtype=torch.long),
                       torch.zeros((2, 2, 1, 2, 64, HD), dtype=torch.int8), 0)
