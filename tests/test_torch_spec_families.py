"""Port parity of the batched speculative verify for every non-ALiBi family
of JAX's verify step: ``BatchEngine(spec_k=4)``'s greedy ids against JAX's
``BatchEngine(spec_k=4)``'s and the port's plain engine's, bit for bit, on
the CPU.

The tiny f32 models of ``tests/test_torch_verify.py`` (falcon-7b-style MQA
at head_dim 64 with one norm, OPT's learned positions, GPT-BigCode MQA,
GPT-NeoX's partial rope in both blocks; llama runs in
``tests/test_torch_speculative.py``). Four requests through three slots
(the last joins while the others verify), prompts that repeat a short
pattern so that the drafter proposes, 16-18 new ids each; JAX's engine runs
its XLA verify step, the port the window mode's plain version (the CPU
path). Each run counts its verify steps: the engines verified, and the
drafts were accepted where they agreed.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import GenConfig as TGen
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.runtime.batch_engine import BatchEngine as TBatchEngine
from test_torch_verify import T, verify_model

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


def requests(vocab: int, seed: int = 6):
    """Prompts of a repeated 2-4 token pattern and 16-18 new ids."""
    rng = np.random.default_rng(seed)
    out = []
    for n, reps, m in zip([3, 2, 4, 3], [4, 6, 3, 5], [16, 18, 17, 16]):
        out.append((np.tile(rng.integers(1, vocab, n), reps).tolist(), m))
    return out


def run(engine, gen_cls, reqs):
    """Three requests, two steps, then the last; the ids of each."""
    rids = [engine.submit(p, gen_cls(greedy=True, max_new_tokens=m)) for p, m in reqs[:-1]]
    engine.step()
    engine.step()
    rids.append(engine.submit(reqs[-1][0], gen_cls(greedy=True, max_new_tokens=reqs[-1][1])))
    done = engine.run()
    return [list(map(int, done[r].out_ids)) for r in rids]


@pytest.mark.parametrize("family", ["falcon7b", "opt", "bigcode", "neox", "neox_seq"])
def test_batch_engine_spec_ids_match_jax(family, monkeypatch):
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen
    from awq_tpu.runtime.batch_engine import BatchEngine as JBatchEngine

    jcfg, jparams, tcfg, tparams = verify_model(family)
    monkeypatch.delenv("AWQ_TPU_FORCE_FLASH", raising=False)
    reqs = requests(tcfg.vocab_size)
    steps = []
    real = tllama.verify_step_batched

    def counted(*a, **kw):
        steps.append(a[2].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tllama, "verify_step_batched", counted)
    ref = run(JBatchEngine(jcfg, jparams, n_slots=3, max_seq_len=T, cache_dtype=jnp.float32,
                           spec_k=4), JGen, reqs)
    got = run(TBatchEngine(tcfg, tparams, n_slots=3, max_seq_len=T, cache_dtype=torch.float32,
                           spec_k=4, device="cpu"), TGen, reqs)
    n_verify = len(steps)
    plain = run(TBatchEngine(tcfg, tparams, n_slots=3, max_seq_len=T,
                             cache_dtype=torch.float32, device="cpu"), TGen, reqs)
    assert [len(r) for r in ref] == [m for _, m in reqs]
    assert got == ref == plain
    assert n_verify > 0 and len(steps) == n_verify and set(steps) == {(3, 5)}
