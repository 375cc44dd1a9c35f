"""Port parity for OPT, and the helpers of ``tests/test_torch_bigcode.py``
and ``tests/test_torch_neox.py`` (the three families the port serves on the
stacked path alone: learned positions, or NeoX's partial rotary).

Tiny f32 models, each JAX's ``init_params`` with every norm weight and bias,
every linear bias and the position table jittered (it sets the first to 1
and 0), quantized to W4 (group 64 at head_dim 64, 128 at 128), reach the
port through ``params_from_jax``:
- OPT at head_dim 64 (OPT-125m..1.3b's) and 128 (OPT-6.7B's): learned
  positions from row 2, LayerNorm with bias, ReLU, biases, the tied head;
- (``test_torch_bigcode.py``) GPT-BigCode: MQA at head_dim 64 (4 q heads
  over one kv head) and StarCoder's group, 48 q heads over one at 128;
- (``test_torch_neox.py``) GPT-NeoX: Pythia's parallel block with two
  norms at head_dim 128 and the sequential block at 64, rope over a
  quarter of the head, an untied head.
Through ``forward``, ``decode_step`` (the position in device memory),
``InferenceEngine``, ``decode_step_batched`` and ``decode_step_paged`` over
f32 and bf16 slot caches, a page pool and ``KVCache8``, ``BatchEngine`` and
``PagedBatchEngine`` against the JAX package's (the port's plain versions
on the CPU: K2 at head_dim 128 with narrow groups, K14 through
``layers.attention`` elsewhere on the single-position step, K2/K8/K9 on the
per-row steps, K3); the HF importers against JAX's and ``transformers``'
logits; checkpoints both ways with JAX; the refusals. The tests marked
``cuda`` hold the stacked path on the card to its plain version and skip
here.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import GenConfig as TGen, ModelConfig as TConfig
from awq_tpu_torch.config import QuantConfig as TQuant
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import cache_append as tca
from awq_tpu_torch.ops import decode_attn as tda
from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops import megakernel_batched as tmb
from awq_tpu_torch.ops import megakernel_chunk as tmc
from awq_tpu_torch.ops.w4a16 import QLinear

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

T = 256      # JAX's flash kernels need a cache of a multiple of 256 positions
_BASE = dict(vocab_size=512, num_layers=2, max_position_embeddings=T, norm="layernorm",
             attn_bias=True, mlp_bias=True, dtype="float32")
_OPT = dict(_BASE, arch="opt", act="relu", pos_embed="learned", tie_word_embeddings=True)
_BIGCODE = dict(_BASE, arch="bigcode", act="gelu_tanh", pos_embed="learned",
                tie_word_embeddings=True)
_NEOX = dict(_BASE, arch="neox", act="gelu", pos_embed="rope", rotary_pct=0.25)
STYLES = {
    "opt": dict(_OPT, hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=4,
                head_dim=64),
    "opt128": dict(_OPT, hidden_size=256, intermediate_size=512, num_heads=2, num_kv_heads=2,
                   head_dim=128),
    "bigcode": dict(_BIGCODE, hidden_size=256, intermediate_size=1024, num_heads=4,
                    num_kv_heads=1, head_dim=64),
    # StarCoder's group: 48 q heads over one kv head at head_dim 128 (the
    # width cut, the heads kept)
    "bigcode48": dict(_BIGCODE, hidden_size=256, intermediate_size=512, num_heads=48,
                      num_kv_heads=1, head_dim=128),
    "neox": dict(_NEOX, hidden_size=256, intermediate_size=512, num_heads=2, num_kv_heads=2,
                 head_dim=128, parallel_block=True),
    "neox_seq": dict(_NEOX, hidden_size=256, intermediate_size=512, num_heads=4,
                     num_kv_heads=4, head_dim=64),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def close(got, ref, tol):
    """``got`` within ``tol`` of ``ref``'s largest magnitude."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def family_model(style: str, seed: int = 1):
    """``(jax cfg, jax params, port cfg, port params)``: JAX's ``init_params``
    with the norms, the linear biases and the position table jittered,
    quantized to W4."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    cfg = JConfig(**STYLES[style])
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed), scale=0.05)
    rng = np.random.default_rng(seed)

    def jitter(a, base, scale=0.1):
        return jnp.asarray(base + scale * rng.standard_normal(a.shape).astype(np.float32))

    layers = {k: (jitter(v, 0.0 if k.endswith("_b") else 1.0) if k.startswith("ln") else v)
              for k, v in params["layers"].items()}
    for name, p in layers.items():
        if getattr(p, "b", None) is not None:
            layers[name] = dataclasses.replace(p, b=jitter(p.b, 0.0))
    top = {k: jitter(params[k], 0.0 if k.endswith("_b") else 1.0)
           for k in ("norm", "norm_b") if k in params}
    if "pos_embed" in params:
        top["pos_embed"] = jitter(params["pos_embed"], 0.0, 0.3)
    group = 64 if cfg.head_dim == 64 else 128
    jparams = jllama.quantize_params({**params, **top, "layers": layers},
                                     JQuant(w_bit=4, group_size=group))
    return cfg, jparams, TConfig(**STYLES[style]), params_from_jax(jax.device_get(jparams),
                                                                   device="cpu")


def prompt_steps(seed, n=16, vocab=512):
    """A prompt of 11 tokens, then ``n`` one-token decode steps."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (1, 11))] + [rng.integers(0, vocab, (1, 1))
                                                for _ in range(n)]


def set_flash(monkeypatch, flash: bool) -> None:
    """JAX's test hook for its flash kernels in interpret mode; the jitted
    steps read it at trace time, so their caches are cleared."""
    import jax

    if flash:
        monkeypatch.setenv("AWQ_TPU_FORCE_FLASH", "1")
    else:
        monkeypatch.delenv("AWQ_TPU_FORCE_FLASH", raising=False)
    for name in ("AWQ_TPU_FORCE_MEGAKERNEL", "AWQ_TPU_DISABLE_MEGAKERNEL"):
        monkeypatch.delenv(name, raising=False)
    jax.clear_caches()


# ---- the checks each family file runs on its styles ----------------------------

def check_forward(style, impl):
    """A prompt of 11 and 16 decode steps through JAX's ``forward`` and the
    port's over f32 caches: every logit within 1e-5 of the largest (f32 on
    both sides, other summation orders), the caches within 1e-4."""
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = family_model(style)
    jcache = jllama.init_kv_cache(jcfg, 1, T, jnp.float32)
    tcache = tllama.init_kv_cache(tcfg, 1, T, torch.float32, device="cpu")
    pos = 0
    for toks in prompt_steps(3, vocab=tcfg.vocab_size):
        jl, jcache = jllama.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), jcache,
                                    jnp.int32(pos), last_only=False)
        tl, tcache = tllama.forward(tparams, tcfg, torch.from_numpy(toks), tcache, pos,
                                    last_only=False, impl=impl)
        close(tl, np.asarray(jl), 1e-5)
        pos += toks.shape[1]
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), rtol=0, atol=1e-4)


def check_decode_step(style, cache_dtype="float32"):
    """``decode_step`` (the position an int32 tensor, the captured step's
    body: the position's table row and rope row looked up on the device)
    gives ``forward``'s logits at that position to 1e-6 of the largest and
    writes the same cache to 1e-5 (the plain attention sums the bound's
    positions, ``forward``'s the length's: f32 orders)."""
    _, _, tcfg, tparams = family_model(style)
    caches = [tllama.init_cache(tcfg, 1, 64, cache_dtype if cache_dtype == "int8"
                                else getattr(torch, cache_dtype), device="cpu")
              for _ in range(2)]
    for c in caches:
        tllama.forward(tparams, tcfg, torch.tensor([[3, 1, 4, 1, 5]]), c, 0)
    for pos, tok in ((5, 9), (6, 2)):
        ref, _ = tllama.forward(tparams, tcfg, torch.tensor([[tok]]), caches[0], pos)
        got = tllama.decode_step(tparams, tcfg, torch.tensor([tok]), caches[1],
                                 torch.tensor([pos], dtype=torch.int32), 63)
        close(got, ref[:, 0], 1e-6)
    for a, b in zip(tllama.cache_tensors(caches[0]), tllama.cache_tensors(caches[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def check_engine_ids(style, n_new=20):
    """Greedy ids of ``InferenceEngine.generate`` over ``n_new`` tokens equal
    the JAX engine's bit for bit (the CPU's stacked path on both sides)."""
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen, RuntimeConfig as JRuntime
    from awq_tpu.runtime.engine import InferenceEngine as JEngine
    from awq_tpu_torch.config import RuntimeConfig as TRuntime
    from awq_tpu_torch.runtime.engine import InferenceEngine as TEngine

    jcfg, jparams, tcfg, tparams = family_model(style, seed=4)
    jeng = JEngine(jcfg, jparams, JRuntime(max_seq_len=T), cache_dtype=jnp.float32)
    teng = TEngine(tcfg, tparams, TRuntime(max_seq_len=T), cache_dtype=torch.float32,
                   device="cpu")
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab_size, 9).tolist()
    jids = np.asarray(jeng.generate(prompt, JGen(greedy=True, max_new_tokens=n_new))[
        "output_ids"])
    tids = teng.generate(prompt, TGen(greedy=True, max_new_tokens=n_new))["output_ids"].numpy()
    assert len(jids) == n_new
    np.testing.assert_array_equal(tids, jids)


LENGTHS = [5, 0, 200, T - 1]      # ragged, with the first and the last position


def slot_inputs(style, seed, b):
    """A random cache ``[L, 2, B, n_kv, T, hd]`` (f32 numpy) and ``b`` ids."""
    f = STYLES[style]
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((f["num_layers"], 2, b, f["num_kv_heads"], T,
                                 f["head_dim"])).astype(np.float32) * 0.3
    return cache, rng.integers(0, f["vocab_size"], b)


def check_batched(style, cache_dtype, monkeypatch):
    """``decode_step_batched`` at ragged lengths against JAX's: over an f32
    cache its XLA step, 1e-4 of the largest logit and 1e-5 on the cache;
    over a bf16 cache its interpret-mode flash step (the current token
    rounded to the cache's dtype, as K2 takes it; its XLA step attends the
    token unrounded, 1.6e-3 away here), 1e-3 and the written rows within a
    bf16 step (relative 2^-7, or 2^-9 near zero). Only each row's own
    position changes."""
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = family_model(style)
    b = len(LENGTHS)
    cache, tokens = slot_inputs(style, 7, b)
    set_flash(monkeypatch, cache_dtype == "bfloat16")
    tcache = torch.from_numpy(cache).to(getattr(torch, cache_dtype))
    start = tcache.clone()
    jc = jnp.asarray(tcache.float().numpy()).astype(getattr(jnp, cache_dtype))
    jlogits, jcache = jllama.decode_step_batched(jparams, jcfg, jnp.asarray(tokens, jnp.int32),
                                                 jc, jnp.asarray(LENGTHS, jnp.int32))
    tlogits, out = tllama.decode_step_batched(tparams, tcfg, torch.from_numpy(tokens), tcache,
                                              torch.tensor(LENGTHS, dtype=torch.int32))
    assert out is tcache and tlogits.shape == (b, tcfg.vocab_size)
    f32 = cache_dtype == "float32"
    close(tlogits, np.asarray(jlogits), 1e-4 if f32 else 1e-3)
    np.testing.assert_allclose(tcache.float().numpy(), np.asarray(jcache.astype(jnp.float32)),
                               rtol=0 if f32 else 2 ** -7, atol=1e-5 if f32 else 2 ** -9)
    changed = (tcache != start).any(dim=5).any(dim=3).any(dim=1).any(dim=0).numpy()   # [B, T]
    want = np.zeros((b, T), bool)
    want[np.arange(b), LENGTHS] = True
    np.testing.assert_array_equal(changed | want, want)


def scatter(cache: np.ndarray, page: int, seed: int, free_pages: int = 2):
    """A slot cache ``[L, 2, B, nkv, T, hd]`` scattered into a pool of
    permuted pages (page 0 the trash page): ``(pool, tables [B, T / page])``."""
    L, _, b, nkv, t, hd = cache.shape
    mp = t // page
    n_pages = 1 + b * mp + free_pages
    tables = np.random.default_rng(seed).permutation(np.arange(1, n_pages))[:b * mp]
    tables = tables.reshape(b, mp).astype(np.int32)
    pool = np.zeros((L, 2, n_pages, nkv, page, hd), cache.dtype)
    for i in range(b):
        for j in range(mp):
            pool[:, :, tables[i, j]] = cache[:, :, i, :, j * page:(j + 1) * page]
    return pool, tables


def check_paged(style, monkeypatch):
    """``decode_step_paged`` over pages of 64 against JAX's (its gathered XLA
    attention): 1e-4 of the largest logit, 1e-5 on the pool; and the slot
    step's logits to 1e-5."""
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = family_model(style)
    lengths = np.array([5, 0, 130, T - 1], np.int32)
    cache, tokens = slot_inputs(style, 11, len(lengths))
    pool, tables = scatter(cache, 64, 4)
    set_flash(monkeypatch, False)
    jlogits, jpool = jllama.decode_step_paged(
        jparams, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(pool),
        jnp.asarray(tables), jnp.asarray(lengths))
    tpool = torch.from_numpy(pool.copy())
    tlogits, out = tllama.decode_step_paged(tparams, tcfg, torch.from_numpy(tokens), tpool,
                                            torch.from_numpy(tables), torch.from_numpy(lengths))
    assert out is tpool
    close(tlogits, np.asarray(jlogits), 1e-4)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), rtol=0, atol=1e-5)
    slot, _ = tllama.decode_step_batched(tparams, tcfg, torch.from_numpy(tokens),
                                         torch.from_numpy(cache.copy()),
                                         torch.from_numpy(lengths))
    close(tlogits, slot, 1e-5)


def assert_caches8_close(jcache, tcache):
    """Codes and scales of the two sides: the k/v they quantize differ in f32
    rounding, so a code on a step's edge may differ by one (at most 1 in 1000
    of them) and a scale by a few ulp."""
    dq = np.abs(tcache.data.numpy().astype(int) - np.asarray(jcache.data).astype(int))
    assert dq.max() <= 1 and (dq != 0).mean() < 1e-3
    np.testing.assert_allclose(tcache.scales.numpy(), np.asarray(jcache.scales), rtol=2e-6,
                               atol=0)


def check_int8(style, monkeypatch):
    """The int8 cache: ``forward`` over a prompt of 11 and 16 steps against
    JAX's under ``AWQ_TPU_FORCE_FLASH=1`` (its interpret-mode
    ``flash_decode_stacked8``, the current token in full precision, as K9
    takes it), 1e-5 of the largest logit; then ``decode_step_batched`` at
    ragged lengths against JAX's, 1e-4 (the llama int8 bounds,
    ``tests/test_torch_kv8_forward.py``)."""
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = family_model(style)
    set_flash(monkeypatch, True)
    jcache = jllama.init_kv_cache8(jcfg, 1, T)
    tcache = tllama.init_kv_cache8(tcfg, 1, T, device="cpu")
    pos = 0
    for toks in prompt_steps(4, vocab=tcfg.vocab_size):
        jl, jcache = jllama.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), jcache,
                                    jnp.int32(pos))
        tl, _ = tllama.forward(tparams, tcfg, torch.from_numpy(toks), tcache, pos)
        close(tl, np.asarray(jl), 1e-5)
        pos += toks.shape[1]
    assert_caches8_close(jcache, tcache)

    set_flash(monkeypatch, False)
    f = STYLES[style]
    b = len(LENGTHS)
    rng = np.random.default_rng(13)
    codes, scales = (a.numpy() for a in tca.quantize_kv(torch.from_numpy(rng.standard_normal(
        (f["num_layers"], 2, b, f["num_kv_heads"], T, f["head_dim"])).astype(np.float32))))
    tokens = rng.integers(0, f["vocab_size"], b)
    jl, jc = jllama.decode_step_batched(jparams, jcfg, jnp.asarray(tokens, jnp.int32),
                                        jllama.KVCache8(jnp.asarray(codes), jnp.asarray(scales)),
                                        jnp.asarray(LENGTHS, jnp.int32))
    tc = tllama.KVCache8(torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy()))
    tl, _ = tllama.decode_step_batched(tparams, tcfg, torch.from_numpy(tokens), tc,
                                       torch.tensor(LENGTHS, dtype=torch.int32))
    close(tl, np.asarray(jl), 1e-4)
    assert_caches8_close(jc, tc)


def engine_requests(vocab: int, seed: int = 4):
    """Five requests through three slots: prompts of 3..24 tokens, 16-18 new
    tokens each (a late one joins while the others decode)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, n).tolist(), m)
            for n, m in zip([7, 24, 3, 12, 7], [16, 18, 17, 16, 16])]


def run_engine(engine, gen_cls, reqs, late: int = 1):
    rids = [engine.submit(p, gen_cls(greedy=True, max_new_tokens=m)) for p, m in reqs[:-late]]
    engine.step()
    engine.step()
    rids += [engine.submit(p, gen_cls(greedy=True, max_new_tokens=m)) for p, m in reqs[-late:]]
    done = engine.run()
    assert set(done) == set(rids)
    return [done[r].out_ids for r in rids]


def check_batch_engines(style, paged, monkeypatch):
    """Greedy ids of the port's ``BatchEngine`` (or ``PagedBatchEngine``,
    pages of 64) equal the JAX engine's bit for bit over 16-18 new tokens a
    request (both f32 on the CPU)."""
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen
    from awq_tpu.runtime.batch_engine import BatchEngine as JBatch
    from awq_tpu.runtime.paged import PagedBatchEngine as JPaged
    from awq_tpu_torch.runtime.batch_engine import BatchEngine as TBatch
    from awq_tpu_torch.runtime.paged import PagedBatchEngine as TPaged

    jcfg, jparams, tcfg, tparams = family_model(style)
    set_flash(monkeypatch, False)
    reqs = engine_requests(tcfg.vocab_size, seed=6 if paged else 4)
    kw = dict(page_size=64) if paged else {}
    ref = run_engine((JPaged if paged else JBatch)(jcfg, jparams, n_slots=3, max_seq_len=T,
                                                   cache_dtype=jnp.float32, **kw), JGen, reqs)
    got = run_engine((TPaged if paged else TBatch)(tcfg, tparams, n_slots=3, max_seq_len=T,
                                                   cache_dtype=torch.float32, device="cpu",
                                                   **kw), TGen, reqs)
    assert [len(r) for r in ref] == [m for _, m in reqs]
    assert got == ref


def check_import(model, arch, tol=3e-3):
    """The port's importer of an in-memory ``transformers`` model against
    JAX's (every array equal) and the model's logits (JAX's tolerance
    against HF, ``tests/test_models_multiarch.py``), for a prompt and one
    decode step. Returns the config."""
    from awq_tpu.models.hf_import import import_hf_model as jimport
    from awq_tpu_torch.models import hf_import as thf
    from tests.test_torch_hf_import import _assert_trees_equal

    cfg, params = thf.import_hf_model(model, dtype="float32", device="cpu")
    jcfg, jparams = jimport(model, dtype="float32")
    assert cfg.__dict__ == jcfg.__dict__ and cfg.arch == arch
    _assert_trees_equal(params, jparams)
    check_hf_logits(model, cfg, params, tol)
    return cfg


def check_hf_logits(model, cfg, params, tol=3e-3):
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 9))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens).long()).logits.numpy()
    cache = tllama.init_kv_cache(cfg, 1, 16, torch.float32, device="cpu")
    ours, _ = tllama.forward(params, cfg, torch.from_numpy(tokens), cache, 0, last_only=False)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=tol, atol=tol)
    nxt = np.concatenate([tokens, [[7]]], axis=1)
    with torch.no_grad():
        ref2 = model(torch.from_numpy(nxt).long()).logits.numpy()[:, -1:]
    ours2, _ = tllama.forward(params, cfg, torch.tensor([[7]]), cache, 9)
    np.testing.assert_allclose(ours2.numpy(), ref2, rtol=tol, atol=tol)


def jitter_hf(model, seed):
    """An HF model's norm weights and biases jittered (their inits are 1 and
    0), in place."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model.eval().float()


def check_checkpoint(style, direction, tmp_path, extra=("pos_embed",)):
    import jax
    from awq_tpu.config import QuantConfig as JQuant
    from awq_tpu.utils import checkpoint as jck
    from awq_tpu_torch.utils import checkpoint as tck
    from tests.test_torch_checkpoint import _assert_same

    jcfg, tree, _, port = family_model(style, seed=5)
    qcfg = JQuant(w_bit=4, group_size=64 if jcfg.head_dim == 64 else 128)
    path = str(tmp_path / "ck")
    assert set(extra) <= set(port)
    if direction == "jax_to_port":
        jck.save_checkpoint(path, tree, jcfg, qcfg)
        got, tcfg, _ = tck.load_checkpoint(path, device="cpu")
        _assert_same(got, port)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    else:
        tck.save_checkpoint(path, port, TConfig(**dataclasses.asdict(jcfg)),
                            TQuant(**dataclasses.asdict(qcfg)))
        jtree, jcfg2, _ = jck.load_checkpoint(path)
        _assert_same(params_from_jax(jax.device_get(jtree), device="cpu"), port)
        assert dataclasses.asdict(jcfg2) == dataclasses.asdict(jcfg)


def check_refusals(style):
    """TP raises naming ROADMAP A17b; head_dim 96 (GPT-NeoX-20B's) and OPT's
    post-LN variant name A12; K4, K5 and K6 refuse the family (as JAX's
    gates) and the engines' single-stream step does not take K4. Nothing
    launches on the CPU."""
    from awq_tpu_torch.parallel.deploy import build_tp_params
    from awq_tpu_torch.parallel.mesh import TPGroup

    cfg = TConfig(**STYLES[style])
    qp = tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=64), device="cpu")
    params = tllama.fuse_linears(qp, cfg)
    assert ("pos_embed" in params) == (cfg.pos_embed == "learned")
    if cfg.pos_embed == "learned":
        assert tuple(params["pos_embed"].shape) == (T + tllama.pos_offset(cfg), cfg.hidden_size)
    assert ("lm_head" in params) == (not cfg.tie_word_embeddings)
    cache = tllama.init_kv_cache(cfg, 1, 64, torch.float32, device="cpu")
    toks = torch.tensor([[1]])
    group = TPGroup(rank=0, size=1, group=None, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="item 17b"):
        tllama.forward(params, cfg, toks, cache, 0, tp_axis=group)
    with pytest.raises(NotImplementedError, match="item 17b"):
        build_tp_params(qp, cfg, group)
    for change in (dict(head_dim=96), dict(do_layer_norm_before=False),
                   dict(norm="rmsnorm"), dict(single_ln=True), dict(embed_ln=True)):
        with pytest.raises(NotImplementedError, match="item 12"):
            tllama.forward(params, dataclasses.replace(cfg, **change), toks, cache, 0)
    layers = params["layers"]
    assert tmk.model_shape(cfg) is None
    assert not tmk.megakernel_supported(cfg, layers, cache)
    assert not tmc.chunk_megakernel_supported(cfg, layers, cache, 8)
    slots = tllama.init_kv_cache(cfg, 4, 64, torch.float32, device="cpu")
    assert not tmb.megakernel_batched_supported(cfg, layers, slots, 4)
    assert not tmb.megakernel_paged_supported(cfg, layers, torch.zeros(
        (cfg.num_layers, 2, 5, cfg.num_kv_heads, 16, cfg.head_dim)), 4)
    assert not tllama.decode_step_on_k4(params, cfg, cache, 1)


def card_model(style, dev, seed=2):
    """A bf16 model of the style on the card: ``init_qparams`` with random
    biases, norm weights and position table, fused."""
    cfg = TConfig(**{**STYLES[style], "dtype": "bfloat16"})
    g = torch.Generator(device=dev).manual_seed(seed)
    params = tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=64 if cfg.head_dim == 64
                                             else 128), g, scale=0.05, device=dev)
    for p in params["layers"].values():
        if isinstance(p, QLinear) and p.bias is not None:
            p.bias.copy_(torch.randn(p.bias.shape, generator=g, device=dev) * 0.05)
    for name in ("ln1", "ln2"):
        la = params["layers"]
        la[name] = (torch.rand(la[name].shape, generator=g, device=dev) * 0.4 + 0.8).to(
            torch.bfloat16)
    if "pos_embed" in params:
        params["pos_embed"].mul_(10)
    return cfg, tllama.fuse_linears(params, cfg)


def check_forward_on_card(style, dev, decode_kernel):
    """A prompt of 40 (K1's GEMM, K3) and four decode steps (K1's GEMV and
    ``decode_kernel``) on the card within 5e-2 of the largest logit of the
    plain path (phase 4's bound); ``decode_kernel`` launches once a layer
    and step, K4-K6 never."""
    cfg, params = card_model(style, dev)
    caches = [tllama.init_kv_cache(cfg, 1, 512, device=dev) for _ in range(2)]
    rng = torch.Generator().manual_seed(1)
    steps = [torch.randint(0, cfg.vocab_size, (1, 40), generator=rng)] + [
        torch.randint(0, cfg.vocab_size, (1, 1), generator=rng) for _ in range(4)]
    before = dict(tda.LAUNCHES)
    k4, k6 = dict(tmk.LAUNCHES), dict(tmb.LAUNCHES)
    pos = 0
    for toks in steps:
        toks = toks.to(dev)
        got, _ = tllama.forward(params, cfg, toks, caches[0], pos)
        ref, _ = tllama.forward(params, cfg, toks, caches[1], pos, impl="plain")
        close(got.cpu(), ref.cpu(), 5e-2)
        pos += toks.shape[1]
    moved = {k: tda.LAUNCHES[k] - before[k] for k in tda.LAUNCHES}
    assert moved[decode_kernel] == 4 * cfg.num_layers and moved["flash_prefill"] == cfg.num_layers
    assert tmk.LAUNCHES == k4 and tmb.LAUNCHES == k6


def check_steps_on_card(style, dev, kernels):
    """``decode_step_batched`` over a bf16 and an int8 slot cache and
    ``decode_step_paged`` over pages of 16 on the card, each within 5e-2 of
    the largest logit of its plain version, and ``decode_step`` (a device
    position) equal to ``forward``'s step planned for its length, bit for
    bit; ``kernels`` (K2, K9, K8 in their units) launch once a layer each."""
    cfg, params = card_model(style, dev)
    lens = torch.tensor([0, 37, 300, 511], dtype=torch.int32, device=dev)
    toks = torch.tensor([5, 9, 2, 7], device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    cache = (torch.randn((cfg.num_layers, 2, 4, cfg.num_kv_heads, 512, cfg.head_dim),
                         generator=g, device=dev) * 0.5).to(torch.bfloat16)
    before = dict(tda.LAUNCHES)
    for kind in ("bf16", "int8"):
        c1 = cache.clone() if kind == "bf16" else tllama.KVCache8(*tca.quantize_kv(cache))
        c2 = c1.clone() if kind == "bf16" else tllama.KVCache8(c1.data.clone(),
                                                                c1.scales.clone())
        got, _ = tllama.decode_step_batched(params, cfg, toks, c1, lens, max_length=511)
        ref, _ = tllama.decode_step_batched(params, cfg, toks, c2, lens, impl="plain",
                                            max_length=511)
        close(got.cpu(), ref.cpu(), 5e-2)
    pool, tables = scatter(cache.float().cpu().numpy(), 16, 7)
    pool = torch.from_numpy(pool).to(dev, torch.bfloat16)
    tables = torch.from_numpy(tables).to(dev)
    got, _ = tllama.decode_step_paged(params, cfg, toks, pool.clone(), tables, lens,
                                      max_length=511)
    ref, _ = tllama.decode_step_paged(params, cfg, toks, pool.clone(), tables, lens,
                                      impl="plain", max_length=511)
    close(got.cpu(), ref.cpu(), 5e-2)
    moved = {k: tda.LAUNCHES[k] - before[k] for k in tda.LAUNCHES}
    for k in kernels:
        assert moved[k] == cfg.num_layers, (k, moved)
    one = [cache[:, :, :1].clone() for _ in range(2)]
    pos = 300
    ref, _ = tllama.forward(params, cfg, toks[:1, None], one[0], pos)
    got = tllama.decode_step(params, cfg, toks[:1], one[1],
                             torch.tensor([pos], dtype=torch.int32, device=dev), 511)
    torch.cuda.synchronize()
    assert torch.equal(got, ref[:, 0]) and torch.equal(one[0], one[1])


# ---- OPT --------------------------------------------------------------------------

OPT_STYLES = ["opt", "opt128"]


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("style", OPT_STYLES)
def test_forward_matches_jax(style, impl):
    check_forward(style, impl)


@pytest.mark.parametrize("style", OPT_STYLES)
def test_decode_step_matches_forward(style):
    check_decode_step(style)


def test_learned_positions_at_jax_rounding_point():
    """The position table's row is cast to the model dtype and added to the
    embedding in that dtype, from row 2 for OPT, as JAX adds it; a row
    past the table is clamped to the last, as JAX's gather clamps."""
    import jax.numpy as jnp

    cfg = TConfig(**{**STYLES["opt"], "dtype": "bfloat16"})
    rng = np.random.default_rng(0)
    params = {"embed": torch.from_numpy(rng.standard_normal((512, 256)).astype(np.float32)),
              "pos_embed": torch.from_numpy(rng.standard_normal((T + 2, 256)).astype(
                  np.float32))}
    ids = torch.tensor([[3, 7, 11]])
    for pos in (torch.arange(0, 3), torch.tensor([T - 1]), torch.tensor([T + 5])):
        got = tllama._embed(params, cfg, ids[:, :pos.numel()], pos)
        emb = jnp.asarray(params["embed"].numpy()).astype(jnp.bfloat16)[ids[:, :pos.numel()]
                                                                        .numpy()]
        ref = emb + jnp.asarray(params["pos_embed"].numpy())[
            np.minimum(pos.numpy() + 2, T + 1)][None].astype(jnp.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("style", OPT_STYLES)
def test_engine_greedy_ids_bit_exact(style):
    check_engine_ids(style)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_step_batched_matches_jax(cache_dtype, monkeypatch):
    check_batched("opt128", cache_dtype, monkeypatch)


def test_decode_step_paged_matches_jax(monkeypatch):
    check_paged("opt", monkeypatch)


def test_int8_cache_matches_jax(monkeypatch):
    check_int8("opt128", monkeypatch)


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_batch_engines_greedy_ids_match_jax(paged, monkeypatch):
    check_batch_engines("opt", paged, monkeypatch)


def _hf_opt(seed, **kw):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.OPTConfig(vocab_size=256, hidden_size=128, ffn_dim=256,
                                 num_hidden_layers=2, num_attention_heads=2,
                                 max_position_embeddings=64, word_embed_proj_dim=128, **kw)
    torch.manual_seed(seed)
    return jitter_hf(transformers.OPTForCausalLM(cfg), seed)


def test_import_equals_jax_and_logits_equal_hf():
    cfg = check_import(_hf_opt(3), "opt")
    assert cfg.pos_embed == "learned" and cfg.act == "relu" and cfg.tie_word_embeddings


def test_import_refuses_what_jax_ignores():
    """OPT-350m's projected embedding (``word_embed_proj_dim != hidden_size``:
    ``project_in``/``project_out``) and its post-LN block
    (``do_layer_norm_before=False``) raise naming ROADMAP A12: the JAX
    importer drops the projections and JAX's forward runs every OPT
    pre-LN, which gives other logits than the model's."""
    from awq_tpu_torch.models import hf_import as thf

    transformers = pytest.importorskip("transformers")
    cfg = transformers.OPTConfig(vocab_size=64, hidden_size=32, ffn_dim=64, num_hidden_layers=1,
                                 num_attention_heads=2, word_embed_proj_dim=16)
    with pytest.raises(NotImplementedError, match="item 12"):
        thf.import_hf_model(transformers.OPTForCausalLM(cfg), dtype="float32", device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        thf.import_hf_model(_hf_opt(2, do_layer_norm_before=False), dtype="float32",
                            device="cpu")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_round_trip_with_jax(direction, tmp_path):
    check_checkpoint("opt", direction, tmp_path)


@pytest.mark.parametrize("style", OPT_STYLES)
def test_refusals_and_gates(style):
    check_refusals(style)


def test_worker_serves_input_ids():
    """The port's ``ModelWorker`` over an OPT engine (no tokenizer) answers an
    ``input_ids`` request over HTTP on localhost with the JAX engine's
    greedy ids."""
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen, RuntimeConfig as JRuntime
    from awq_tpu.runtime.engine import InferenceEngine as JEngine
    from awq_tpu_torch.config import RuntimeConfig as TRuntime
    from awq_tpu_torch.runtime.engine import InferenceEngine as TEngine
    from awq_tpu_torch.serve.http import post_stream
    from awq_tpu_torch.serve.worker import ModelWorker

    jcfg, jparams, tcfg, tparams = family_model("opt", seed=4)
    prompt = np.random.default_rng(8).integers(0, 512, 12).tolist()
    ref = JEngine(jcfg, jparams, JRuntime(max_seq_len=T), cache_dtype=jnp.float32).generate(
        prompt, JGen(greedy=True, max_new_tokens=10))["output_ids"]
    worker = ModelWorker(TEngine(tcfg, tparams, TRuntime(max_seq_len=T),
                                 cache_dtype=torch.float32, device="cpu"), "opt", port=0)
    worker.start()
    try:
        chunks = list(post_stream(worker.url + "/worker_generate_stream",
                                  dict(input_ids=prompt, greedy=True, max_new_tokens=10),
                                  timeout=300))
    finally:
        worker.stop()
    assert [c["error_code"] for c in chunks] == [0] * len(chunks)
    assert chunks[-1]["finished"] and chunks[-1]["ids"] == np.asarray(ref).tolist()


# ---- on the card ------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("style,kernel", [("opt", "flash_decode_layer"),
                                          ("opt128", "flash_decode")])
def test_forward_on_card(cuda, style, kernel):
    check_forward_on_card(style, cuda, kernel)


@pytest.mark.cuda
def test_steps_on_card(cuda):
    check_steps_on_card("opt128", cuda, ("flash_decode", "flash_decode_int8",
                                         "flash_decode_paged"))
