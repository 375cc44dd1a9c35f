"""Port parity of the batched step for falcon, MPT and BLOOM:
``decode_step_batched`` and ``BatchEngine`` against the JAX package's on the
CPU, and K2's head_dim-64, wide-group and ALiBi modes on the card.

Four tiny f32 models, each JAX's ``init_params`` with random norm weights
and biases (and BLOOM's linear biases), quantized as the repo quantizes the
family (W4-g64 at head_dim 64, W4-g128 at 128), reach the port through
``params_from_jax``:
- falcon-7b-style: 16 query heads over ONE kv head at head_dim 64 (a wide
  MQA group, as Falcon-7B's 71 over one), ``single_ln``;
- falcon-40b-style: grouped QKV, 8 over 2 kv heads, two norms;
- MPT: ALiBi, 2 heads of 128 (MHA), bias-free LayerNorm;
- BLOOM: ALiBi, 4 heads of 64, ``embed_ln``, biases everywhere.
JAX's ``decode_step_batched`` runs its XLA attention, or under
``AWQ_TPU_FORCE_FLASH=1`` its interpret-mode ``flash_decode_stacked`` (the
paired head_dim-64 mode, ALiBi slopes as fixed point: exact for these
power-of-two head counts); the port runs K2's plain version (the CPU path).
The tests marked ``cuda`` hold K2's new modes and the families' batched step
to their plain versions on a card and skip here.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import GenConfig as TGen, ModelConfig as TConfig
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.models import layers as tlayers
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import decode_attn as tda

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

T = 256      # JAX's flash decode needs a cache of a multiple of 256 positions
_FALCON = dict(arch="falcon", vocab_size=512, num_layers=2, head_dim=64,
               max_position_embeddings=T, norm="layernorm", act="gelu",
               parallel_block=True, dtype="float32")
FAMILIES = {
    "falcon7b": dict(_FALCON, hidden_size=1024, intermediate_size=2048, num_heads=16,
                     num_kv_heads=1, single_ln=True),
    "falcon40b": dict(_FALCON, hidden_size=512, intermediate_size=1024, num_heads=8,
                      num_kv_heads=2, grouped_qkv=True),
    "mpt": dict(arch="mpt", vocab_size=512, hidden_size=256, intermediate_size=1024,
                num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128,
                max_position_embeddings=T, norm="layernorm", norm_bias=False, act="gelu",
                pos_embed="alibi", dtype="float32"),
    "bloom": dict(arch="bloom", vocab_size=512, num_layers=2, max_position_embeddings=T,
                  norm="layernorm", act="gelu_tanh", pos_embed="alibi", attn_bias=True,
                  mlp_bias=True, embed_ln=True, tie_word_embeddings=True, dtype="float32",
                  hidden_size=256, intermediate_size=1024, num_heads=4, num_kv_heads=4,
                  head_dim=64),
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
def family_model(family: str, seed: int = 1):
    """``(jax cfg, jax params, port cfg, port params)`` of a family: JAX's
    ``init_params`` with every norm weight and bias and every linear bias
    jittered (it sets them to 1 and 0), quantized to W4 at group 64
    (head_dim 64) or 128."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    cfg = JConfig(**FAMILIES[family])
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed), scale=0.05)
    rng = np.random.default_rng(seed)

    def jitter(a, base):
        return jnp.asarray(base + 0.1 * rng.standard_normal(a.shape).astype(np.float32))

    layers = {k: (jitter(v, 0.0 if k.endswith("_b") else 1.0) if k.startswith("ln") else v)
              for k, v in params["layers"].items()}
    for name, p in layers.items():
        if getattr(p, "b", None) is not None:
            layers[name] = dataclasses.replace(p, b=jitter(p.b, 0.0))
    top = {k: jitter(params[k], 0.0 if k.endswith("_b") else 1.0)
           for k in ("norm", "norm_b", "embed_ln_w", "embed_ln_b") if k in params}
    group = 64 if cfg.head_dim == 64 else 128
    jparams = jllama.quantize_params({**params, **top, "layers": layers},
                                     JQuant(w_bit=4, group_size=group))
    tcfg = TConfig(**FAMILIES[family])
    return cfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


def step_inputs(family: str, seed: int, b: int):
    """A random f32 cache ``[L, 2, B, n_kv, T, hd]`` and ``b`` token ids."""
    f = FAMILIES[family]
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((f["num_layers"], 2, b, f["num_kv_heads"], T,
                                 f["head_dim"])).astype(np.float32) * 0.3
    return cache, rng.integers(0, f["vocab_size"], b)


def set_flash(monkeypatch, flash: bool) -> None:
    """JAX's test hook for its flash kernels in interpret mode; the jitted
    steps read it at trace time, so their caches are cleared."""
    import jax

    if flash:
        monkeypatch.setenv("AWQ_TPU_FORCE_FLASH", "1")
    else:
        monkeypatch.delenv("AWQ_TPU_FORCE_FLASH", raising=False)
    monkeypatch.delenv("AWQ_TPU_FORCE_MEGAKERNEL", raising=False)
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    jax.clear_caches()


LENGTHS = [5, 0, 200, T - 1]      # ragged, with the first and the last position


# f32 on both sides: JAX's XLA attention (or its interpret-mode flash kernel
# over 256-position blocks) against K2's plain version, other summation
# orders; 1e-4 of the largest logit, 1e-5 absolute on the cache (values ~1).
@pytest.mark.parametrize("flash", [False, True], ids=["xla", "flash"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_step_batched_matches_jax(family, flash, monkeypatch):
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = family_model(family)
    b = len(LENGTHS)
    cache, tokens = step_inputs(family, 7, b)
    set_flash(monkeypatch, flash)
    jlogits, jcache = jllama.decode_step_batched(
        jparams, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(cache),
        jnp.asarray(LENGTHS, jnp.int32))
    tcache = torch.from_numpy(cache.copy())
    tlogits, out = tllama.decode_step_batched(
        tparams, tcfg, torch.from_numpy(tokens), tcache,
        torch.tensor(LENGTHS, dtype=torch.int32))
    assert out is tcache and tlogits.shape == (b, tcfg.vocab_size)
    close(tlogits, np.asarray(jlogits), 1e-4)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), rtol=0, atol=1e-5)
    changed = (tcache.numpy() != cache).any(axis=(0, 1, 3, 5))       # [B, T]
    want = np.zeros((b, T), bool)
    want[np.arange(b), LENGTHS] = True
    np.testing.assert_array_equal(changed, want)


def test_per_row_step_takes_k2_and_single_position_keeps_k14(monkeypatch):
    """Falcon's per-row step attends through K2 (its wrapper, the plain
    version on the CPU) with the current token as an operand; its single-
    position step at one shared position (``forward`` at S = 1,
    ``decode_step``) keeps K14, as before K2 took head_dim 64."""
    _, _, tcfg, tparams = family_model("falcon7b")
    calls = []
    for name in ("flash_decode", "flash_decode_layer"):
        real = getattr(tllama, name)
        monkeypatch.setattr(tllama, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    real_attn = tlayers.attention
    monkeypatch.setattr(tllama, "attention", lambda *a, **k: calls.append("attention")
                        or real_attn(*a, **k))
    cache = tllama.init_kv_cache(tcfg, 3, 64, torch.float32, device="cpu")
    tllama.decode_step_batched(tparams, tcfg, torch.tensor([1, 2, 3]), cache,
                               torch.tensor([4, 0, 9], dtype=torch.int32))
    assert calls == ["flash_decode"] * tcfg.num_layers
    calls.clear()
    one = tllama.init_kv_cache(tcfg, 1, 64, torch.float32, device="cpu")
    tllama.forward(tparams, tcfg, torch.tensor([[5]]), one, 3)
    assert calls == ["attention"] * tcfg.num_layers
    calls.clear()
    tllama.decode_step(tparams, tcfg, torch.tensor([5]), one,
                       torch.tensor([4], dtype=torch.int32), 63)
    assert calls == ["flash_decode_layer"] * tcfg.num_layers


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


@pytest.mark.parametrize("family", list(FAMILIES))
def test_batch_engine_greedy_ids_match_jax(family, monkeypatch):
    """Greedy ids of the port's ``BatchEngine`` equal the JAX engine's bit
    for bit over 16-18 new tokens a request (both f32 on the CPU: JAX's XLA
    step, the port's K2 plain version)."""
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen
    from awq_tpu.runtime.batch_engine import BatchEngine as JBatchEngine
    from awq_tpu_torch.runtime.batch_engine import BatchEngine as TBatchEngine

    jcfg, jparams, tcfg, tparams = family_model(family)
    set_flash(monkeypatch, False)
    reqs = engine_requests(tcfg.vocab_size)
    ref = run_engine(JBatchEngine(jcfg, jparams, n_slots=3, max_seq_len=T,
                                  cache_dtype=jnp.float32), JGen, reqs)
    got = run_engine(TBatchEngine(tcfg, tparams, n_slots=3, max_seq_len=T,
                                  cache_dtype=torch.float32, device="cpu"), TGen, reqs)
    assert [len(r) for r in ref] == [m for _, m in reqs]
    assert got == ref


# ---- on the card ------------------------------------------------------------

CARD_TOL = 2.0 ** -6     # the split decode's bound (tests/test_torch_decode_attn.py)

# (b, nq, nkv, hd): Falcon-7B's MQA group at head_dim 64, a GQA group at 64,
# BLOOM-560m's MHA at 64, and wide groups at 128 (64 and 128 q heads a kv head)
WIDE_SHAPES = [(8, 71, 1, 64), (3, 16, 2, 64), (4, 16, 16, 64), (2, 64, 1, 128),
               (2, 128, 1, 128)]
CARD_LENGTHS = {8: [1000, 0, 930, 1100, 1015, 850, 1200, 977], 4: [0, 1, 300, 1023],
                3: [1, 255, 700], 2: [2047, 64]}


def card_inputs(dev, b, nq, nkv, hd, dtype, t=2048, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + nq + hd + b)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    lens = torch.tensor(CARD_LENGTHS[b], dtype=torch.int32, device=dev)
    return rnd(b, nq, hd), rnd(b, nkv, hd), rnd(b, nkv, hd), rnd(2, b, nkv, t, hd), lens


def within(got, ref, tol=CARD_TOL):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b,nq,nkv,hd", WIDE_SHAPES)
def test_k2_wide_modes_match_plain_on_card(cuda, b, nq, nkv, hd, dtype):
    q, kn, vn, cache, lens = card_inputs(cuda, b, nq, nkv, hd, dtype)
    mx = int(lens.max())
    n0 = tda.LAUNCHES["flash_decode_wide"]
    got = tda.flash_decode(q, kn, vn, cache, lens, max_length=mx)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_wide"] == n0 + 1
    within(got, tda.flash_decode_plain(q, kn, vn, cache, lens, max_length=mx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nkv,hd", [(4, 16, 16, 64), (8, 32, 32, 128), (3, 16, 2, 64)])
def test_k2_alibi_modes_match_plain_on_card(cuda, b, nq, nkv, hd, dtype):
    q, kn, vn, cache, lens = card_inputs(cuda, b, nq, nkv, hd, dtype, seed=1)
    sl = tlayers.alibi_slopes(nq, device=cuda)
    mx = int(lens.max())
    n0 = tda.LAUNCHES["flash_decode_alibi"]
    got = tda.flash_decode(q, kn, vn, cache, lens, max_length=mx, slopes=sl)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_alibi"] == n0 + 1
    within(got, tda.flash_decode_plain(q, kn, vn, cache, lens, max_length=mx, slopes=sl))


@pytest.mark.cuda
def test_k2_refuses_what_no_unit_holds_on_card(cuda):
    """A head_dim of 96, a group of 129, or ALiBi slopes over a group of 64
    raise naming ROADMAP A12; nothing launches."""
    before = dict(tda.LAUNCHES)
    for b, nq, nkv, hd, sl in ((1, 8, 1, 96, None), (1, 129, 1, 64, None),
                               (1, 64, 1, 128, tlayers.alibi_slopes(64, device=cuda))):
        q, kn, vn, cache, _ = card_inputs(cuda, 2, nq, nkv, hd, torch.bfloat16, t=256)
        with pytest.raises(NotImplementedError, match="item 12"):
            tda.flash_decode(q, kn, vn, cache, torch.tensor([3, 9], dtype=torch.int32,
                                                            device=cuda), slopes=sl)
    assert tda.LAUNCHES == before


def card_family(family, dev, layers=2, seed=5):
    """A bf16 model of the family on the card: ``init_qparams`` (zero-mean
    codes for MPT, as the smoke's), norms jittered."""
    from awq_tpu_torch.config import QuantConfig as TQuant

    cfg = TConfig(**{**FAMILIES[family], "num_layers": layers, "dtype": "bfloat16"})
    g = torch.Generator(device=dev).manual_seed(seed)
    params = tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=64 if cfg.head_dim == 64
                                             else 128), g, scale=0.05, device=dev)
    params = tllama.fuse_linears(params, cfg)
    la = params["layers"]
    for name in ("ln1", "ln2"):             # falcon-7b's single_ln has no ln2
        if name in la:
            la[name] = (torch.rand(la[name].shape, generator=g, device=dev) * 0.4 + 0.8).to(
                torch.bfloat16)
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_batched_step_matches_plain_on_card(cuda, family):
    """The families' batched step on the card (K1, K2 in its new modes, K7)
    within 5e-2 of the largest logit of the plain path and the written
    cache within 5e-2 of its own largest (phase 4's bounds: a later layer's
    k/v carry the earlier layers' bf16 rounding, which falcon's block
    amplifies), and no K14 or K6 launch."""
    from awq_tpu_torch.ops import megakernel_batched as tmb

    cfg, params = card_family(family, cuda)
    lens = torch.tensor([0, 37, 300, 511], dtype=torch.int32, device=cuda)
    toks = torch.tensor([5, 9, 2, 7], device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    cache = (torch.randn((2, 2, 4, cfg.num_kv_heads, 512, cfg.head_dim), generator=g,
                         device=cuda) * 0.5).to(torch.bfloat16)
    c1, c2 = cache.clone(), cache.clone()
    k14, k6 = tda.LAUNCHES["flash_decode_layer"], dict(tmb.LAUNCHES)
    got, _ = tllama.decode_step_batched(params, cfg, toks, c1, lens, max_length=511)
    ref, _ = tllama.decode_step_batched(params, cfg, toks, c2, lens, impl="plain",
                                        max_length=511)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_layer"] == k14 and tmb.LAUNCHES == k6
    within(got, ref, 5e-2)
    within(c1, c2, 5e-2)
