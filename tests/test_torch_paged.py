"""Port parity of the paged KV path (``runtime/paged.py``,
``decode_step_paged``, K8 ``flash_decode_paged``, K6's and K7's paged
modes) against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both sides. The engine tests use the
tiny f32 model of the JAX package's own paged tests (2 layers, hidden 128,
head_dim 32, W4-g64); the step and kernel tests use head_dim 128, the
kernels' width. The JAX side is imported inside the CPU tests: the tests
marked ``cuda`` run on a card without JAX and hold the CUDA kernels to
their plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import (GenConfig as TGen, ModelConfig as TConfig,
                                  RuntimeConfig as TRuntime)
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import cache_append as tca
from awq_tpu_torch.ops import decode_attn as tda
from awq_tpu_torch.ops import megakernel_batched as tmb
from awq_tpu_torch.runtime.batch_engine import BatchEngine as TBatchEngine
from awq_tpu_torch.runtime.paged import PageAllocator, PagedBatchEngine

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _scatter(cache, mp, page, seed, free_pages=0):
    """A contiguous ``[L, 2, B, nkv, mp*page, hd]`` cache scattered into a
    pool of permuted pages (page 0, the trash page, and ``free_pages``
    spare pages left unused): ``(pool, tables [B, mp] int32)``."""
    L, _, b, nkv, _, hd = cache.shape
    n_pages = 1 + b * mp + free_pages
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))[:b * mp]
    tables = perm.reshape(b, mp).astype(np.int32)
    pool = np.zeros((L, 2, n_pages, nkv, page, hd), cache.dtype)
    for i in range(b):
        for j in range(mp):
            pool[:, :, tables[i, j]] = cache[:, :, i, :, j * page:(j + 1) * page]
    return pool, tables


# ---- the allocator -------------------------------------------------------------

def test_page_allocator_matches_jax():
    """The same calls give the same pages on both sides; page 0 is never
    handed out and freeing it (or a free page) trips the assert."""
    from awq_tpu.runtime.paged import PageAllocator as JAlloc

    ours, ref = PageAllocator(8), JAlloc(8)
    assert ours.n_free == ref.n_free == 7
    for call, arg in (("alloc", 3), ("alloc", 5), ("alloc", 2), ("free", None),
                      ("alloc", 4), ("alloc", 2)):
        if call == "alloc":
            got, want = ours.alloc(arg), ref.alloc(arg)
            assert got == want and (got is None or 0 not in got)
            last = got if got is not None else last
        else:
            ours.free(last)
            ref.free(last)
        assert ours.n_free == ref.n_free
    for a in (ours, ref):
        a.free(last)
        with pytest.raises(AssertionError):
            a.free([0])                 # the trash page is never freeable
        with pytest.raises(AssertionError):
            a.free([a._free[0]])        # nor a page that is free already


# ---- K8: paged flash decode --------------------------------------------------------

def test_flash_decode_paged_plain_matches_jax():
    """The plain K8 against JAX ``flash_decode_paged(interpret=True)`` over a
    permuted pool (the setup of the JAX package's own test, one row more,
    of length 0). Both run in f32 and differ in summation order only:
    2e-5, the JAX test's tolerance. Over the same data laid out
    contiguously the plain K2 gives the same values bit for bit."""
    import jax.numpy as jnp
    from awq_tpu.ops.decode_attn import flash_decode_paged

    L, nkv, nq, hd, page, mp = 2, 2, 4, 128, 256, 3
    lengths = np.array([0, 5, page + 7, mp * page - 1], np.int32)
    b = len(lengths)
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((L, 2, b, nkv, mp * page, hd)).astype(np.float32)
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((b, nq, hd), (b, nkv, hd), (b, nkv, hd)))
    pool, tables = _scatter(cache, mp, page, 1)
    ref = np.asarray(flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pool),
        jnp.asarray(tables), jnp.int32(1), jnp.asarray(lengths), interpret=True))
    t = lambda a: torch.from_numpy(a)
    before = dict(tda.LAUNCHES)
    got = tda.flash_decode_paged(t(q), t(kn), t(vn), t(pool), t(tables), 1, t(lengths))
    assert tda.LAUNCHES == before           # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    flat = tda.flash_decode_plain(t(q), t(kn), t(vn), t(cache[1]), t(lengths),
                                  max_length=int(lengths.max()))
    assert torch.equal(got, flat)


# ---- K6: the batched megakernel in paged mode ------------------------------------

def test_paged_megakernel_plain_matches_jax():
    """The plain K6 with ``tables`` against the JAX kernel's paged mode in
    interpret mode, on the setup of the JAX package's test of it (8 rows,
    2 layers, hidden 256, bf16, pages of 256) with two pages per row and
    ragged lengths 0..511. Tolerance 2^-6 of each output's largest
    magnitude, as for the contiguous kernel (bf16 rounding edges). The pool
    equals the JAX-appended pool within it, and the port's paged step
    equals its contiguous step on the same data bit for bit."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel_batched import w4a16_llama_token_step_batched
    from test_torch_megakernel_batched import HD, TOL, _bf16_t, _close, _jax_lins

    nq, nkv, H, I, L, page, mp = 2, 2, 256, 256, 2, 256, 2
    lens = np.array([37, 0, 300, 200, 5, 511, 256, 17], np.int32)
    b = len(lens)
    jl = _jax_lins(7, H, I, nq, nkv, L)
    t = params_from_jax(jax.device_get(jl), device="cpu")
    rng = np.random.default_rng(8)
    h = rng.standard_normal((b, H)).astype(np.float32) * 0.3
    ln1, ln2 = (rng.uniform(0.8, 1.2, (L, H)).astype(np.float32) for _ in range(2))
    ang = rng.uniform(0, 6.28, (b, HD)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    cache = (rng.standard_normal((L, 2, b, nkv, mp * page, HD)) * 0.2).astype(np.float32)
    cache = np.asarray(jnp.asarray(cache).astype(jnp.bfloat16).astype(jnp.float32))
    pool, tables = _scatter(cache, mp, page, 2)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    res = w4a16_llama_token_step_batched(
        jb(h), jl["wqkv"], jl["wo"], jl["wgateup"], jl["down"], jnp.asarray(ln1),
        jnp.asarray(ln2), jnp.asarray(cos), jnp.asarray(sin), jb(pool),
        jnp.asarray(lens), nq=nq, nkv=nkv, eps=1e-5, interpret=True,
        tables=jnp.asarray(tables))
    args = (_bf16_t(h), t["wqkv"], t["wo"], t["wgateup"], t["down"],
            torch.from_numpy(ln1), torch.from_numpy(ln2), torch.from_numpy(cos),
            torch.from_numpy(sin))
    tpool = _bf16_t(pool)
    got = tmb.w4a16_llama_token_step_batched(
        *args, tpool, torch.from_numpy(lens), nq, nkv, 1e-5,
        tables=torch.from_numpy(tables))
    for g, r in zip(got, res):
        _close(g, r, TOL)
    # JAX's caller appends into the pages; the port wrote them in place
    rows = np.arange(b)
    jpool = jb(pool).at[:, :, tables[rows, lens // page], :, lens % page].set(
        jnp.stack([res[1], res[2]], axis=1).transpose(2, 0, 1, 3, 4))
    _close(tpool, jpool.astype(jnp.float32), TOL)
    # the contiguous step on the same data: equal bit for bit
    tcache = _bf16_t(cache)
    flat = tmb.w4a16_llama_token_step_batched(*args, tcache, torch.from_numpy(lens),
                                              nq, nkv, 1e-5)
    for g, f in zip(got, flat):
        assert torch.equal(g, f)
    for i in range(b):
        for j in range(mp):
            assert torch.equal(tpool[:, :, int(tables[i, j])],
                               tcache[:, :, i, :, j * page:(j + 1) * page])


# ---- K7: the paged append ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_append_plain_matches_jax_loop(dtype):
    """The plain paged K7 against JAX's per-row ``dynamic_update_slice``
    loop (``decode_step_paged``'s append, ``awq_tpu/models/llama.py:1729-
    1736``), bit for bit: a scatter has no arithmetic. Lengths include 0,
    a page's last position and the pool's last position."""
    import jax
    import jax.numpy as jnp

    L, nkv, hd, page, mp = 2, 2, 16, 8, 3
    lens = np.array([0, 7, 8, mp * page - 1], np.int32)
    b = len(lens)
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((L, 2, 1 + b * mp, nkv, page, hd)).astype(np.float32)
    tables = (rng.permutation(b * mp) + 1).reshape(b, mp).astype(np.int32)
    kv = rng.standard_normal((L, 2, b, nkv, hd)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jpool, jkv = jnp.asarray(pool).astype(jdt), jnp.asarray(kv).astype(jdt)
    w_pages = jnp.asarray(tables)[jnp.arange(b), jnp.asarray(lens) // page]
    w_offs = jnp.asarray(lens) % page
    for i in range(b):
        row = jkv[:, :, i][:, :, None, :, None, :]
        jpool = jax.lax.dynamic_update_slice(jpool, row, (0, 0, w_pages[i], 0, w_offs[i], 0))
    tdt = getattr(torch, dtype)
    tpool = torch.from_numpy(pool).to(tdt)
    out = tca.batched_cache_append(tpool, torch.from_numpy(kv).to(tdt),
                                   torch.from_numpy(lens), torch.from_numpy(tables))
    assert out is tpool
    np.testing.assert_array_equal(tpool.float().numpy(),
                                  np.asarray(jpool.astype(jnp.float32)))


# ---- decode_step_paged ------------------------------------------------------------------

GEOM = dict(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=1024,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
            max_position_embeddings=512, dtype="float32")


@pytest.fixture(scope="module")
def model():
    import jax
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    jcfg, tcfg = JConfig(**GEOM), TConfig(**GEOM)
    jparams = jllama.quantize_params(jllama.init_params(jcfg, jax.random.PRNGKey(2)),
                                     JQuant(w_bit=4, group_size=128))
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


# The plain K6 rounds every matmul input and the QKV, gate/up and SiLU·mul
# rows to bf16 where JAX's paged step (its XLA path on the CPU; JAX has no
# CPU mode of its paged megakernel) computes in f32: 2^-6 of the largest
# logit bounds that over two layers.
@pytest.mark.parametrize("mega,tol", [(False, 1e-4), (True, 2.0 ** -6)])
def test_decode_step_paged_matches_jax(model, mega, tol, monkeypatch):
    """Logits and the pool after one step against JAX ``decode_step_paged``,
    4 rows over a permuted pool with pages of 64, lengths 0..255 (row 3 on
    its table's last position). The stacked path (K8, paged K7 plain)
    computes in f32: 1e-4 of the largest logit, as the slot step's test.
    With ``AWQ_TPU_FORCE_MEGAKERNEL=1`` the plain K6 in paged mode runs;
    it must equal the port's contiguous step bit for bit. Pool rows written:
    1e-5 absolute (values of size ~1)."""
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = model
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    if mega:
        monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    else:
        monkeypatch.delenv("AWQ_TPU_FORCE_MEGAKERNEL", raising=False)
    L, nkv, hd, page, mp = 2, 2, 128, 64, 4
    lens = np.array([5, 0, 130, mp * page - 1], np.int32)
    b = len(lens)
    rng = np.random.default_rng(11)
    cache = (rng.standard_normal((L, 2, b, nkv, mp * page, hd)) * 0.3).astype(np.float32)
    tokens = rng.integers(0, GEOM["vocab_size"], b)
    pool, tables = _scatter(cache, mp, page, 4, free_pages=2)
    jlogits, jpool = jllama.decode_step_paged(
        jparams, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(pool),
        jnp.asarray(tables), jnp.asarray(lens))
    tpool = torch.from_numpy(pool.copy())
    tparams = tllama.fuse_linears(tparams, tcfg)    # as the engines hold them
    assert tmb.megakernel_paged_supported(tcfg, tparams["layers"], tpool, b) == mega
    tlogits, out = tllama.decode_step_paged(
        tparams, tcfg, torch.from_numpy(tokens), tpool, torch.from_numpy(tables),
        torch.from_numpy(lens), max_length=int(lens.max()))
    assert out is tpool
    jlogits = np.asarray(jlogits)
    assert tlogits.shape == jlogits.shape == (b, GEOM["vocab_size"])
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=0,
                               atol=tol * np.abs(jlogits).max())
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), rtol=0,
                               atol=1e-5 if not mega else tol)
    # only each row's write position changed, in its own page
    changed = (tpool.numpy() != pool).any(axis=(0, 1, 3, 5))        # [NP, page]
    want = np.zeros(changed.shape, bool)
    want[tables[np.arange(b), lens // page], lens % page] = True
    np.testing.assert_array_equal(changed, want)
    if mega:
        tcache = torch.from_numpy(cache.copy())
        flat, _ = tllama.decode_step_batched(tparams, tcfg, torch.from_numpy(tokens),
                                             tcache, torch.from_numpy(lens),
                                             max_length=int(lens.max()))
        assert torch.equal(tlogits, flat)


def test_decode_step_paged_unported_branches_raise(model):
    _, _, tcfg, tparams = model
    pool = torch.zeros((2, 2, 4, 2, 8, 128))
    toks, lens = torch.tensor([1, 2]), torch.tensor([0, 3], dtype=torch.int32)
    tables = torch.tensor([[1], [2]], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 17"):
        tllama.decode_step_paged(tparams, tcfg, toks, pool, tables, lens, tp_axis="tp")
    with pytest.raises(NotImplementedError, match="item 10"):
        tllama.decode_step_paged(tparams, tcfg, toks, pool.to(torch.int8), tables, lens)
    for change in (dict(pos_embed="alibi"), dict(pos_embed="learned"),
                   dict(parallel_block=True)):
        with pytest.raises(NotImplementedError, match="item 12"):
            tllama.decode_step_paged(tparams, dataclasses.replace(tcfg, **change),
                                     toks, pool, tables, lens)


@pytest.mark.parametrize("case", ["b8", "b2", "b64", "f32_forced", "b1", "b72",
                                  "int8", "disabled", "unforced", "hd64", "page24"])
def test_paged_gate(case, monkeypatch):
    """K6's paged mode takes 2..64 rows over a float pool whose page size is
    a power of two (here 16, not 24) under K4's gate; the JAX gate's
    ``page == 256`` and ``B % 8`` are its tiles'. On the card the paged
    kernel is built for bf16 and its wrapper refuses another pool dtype."""
    from test_torch_megakernel_batched import _gate_model

    monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    cfg, layers = _gate_model()
    batch = {"b2": 2, "b64": 64, "b1": 1, "b72": 72}.get(case, 8)
    pool = torch.zeros((2, 2, 5, 2, 16, 128), dtype=torch.bfloat16)
    if case == "f32_forced":
        pool = pool.float()
    elif case == "int8":
        pool = pool.to(torch.int8)
    elif case == "disabled":
        monkeypatch.setenv("AWQ_TPU_DISABLE_MEGAKERNEL", "1")
    elif case == "unforced":
        monkeypatch.delenv("AWQ_TPU_FORCE_MEGAKERNEL")      # a CPU pool
    elif case == "hd64":
        cfg = dataclasses.replace(cfg, head_dim=64)
    elif case == "page24":
        pool = torch.zeros((2, 2, 5, 2, 24, 128), dtype=torch.bfloat16)
    ok = tmb.megakernel_paged_supported(cfg, layers, pool, batch)
    assert ok == (case in ("b8", "b2", "b64", "f32_forced"))


# ---- the engine ------------------------------------------------------------------------

def _tiny_cfg():
    """The JAX package's paged-test model: ``tests/test_paged.py::_cfg``."""
    return dict(arch="llama", vocab_size=512, hidden_size=128, intermediate_size=256,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                max_position_embeddings=512, dtype="float32")


@pytest.fixture(scope="module")
def tiny():
    import jax
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models.llama import init_params, quantize_params

    jcfg = JConfig(**_tiny_cfg())
    jparams = quantize_params(init_params(jcfg, jax.random.PRNGKey(0)),
                              JQuant(w_bit=4, group_size=64))
    return (jcfg, jparams, TConfig(**_tiny_cfg()),
            params_from_jax(jax.device_get(jparams), device="cpu"))


def _run(engine, gen_cls, prompts, max_new):
    gen = gen_cls(greedy=True, max_new_tokens=max_new)
    rids = [engine.submit(p, gen) for p in prompts]
    done = engine.run()
    return [done[r].out_ids for r in rids]


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [[int(x) for x in rng.randint(0, 512, n)] for n in sizes]


def test_paged_engine_greedy_ids_match_jax(tiny):
    """Six requests through three slots with pages of 64 (the setup of the
    JAX package's ``test_paged_engine_matches_slot_engine``): the port's
    ``PagedBatchEngine`` gives the JAX ``PagedBatchEngine``'s greedy ids bit
    for bit, and so does the port's slot engine."""
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen
    from awq_tpu.runtime.paged import PagedBatchEngine as JPaged

    jcfg, jparams, tcfg, tparams = tiny
    prompts = _prompts(0, (5, 37, 12, 20, 9, 31))
    ref = _run(JPaged(jcfg, jparams, n_slots=3, max_seq_len=256,
                      cache_dtype=jnp.float32, page_size=64), JGen, prompts, 6)
    eng = PagedBatchEngine(tcfg, tparams, n_slots=3, max_seq_len=256,
                           cache_dtype=torch.float32, page_size=64, device="cpu")
    assert eng.n_pages == 6 and tuple(eng.cache.shape) == (2, 2, 6, 2, 64, 32)
    assert _run(eng, TGen, prompts, 6) == ref
    assert eng.n_preempted == 0 and eng.alloc.n_free == 5 and not eng.tables.any()
    slot = TBatchEngine(tcfg, tparams, n_slots=3, max_seq_len=256,
                        cache_dtype=torch.float32, device="cpu")
    assert _run(slot, TGen, prompts, 6) == ref


@pytest.fixture(scope="module")
def slot_ref(tiny):
    """The JAX slot engine's ids on the preemption test's requests."""
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen
    from awq_tpu.runtime.batch_engine import BatchEngine as JBatchEngine

    jcfg, jparams, _, _ = tiny
    prompts = _prompts(1, (60, 50, 55))
    return prompts, _run(JBatchEngine(jcfg, jparams, n_slots=3, max_seq_len=256,
                                      cache_dtype=jnp.float32), JGen, prompts, 12)


@pytest.mark.parametrize("n_pages", [5, 4])
def test_paged_engine_preemption(tiny, slot_ref, n_pages):
    """A pool too small for three requests (prompts 60, 50, 55, 12 new
    tokens, pages of 64; 4 or 3 usable pages) forces preemption with
    recompute: the port preempts, completes every request, and its greedy
    ids equal the JAX slot engine's. (The JAX paged engine raises on this
    input: its ``step`` reads the slot that preemption freed.)"""
    _, _, tcfg, tparams = tiny
    prompts, ref = slot_ref
    eng = PagedBatchEngine(tcfg, tparams, n_slots=3, max_seq_len=256,
                           cache_dtype=torch.float32, page_size=64, n_pages=n_pages,
                           device="cpu")
    got = _run(eng, TGen, prompts, 12)
    assert eng.n_preempted >= 1
    assert [len(g) for g in got] == [12, 12, 12]
    assert got == ref
    assert eng.alloc.n_free == n_pages - 1 and not eng.tables.any()


def test_preempted_request_near_max_seq_is_not_dropped(tiny):
    """A request preempted near the cache length comes back with its
    generated ids in its prompt; admission counts only the ids it still has
    to generate. Here 100 + 28 fits a 128-position cache, the request is
    preempted after 5 ids (105 + 28 > 128, but 105 + 23 fits) and must
    finish with all 28, equal to the slot engine's ids."""
    _, _, tcfg, tparams = tiny
    prompts = _prompts(2, (60, 100))
    budgets = (60, 28)

    def run(eng):
        rids = [eng.submit(p, TGen(greedy=True, max_new_tokens=m))
                for p, m in zip(prompts, budgets)]
        done = eng.run()
        return [done[r].out_ids for r in rids]

    ref = run(TBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=128,
                           cache_dtype=torch.float32, device="cpu"))
    eng = PagedBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=128,
                           cache_dtype=torch.float32, page_size=64, n_pages=4,
                           device="cpu")
    got = run(eng)
    assert eng.n_preempted == 1
    assert [len(g) for g in got] == list(budgets)
    assert got == ref


def test_paged_engine_memory_footprint(tiny):
    """The point of paging (the JAX package's ``test_paged_engine_memory_
    footprint``): the default pool holds at most half the slot cache."""
    _, _, tcfg, tparams = tiny
    slot = TBatchEngine(tcfg, tparams, n_slots=8, max_seq_len=256,
                        cache_dtype=torch.float32, device="cpu")
    paged = PagedBatchEngine(tcfg, tparams, n_slots=8, max_seq_len=256,
                             cache_dtype=torch.float32, page_size=64, device="cpu")
    nbytes = lambda t: t.numel() * t.element_size()
    assert nbytes(paged.cache) <= nbytes(slot.cache) // 2 + 1


@pytest.mark.parametrize("what,kw", [
    ("item 10", dict(cache_dtype="int8")),
    ("item 17", dict(runtime=TRuntime(mesh=object()))),
])
def test_paged_engine_unported_options_raise(tiny, what, kw):
    _, _, tcfg, tparams = tiny
    with pytest.raises(NotImplementedError, match=what):
        PagedBatchEngine(tcfg, tparams, n_slots=2, max_seq_len=128, page_size=64,
                         device="cpu", **kw)


# ---- on the card: K8, K6 and K7 paged against their plain versions ---------------

def _card_pool(dev, L, b, nkv, page, mp, seed):
    """A random bf16 pool of 1 + b*mp + 3 pages and a permuted table."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + b * mp + 3
    pool = (torch.randn((L, 2, n_pages, nkv, page, 128), generator=g, device=dev)
            * 0.5).to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    tables = perm[:b * mp].reshape(b, mp).to(torch.int32).to(dev)
    return pool, tables, g


@pytest.mark.cuda
@pytest.mark.parametrize("page", [256, 64, 16])
def test_flash_decode_paged_kernel_matches_plain_on_card(cuda, page):
    """K8 against its plain version, 6 rows of ragged lengths (0 and the
    table's last position among them), GQA 4:1; bf16 output, f32 sums in
    other orders: 2^-6 of the largest value. A page of 16 is smaller than
    the kernel's 32-position tile."""
    b, nq, nkv, mp = 6, 16, 4, 1024 // page
    pool, tables, g = _card_pool(cuda, 2, b, nkv, page, mp, page)
    q = torch.randn((b, nq, 128), generator=g, device=cuda).to(torch.bfloat16)
    kn, vn = (torch.randn((b, nkv, 128), generator=g, device=cuda).to(torch.bfloat16)
              for _ in range(2))
    lens = torch.tensor([0, 1, 300, 1023, 512, 77], dtype=torch.int32, device=cuda)
    n0 = tda.LAUNCHES["flash_decode_paged"]
    got = tda.flash_decode_paged(q, kn, vn, pool, tables, 1, lens, max_length=1023)
    ref = tda.flash_decode_paged_plain(q, kn, vn, pool, tables, 1, lens)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_paged"] == n0 + 1
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -6 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 3])
def test_paged_megakernel_matches_plain_on_card(cuda, b):
    """K6's paged mode against its plain version over a permuted pool: the
    outputs within K6's card tolerance (2^-5), each row's k/v at its page
    and offset as returned, and every other element of the pool untouched."""
    from test_torch_megakernel_batched import CARD_TOL, _card_model, _close

    nq, nkv, H, I, L, page, mp = 4, 2, 512, 1024, 3, 64, 4
    ws, (ln1, ln2), _, cos, sin, head, g = _card_model(cuda, nq, nkv, H, I, L, b, True, b)
    pool, tables, _ = _card_pool(cuda, L, b, nkv, page, mp, b + 1)
    h = (torch.randn((b, H), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    lens = torch.randint(0, mp * page, (b,), generator=g, device=cuda).to(torch.int32)
    lens[0], lens[-1] = 0, mp * page - 1
    p1, p2 = pool.clone(), pool.clone()
    n0 = tmb.LAUNCHES["megakernel_batched_paged"]
    got = tmb.w4a16_llama_token_step_batched(h, *ws, ln1, ln2, cos, sin, p1, lens, nq,
                                             nkv, tables=tables, **head)
    ref = tmb.w4a16_llama_token_step_batched_plain(h, *ws, ln1, ln2, cos, sin, p2, lens,
                                                   nq, nkv, tables=tables, **head)
    torch.cuda.synchronize()
    assert tmb.LAUNCHES["megakernel_batched_paged"] == n0 + 1
    for a, r in zip(got, ref):
        _close(a.cpu(), r.cpu(), CARD_TOL)
    rows, ll = torch.arange(b, device=cuda), lens.long()
    where, off = tables.long()[rows, ll // page], ll % page
    assert torch.equal(p1[:, 0, where, :, off].transpose(0, 1), got[1])
    assert torch.equal(p1[:, 1, where, :, off].transpose(0, 1), got[2])
    p1[:, :, where, :, off] = pool[:, :, where, :, off]
    assert torch.equal(p1, pool)


@pytest.mark.cuda
def test_paged_append_kernel_matches_plain_on_card(cuda):
    """K7's paged mode against its plain version, bit for bit; a length past
    the table's end is clamped to its last position by both."""
    L, b, nkv, page, mp = 4, 5, 8, 32, 3
    pool, tables, g = _card_pool(cuda, L, b, nkv, page, mp, 7)
    kv = torch.randn((L, 2, b, nkv, 128), generator=g, device=cuda).to(torch.bfloat16)
    lens = torch.tensor([0, 31, 32, mp * page - 1, mp * page + 5], dtype=torch.int32,
                        device=cuda)
    p1, p2 = pool.clone(), pool.clone()
    n0 = tca.LAUNCHES["cache_append_paged"]
    tca.batched_cache_append(p1, kv, lens, tables)
    tca.batched_cache_append_plain(p2, kv, lens, tables)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["cache_append_paged"] == n0 + 1
    assert torch.equal(p1, p2) and not torch.equal(p1, pool)
