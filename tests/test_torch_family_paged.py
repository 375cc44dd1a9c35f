"""Port parity of the paged step for falcon, MPT and BLOOM:
``decode_step_paged`` and ``PagedBatchEngine`` against the JAX package's on
the CPU, and K8's head_dim-64, wide-group and ALiBi modes on the card.

The four tiny f32 models of ``tests/test_torch_family_batched.py``. JAX's
``decode_step_paged`` gathers each row's pages for its XLA attention (its
flash kernel takes head_dim 128 without ALiBi only; under
``AWQ_TPU_FORCE_FLASH=1`` the 40b-style falcon at head_dim 64 stays on XLA
too); the port runs K8's plain version. The tests marked ``cuda`` hold K8's
new modes to its plain version (and, over pages dividing 256, to K2's
output bit for bit) on a card and skip here.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import GenConfig as TGen
from awq_tpu_torch.models import layers as tlayers
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import decode_attn as tda
from test_torch_family_batched import (FAMILIES, T, WIDE_SHAPES, card_family,
                                       card_inputs, close, cuda,  # noqa: F401
                                       engine_requests, family_model, run_engine,
                                       set_flash, step_inputs, within)

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


def scatter(cache: np.ndarray, page: int, seed: int, free_pages: int = 2):
    """A slot cache ``[L, 2, B, nkv, T, hd]`` scattered into a pool of
    permuted pages (page 0 the trash page, ``free_pages`` spare):
    ``(pool, tables [B, T / page] int32)``."""
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


# f32 on both sides: JAX's gathered XLA attention against K8's plain version
# (K2's over the gathered pages), other summation orders: 1e-4 of the
# largest logit, 1e-5 absolute on the pool (values ~1).
@pytest.mark.parametrize("flash", [False, True], ids=["xla", "flash"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_step_paged_matches_jax(family, flash, monkeypatch):
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = family_model(family)
    lengths = np.array([5, 0, 130, T - 1], np.int32)
    cache, tokens = step_inputs(family, 11, len(lengths))
    pool, tables = scatter(cache, 64, 4)
    set_flash(monkeypatch, flash)
    jlogits, jpool = jllama.decode_step_paged(
        jparams, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(pool),
        jnp.asarray(tables), jnp.asarray(lengths))
    tpool = torch.from_numpy(pool.copy())
    tlogits, out = tllama.decode_step_paged(
        tparams, tcfg, torch.from_numpy(tokens), tpool, torch.from_numpy(tables),
        torch.from_numpy(lengths))
    assert out is tpool
    close(tlogits, np.asarray(jlogits), 1e-4)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_paged_step_equals_slot_step(family):
    """Over pages of 64 the paged step (K8's plain version) gives the slot
    step's logits and writes the same rows (a later layer's k/v through the
    earlier layers' attention), to f32 rounding of the two views' sums:
    1e-5 of the largest value."""
    _, _, tcfg, tparams = family_model(family)
    lengths = torch.tensor([17, 255, 0], dtype=torch.int32)
    cache, tokens = step_inputs(family, 2, 3)
    pool, tables = scatter(cache, 64, 9)
    tpool, tcache = torch.from_numpy(pool), torch.from_numpy(cache.copy())
    paged, _ = tllama.decode_step_paged(tparams, tcfg, torch.from_numpy(tokens), tpool,
                                        torch.from_numpy(tables), lengths)
    slot, _ = tllama.decode_step_batched(tparams, tcfg, torch.from_numpy(tokens), tcache,
                                         lengths)
    close(paged, slot, 1e-5)
    for i, n in enumerate(lengths.tolist()):
        page, off = tables[i, n // 64], n % 64
        close(tpool[:, :, page, :, off], tcache[:, :, i, :, n], 1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_paged_engine_greedy_ids_match_jax(family, monkeypatch):
    """Greedy ids of the port's ``PagedBatchEngine`` (pages of 64) equal the
    JAX paged engine's bit for bit over 16-18 new tokens a request, and the
    port's slot engine's."""
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen
    from awq_tpu.runtime.paged import PagedBatchEngine as JPaged
    from awq_tpu_torch.runtime.paged import PagedBatchEngine as TPaged

    jcfg, jparams, tcfg, tparams = family_model(family)
    set_flash(monkeypatch, False)
    reqs = engine_requests(tcfg.vocab_size, seed=6)
    ref = run_engine(JPaged(jcfg, jparams, n_slots=3, max_seq_len=T, cache_dtype=jnp.float32,
                            page_size=64), JGen, reqs)
    eng = TPaged(tcfg, tparams, n_slots=3, max_seq_len=T, cache_dtype=torch.float32,
                 page_size=64, device="cpu")
    got = run_engine(eng, TGen, reqs)
    assert [len(r) for r in ref] == [m for _, m in reqs]
    assert got == ref


# ---- on the card ------------------------------------------------------------

def card_pool(cache, page, seed):
    pool, tables = scatter(cache.float().cpu().numpy(), page, seed)
    return (torch.from_numpy(pool).to(cache.dtype).to(cache.device),
            torch.from_numpy(tables).to(cache.device))


@pytest.mark.cuda
@pytest.mark.parametrize("page", [256, 64, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nkv,hd", WIDE_SHAPES)
def test_k8_wide_modes_match_plain_on_card(cuda, b, nq, nkv, hd, dtype, page):
    """K8 at head_dim 64 and wide groups against its plain version (2^-6 of
    the largest value); over pages of 256 its output equals K2's on the same
    rows bit for bit (the same slices, the same sums)."""
    q, kn, vn, cache, lens = card_inputs(cuda, b, nq, nkv, hd, dtype)
    pool, tables = card_pool(cache[None], page, page + b)
    mx = int(lens.max())
    n0 = tda.LAUNCHES["flash_decode_paged_wide"]
    got = tda.flash_decode_paged(q, kn, vn, pool, tables, 0, lens, max_length=mx)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_paged_wide"] == n0 + 1
    within(got, tda.flash_decode_paged_plain(q, kn, vn, pool, tables, 0, lens, max_length=mx))
    if page == 256:
        assert torch.equal(got, tda.flash_decode(q, kn, vn, cache, lens, max_length=mx))


@pytest.mark.cuda
@pytest.mark.parametrize("page", [256, 16])
@pytest.mark.parametrize("b,nq,nkv,hd", [(4, 16, 16, 64), (8, 32, 32, 128)])
def test_k8_alibi_modes_match_plain_on_card(cuda, b, nq, nkv, hd, page):
    q, kn, vn, cache, lens = card_inputs(cuda, b, nq, nkv, hd, torch.bfloat16, seed=2)
    pool, tables = card_pool(cache[None], page, page + nq)
    sl = tlayers.alibi_slopes(nq, device=cuda)
    mx = int(lens.max())
    n0 = tda.LAUNCHES["flash_decode_paged_alibi"]
    got = tda.flash_decode_paged(q, kn, vn, pool, tables, 0, lens, max_length=mx, slopes=sl)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_paged_alibi"] == n0 + 1
    within(got, tda.flash_decode_paged_plain(q, kn, vn, pool, tables, 0, lens, max_length=mx,
                                       slopes=sl))
    if page == 256:
        assert torch.equal(got, tda.flash_decode(q, kn, vn, cache, lens, max_length=mx,
                                           slopes=sl))


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_paged_step_matches_plain_on_card(cuda, family):
    """The families' paged step on the card (K1, K8 in its new modes, the
    paged K7) within 5e-2 of the largest logit of the plain path and the
    pool within 5e-2 of its own largest (phase 4's bounds), and no K14 or
    K6 launch."""
    from awq_tpu_torch.ops import megakernel_batched as tmb

    cfg, params = card_family(family, cuda)
    lens = torch.tensor([0, 37, 300, 511], dtype=torch.int32, device=cuda)
    toks = torch.tensor([5, 9, 2, 7], device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    cache = (torch.randn((2, 2, 4, cfg.num_kv_heads, 512, cfg.head_dim), generator=g,
                         device=cuda) * 0.5).to(torch.bfloat16)
    pool, tables = card_pool(cache, 256, 5)
    p1, p2 = pool.clone(), pool.clone()
    k14, k6 = tda.LAUNCHES["flash_decode_layer"], dict(tmb.LAUNCHES)
    got, _ = tllama.decode_step_paged(params, cfg, toks, p1, tables, lens, max_length=511)
    ref, _ = tllama.decode_step_paged(params, cfg, toks, p2, tables, lens, impl="plain",
                                      max_length=511)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_layer"] == k14 and tmb.LAUNCHES == k6
    within(got, ref, 5e-2)
    within(p1, p2, 5e-2)
