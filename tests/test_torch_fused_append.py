"""The KV append fused into K2, K8 and K9 (``ops/decode_attn.py``).

Each wrapper attends, then writes the current token into the layer's
cache: row ``b``'s k/v at ``min(max(len_b, 0), T - 1)`` (K8: in the row's
pages, the position clamped to ``MP * page - 1``; K9: ``quantize_kv``'s codes
and scale of ``k_app``/``v_app``). On the CPU the wrappers run the plain
attention, then the plain append; here that is held to the JAX package: its
interpret-mode ``flash_decode_stacked``, ``flash_decode_paged`` and
``flash_decode_stacked8`` for the output, and for the cache its
``batched_cache_append`` (interpret mode; T % 8 == 0) or ``jax.jit(
quantize_kv)`` with one ``dynamic_update_slice`` a row, as its
``decode_step_batched`` and ``decode_step_paged`` write, bit for bit. JAX
attends over at most T positions (its kernels read no further), so it is
given each length clamped to T, as the port's kernels clamp it.

The tests marked ``cuda`` hold the fused append on a card to the standalone
K7 (``ops/cache_append.py``) and to the plain append, bit for bit, at the
edges (lengths 0, T - 1 and past T), in every mode and the device-length
(``by_length``) entries; and the output of a launch that appended into the
cache it read to one whose append went elsewhere (``append_to``), bit for
bit: the attention never sees its own write.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.models import layers as tlayers
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import cache_append as tca
from awq_tpu_torch.ops import decode_attn as tda

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

T = 256         # JAX's decode kernels take caches of a multiple of 256 positions


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _round24(slopes):
    """The slopes as JAX's decode kernel holds them: fixed point, x 2^24."""
    return (np.round(slopes.astype(np.float64) * 2 ** 24) / 2 ** 24).astype(np.float32)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _counts():
    return dict(tda.LAUNCHES), dict(tca.LAUNCHES)


# ---- the CPU path against JAX ------------------------------------------------------

# Outputs: f32 on both sides, the Pallas kernel's online softmax against the
# plain one-pass softmax (f32 rounding; 2e-5 of the largest output, the JAX
# package's own tolerance), in bf16 the Pallas kernel's bf16 P (2^-6); with
# slopes the port takes JAX's fixed-point slopes. The cache: bit for bit.
@pytest.mark.parametrize("hd,nq,nkv,alibi,dtype", [
    (128, 4, 2, False, "float32"), (64, 16, 1, False, "float32"),
    (128, 4, 4, True, "float32"), (64, 4, 4, True, "float32"),
    (128, 4, 2, False, "bfloat16")])
def test_k2_attends_then_appends_as_jax(hd, nq, nkv, alibi, dtype):
    import jax.numpy as jnp
    from awq_tpu.ops import decode_attn as jda
    from awq_tpu.ops.cache_append import batched_cache_append

    L, layer = 2, 1
    # a row of length 0, a ragged one, T - 1, and one at or past T (clamped);
    # ALiBi adds slope * len_b to the current token, read at the clamped length
    lengths = np.array([0, 37, T - 1, T if alibi else T + 5], np.int32)
    b = len(lengths)
    rng = np.random.default_rng(hd + nq + nkv + alibi)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cache = jnp.asarray(_normal(rng, L, 2, b, nkv, T, hd)).astype(jdt)
    q, kn, vn = (jnp.asarray(_normal(rng, *s)).astype(jdt)
                 for s in ((b, nq, hd), (b, nkv, hd), (b, nkv, hd)))
    slopes = np.asarray(tlayers.alibi_slopes(nq)) if alibi else None
    ref = jda.flash_decode_stacked(q, kn, vn, cache, jnp.int32(layer),
                                   jnp.asarray(np.minimum(lengths, T)), interpret=True,
                                   slopes=None if slopes is None else jnp.asarray(slopes))
    tt = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)  # noqa: E731
    tcache, before_cache = tt(cache), np.asarray(cache.astype(jnp.float32))
    kv = jnp.zeros((L, 2, b, nkv, hd), jdt).at[layer].set(jnp.stack([kn, vn]))
    # the JAX append donates its cache: it takes a copy
    jcache = np.asarray(batched_cache_append(jnp.array(cache, copy=True), kv,
                                             jnp.asarray(lengths)).astype(jnp.float32))
    before = _counts()
    got = tda.flash_decode(tt(q), tt(kn), tt(vn), tcache[layer], torch.from_numpy(lengths),
                           slopes=None if slopes is None else torch.from_numpy(_round24(slopes)))
    assert _counts() == before                      # the CPU launches nothing
    _close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
           2e-5 if dtype == "float32" else 2.0 ** -6)
    np.testing.assert_array_equal(tcache.float().numpy()[layer], jcache[layer])
    np.testing.assert_array_equal(tcache.float().numpy()[0], before_cache[0])


def _jax_row_writes(target, rows, starts):
    """JAX's per-row ``dynamic_update_slice`` loop (``decode_step_batched``'s
    int8 and ``decode_step_paged``'s append): ``rows[i]`` written at
    ``starts[i]``."""
    import jax

    for row, start in zip(rows, starts):
        target = jax.lax.dynamic_update_slice(target, row, start)
    return target


def test_k8_attends_then_appends_as_jax():
    """K8 over a permuted pool (page 0, the trash page, unused) against JAX's
    interpret-mode ``flash_decode_paged``, then JAX's per-row page write at
    ``tables[b, p // page]``, offset ``p % page``, with ``p`` clamped to the
    table's last position as the port's append clamps it (JAX's engine never
    writes past a row's pages)."""
    import jax.numpy as jnp
    from awq_tpu.ops.decode_attn import flash_decode_paged

    L, layer, nkv, nq, hd, page, mp = 2, 1, 2, 4, 128, 256, 3
    cap = mp * page
    lengths = np.array([0, 5, page + 7, cap - 1, cap + 3], np.int32)
    b = len(lengths)
    rng = np.random.default_rng(11)
    n_pages = 1 + b * mp
    tables = rng.permutation(np.arange(1, n_pages)).reshape(b, mp).astype(np.int32)
    pool = _normal(rng, L, 2, n_pages, nkv, page, hd)
    q, kn, vn = (_normal(rng, *s) for s in ((b, nq, hd), (b, nkv, hd), (b, nkv, hd)))
    clamped = np.minimum(lengths, cap)
    ref = np.asarray(flash_decode_paged(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pool),
        jnp.asarray(tables), jnp.int32(layer), jnp.asarray(clamped), interpret=True))
    p = np.minimum(lengths, cap - 1)
    kv = np.stack([kn, vn])                                   # [2, B, n_kv, hd]
    jpool = np.asarray(_jax_row_writes(
        jnp.asarray(pool), [jnp.asarray(kv[:, i][None, :, None, :, None, :]) for i in range(b)],
        [(layer, 0, int(tables[i, p[i] // page]), 0, int(p[i] % page), 0) for i in range(b)]))

    t = torch.from_numpy
    tpool = t(pool.copy())
    before = _counts()
    got = tda.flash_decode_paged(t(q), t(kn), t(vn), tpool, t(tables), layer, t(lengths))
    assert _counts() == before
    _close(got.numpy(), ref, 2e-5)
    np.testing.assert_array_equal(tpool.numpy(), jpool)


# K9's output in f32 on both sides (the scales multiply in the TPU kernel's
# order): 2e-5 as above. The codes and scales: bit for bit against
# jax.jit(quantize_kv), what every deployed JAX caller runs.
@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("quantize_first", [False, True], ids=["full", "quantize_first"])
def test_k9_attends_then_appends_as_jax(hd, quantize_first):
    """``quantize_first`` is the int8 ALiBi single-position step's order
    (``models/llama.py``): K9 attends over ``dequantize_kv(quantize_kv(k))``
    while its append quantizes the full-precision ``k`` (``k_app``)."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.models.llama import quantize_kv
    from awq_tpu.ops.decode_attn import flash_decode_stacked8

    L, layer, nq, nkv = 2, 1, 4, 2
    lengths = np.array([0, 37, T - 1, T + 5, 130], np.int32)
    b = len(lengths)
    rng = np.random.default_rng(hd + quantize_first)
    codes, scales = (a.numpy() for a in tca.quantize_kv(torch.from_numpy(
        _normal(rng, L, 2, b, nkv, T, hd))))
    q, k1, v1 = (_normal(rng, *s) for s in ((b, nq, hd), (b, nkv, hd), (b, nkv, hd)))
    k1[2, 1] = 0.0                                      # a zero row: the 1e-6 floor
    kn, vn = k1, v1
    if quantize_first:
        kn, vn = (tca.dequantize_kv(*tca.quantize_kv(torch.from_numpy(x))).numpy()
                  for x in (k1, v1))
    ref = np.asarray(flash_decode_stacked8(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(codes),
        jnp.asarray(scales.reshape(L, 2, b, nkv, T // 256, 256)), jnp.int32(layer),
        jnp.asarray(np.minimum(lengths, T)), interpret=True))
    jq, js = jax.jit(quantize_kv)(jnp.asarray(np.stack([k1, v1])))   # [2, B, n_kv, (hd)]
    jcodes = np.asarray(_jax_row_writes(
        jnp.asarray(codes), [jq[:, i][None, :, None, :, None, :] for i in range(b)],
        [(layer, 0, i, 0, int(lengths[i]), 0) for i in range(b)]))
    jscales = np.asarray(_jax_row_writes(
        jnp.asarray(scales), [js[:, i][None, :, None, :, None] for i in range(b)],
        [(layer, 0, i, 0, int(lengths[i])) for i in range(b)]))

    t = torch.from_numpy
    tc, ts = t(codes.copy()), t(scales.copy())
    before = _counts()
    got = tda.flash_decode_int8(t(q), t(kn), t(vn), tc[layer], ts[layer], t(lengths),
                                k_app=t(k1), v_app=t(v1))
    assert _counts() == before
    _close(got.numpy(), ref, 2e-5)
    np.testing.assert_array_equal(tc.numpy(), jcodes)
    np.testing.assert_array_equal(ts.numpy(), jscales)


def test_append_to_leaves_the_read_cache_alone():
    """``append_to`` takes the write; the cache the attention read keeps its
    bits, and the output is the in-place call's (the plain path attends
    before it writes, so this holds at a length past T too)."""
    rng = np.random.default_rng(3)
    b, nq, nkv, hd, t = 3, 4, 2, 128, 64
    cache = torch.from_numpy(_normal(rng, 2, b, nkv, t, hd))
    q, kn, vn = (torch.from_numpy(_normal(rng, *s)) for s in ((b, nq, hd), (b, nkv, hd),
                                                             (b, nkv, hd)))
    lens = torch.tensor([0, t - 1, t + 4], dtype=torch.int32)
    read, away, inplace = cache.clone(), cache.clone(), cache.clone()
    out_away = tda.flash_decode(q, kn, vn, read, lens, append_to=away)
    out_in = tda.flash_decode(q, kn, vn, inplace, lens)
    assert torch.equal(read, cache)
    assert torch.equal(away, inplace) and not torch.equal(inplace, cache)
    assert torch.equal(out_away, out_in)
    codes, scales = tca.quantize_kv(cache)
    c8 = [(codes.clone(), scales.clone()) for _ in range(3)]
    o_away = tda.flash_decode_int8(q, kn, vn, *c8[0], lens, append_to=c8[1])
    o_in = tda.flash_decode_int8(q, kn, vn, *c8[2], lens)
    assert torch.equal(c8[0][0], codes) and torch.equal(c8[0][1], scales)
    assert torch.equal(c8[1][0], c8[2][0]) and torch.equal(c8[1][1], c8[2][1])
    assert torch.equal(o_away, o_in)


def test_stacked_step_appends_through_the_attention(monkeypatch):
    """The stacked path's decode steps (``forward`` at S = 1 over a float and
    an int8 cache, the batched and the paged step) write the current token
    through K2, K9 and K8 alone: no K7 wrapper runs and ``update_kv_cache``
    writes only prefills; each step's token lands at its row's position in
    every layer."""
    from awq_tpu_torch.config import ModelConfig

    # head_dim 128: the single-position step takes K2 there (flash_decode_supported)
    cfg = ModelConfig(arch="llama", vocab_size=128, hidden_size=512, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                      max_position_embeddings=64, dtype="float32")
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setenv("AWQ_TPU_DISABLE_MEGAKERNEL", "1")

    def refuse(*a, **k):
        raise AssertionError("a K7 wrapper ran on the stacked step")
    for name in ("batched_cache_append", "batched_cache_append_int8"):
        monkeypatch.setattr(tca, name, refuse)
    writes = []
    real_update = tllama.update_kv_cache
    monkeypatch.setattr(tllama, "update_kv_cache",
                        lambda kv, k, v, start: writes.append(k.shape[1]) or real_update(
                            kv, k, v, start))

    def written(cache, row, pos):
        data = cache.data if isinstance(cache, tllama.KVCache8) else cache
        return bool((data[:, :, row, :, pos] != 0).any(dim=-1).all())

    for cache_dtype in (torch.float32, "int8"):
        cache = tllama.init_cache(cfg, 2, 64, cache_dtype, device="cpu")
        tllama.forward(params, cfg, torch.tensor([[3, 5, 7, 9], [1, 2, 4, 8]]), cache, 0)
        assert writes == ([4] * cfg.num_layers if cache_dtype == torch.float32 else [])
        writes.clear()
        for pos in (4, 5):
            assert not written(cache, 0, pos)
            tllama.forward(params, cfg, torch.tensor([[11], [12]]), cache, pos)
            assert written(cache, 0, pos) and written(cache, 1, pos)
        lens = torch.tensor([6, 3], dtype=torch.int32)
        tllama.decode_step_batched(params, cfg, torch.tensor([13, 14]), cache, lens,
                                   max_length=6)
        assert written(cache, 0, 6)
        assert writes == []
    page = 16
    pool = torch.zeros((cfg.num_layers, 2, 5, cfg.num_kv_heads, page, cfg.head_dim))
    tables = torch.tensor([[3, 1], [2, 4]], dtype=torch.int32)
    lens = torch.tensor([17, 5], dtype=torch.int32)
    tllama.decode_step_paged(params, cfg, torch.tensor([13, 14]), pool, tables, lens,
                             max_length=17)
    assert bool((pool[:, :, 1, :, 1] != 0).any(dim=-1).all())      # row 0: page 1, offset 1
    assert bool((pool[:, :, 2, :, 5] != 0).any(dim=-1).all())      # row 1: page 2, offset 5
    assert int((pool != 0).any(dim=-1).sum()) == 2 * cfg.num_layers * 2 * cfg.num_kv_heads
    assert writes == []


# ---- on the card ---------------------------------------------------------------------

CARD_T = 1024
# 8 rows: a row of length 0, ragged ones, T - 1, and one past T (its write
# clamped to T - 1, a position its attention reads); with ALiBi slopes the
# last row is T (the plain version adds slope * len_b unclamped)
CARD_LENGTHS = [0, 1, 255, 700, CARD_T - 1, CARD_T + 9, 64, 513]
CARD_LENGTHS_ALIBI = CARD_LENGTHS[:5] + [CARD_T] + CARD_LENGTHS[6:]
# the outputs against the plain attention: 2^-6 of the largest (the kernels'
# rounding of P to the cache dtype, the card tests' tolerance elsewhere)
CARD_TOL = 2.0 ** -6
CARD_SHAPES = [(32, 8, 128, False), (16, 1, 64, False), (8, 8, 64, True), (32, 32, 128, True)]


def _rnd(gen, dev, dtype, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _within(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= CARD_TOL * ref.float().abs().max().item(), err


def _card_lens(dev, alibi):
    return torch.tensor(CARD_LENGTHS_ALIBI if alibi else CARD_LENGTHS, dtype=torch.int32,
                        device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kdtype", [(torch.bfloat16, torch.bfloat16),
                                          (torch.float16, torch.float16),
                                          (torch.float32, torch.float32),
                                          (torch.bfloat16, torch.float32)],
                         ids=["bf16", "f16", "f32", "bf16-cache-f32-token"])
@pytest.mark.parametrize("nq,nkv,hd,alibi", CARD_SHAPES)
def test_k2_fused_append_equals_k7_on_card(cuda, dtype, kdtype, nq, nkv, hd, alibi):
    """K2's append: the cache bit-equal to the standalone K7's (given the
    token in the cache's dtype) and the plain append's; the output of the
    launch that appended in place bit-equal to the one that appended
    elsewhere, which left its cache's bits alone."""
    if dtype == torch.float32 and nq // nkv > 16:
        pytest.skip("an f32 cache takes at most 16 q heads a kv head in K2's narrow unit")
    gen = torch.Generator(device=cuda).manual_seed(nq + hd + alibi)
    b = len(CARD_LENGTHS)
    cache = _rnd(gen, cuda, dtype, 2, b, nkv, CARD_T, hd)
    q = _rnd(gen, cuda, dtype, b, nq, hd)
    kn, vn = _rnd(gen, cuda, kdtype, b, nkv, hd), _rnd(gen, cuda, kdtype, b, nkv, hd)
    lens = _card_lens(cuda, alibi)
    sl = tlayers.alibi_slopes(nq, device=cuda) if alibi else None
    read, away, inplace, plain = (cache.clone() for _ in range(4))
    k7 = cache.clone()[None]
    n0 = tca.LAUNCHES["cache_append"]
    out_away = tda.flash_decode(q, kn, vn, read, lens, max_length=CARD_T, slopes=sl,
                                append_to=away)
    out_in = tda.flash_decode(q, kn, vn, inplace, lens, max_length=CARD_T, slopes=sl)
    tca.batched_cache_append(k7, torch.stack([kn, vn]).to(dtype)[None].contiguous(), lens)
    tca.batched_cache_append_plain(plain[None], torch.stack([kn, vn])[None], lens)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["cache_append"] == n0 + 3
    assert torch.equal(read, cache)
    assert torch.equal(out_in, out_away)
    assert torch.equal(inplace, k7[0]) and torch.equal(away, k7[0])
    assert torch.equal(inplace, plain)
    _within(out_in, tda.flash_decode_plain(q, kn, vn, cache, lens, max_length=CARD_T,
                                           slopes=sl))


def _card_pool(gen, dev, dtype, b, nkv, hd, page):
    """A 2-layer pool of permuted pages (page 0, the trash page, unused) and
    its tables ``[b, CARD_T // page]``."""
    mp = CARD_T // page
    n_pages = 1 + b * mp
    tables = (torch.randperm(b * mp, generator=gen, device=dev) + 1).reshape(b, mp)
    return _rnd(gen, dev, dtype, 2, 2, n_pages, nkv, page, hd), tables.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("page", [256, 64])
@pytest.mark.parametrize("nq,nkv,hd,alibi", CARD_SHAPES)
def test_k8_fused_append_equals_k7_on_card(cuda, dtype, page, nq, nkv, hd, alibi):
    """K8's append into the rows' pages of layer 1 (the past-T row's at the
    table's last position): bit-equal to K7's paged mode and the plain
    append; in place and elsewhere give one output."""
    gen = torch.Generator(device=cuda).manual_seed(page + nq + hd)
    b, layer = len(CARD_LENGTHS), 1
    pool, tables = _card_pool(gen, cuda, dtype, b, nkv, hd, page)
    q = _rnd(gen, cuda, dtype, b, nq, hd)
    kn, vn = _rnd(gen, cuda, dtype, b, nkv, hd), _rnd(gen, cuda, dtype, b, nkv, hd)
    lens = _card_lens(cuda, alibi)
    sl = tlayers.alibi_slopes(nq, device=cuda) if alibi else None
    read, away, inplace, plain, k7 = (pool.clone() for _ in range(5))
    n0 = tca.LAUNCHES["cache_append_paged"]
    out_away = tda.flash_decode_paged(q, kn, vn, read, tables, layer, lens, max_length=CARD_T,
                                      slopes=sl, append_to=away)
    out_in = tda.flash_decode_paged(q, kn, vn, inplace, tables, layer, lens,
                                    max_length=CARD_T, slopes=sl)
    kv = torch.stack([kn, vn])[None].contiguous()
    tca.batched_cache_append(k7[layer:layer + 1], kv, lens, tables)
    tca.batched_cache_append_plain(plain[layer:layer + 1], kv, lens, tables)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["cache_append_paged"] == n0 + 3
    assert torch.equal(read, pool)
    assert torch.equal(out_in, out_away)
    assert torch.equal(inplace, k7) and torch.equal(away, k7) and torch.equal(inplace, plain)
    _within(out_in, tda.flash_decode_paged_plain(q, kn, vn, pool, tables, layer, lens,
                                                 max_length=CARD_T, slopes=sl))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["full", "quantize_first"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("nq,nkv,hd,alibi", CARD_SHAPES)
def test_k9_fused_append_equals_k7_on_card(cuda, order, dtype, nq, nkv, hd, alibi):
    """K9's append: ``quantize_kv`` of ``k_app``/``v_app`` (the full-precision
    token; under ``quantize_first`` K9 attends over its dequantized codes)
    bit-equal to K7's int8 mode (bf16 and f32 tokens, the dtypes K7 takes)
    and the plain append, codes and scales; in place and elsewhere give one
    output."""
    gen = torch.Generator(device=cuda).manual_seed(nq + hd + alibi + 7)
    b = len(CARD_LENGTHS)
    codes, scales = tca.quantize_kv(torch.randn((2, b, nkv, CARD_T, hd), generator=gen,
                                                device=cuda))
    q = _rnd(gen, cuda, dtype, b, nq, hd)
    k1, v1 = _rnd(gen, cuda, dtype, b, nkv, hd), _rnd(gen, cuda, dtype, b, nkv, hd)
    k1[3, 0] = 0.0                                      # a zero row: the 1e-6 floor
    kn, vn = k1, v1
    if order == "quantize_first":
        kn, vn = (tca.dequantize_kv(*tca.quantize_kv(x), dtype) for x in (k1, v1))
    lens = _card_lens(cuda, alibi)
    sl = tlayers.alibi_slopes(nq, device=cuda) if alibi else None
    read, away, inplace, plain, k7 = ((codes.clone(), scales.clone()) for _ in range(5))
    n0 = tca.LAUNCHES["cache_append_int8"]
    out_away = tda.flash_decode_int8(q, kn, vn, *read, lens, max_length=CARD_T, slopes=sl,
                                     k_app=k1, v_app=v1, append_to=away)
    out_in = tda.flash_decode_int8(q, kn, vn, *inplace, lens, max_length=CARD_T, slopes=sl,
                                   k_app=k1, v_app=v1)
    kv = torch.stack([k1, v1])[None].contiguous()
    tca.batched_cache_append_int8_plain(plain[0][None], plain[1][None], kv, lens)
    if dtype != torch.float16:
        tca.batched_cache_append_int8(k7[0][None], k7[1][None], kv, lens)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["cache_append_int8"] == n0 + 2 + (dtype != torch.float16)
    assert torch.equal(read[0], codes) and torch.equal(read[1], scales)
    assert torch.equal(out_in, out_away)
    for got in (inplace, away) + ((k7,) if dtype != torch.float16 else ()):
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    _within(out_in, tda.flash_decode_int8_plain(q, kn, vn, codes, scales, lens,
                                                max_length=CARD_T, slopes=sl))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 255, 1000, 2047])
@pytest.mark.parametrize("kind", ["k2", "k2_alibi", "k9"])
def test_device_length_entries_append_on_card(cuda, kind, length):
    """The ``*_dev`` entries (a captured step's, split by the length read,
    the grid planned for the bucket T - 1): output and cache bit-equal to
    the host launch planned for the length, the cache to K7's and the plain
    append's; the append elsewhere leaves the output's bits."""
    t = 2048
    nq, nkv, hd = (32, 32, 128) if kind == "k2_alibi" else (32, 8, 128)
    gen = torch.Generator(device=cuda).manual_seed(length)
    q = _rnd(gen, cuda, torch.bfloat16, 1, nq, hd)
    kn, vn = (_rnd(gen, cuda, torch.bfloat16, 1, nkv, hd) for _ in range(2))
    lens = torch.tensor([length], dtype=torch.int32, device=cuda)
    sl = tlayers.alibi_slopes(nq, device=cuda) if kind == "k2_alibi" else None
    kv = torch.stack([kn, vn])[None].contiguous()
    if kind == "k9":
        codes, scales = tca.quantize_kv(torch.randn((2, 1, nkv, t, hd), generator=gen,
                                                    device=cuda))
        c = [(codes.clone(), scales.clone()) for _ in range(5)]
        host = tda.flash_decode_int8(q, kn, vn, *c[0], lens, max_length=length)
        dev = tda.flash_decode_int8(q, kn, vn, *c[1], lens, max_length=t - 1, by_length=True)
        away = tda.flash_decode_int8(q, kn, vn, *c[2], lens, max_length=t - 1, by_length=True,
                                     append_to=c[3])
        tca.batched_cache_append_int8(c[4][0][None], c[4][1][None], kv, lens)
        torch.cuda.synchronize()
        assert torch.equal(c[2][0], codes) and torch.equal(c[2][1], scales)
        for got in (c[1], c[3], c[4]):
            assert torch.equal(got[0], c[0][0]) and torch.equal(got[1], c[0][1])
    else:
        cache = _rnd(gen, cuda, torch.bfloat16, 2, 1, nkv, t, hd)
        c = [cache.clone() for _ in range(5)]
        host = tda.flash_decode(q, kn, vn, c[0], lens, max_length=length, slopes=sl)
        dev = tda.flash_decode(q, kn, vn, c[1], lens, max_length=t - 1, slopes=sl,
                               by_length=True)
        away = tda.flash_decode(q, kn, vn, c[2], lens, max_length=t - 1, slopes=sl,
                                by_length=True, append_to=c[3])
        tca.batched_cache_append(c[4][None], kv, lens)
        torch.cuda.synchronize()
        assert torch.equal(c[2], cache)
        for got in (c[1], c[3], c[4]):
            assert torch.equal(got, c[0])
    assert torch.equal(dev, host) and torch.equal(away, dev)
