"""Port parity of the int8 KV cache (``KVCache8``) for falcon, MPT and BLOOM
against the JAX package on the CPU, and K9's head_dim-64, wide-group and
ALiBi modes and K7's int8 mode at head_dim 64 on the card.

The JAX package attends to the current token of an int8 step in two orders:
- its ``forward`` over an int8 ALiBi cache quantizes the token into the
  cache first and attends at its dequantized value (XLA attention: it never
  takes the flash kernel there, ``awq_tpu/models/llama.py:681``), even
  under ``AWQ_TPU_FORCE_FLASH=1``;
- its ``decode_step_batched`` takes the token in full precision (its XLA
  ``xla_attn``, or for a rope family under the hook the interpret-mode
  ``flash_decode_stacked8``), and quantizes it after the layer scan.
The port's single-position ALiBi step (``forward`` at S = 1,
``decode_step``) follows the first, its per-row step the second; falcon's
single-position step follows the deployed flash order (ROADMAP C). The four
tiny f32 models of ``tests/test_torch_family_batched.py``.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.models import layers as tlayers
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import cache_append as tca
from awq_tpu_torch.ops import decode_attn as tda
from awq_tpu_torch.ops import megakernel as tmk
from test_torch_family_batched import (FAMILIES, T, WIDE_SHAPES, card_inputs, close,
                                       cuda, family_model, set_flash,  # noqa: F401
                                       within)

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


def run_forward(family, steps, flash, monkeypatch, impl="auto"):
    """The prompt and the decode steps through JAX's ``forward`` and the
    port's over fresh int8 caches: ``(worst logit gap / largest, jax cache,
    port cache)``."""
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = family_model(family)
    set_flash(monkeypatch, flash)
    jcache = jllama.init_kv_cache8(jcfg, 1, T)
    tcache = tllama.init_kv_cache8(tcfg, 1, T, device="cpu")
    pos, worst = 0, 0.0
    for toks in steps:
        jl, jcache = jllama.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), jcache,
                                    jnp.int32(pos))
        tl, _ = tllama.forward(tparams, tcfg, torch.from_numpy(toks), tcache, pos, impl=impl)
        jl = np.asarray(jl)
        worst = max(worst, float(np.abs(tl.numpy() - jl).max() / np.abs(jl).max()))
        pos += toks.shape[1]
    return worst, jcache, tcache


def prompt_steps(seed, n=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (1, 11))] + [rng.integers(0, 512, (1, 1)) for _ in range(n)]


def assert_caches_close(jcache, tcache):
    """Codes and scales of the two sides: the k/v they quantize differ in f32
    rounding, so a code on a step's edge may differ by one (at most 1 in 1000
    of them) and a scale by a few ulp (``tests/test_torch_kv8_forward.py``
    measured <= 12 ulp)."""
    dq = np.abs(tcache.data.numpy().astype(int) - np.asarray(jcache.data).astype(int))
    assert dq.max() <= 1 and (dq != 0).mean() < 1e-3
    np.testing.assert_allclose(tcache.scales.numpy(), np.asarray(jcache.scales), rtol=2e-6,
                               atol=0)


# f32 on both sides, other summation orders: 1e-5 of the largest logit over a
# prompt of 11 and 16 decode steps (the rope families' int8 forward bound,
# tests/test_torch_kv8_forward.py).
@pytest.mark.parametrize("flash", [False, True], ids=["xla", "flash"])
@pytest.mark.parametrize("family", ["mpt", "bloom"])
def test_alibi_forward_int8_quantizes_first_as_jax(family, flash, monkeypatch):
    worst, jcache, tcache = run_forward(family, prompt_steps(3), flash, monkeypatch)
    assert worst <= 1e-5, worst
    assert_caches_close(jcache, tcache)


@pytest.mark.parametrize("family", ["mpt", "bloom"])
def test_alibi_int8_orders_differ(family, monkeypatch):
    """The full-precision order (the batched step's) measurably parts from
    JAX's ``forward`` at S = 1, so the test above tells the orders apart:
    the port's single-position step run with the batched step's order (a
    per-row step of one row) is more than 1e-4 of the largest logit away."""
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = family_model(family)
    set_flash(monkeypatch, False)
    steps = prompt_steps(5, 1)
    jcache = jllama.init_kv_cache8(jcfg, 1, T)
    tcache = tllama.init_kv_cache8(tcfg, 1, T, device="cpu")
    _, jcache = jllama.forward(jparams, jcfg, jnp.asarray(steps[0], jnp.int32), jcache,
                               jnp.int32(0))
    tllama.forward(tparams, tcfg, torch.from_numpy(steps[0]), tcache, 0)
    jl, _ = jllama.forward(jparams, jcfg, jnp.asarray(steps[1], jnp.int32), jcache,
                           jnp.int32(11))
    jl = np.asarray(jl)[:, 0]
    first, _ = tllama.forward(tparams, tcfg, torch.from_numpy(steps[1]),
                              tllama.KVCache8(tcache.data.clone(), tcache.scales.clone()), 11)
    per_row, _ = tllama.decode_step_batched(
        tparams, tcfg, torch.from_numpy(steps[1][0]), tcache,
        torch.tensor([11], dtype=torch.int32))
    scale = np.abs(jl).max()
    assert np.abs(first[:, 0].numpy() - jl).max() <= 1e-5 * scale
    assert np.abs(per_row.numpy() - jl).max() > 1e-4 * scale


@pytest.mark.parametrize("family", ["mpt", "bloom", "falcon7b"])
def test_decode_step_int8_matches_forward(family, monkeypatch):
    """``decode_step`` (the position an int32 tensor, the captured step's
    body) over an int8 cache gives ``forward``'s logits and cache at that
    position: quantize-first for ALiBi, the flash order for falcon."""
    set_flash(monkeypatch, True)
    _, _, tcfg, tparams = family_model(family)
    caches = [tllama.init_kv_cache8(tcfg, 1, 64, device="cpu") for _ in range(2)]
    prompt = torch.tensor([[3, 1, 4, 1, 5]])
    for c in caches:
        tllama.forward(tparams, tcfg, prompt, c, 0)
    ref, _ = tllama.forward(tparams, tcfg, torch.tensor([[9]]), caches[0], 5)
    got = tllama.decode_step(tparams, tcfg, torch.tensor([9]), caches[1],
                             torch.tensor([5], dtype=torch.int32), 63)
    close(got, ref[:, 0], 1e-6)
    assert torch.equal(caches[0].data, caches[1].data)
    torch.testing.assert_close(caches[0].scales, caches[1].scales, rtol=1e-6, atol=0)


def test_falcon_forward_int8_follows_the_flash_order(monkeypatch):
    """Falcon (a rope family) over an int8 cache: the port's ``forward``
    against JAX's under ``AWQ_TPU_FORCE_FLASH=1`` (its interpret-mode
    ``flash_decode_stacked8`` at head_dim 64, a wide MQA group), the current
    token in full precision, K9's plain version on the port's side."""
    worst, jcache, tcache = run_forward("falcon7b", prompt_steps(4), True, monkeypatch)
    assert worst <= 1e-5, worst
    assert_caches_close(jcache, tcache)


# the batched step: 1e-4 of the largest logit (the llama int8 step's bound,
# tests/test_torch_kv8_forward.py::test_decode_step_batched_kv8_matches_jax)
@pytest.mark.parametrize("flash", [False, True], ids=["xla", "flash"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_step_batched_int8_matches_jax(family, flash, monkeypatch):
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = family_model(family)
    f = FAMILIES[family]
    lengths = [5, 0, 200, T - 1]
    b = len(lengths)
    rng = np.random.default_rng(13)
    codes, scales = tca.quantize_kv(torch.from_numpy(rng.standard_normal(
        (f["num_layers"], 2, b, f["num_kv_heads"], T, f["head_dim"])).astype(np.float32)))
    codes, scales = codes.numpy(), scales.numpy()
    tokens = rng.integers(0, 512, b)
    set_flash(monkeypatch, flash)
    jl, jc = jllama.decode_step_batched(
        jparams, jcfg, jnp.asarray(tokens, jnp.int32),
        jllama.KVCache8(jnp.asarray(codes), jnp.asarray(scales)),
        jnp.asarray(lengths, jnp.int32))
    tc = tllama.KVCache8(torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy()))
    tl, out = tllama.decode_step_batched(tparams, tcfg, torch.from_numpy(tokens), tc,
                                         torch.tensor(lengths, dtype=torch.int32))
    assert out is tc
    close(tl, np.asarray(jl), 1e-4)
    assert_caches_close(jc, tc)
    changed = (tc.data.numpy() != codes).any(axis=(0, 1, 3, 5))
    want = np.zeros((b, T), bool)
    want[np.arange(b), lengths] = True
    np.testing.assert_array_equal(changed, want)


def test_k4_mpt_shape_refuses_an_int8_cache(monkeypatch):
    """K4's MPT shape takes no int8 cache (JAX never gives K4 an int8 ALiBi
    cache): under ``AWQ_TPU_FORCE_MEGAKERNEL=1`` an MPT step over a
    ``KVCache8`` takes the stacked path (K9 with slopes), never K4."""
    _, _, tcfg, tparams = family_model("mpt")
    monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    params = tllama.fuse_linears(tparams, tcfg)
    c8 = tllama.init_kv_cache8(tcfg, 1, 64, device="cpu")
    assert not tmk.megakernel_supported(tcfg, params["layers"], c8)
    assert not tllama.decode_step_on_k4(params, tcfg, c8, 1)
    assert tmk.megakernel_supported(tcfg, params["layers"],
                                    tllama.init_kv_cache(tcfg, 1, 64, torch.float32,
                                                   device="cpu"))
    calls = []
    for name in ("w4a16_llama_token_step", "w4a16_llama_token_step_plain"):
        monkeypatch.setattr(tmk, name, lambda *a, _n=name, **k: calls.append(_n))
    real = tllama.flash_decode_int8
    monkeypatch.setattr(tllama, "flash_decode_int8",
                        lambda *a, **k: calls.append(k.get("slopes") is not None) or real(*a, **k))
    tllama.forward(params, tcfg, torch.tensor([[3, 1, 4]]), c8, 0)
    tllama.forward(params, tcfg, torch.tensor([[5]]), c8, 3)
    assert calls == [True] * tcfg.num_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_append_int8_plain_head_dim_64_bit_exact_against_jax(dtype):
    """K7's int8 mode at head_dim 64 (Falcon-7B's and BLOOM's rows) against
    JAX's per-row ``quantize_kv`` (jitted, as its callers run it) +
    ``dynamic_update_slice`` loop, bit for bit, rows at 0, T-1 and past T
    (clamped to T-1 by both); one kv head, as Falcon-7B's."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.models.llama import quantize_kv

    L, b, nkv, t, hd = 2, 5, 1, 64, 64
    rng = np.random.default_rng(7)
    codes, scales = (a.numpy() for a in tca.quantize_kv(torch.from_numpy(
        rng.standard_normal((L, 2, b, nkv, t, hd)).astype(np.float32))))
    kv = torch.from_numpy(rng.standard_normal((L, 2, b, nkv, hd)).astype(np.float32) * 2)
    kv = kv.to(getattr(torch, dtype))
    kv[1, 0, 2] = 0.0                                       # the 1e-6 floor
    lengths = np.array([0, t - 1, t + 5, 17, 30], np.int32)
    jkvq, jkvs = jax.jit(quantize_kv)(jnp.asarray(kv.float().numpy()).astype(
        getattr(jnp, dtype)))
    jd, js = jnp.asarray(codes), jnp.asarray(scales)
    for i in range(b):
        jd = jax.lax.dynamic_update_slice(jd, jkvq[:, :, i][:, :, None, :, None, :],
                                          (0, 0, i, 0, int(lengths[i]), 0))
        js = jax.lax.dynamic_update_slice(js, jkvs[:, :, i][:, :, None, :, None],
                                          (0, 0, i, 0, int(lengths[i])))
    td, ts = torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())
    assert tca.batched_cache_append_int8(td, ts, kv, torch.from_numpy(lengths)) is None
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


# ---- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nkv,hd", WIDE_SHAPES)
def test_k9_wide_modes_match_plain_on_card(cuda, b, nq, nkv, hd, dtype):
    q, kn, vn, cache, lens = card_inputs(cuda, b, nq, nkv, hd, dtype)
    codes, scales = tca.quantize_kv(cache.float())
    mx = int(lens.max())
    n0 = tda.LAUNCHES["flash_decode_int8_wide"]
    got = tda.flash_decode_int8(q, kn, vn, codes, scales, lens, max_length=mx)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_int8_wide"] == n0 + 1
    within(got, tda.flash_decode_int8_plain(q, kn, vn, codes, scales, lens, max_length=mx))


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nkv,hd", [(4, 16, 16, 64), (8, 32, 32, 128)])
def test_k9_alibi_modes_match_plain_on_card(cuda, b, nq, nkv, hd):
    q, kn, vn, cache, lens = card_inputs(cuda, b, nq, nkv, hd, torch.bfloat16, seed=3)
    codes, scales = tca.quantize_kv(cache.float())
    sl = tlayers.alibi_slopes(nq, device=cuda)
    mx = int(lens.max())
    n0 = tda.LAUNCHES["flash_decode_int8_alibi"]
    got = tda.flash_decode_int8(q, kn, vn, codes, scales, lens, max_length=mx, slopes=sl)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_int8_alibi"] == n0 + 1
    within(got, tda.flash_decode_int8_plain(q, kn, vn, codes, scales, lens, max_length=mx,
                                            slopes=sl))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nkv", [1, 16])
def test_cache_append_int8_head_dim_64_exact_on_card(cuda, nkv, dtype):
    """K7's int8 mode at head_dim 64 (a half-warp a row) against its plain
    version, bit for bit; an odd number of rows a layer, the 1e-6 floor and a
    length past T clamped."""
    g = torch.Generator(device=cuda).manual_seed(nkv)
    L, b, t = 3, 5, 300
    codes, scales = tca.quantize_kv(torch.randn((L, 2, b, nkv, t, 64), generator=g,
                                          device=cuda))
    kv = (torch.randn((L, 2, b, nkv, 64), generator=g, device=cuda) * 2).to(dtype)
    kv[0, 1, 2, 0] = 0.0
    lens = torch.tensor([0, t - 1, t + 9, 17, 123], dtype=torch.int32, device=cuda)
    c1, s1, c2, s2 = codes.clone(), scales.clone(), codes.clone(), scales.clone()
    n0 = tca.LAUNCHES["cache_append_int8"]
    tca.batched_cache_append_int8(c1, s1, kv, lens)
    tca.batched_cache_append_int8_plain(c2, s2, kv, lens)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["cache_append_int8"] == n0 + 1
    assert torch.equal(c1, c2) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_int8_steps_match_plain_on_card(cuda, family):
    """The families over an int8 cache on the card: the batched step (K9 in
    its new modes, K7's int8 mode) and ``forward`` at S = 1 within 5e-2 of
    the largest logit of the plain path, the dequantized cache within 5e-2
    of its largest (phase 4's bounds: a later layer's codes carry the
    earlier layers' bf16 rounding), no K14 launch."""
    from test_torch_family_batched import card_family

    cfg, params = card_family(family, cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    codes, scales = tca.quantize_kv(torch.randn((2, 2, 4, cfg.num_kv_heads, 512,
                                           cfg.head_dim), generator=g, device=cuda))
    lens = torch.tensor([0, 37, 300, 511], dtype=torch.int32, device=cuda)
    toks = torch.tensor([5, 9, 2, 7], device=cuda)
    k14 = tda.LAUNCHES["flash_decode_layer"]
    c1 = tllama.KVCache8(codes.clone(), scales.clone())
    c2 = tllama.KVCache8(codes.clone(), scales.clone())
    got, _ = tllama.decode_step_batched(params, cfg, toks, c1, lens, max_length=511)
    ref, _ = tllama.decode_step_batched(params, cfg, toks, c2, lens, impl="plain",
                                        max_length=511)
    torch.cuda.synchronize()
    within(got, ref, 5e-2)
    within(tca.dequantize_kv(*c1), tca.dequantize_kv(*c2), 5e-2)
    one = [tllama.KVCache8(codes[:, :, :1].contiguous(), scales[:, :, :1].contiguous())
           for _ in range(2)]
    got, _ = tllama.forward(params, cfg, toks[None, :1], one[0], 300)
    ref, _ = tllama.forward(params, cfg, toks[None, :1], one[1], 300, impl="plain")
    torch.cuda.synchronize()
    within(got, ref, 5e-2)
    assert tda.LAUNCHES["flash_decode_layer"] == k14
