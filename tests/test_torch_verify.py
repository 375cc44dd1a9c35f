"""The window mode of K2 and K9 (``ops/decode_attn.py::flash_verify``,
``flash_verify_int8``): the attention of ``verify_step_batched``.

On the CPU the wrappers run the plain attention (JAX's ``xla_attn`` of
``verify_step_batched``, ``awq_tpu/models/llama.py:1407-1434``), then the
plain append of the window at ``min(max(len_b, 0), T - W)`` (JAX's
``dynamic_update_slice``; over an int8 cache ``quantize_kv`` of the window
after the attention, :1484-1502). Here that is held to JAX itself:
``models/llama.py::verify_step_batched`` against JAX's on tiny f32 models of
every family JAX's verify step takes (rope, NeoX's partial rope, learned
positions), over f32 and int8 caches, the logits and the cache; and the
append, given the k/v JAX's step writes, against JAX's own append, bit for
bit, int8 codes and scales included.

The tests marked ``cuda`` hold the kernel on a card to its plain version:
bf16, f16, f32 and int8 caches, head_dim 64 and 128, Llama-3-8B's group (4),
StarCoder's 48 and Falcon-7B's 71 over one kv head, windows of 1, 8 and 32,
ragged lengths with a row at 0 and, where the rows fit one block, a window
clamped against the cache's end; each row's output within 2^-6 of that row's
largest magnitude in the plain version (the other decode kernels' tolerance,
taken a row) and the
written cache bit-equal to the plain append; the output of a launch that
appended in place bit-equal to one whose append went elsewhere.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import cache_append as tca
from awq_tpu_torch.ops import decode_attn as tda
from test_torch_family_batched import FAMILIES, close, family_model as batched_model
from test_torch_opt import STYLES, family_model as stacked_model

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

T = 256
# the families of JAX's verify step (rope, learned positions; no ALiBi), tiny
# f32 models: llama GQA (4 q heads over 2 at head_dim 128), falcon-7b-style
# (16 over one kv head at 64, the parallel block with one norm), OPT (learned
# positions from row 2), GPT-BigCode MQA (4 over one at 64), GPT-NeoX with a
# quarter of the head rotated (the sequential block at 64, the parallel at 128)
LLAMA = dict(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=1024,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
             max_position_embeddings=T, dtype="float32")
VERIFY_FAMILIES = ["llama", "falcon7b", "opt", "bigcode", "neox_seq", "neox"]


def verify_model(family: str):
    """``(jax cfg, jax params, port cfg, port params)`` of a verify family:
    the helpers of ``test_torch_family_batched.py`` and ``test_torch_opt.py``
    (norms and biases jittered, W4), llama's built here the same way."""
    if family in FAMILIES:
        return batched_model(family)
    if family in STYLES:
        return stacked_model(family)
    return llama_model()


def llama_model(seed: int = 2):
    import jax
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama
    from awq_tpu_torch.config import ModelConfig as TConfig
    from awq_tpu_torch.convert import params_from_jax

    cfg = JConfig(**LLAMA)
    jparams = jllama.quantize_params(jllama.init_params(cfg, jax.random.PRNGKey(seed)),
                                     JQuant(w_bit=4, group_size=128))
    return cfg, jparams, TConfig(**LLAMA), params_from_jax(jax.device_get(jparams),
                                                           device="cpu")


def _step_inputs(jcfg, seed, b, w):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((jcfg.num_layers, 2, b, jcfg.num_kv_heads, T,
                                 jcfg.head_dim)).astype(np.float32) * 0.3
    windows = rng.integers(0, jcfg.vocab_size, (b, w))
    return cache, windows


# ragged, with an empty row and a row whose window ends at the cache's end
VERIFY_LENGTHS = [5, 0, 130, T - 6]

CARD_T = 1024
CARD_TOL = 2.0 ** -6
# (nq, nkv, hd): Llama-3-8B's group, a narrow hd-64 MHA, StarCoder's and
# Falcon-7B's groups over one kv head
CARD_SHAPES = [(32, 8, 128), (8, 8, 64), (48, 1, 128), (71, 1, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rnd(gen, dev, dtype, *shape):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _within(got, ref):
    """Each batch row within 2^-6 of its own largest magnitude: a row at
    length 0 attends its window alone and outweighs the rows with a long
    prefix many times."""
    err = (got.float() - ref.float()).abs().flatten(1).amax(1)
    scale = ref.float().abs().flatten(1).amax(1)
    assert bool((err <= CARD_TOL * scale).all()), (err.tolist(), scale.tolist())


def _card_lengths(nq, nkv, w):
    """Ragged lengths with a row at 0; with the rows of a (row, kv head) in
    one block, a last row whose window is clamped against T."""
    lens = [700, 0, 930, 1000 - w, 15, 512, 64, 1]
    if (nq // nkv) * w <= tda.VERIFY_ROWS:
        lens[-1] = CARD_T - w // 2
    return lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, "int8"],
                         ids=["bf16", "f16", "f32", "int8"])
@pytest.mark.parametrize("w", [1, 8, 32])
@pytest.mark.parametrize("nq,nkv,hd", CARD_SHAPES)
def test_flash_verify_matches_plain_on_card(cuda, dtype, w, nq, nkv, hd):
    """The window mode against its plain version: the output within 2^-6,
    the appended cache bit for bit, in place and elsewhere one output."""
    int8 = dtype == "int8"
    qdt = torch.bfloat16 if int8 or dtype == torch.float32 else dtype
    gen = torch.Generator(device=cuda).manual_seed(nq + hd + w)
    lens_l = _card_lengths(nq, nkv, w)
    b = len(lens_l)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    q = _rnd(gen, cuda, qdt, b, w, nq, hd)
    kn, vn = _rnd(gen, cuda, qdt, b, w, nkv, hd), _rnd(gen, cuda, qdt, b, w, nkv, hd)
    n0 = dict(tda.LAUNCHES), dict(tca.LAUNCHES)
    if int8:
        codes, scales = tca.quantize_kv(_rnd(gen, cuda, torch.float32, 2, b, nkv, CARD_T, hd))
        read = (codes.clone(), scales.clone())
        away = (codes.clone(), scales.clone())
        inplace = (codes.clone(), scales.clone())
        plain = (codes.clone(), scales.clone())
        out_away = tda.flash_verify_int8(q, kn, vn, *read, lens, max_length=CARD_T,
                                         append_to=away)
        out_in = tda.flash_verify_int8(q, kn, vn, *inplace, lens, max_length=CARD_T)
        ref = tda.flash_verify_int8_append_plain(q, kn, vn, *plain, lens, max_length=CARD_T)
        name = "flash_verify_int8"
        torch.cuda.synchronize()
        assert torch.equal(read[0], codes) and torch.equal(read[1], scales)
        for got in (inplace, away):
            assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    else:
        cache = _rnd(gen, cuda, dtype, 2, b, nkv, CARD_T, hd)
        read, away, inplace, plain = (cache.clone() for _ in range(4))
        out_away = tda.flash_verify(q, kn, vn, read, lens, max_length=CARD_T, append_to=away)
        out_in = tda.flash_verify(q, kn, vn, inplace, lens, max_length=CARD_T)
        ref = tda.flash_verify_append_plain(q, kn, vn, plain, lens, max_length=CARD_T)
        name = "flash_verify"
        torch.cuda.synchronize()
        assert torch.equal(read, cache)
        assert torch.equal(inplace, plain) and torch.equal(away, plain)
    assert tda.LAUNCHES[name] == n0[0][name] + 2
    assert tca.LAUNCHES == n0[1]             # the window's append is the launch's own
    assert torch.equal(out_in, out_away)
    assert out_in.shape == (b, w, nq, hd) and out_in.dtype == qdt
    _within(out_in, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("max_length", [0, 64, 4000])
def test_flash_verify_single_row_lengths_on_card(cuda, max_length):
    """B = 1 at Llama-3-8B's group and W = 8 (the smoke's single-stream
    rows): every prefix length the split takes, from none to a 16-block
    cluster."""
    t = 4096
    gen = torch.Generator(device=cuda).manual_seed(max_length)
    q = _rnd(gen, cuda, torch.bfloat16, 1, 8, 32, 128)
    kn, vn = (_rnd(gen, cuda, torch.bfloat16, 1, 8, 8, 128) for _ in range(2))
    cache = _rnd(gen, cuda, torch.bfloat16, 2, 1, 8, t, 128)
    plain = cache.clone()
    lens = torch.tensor([max_length], dtype=torch.int32, device=cuda)
    out = tda.flash_verify(q, kn, vn, cache, lens, max_length=max_length)
    ref = tda.flash_verify_append_plain(q, kn, vn, plain, lens)
    torch.cuda.synchronize()
    assert torch.equal(cache, plain)
    _within(out, ref)


@pytest.mark.cuda
def test_flash_verify_refuses_what_it_cannot_take_on_card(cuda):
    q = torch.zeros((1, 33, 32, 128), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((1, 33, 8, 128), dtype=torch.bfloat16, device=cuda)
    cache = torch.zeros((2, 1, 8, 256, 128), dtype=torch.bfloat16, device=cuda)
    lens = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="window of 33"):
        tda.flash_verify(q, kv, kv, cache, lens)
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        tda.flash_verify(q[..., :96].contiguous(), kv[..., :96].contiguous(),
                         kv[..., :96].contiguous(), cache[..., :96].contiguous(), lens)


# ---- the CPU path against JAX ----------------------------------------------

# f32 on both sides, other summation orders: 1e-4 of the largest logit (the
# batched step's bound, tests/test_torch_family_batched.py). The cache: every
# position outside the windows bit for bit; the windows' k/v within 1e-5 of
# the largest (the same linears in another order); over int8 the window's
# codes within one step on the rounding edge (at most 1 in 100 of them) and
# the scales within 2e-6 (tests/test_torch_family_kv8.py's bounds).
@pytest.mark.parametrize("cache_dtype", ["f32", "int8"])
@pytest.mark.parametrize("family", VERIFY_FAMILIES)
def test_verify_step_batched_matches_jax(family, cache_dtype):
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams, tcfg, tparams = verify_model(family)
    w = 6
    cache, windows = _step_inputs(jcfg, 7, len(VERIFY_LENGTHS), w)
    lens = np.array(VERIFY_LENGTHS, np.int32)
    if cache_dtype == "int8":
        kq, ks = jllama.quantize_kv(jnp.asarray(cache))
        jcache = jllama.KVCache8(data=kq, scales=ks)
        tcache = tllama.KVCache8(data=torch.from_numpy(np.array(kq)),
                                 scales=torch.from_numpy(np.array(ks)))
    else:
        jcache, tcache = jnp.asarray(cache), torch.from_numpy(cache.copy())
    jl, jcache = jllama.verify_step_batched(jparams, jcfg, jnp.asarray(windows, jnp.int32),
                                            jcache, jnp.asarray(lens))
    tl, tcache = tllama.verify_step_batched(tparams, tcfg, torch.from_numpy(windows), tcache,
                                            torch.from_numpy(lens))
    assert tl.shape == (len(lens), w, jcfg.vocab_size) and tl.dtype == torch.float32
    close(tl, np.asarray(jl), 1e-4)
    written = np.zeros(T, bool)[None].repeat(len(lens), 0)
    for i, n in enumerate(lens):
        written[i, n:n + w] = True
    outside = ~written[None, None, :, None, :]          # [1, 1, B, 1, T]
    if cache_dtype == "int8":
        dq = tcache.data.numpy().astype(int) - np.asarray(jcache.data).astype(int)
        assert (dq[np.broadcast_to(outside, dq.shape[:-1])] == 0).all()
        assert np.abs(dq).max() <= 1 and (dq != 0).mean() < 1e-2
        js, ts = np.asarray(jcache.scales), tcache.scales.numpy()
        assert np.array_equal(ts[np.broadcast_to(outside, ts.shape)],
                              js[np.broadcast_to(outside, js.shape)])
        np.testing.assert_allclose(ts, js, rtol=2e-6, atol=0)
    else:
        jc, tc = np.asarray(jcache), tcache.numpy()
        mask = np.broadcast_to(outside[..., None], tc.shape)
        assert np.array_equal(tc[mask], jc[mask])
        close(tc, jc, 1e-5)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("cache_dtype", ["bf16", "f32", "int8"])
def test_window_append_bit_exact_against_jax(cache_dtype, hd):
    """The wrappers' CPU append of a window (given the same k/v as JAX's
    verify step writes) against JAX's own append after its layer scan:
    ``quantize_kv`` under ``jit`` over int8 and one ``dynamic_update_slice``
    a row (which clamps a window past the end to ``T - W``), bit for bit,
    codes and scales included; lengths 0, mid-cache, one that ends at T and
    one past it. The attention's output equals the plain version's."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    rng = np.random.default_rng(hd)
    b, w, nq, nkv = 4, 5, 8, 2
    lens = np.array([0, 100, T - w, T - 2], np.int32)
    q = rng.standard_normal((b, w, nq, hd)).astype(np.float32)
    kv = rng.standard_normal((2, b, w, nkv, hd)).astype(np.float32)
    base = rng.standard_normal((2, b, nkv, T, hd)).astype(np.float32)
    kv_all = jnp.swapaxes(jnp.asarray(kv), 2, 3)                   # [2, B, nkv, W, hd]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kv[0], kv[1]))
    tlens = torch.from_numpy(lens)
    if cache_dtype == "int8":
        codes, scales = jax.jit(jllama.quantize_kv)(jnp.asarray(base))
        wq, ws = jax.jit(jllama.quantize_kv)(kv_all)
        for i in range(b):
            codes = jax.lax.dynamic_update_slice(codes, wq[:, i][:, None], (0, i, 0, lens[i], 0))
            scales = jax.lax.dynamic_update_slice(scales, ws[:, i][:, None], (0, i, 0, lens[i]))
        tcodes, tscales = tca.quantize_kv(torch.from_numpy(base))
        ref = tda.flash_verify_int8_plain(tq, tk, tv, tcodes, tscales, tlens)
        out = tda.flash_verify_int8(tq, tk, tv, tcodes, tscales, tlens)
        assert np.array_equal(tcodes.numpy(), np.asarray(codes))
        assert np.array_equal(tscales.numpy(), np.asarray(scales))
    else:
        dt = jnp.bfloat16 if cache_dtype == "bf16" else jnp.float32
        jc = jnp.asarray(base).astype(dt)
        for i in range(b):
            jc = jax.lax.dynamic_update_slice(jc, kv_all[:, i][:, None].astype(dt),
                                              (0, i, 0, lens[i], 0))
        tc = torch.from_numpy(base).to(getattr(torch, {"bf16": "bfloat16",
                                                       "f32": "float32"}[cache_dtype]))
        ref = tda.flash_verify_plain(tq, tk, tv, tc, tlens)
        out = tda.flash_verify(tq, tk, tv, tc, tlens)
        assert np.array_equal(tc.float().numpy(), np.asarray(jc.astype(jnp.float32)))
    assert torch.equal(out, ref)


def test_verify_step_batched_refusals():
    """ALiBi raises (JAX's verify step has no ALiBi path), and so does a
    tensor-parallel axis (ROADMAP A17b) and a cache of other rows."""
    _, _, tcfg, tparams = verify_model("llama")
    cache = tllama.init_kv_cache(tcfg, 2, T, torch.float32, device="cpu")
    win, lens = torch.zeros((2, 3), dtype=torch.long), torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 17b"):
        tllama.verify_step_batched(tparams, tcfg, win, cache, lens, tp_axis=object())
    with pytest.raises(ValueError, match="slots and lengths"):
        tllama.verify_step_batched(tparams, tcfg, win[:1], cache, lens[:1])
    _, _, mcfg, mparams = verify_model("mpt")
    mcache = tllama.init_kv_cache(mcfg, 2, T, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="no ALiBi path"):
        tllama.verify_step_batched(mparams, mcfg, win, mcache, lens)
