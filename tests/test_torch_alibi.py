"""Port parity: ALiBi in the attention kernels (MPT, BLOOM).

``layers.alibi_slopes`` against the JAX package's; the plain versions of
K2 (``flash_decode``), K3 (``flash_prefill``) and K14
(``flash_decode_layer``) with slopes against the JAX package's Pallas
kernels run in interpret mode (``flash_decode_stacked`` and
``flash_prefill_stacked`` with ``slopes``) or, for K14, whose Pallas kernel
takes no slopes, against JAX's masked ``layers.attention`` with the ALiBi
bias ``forward`` builds, in f32 and bf16, at power-of-two head counts and
at 12 heads (the closest-power-of-two extension). K8 and K9 take no slopes
and raise. The tests marked ``cuda`` hold each kernel's ALiBi mode to its
plain version on a card, show that zero slopes give the bits of no slopes,
and that ``layers.attention`` on a CUDA tensor launches K14 or raises,
never taking its masked path with a bias; they skip here.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.models import layers as tlayers
from awq_tpu_torch.ops import decode_attn as tda

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _round24(slopes):
    """The slopes as JAX's decode kernel holds them: fixed point, x 2^24
    (``awq_tpu/ops/decode_attn.py:434-440``)."""
    return (np.round(slopes.astype(np.float64) * 2 ** 24) / 2 ** 24).astype(np.float32)


def _close(got, ref, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("n", [4, 8, 12, 32, 112])
def test_alibi_slopes_bit_equal_to_jax(n):
    from awq_tpu.models.layers import alibi_slopes as jslopes

    ref = np.asarray(jslopes(n))
    got = tlayers.alibi_slopes(n)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy(), ref)


# f32: the Pallas decode kernel's online softmax against the plain version's
# one pass, both adding slope * j (the port is given JAX's fixed-point
# slopes, so only f32 summation orders differ): 5e-7 of the largest output
# measured, 1e-5 allowed. bf16: the Pallas kernel rounds P to bf16 for P.V
# and the plain version keeps f32 weights, and the output rounds to bf16
# (2^-9): 2.8e-3 measured, 2^-6 allowed.
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), ("bfloat16", 2.0 ** -6)])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (12, 12), (8, 2)])
def test_flash_decode_plain_with_slopes_matches_pallas(dtype, tol, nq, nkv):
    import jax.numpy as jnp
    from awq_tpu.ops import decode_attn as jda

    L, b, t, hd = 2, 3, 256, 128
    rng = np.random.default_rng(nq + nkv)
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    cache = jnp.asarray(_normal(rng, L, 2, b, nkv, t, hd)).astype(jdt)
    q = jnp.asarray(_normal(rng, b, nq, hd)).astype(jdt)
    k_new = jnp.asarray(_normal(rng, b, nkv, hd)).astype(jdt)
    v_new = jnp.asarray(_normal(rng, b, nkv, hd)).astype(jdt)
    lengths = np.array([0, 37, 255], np.int32)
    slopes = np.asarray(tlayers.alibi_slopes(nq))
    ref = jda.flash_decode_stacked(q, k_new, v_new, cache, jnp.int32(1),
                                   jnp.asarray(lengths), interpret=True,
                                   slopes=jnp.asarray(slopes))
    tt = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(  # noqa: E731
        torch.float32 if dtype == np.float32 else torch.bfloat16)
    got = tda.flash_decode(tt(q), tt(k_new), tt(v_new), tt(cache)[1], torch.from_numpy(lengths),
                           slopes=torch.from_numpy(_round24(slopes)))
    _close(got, ref.astype(jnp.float32), tol)


# The Pallas prefill kernel takes its dots in bf16 (q pre-scaled and rounded,
# k, v and P rounded), in f32 and in bf16 alike: against the f32 plain
# version the outputs agree to about 1e-2 of their largest (2e-2 here, as
# tests/test_torch_decode_attn.py holds the kernel without slopes). The
# plain version is also held to JAX's f32 masked attention with forward's
# bias slope * j (equal under the softmax to slope * (j - i)), to f32
# rounding: the bias reaches 0.25 * 400 = 100, where an f32 step is 8e-6
# (6e-6 of the largest output measured, 5e-5 allowed).
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("start_pos,s", [(0, 40), (300, 19)])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (12, 12)])
def test_flash_prefill_plain_with_slopes_matches_pallas(dtype, start_pos, s, nq, nkv):
    import jax.numpy as jnp
    from awq_tpu.models import layers as jlayers
    from awq_tpu.ops import decode_attn as jda

    L, b, t, hd = 2, 2, 512, 128
    rng = np.random.default_rng(start_pos + s + nq)
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    cache = jnp.asarray(_normal(rng, L, 2, b, nkv, t, hd)).astype(jdt)
    q = jnp.asarray(_normal(rng, b, s, nq, hd)).astype(jdt)
    slopes = np.asarray(tlayers.alibi_slopes(nq))
    ref = np.asarray(jda.flash_prefill_stacked(
        q, cache, jnp.int32(0), jnp.int32(start_pos), block_q=16, interpret=True,
        slopes=jnp.asarray(slopes), fixed_max=None).astype(jnp.float32))
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    tq = torch.from_numpy(np.array(q.astype(jnp.float32))).to(tdt)
    tc = torch.from_numpy(np.array(cache.astype(jnp.float32))).to(tdt)
    got = tda.flash_prefill(tq, tc[0], start_pos, slopes=torch.from_numpy(slopes))
    assert got.dtype == tdt
    _close(got, ref, 2e-2)
    if dtype == np.float32:
        bias = jnp.asarray(slopes)[:, None, None] * jnp.arange(t, dtype=jnp.float32)
        exact = np.asarray(jlayers.attention(q, cache[0, 0], cache[0, 1], jnp.int32(start_pos),
                                             bias=bias))
        _close(got, exact, 5e-5)


# K14's Pallas kernel takes no slopes: its plain version with slopes is held
# to JAX's masked attention at S = 1 with forward's bias slope * j, which is
# what JAX's CPU forward runs for an ALiBi model. f32: 3.4e-7 of the largest
# output measured, 1e-5 allowed; bf16: JAX rounds the weights to bf16 before
# P.V and the plain version does not, and the output rounds to bf16: 6.7e-3
# measured, 2^-6 allowed.
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), ("bfloat16", 2.0 ** -6)])
@pytest.mark.parametrize("nq,nkv,hd", [(16, 16, 64), (12, 12, 64), (4, 4, 128)])
def test_flash_decode_layer_plain_with_slopes_matches_jax_attention(dtype, tol, nq, nkv, hd):
    import jax.numpy as jnp
    from awq_tpu.models import layers as jlayers

    b, t, length = 2, 512, 501
    rng = np.random.default_rng(nq + hd)
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    k = jnp.asarray(_normal(rng, b, nkv, t, hd)).astype(jdt)
    v = jnp.asarray(_normal(rng, b, nkv, t, hd)).astype(jdt)
    q = jnp.asarray(_normal(rng, b, 1, nq, hd)).astype(jdt)
    slopes = np.asarray(tlayers.alibi_slopes(nq))
    bias = jnp.asarray(slopes)[:, None, None] * jnp.arange(t, dtype=jnp.float32)
    ref = np.asarray(jlayers.attention(q, k, v, jnp.int32(length - 1), bias=bias)
                     .astype(jnp.float32)).reshape(b, nq, hd)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    tt = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)  # noqa: E731
    got = tda.flash_decode_layer(tt(q)[:, 0], tt(k), tt(v), length,
                                 slopes=torch.from_numpy(slopes))
    _close(got, ref, tol)
    # layers.attention at S = 1 takes the same K14 (its plain version here)
    out = tlayers.attention(tt(q), tt(k), tt(v), length - 1, slopes=torch.from_numpy(slopes))
    assert torch.equal(out.reshape(b, nq, hd), got)


def test_attention_with_slopes_matches_jax_bias_on_cpu():
    """``layers.attention`` with ``slopes`` over a chunk (the CPU's masked
    path, never taken on a card) equals JAX's attention with the bias
    ``slope * j`` in f32, to f32 rounding."""
    import jax.numpy as jnp
    from awq_tpu.models import layers as jlayers

    b, s, nq, t, hd, start = 1, 9, 12, 64, 64, 20
    rng = np.random.default_rng(5)
    q, k, v = _normal(rng, b, s, nq, hd), _normal(rng, b, nq, t, hd), _normal(rng, b, nq, t, hd)
    slopes = np.asarray(tlayers.alibi_slopes(nq))
    bias = jnp.asarray(slopes)[:, None, None] * jnp.arange(t, dtype=jnp.float32)
    ref = np.asarray(jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.int32(start), bias=bias))
    got = tlayers.attention(*map(torch.from_numpy, (q, k, v)), start,
                            slopes=torch.from_numpy(slopes))
    _close(got, ref, 1e-5)


def test_k8_and_k9_refuse_slopes():
    """K8 and K9 take ALiBi slopes: on the CPU their wrappers run the plain
    versions with the bias (K8's equal to K2's over the same rows); what
    they refuse is a group wider than the ALiBi unit's 32 q heads a kv head
    (the ALiBi families are MHA), naming ROADMAP A12."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(_normal(rng, 1, 4, 128))
    kn = torch.from_numpy(_normal(rng, 1, 4, 128))
    lens = torch.tensor([3], dtype=torch.int32)
    sl = tlayers.alibi_slopes(4)
    pool = torch.from_numpy(_normal(rng, 1, 2, 2, 4, 16, 128))
    tables = torch.tensor([[1]], dtype=torch.int32)
    paged = tda.flash_decode_paged(q, kn, kn, pool, tables, 0, lens, slopes=sl)
    torch.testing.assert_close(paged, tda.flash_decode_plain(
        q, kn, kn, pool[0][:, 1:2], lens, max_length=3, slopes=sl), rtol=0, atol=0)
    assert not torch.equal(paged, tda.flash_decode_paged(q, kn, kn, pool, tables, 0, lens))
    codes = torch.from_numpy(rng.integers(-127, 128, (2, 1, 4, 16, 128)).astype(np.int8))
    scales = torch.from_numpy(rng.uniform(0.01, 0.02, (2, 1, 4, 16)).astype(np.float32))
    k9 = tda.flash_decode_int8(q, kn, kn, codes, scales, lens, slopes=sl)
    ref = tda.flash_decode_plain(q, kn, kn, codes.float() * scales[..., None], lens,
                                 slopes=sl)
    torch.testing.assert_close(k9, ref, rtol=0, atol=1e-5)
    assert not torch.equal(k9, tda.flash_decode_int8(q, kn, kn, codes, scales, lens))
    for what in ("flash_decode", "flash_decode_paged", "flash_decode_int8"):
        tda._check_decode_group(what, 32, 1, True)
        tda._check_decode_group(what, 71, 1, False)
        with pytest.raises(NotImplementedError, match="item 12"):
            tda._check_decode_group(what, 64, 1, True)
        with pytest.raises(NotImplementedError, match="item 12"):
            tda._check_decode_group(what, 129, 1, False)


# ---- on the card: each ALiBi mode against its plain version ---------------

# the split decode's and K3's bounds without slopes (2^-6 of the largest
# output: bf16 rounding of q halves, P and the output), kept with them
CARD_TOL = 2.0 ** -6


def _dev(dev, g, dtype, *shape):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("nq,nkv,lengths", [(32, 32, [1000]), (12, 12, [0, 37, 700]),
                                            (8, 2, [4000, 5])])
def test_flash_decode_slopes_match_plain_on_card(cuda, dtype, nq, nkv, lengths):
    g = torch.Generator(device=cuda).manual_seed(nq + len(lengths))
    b, t = len(lengths), 4096
    q, kn, vn = (_dev(cuda, g, dtype, b, n, 128) for n in (nq, nkv, nkv))
    cache = _dev(cuda, g, dtype, 2, b, nkv, t, 128)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    sl = tlayers.alibi_slopes(nq, device=cuda)
    got = tda.flash_decode(q, kn, vn, cache, lens, slopes=sl)
    ref = tda.flash_decode_plain(q, kn, vn, cache, lens, slopes=sl)
    torch.cuda.synchronize()
    _close(got.cpu(), ref.cpu(), CARD_TOL)
    # zero slopes add nothing: the bits of the launch without them
    zero = torch.zeros_like(sl)
    assert torch.equal(tda.flash_decode(q, kn, vn, cache, lens, slopes=zero),
                       tda.flash_decode(q, kn, vn, cache, lens))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq,nkv,hd", [(32, 32, 128), (16, 16, 64), (12, 12, 64)])
@pytest.mark.parametrize("start,s", [(0, 512), (700, 77)])
def test_flash_prefill_slopes_match_plain_on_card(cuda, dtype, nq, nkv, hd, start, s):
    g = torch.Generator(device=cuda).manual_seed(nq + start)
    q = _dev(cuda, g, dtype, 1, s, nq, hd)
    cache = _dev(cuda, g, dtype, 2, 1, nkv, 2048, hd)
    sl = tlayers.alibi_slopes(nq, device=cuda)
    got = tda.flash_prefill(q, cache, start, slopes=sl)
    ref = tda.flash_prefill_plain(q, cache, start, slopes=sl)
    torch.cuda.synchronize()
    _close(got.cpu(), ref.cpu(), CARD_TOL)
    assert torch.equal(tda.flash_prefill(q, cache, start, slopes=torch.zeros_like(sl)),
                       tda.flash_prefill(q, cache, start))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq,nkv,hd", [(16, 16, 64), (12, 12, 64), (32, 32, 128)])
@pytest.mark.parametrize("length", [1, 700, 2047])
def test_flash_decode_layer_slopes_match_plain_on_card(cuda, dtype, nq, nkv, hd, length):
    g = torch.Generator(device=cuda).manual_seed(nq + length)
    q = _dev(cuda, g, dtype, 1, nq, hd)
    k, v = (_dev(cuda, g, dtype, 1, nkv, 2048, hd) for _ in range(2))
    sl = tlayers.alibi_slopes(nq, device=cuda)
    got = tda.flash_decode_layer(q, k, v, length, slopes=sl)
    ref = tda.flash_decode_layer_plain(q, k, v, length, slopes=sl)
    # the length read in device memory, the grid planned for a bound: the
    # kernel splits by the length it reads, so the bits are those of the
    # host launch planned for the length
    n_dev = torch.tensor([length], dtype=torch.int32, device=cuda)
    assert torch.equal(tda.flash_decode_layer(q, k, v, n_dev, 2047, slopes=sl), got)
    torch.cuda.synchronize()
    _close(got.cpu(), ref.cpu(), CARD_TOL)
    assert torch.equal(tda.flash_decode_layer(q, k, v, length, slopes=torch.zeros_like(sl)),
                       tda.flash_decode_layer(q, k, v, length))


@pytest.mark.cuda
def test_alibi_attention_launches_k14_or_raises_on_the_card(cuda):
    """No ALiBi step on a CUDA tensor reaches ``layers.attention``'s masked
    path: at S = 1 it launches K14's ALiBi mode, and a chunk or a bias
    raises."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = _dev(cuda, g, torch.bfloat16, 1, 1, 16, 64)
    k, v = (_dev(cuda, g, torch.bfloat16, 1, 16, 512, 64) for _ in range(2))
    sl = tlayers.alibi_slopes(16, device=cuda)
    before = dict(tda.LAUNCHES)
    out = tlayers.attention(q, k, v, 99, slopes=sl)
    assert tda.LAUNCHES["flash_decode_layer_alibi"] == before["flash_decode_layer_alibi"] + 1
    ref = tda.flash_decode_layer_plain(q[:, 0], k, v, 100, slopes=sl)
    _close(out.reshape(1, 16, 64).cpu(), ref.cpu(), CARD_TOL)
    q2 = _dev(cuda, g, torch.bfloat16, 1, 4, 16, 64)
    with pytest.raises(NotImplementedError, match="masked path"):
        tlayers.attention(q2, k, v, 99, slopes=sl)
    with pytest.raises(NotImplementedError, match="masked path"):
        tlayers.attention(q, k, v, 99, bias=torch.zeros((16, 1, 512), device=cuda))
