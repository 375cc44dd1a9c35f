"""Port parity: flash decode (K2) and causal flash prefill (K3).

On the CPU the wrappers run their plain versions, held here to the JAX
package's Pallas kernels run in interpret mode on the same numpy inputs.
The tests marked ``cuda`` hold the CUDA kernels to the plain versions on
a card and skip without one. The JAX side is imported inside the tests
that use it, so that the card's tests run where JAX is not installed
(``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

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


# f32 throughout on both sides: the Pallas decode kernel's online softmax
# and the plain version's one-pass softmax differ only in f32 rounding.
@pytest.mark.parametrize("nkv", [2, 1])
def test_flash_decode_plain_matches_pallas(nkv):
    import jax.numpy as jnp
    from awq_tpu.ops import decode_attn as jda

    L, b, nq, t, hd = 2, 3, 4, 256, 128
    rng = np.random.default_rng(nkv)
    cache = _normal(rng, L, 2, b, nkv, t, hd)
    q = _normal(rng, b, nq, hd)
    k_new, v_new = _normal(rng, b, nkv, hd), _normal(rng, b, nkv, hd)
    lengths = np.array([0, 37, 256], np.int32)     # a row with an empty prefix
    layer = 1
    ref = np.asarray(jda.flash_decode_stacked(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(cache), jnp.int32(layer), jnp.asarray(lengths),
        interpret=True))
    got = tda.flash_decode(torch.from_numpy(q), torch.from_numpy(k_new),
                           torch.from_numpy(v_new),
                           torch.from_numpy(cache)[layer],
                           torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_flash_decode_ignores_positions_past_length():
    rng = np.random.default_rng(4)
    cache = torch.from_numpy(_normal(rng, 2, 1, 2, 64, 128))
    q = torch.from_numpy(_normal(rng, 1, 4, 128))
    kn, vn = (torch.from_numpy(_normal(rng, 1, 2, 128)) for _ in range(2))
    lengths = torch.tensor([20], dtype=torch.int32)
    a = tda.flash_decode(q, kn, vn, cache, lengths)
    poisoned = cache.clone()
    poisoned[:, :, :, 20:] = 1e9
    b = tda.flash_decode(q, kn, vn, poisoned, lengths)
    assert torch.equal(a, b)


# The Pallas prefill kernel takes its dots in bf16 (q pre-scaled and
# rounded, k, v and the probabilities rounded): against the f32 plain
# version the outputs, weighted means of unit-normal values, agree to
# about 1e-2. The plain version is also held to layers.attention, the
# JAX package's f32 masked reference, to f32 rounding.
@pytest.mark.parametrize("start_pos,s", [(0, 40), (37, 40), (100, 19)])
@pytest.mark.parametrize("nkv", [2, 1])
def test_flash_prefill_plain_matches_pallas(start_pos, s, nkv):
    import jax.numpy as jnp
    from awq_tpu.models import layers as jlayers
    from awq_tpu.ops import decode_attn as jda

    L, b, nq, t, hd = 2, 2, 4, 256, 128
    rng = np.random.default_rng(start_pos + s + nkv)
    cache = _normal(rng, L, 2, b, nkv, t, hd)
    q = _normal(rng, b, s, nq, hd)
    layer = 0
    ref = np.asarray(jda.flash_prefill_stacked(
        jnp.asarray(q), jnp.asarray(cache), jnp.int32(layer),
        jnp.int32(start_pos), block_q=16, interpret=True, fixed_max=None))
    got = tda.flash_prefill(torch.from_numpy(q), torch.from_numpy(cache)[layer],
                            start_pos).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    exact = np.asarray(jlayers.attention(
        jnp.asarray(q), jnp.asarray(cache[layer, 0]), jnp.asarray(cache[layer, 1]),
        jnp.int32(start_pos)))
    np.testing.assert_allclose(got, exact, atol=2e-5, rtol=2e-5)


def test_wrappers_take_plain_versions_on_cpu():
    rng = np.random.default_rng(8)
    cache = torch.from_numpy(_normal(rng, 2, 1, 2, 64, 128))
    q1 = torch.from_numpy(_normal(rng, 1, 4, 128))
    kn, vn = (torch.from_numpy(_normal(rng, 1, 2, 128)) for _ in range(2))
    lengths = torch.tensor([9], dtype=torch.int32)
    qs = torch.from_numpy(_normal(rng, 1, 5, 4, 128))
    before = dict(tda.LAUNCHES)
    assert torch.equal(tda.flash_decode(q1, kn, vn, cache, lengths),
                       tda.flash_decode_plain(q1, kn, vn, cache, lengths))
    assert torch.equal(tda.flash_prefill(qs, cache, 3),
                       tda.flash_prefill_plain(qs, cache, 3))
    assert tda.LAUNCHES == before


# ---- on the card: the CUDA kernels against the plain versions -------------
# bf16 inputs and output. Tolerance 2^-6 of the output's largest magnitude:
# bf16 output rounding is 2^-9 relative; K3 also rounds the probabilities
# to bf16 for its P·V product, and sums run in other orders.

def _bf16(dev, rng, *shape):
    return torch.from_numpy(_normal(rng, *shape)).to(torch.bfloat16).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv,lengths", [
    (4, 2, [0, 1, 37]), (32, 8, [1]), (32, 8, [1000]), (32, 8, [4000]), (8, 1, [5, 300]),
    # 8 rows as the batched engine has them: the cluster is sized from the
    # longest, so the short rows leave blocks with no position to merge
    (32, 8, [1000, 0, 930, 3, 4000, 850, 64, 977]), (32, 8, [1, 0, 2047, 256])])
def test_flash_decode_kernel_matches_plain(cuda, nq, nkv, lengths):
    rng = np.random.default_rng(len(lengths) * nq)
    b, t = len(lengths), 4096
    cache = _bf16(cuda, rng, 2, b, nkv, t, 128)
    q = _bf16(cuda, rng, b, nq, 128)
    kn, vn = _bf16(cuda, rng, b, nkv, 128), _bf16(cuda, rng, b, nkv, 128)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = tda.LAUNCHES["flash_decode"]
    got = tda.flash_decode(q, kn, vn, cache, lens)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode"] == before + 1
    ref = tda.flash_decode_plain(q, kn, vn, cache, lens)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -6 * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv,start_pos,s", [
    (4, 2, 0, 70), (4, 1, 37, 130), (32, 8, 0, 512), (32, 8, 700, 512), (32, 8, 0, 1000)])
def test_flash_prefill_kernel_matches_plain(cuda, nq, nkv, start_pos, s):
    rng = np.random.default_rng(start_pos + s)
    b, t = 2, 2048
    cache = _bf16(cuda, rng, 2, b, nkv, t, 128)
    q = _bf16(cuda, rng, b, s, nq, 128)
    before = tda.LAUNCHES["flash_prefill"]
    got = tda.flash_prefill(q, cache, start_pos)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_prefill"] == before + 1
    ref = tda.flash_prefill_plain(q, cache, start_pos)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -6 * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("page", [256, 64, 16])
def test_k8_equals_k2_bit_for_bit_on_the_card(cuda, page):
    """K8 over a permuted pool returns K2's output on the same rows bit for
    bit: the plans slice the rows alike (``K2_UNIT``) and the paged functor
    changes addresses only."""
    rng = np.random.default_rng(page)
    lengths = [1000, 0, 930, 1100, 1015, 850, 1200, 977]
    b, nq, nkv, hd, mp = len(lengths), 32, 8, 128, 1280 // page
    cache = _bf16(cuda, rng, 2, b, nkv, mp * page, hd)
    q = _bf16(cuda, rng, b, nq, hd)
    kn, vn = _bf16(cuda, rng, b, nkv, hd), _bf16(cuda, rng, b, nkv, hd)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    perm = torch.from_numpy(rng.permutation(b * mp) + 1).to(cuda)
    tables = perm.reshape(b, mp).to(torch.int32)
    pool = torch.zeros((1, 2, 1 + b * mp, nkv, page, hd), dtype=torch.bfloat16, device=cuda)
    pool[0][:, tables.long()] = cache.reshape(2, b, nkv, mp, page, hd).permute(0, 1, 3, 2, 4, 5)
    got = tda.flash_decode_paged(q, kn, vn, pool, tables, 0, lens, max_length=max(lengths))
    ref = tda.flash_decode(q, kn, vn, cache, lens, max_length=max(lengths))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_each_decode_call_is_one_launch(cuda):
    """K2, K8, K9 and K14: one kernel on the card a call (no combine, no
    partial buffers), counted by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from awq_tpu_torch.ops.cache_append import quantize_kv

    rng = np.random.default_rng(12)
    b, nq, nkv, hd, t = 2, 32, 8, 128, 512
    cache = _bf16(cuda, rng, 2, b, nkv, t, hd)
    q, kn, vn = _bf16(cuda, rng, b, nq, hd), _bf16(cuda, rng, b, nkv, hd), _bf16(cuda, rng, b, nkv, hd)
    lens = torch.tensor([300, 0], dtype=torch.int32, device=cuda)
    codes, scales = quantize_kv(cache.float())
    tables = torch.arange(1, 1 + b * 2, dtype=torch.int32, device=cuda).reshape(b, 2)
    pool = torch.zeros((1, 2, 1 + b * 2, nkv, 256, hd), dtype=torch.bfloat16, device=cuda)
    qf = _bf16(cuda, rng, 1, 71, 64)
    kvf = _bf16(cuda, rng, 2, 1, 1, 1024, 64)
    calls = {"flash_decode": lambda: tda.flash_decode(q, kn, vn, cache, lens, max_length=300),
             "flash_decode_paged": lambda: tda.flash_decode_paged(q, kn, vn, pool, tables, 0,
                                                                  lens, max_length=300),
             "flash_decode_int8": lambda: tda.flash_decode_int8(q, kn, vn, codes, scales, lens,
                                                                max_length=300),
             "flash_decode_layer": lambda: tda.flash_decode_layer(qf, kvf[0], kvf[1], 1000)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        before = tda.LAUNCHES[name]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(kernels) == 1 and "flash_decode_kernel" in kernels[0], (name, kernels)
        assert tda.LAUNCHES[name] == before + 1


@pytest.mark.cuda
def test_stale_positions_past_the_length_do_not_leak_on_the_card(cuda):
    """A block's first tile is copied before the row's length is known, so
    positions past it are read: NaN there (K, V and K9's scales) must not
    reach the output of K2, K8 or K9."""
    from awq_tpu_torch.ops.cache_append import quantize_kv

    rng = np.random.default_rng(13)
    lengths = [5, 0, 63, 64, 65, 300]
    b, nq, nkv, hd, t = len(lengths), 32, 8, 128, 512
    clean = _bf16(cuda, rng, 2, b, nkv, t, hd)
    q = _bf16(cuda, rng, b, nq, hd)
    kn, vn = _bf16(cuda, rng, b, nkv, hd), _bf16(cuda, rng, b, nkv, hd)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    past = torch.arange(t, device=cuda)[None, :] >= lens[:, None]        # [b, t]
    dirty = clean.masked_fill(past[None, :, None, :, None], float("nan"))
    ref = tda.flash_decode_plain(q, kn, vn, clean, lens)
    got = tda.flash_decode(q, kn, vn, dirty, lens)
    tables = torch.arange(1, 1 + b * 2, dtype=torch.int32, device=cuda).reshape(b, 2)
    pool = torch.full((1, 2, 1 + b * 2, nkv, 256, hd), float("nan"), dtype=torch.bfloat16,
                      device=cuda)
    pool[0][:, tables.long()] = dirty.reshape(2, b, nkv, 2, 256, hd).permute(0, 1, 3, 2, 4, 5)
    got8 = tda.flash_decode_paged(q, kn, vn, pool, tables, 0, lens)
    codes, scales = quantize_kv(clean.float())
    ref9 = tda.flash_decode_int8_plain(q, kn, vn, codes, scales, lens)
    got9 = tda.flash_decode_int8(q, kn, vn, codes, scales.masked_fill(past[None, :, None], float("nan")),
                                 lens)
    torch.cuda.synchronize()
    for out, want in ((got, ref), (got8, ref), (got9, ref9)):
        assert bool(out.float().isfinite().all())
        err = (out.float() - want.float()).abs().max().item()
        assert err <= 2 ** -6 * want.float().abs().max().item(), err
