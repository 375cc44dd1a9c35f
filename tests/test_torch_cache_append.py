"""Port parity of the batched KV append (K7, ``ops/cache_append.py``): the
plain version against the JAX Pallas kernel, which runs in interpret mode
on the CPU, bit for bit; the wrapper's checks; and, on a card, the CUDA
kernel against the plain version, bit for bit.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import cache_append as tca

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, L, B, nkv, T, hd):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((L, 2, B, nkv, T, hd)).astype(np.float32)
    kv = rng.standard_normal((L, 2, B, nkv, hd)).astype(np.float32)
    return cache, kv


def _expected(cache, kv, lengths):
    want = cache.copy()
    for b, n in enumerate(lengths):
        want[:, :, b, :, n] = kv[:, :, b]
    return want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [[0, 31, 7, 16], [31, 31, 0, 0], [5, 6, 7, 8]])
def test_plain_append_matches_jax_kernel(lengths, dtype):
    """Exact: a scatter has no arithmetic. Lengths include 0 and T-1."""
    import jax.numpy as jnp
    from awq_tpu.ops.cache_append import batched_cache_append

    L, B, nkv, T, hd = 2, 4, 2, 32, 128
    cache, kv = _inputs(sum(lengths), L, B, nkv, T, hd)
    jdt = getattr(jnp, dtype)
    jout = batched_cache_append(jnp.asarray(cache).astype(jdt),
                                jnp.asarray(kv).astype(jdt),
                                jnp.asarray(lengths, jnp.int32))
    tdt = getattr(torch, dtype)
    tcache = torch.from_numpy(cache.copy()).to(tdt)
    out = tca.batched_cache_append(tcache, torch.from_numpy(kv).to(tdt),
                                   torch.tensor(lengths, dtype=torch.int32))
    assert out is tcache                       # in place
    got = tcache.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(jout.astype(jnp.float32)))
    want = torch.from_numpy(_expected(cache, kv, lengths)).to(tdt).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lengths,where", [([40, 2], [31, 2]), ([-3, 32], [0, 31])])
def test_plain_append_clamps_lengths(lengths, where):
    """A length at or past T lands on T-1, as the JAX wrapper clamps; a
    negative one on 0. Nothing else is touched."""
    cache, kv = _inputs(1, 2, 2, 2, 32, 16)
    tcache = torch.from_numpy(cache.copy())
    tca.batched_cache_append_plain(tcache, torch.from_numpy(kv),
                                   torch.tensor(lengths, dtype=torch.int32))
    np.testing.assert_array_equal(tcache.numpy(), _expected(cache, kv, where))


def test_append_counts_launches_only_on_the_card():
    cache, kv = _inputs(2, 1, 2, 1, 8, 16)
    before = dict(tca.LAUNCHES)
    tca.batched_cache_append(torch.from_numpy(cache), torch.from_numpy(kv),
                             torch.tensor([1, 2], dtype=torch.int32))
    tca.batched_cache_append(torch.from_numpy(cache), torch.from_numpy(kv),
                             torch.tensor([1, 2], dtype=torch.int32),
                             torch.tensor([[0], [1]], dtype=torch.int32))
    q, sc = tca.quantize_kv(torch.from_numpy(cache))
    tca.batched_cache_append_int8(q, sc, torch.from_numpy(kv),
                                  torch.tensor([1, 2], dtype=torch.int32))
    assert tca.LAUNCHES == before
    assert set(before) == {"cache_append", "cache_append_paged", "cache_append_int8"}


# ---- on the card: K7 against its plain version --------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lengths", [[0, 255, 7, 16, 100, 3, 254, 9], [300, -1, 0, 0, 5, 5, 5, 5]])
def test_append_kernel_matches_plain_on_card(cuda, lengths, dtype):
    L, B, nkv, T, hd = 3, 8, 2, 256, 128
    cache, kv = _inputs(sum(lengths) + 1000, L, B, nkv, T, hd)
    c1 = torch.from_numpy(cache).to(device=cuda, dtype=dtype)
    c2 = c1.clone()
    kvt = torch.from_numpy(kv).to(device=cuda, dtype=dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n0 = tca.LAUNCHES["cache_append"]
    tca.batched_cache_append(c1, kvt, lens)
    tca.batched_cache_append_plain(c2, kvt, lens)
    torch.cuda.synchronize()
    assert tca.LAUNCHES["cache_append"] == n0 + 1
    assert torch.equal(c1, c2)


@pytest.mark.cuda
def test_append_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    cache = torch.zeros((2, 2, 2, 2, 16, 128), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((2, 2, 2, 2, 128), dtype=torch.bfloat16, device=cuda)
    lens = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        tca.batched_cache_append(cache, kv, lens.long())
    with pytest.raises(ValueError, match="kv must be"):
        tca.batched_cache_append(cache, kv[:, :, :1], lens)
    with pytest.raises(ValueError, match="contiguous"):
        tca.batched_cache_append(cache[:, :, :, :, ::2], kv, lens)
    with pytest.raises(ValueError, match="kv is"):
        tca.batched_cache_append(cache, kv.float(), lens)
