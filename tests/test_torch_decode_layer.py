"""Port parity: single-layer flash decode (K14, ``flash_decode_layer``), the
counterpart of JAX's ``flash_decode`` (``awq_tpu/ops/decode_attn.py``), and
``layers.attention``'s S = 1 step that dispatches to it on the card; K3
(flash prefill) at head_dim 64.

On the CPU the plain version is held to JAX's Pallas kernel run in
interpret mode, over JAX's own grid of shapes (``tests/test_decode_attn.py``)
plus falcon-7b's group (71 query heads over one kv head), at head_dim 64
and 128. The tests marked ``cuda`` hold the CUDA kernels to the plain
versions on a card and skip without one; the JAX side is imported inside
the tests that use it (``pytest --noconftest -m cuda`` runs without JAX).
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


# f32 on both sides: the Pallas kernel's online softmax over 256-position
# blocks and the plain version's one-pass softmax differ in f32 rounding
# only (JAX's own test holds its kernel to a masked reference at 2e-5).
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("n_q,n_kv", [(8, 8), (8, 4), (8, 1), (71, 1)])
def test_flash_decode_layer_plain_matches_pallas(n_q, n_kv, hd):
    import jax.numpy as jnp
    from awq_tpu.ops import decode_attn as jda

    b, t = 2, 512
    rng = np.random.default_rng(n_q + n_kv + hd)
    q = _normal(rng, b, n_q, hd)
    k, v = _normal(rng, b, n_kv, t, hd), _normal(rng, b, n_kv, t, hd)
    for length in (1, 255, 256, 300, 512):
        ref = np.asarray(jda.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.int32(length), interpret=True))
        got = tda.flash_decode_layer(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), length)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_flash_decode_layer_ignores_stale_cache_suffix():
    """Positions >= length must not affect the result."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_normal(rng, 1, 4, 64))
    k, v = (torch.from_numpy(_normal(rng, 1, 4, 256, 64)) for _ in range(2))
    a = tda.flash_decode_layer(q, k, v, 100)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:], v2[:, :, 100:] = 1e9, -1e9
    assert torch.equal(a, tda.flash_decode_layer(q, k2, v2, 100))


@pytest.mark.parametrize("n_q,n_kv,hd", [(8, 4, 64), (71, 1, 64), (8, 2, 128)])
def test_attention_decode_step_matches_jax(n_q, n_kv, hd):
    """``layers.attention`` at S = 1 (K14's plain version on the CPU)
    against JAX's ``attention`` (its masked path on the CPU) and against
    K14's plain version over ``[0, start_pos + 1)``."""
    import jax.numpy as jnp
    from awq_tpu.models import layers as jlayers

    rng = np.random.default_rng(n_q + hd)
    b, t, start = 1, 256, 99
    q = _normal(rng, b, 1, n_q, hd)
    k, v = _normal(rng, b, n_kv, t, hd), _normal(rng, b, n_kv, t, hd)
    ref = np.asarray(jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.int32(start)))
    got = tlayers.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            start)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)
    plain = tda.flash_decode_layer_plain(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                                         torch.from_numpy(v), start + 1)
    np.testing.assert_allclose(plain.reshape(b, 1, -1).numpy(), ref, atol=2e-5, rtol=2e-5)


def test_gates_of_k2_and_k14():
    f32, bf16 = torch.float32, torch.bfloat16
    assert tda.flash_decode_supported(32, 8, 128, bf16)
    assert not tda.flash_decode_supported(71, 1, 64, bf16)      # falcon-7b
    assert not tda.flash_decode_supported(64, 1, 128, bf16)     # 64 heads a kv head
    assert not tda.flash_decode_supported(32, 1, 128, f32)      # f32 tile: 16
    tda._check_layer("K14", 71, 1, 64, bf16, bf16, bf16)                # falcon-7b
    tda._check_layer("K14", 128, 1, 128, f32, f32, f32)
    with pytest.raises(NotImplementedError, match="item 12"):
        tda._check_layer("K14", 129, 1, 64, bf16, bf16, bf16)
    with pytest.raises(NotImplementedError, match="item 12"):
        tda._check_layer("K14", 8, 1, 96, bf16, bf16, bf16)
    with pytest.raises(ValueError, match="one dtype"):
        tda._check_layer("K14", 8, 1, 64, bf16, bf16, f32)


def test_only_k3_and_k14_take_head_dim_64():
    """The helper's default is the unit ``decode_attn``'s head_dim (128);
    every decode and prefill wrapper passes ``HEAD_DIMS``, so K2, K8 and K9
    take head_dim 64 as K3 and K14 do (their new modes live in the unit
    ``decode_attn_wide``), and another head_dim raises naming A12 (the
    checks the wrappers run on a CUDA tensor)."""
    q = torch.zeros((1, 8, 64))
    cache = torch.zeros((2, 1, 1, 32, 64))
    with pytest.raises(NotImplementedError, match="item 12"):
        tda._check_common("flash_decode", q, cache)
    with pytest.raises(NotImplementedError, match="item 12"):
        tda._check_head_dim("flash_decode_int8", 64)
    for what in ("flash_decode", "flash_decode_paged", "flash_prefill"):
        tda._check_common(what, q, cache, tda.HEAD_DIMS)
    tda._check_head_dim("flash_decode_int8", 64, tda.HEAD_DIMS)
    with pytest.raises(NotImplementedError, match="item 12"):
        tda._check_common("flash_prefill", torch.zeros((1, 8, 96)),
                          torch.zeros((2, 1, 1, 32, 96)), tda.HEAD_DIMS)


def test_wrappers_take_plain_versions_on_cpu():
    rng = np.random.default_rng(8)
    q = torch.from_numpy(_normal(rng, 1, 71, 64))
    k, v = (torch.from_numpy(_normal(rng, 1, 1, 64, 64)) for _ in range(2))
    qs = torch.from_numpy(_normal(rng, 1, 5, 71, 64))
    cache = torch.stack([k, v])
    before = dict(tda.LAUNCHES)
    assert torch.equal(tda.flash_decode_layer(q, k, v, 9),
                       tda.flash_decode_layer_plain(q, k, v, 9))
    assert torch.equal(tda.flash_prefill(qs, cache, 3), tda.flash_prefill_plain(qs, cache, 3))
    assert tda.LAUNCHES == before


# ---- on the card: the CUDA kernels against the plain versions -------------
# bf16 inputs and output. Tolerance 2^-6 of the output's largest magnitude:
# bf16 output rounding is 2^-9 relative; K3 also rounds the probabilities
# to bf16 for its P.V product, and sums run in other orders.

def _dev(dev, rng, dtype, *shape):
    return torch.from_numpy(_normal(rng, *shape)).to(dtype).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b,nq,nkv,hd,lengths", [
    (1, 71, 1, 64, (1, 1000, 2047)), (1, 32, 8, 128, (1, 1000, 4000)),
    (8, 32, 8, 128, (1000,)), (2, 128, 1, 128, (1, 300)), (3, 12, 4, 64, (37, 256)),
    (4, 71, 1, 64, (1, 2047))])
def test_flash_decode_layer_kernel_matches_plain(cuda, dtype, b, nq, nkv, hd, lengths):
    rng = np.random.default_rng(nq + hd + b)
    t = 4096
    q = _dev(cuda, rng, dtype, b, nq, hd)
    k, v = _dev(cuda, rng, dtype, b, nkv, t, hd), _dev(cuda, rng, dtype, b, nkv, t, hd)
    for length in lengths:
        before = tda.LAUNCHES["flash_decode_layer"]
        got = tda.flash_decode_layer(q, k, v, length)
        torch.cuda.synchronize()
        assert tda.LAUNCHES["flash_decode_layer"] == before + 1
        ref = tda.flash_decode_layer_plain(q, k, v, length)
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2 ** -6 * ref.float().abs().max().item(), (length, err)


@pytest.mark.cuda
def test_k2_k8_k9_raise_on_head_dim_64_on_the_card(cuda):
    """K2, K8 and K9 take head_dim 64 (``tests/test_torch_family_*.py`` hold
    those modes to their plain versions); a head_dim of 96 raises naming A12
    in each wrapper, and nothing launches."""
    rng = np.random.default_rng(1)
    q = _dev(cuda, rng, torch.bfloat16, 1, 8, 96)
    kn = _dev(cuda, rng, torch.bfloat16, 1, 1, 96)
    cache = _dev(cuda, rng, torch.bfloat16, 2, 1, 1, 256, 96)
    lens = torch.tensor([10], dtype=torch.int32, device=cuda)
    before = dict(tda.LAUNCHES)
    with pytest.raises(NotImplementedError, match="item 12"):
        tda.flash_decode(q, kn, kn, cache, lens)
    with pytest.raises(NotImplementedError, match="item 12"):
        tda.flash_decode_paged(q, kn, kn, cache[None], torch.zeros(
            (1, 1), dtype=torch.int32, device=cuda), 0, lens)
    with pytest.raises(NotImplementedError, match="item 12"):
        tda.flash_decode_int8(q, kn, kn, cache.to(torch.int8), torch.ones(
            (2, 1, 1, 256), device=cuda), lens)
    assert tda.LAUNCHES == before


@pytest.mark.cuda
def test_attention_launches_k14_on_the_card(cuda):
    rng = np.random.default_rng(2)
    q = _dev(cuda, rng, torch.bfloat16, 1, 1, 71, 64)
    kv = _dev(cuda, rng, torch.bfloat16, 2, 1, 1, 512, 64)
    before = tda.LAUNCHES["flash_decode_layer"]
    got = tlayers.attention(q, kv[0], kv[1], 300)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_layer"] == before + 1
    ref = tda.flash_decode_layer_plain(q[:, 0], kv[0], kv[1], 301).reshape(1, 1, -1)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -6 * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_llama_head_dim_96_decode_raises_on_the_card(cuda):
    """A llama model at a head_dim that neither K2 nor K14 takes: its S = 1
    step fails K2's gate, falls back to ``layers.attention``, and K14
    raises naming A12; the plain version never attends on the card."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama

    cfg = ModelConfig(arch="llama", vocab_size=256, hidden_size=384, intermediate_size=768,
                      num_layers=1, num_heads=4, num_kv_heads=2, head_dim=96,
                      max_position_embeddings=64)
    params = llama.fuse_linears(llama.init_qparams(
        cfg, QuantConfig(w_bit=4, group_size=128), torch.Generator(device=cuda).manual_seed(0),
        device=cuda), cfg)
    cache = llama.init_cache(cfg, 1, 64, device=cuda)
    before = tda.LAUNCHES["flash_decode_layer"]
    with pytest.raises(NotImplementedError, match="item 12"):
        llama.forward(params, cfg, torch.tensor([[5]], device=cuda), cache, 3)
    assert tda.LAUNCHES["flash_decode_layer"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv,start_pos,s", [
    (71, 1, 0, 512), (71, 1, 700, 512), (4, 2, 37, 130), (12, 4, 0, 70), (71, 1, 0, 1000)])
def test_flash_prefill_head_dim_64_kernel_matches_plain(cuda, nq, nkv, start_pos, s):
    rng = np.random.default_rng(start_pos + s + nq)
    b, t = 1, 2048
    cache = _dev(cuda, rng, torch.bfloat16, 2, b, nkv, t, 64)
    q = _dev(cuda, rng, torch.bfloat16, b, s, nq, 64)
    before = tda.LAUNCHES["flash_prefill"]
    got = tda.flash_prefill(q, cache, start_pos)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_prefill"] == before + 1
    ref = tda.flash_prefill_plain(q, cache, start_pos)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -6 * ref.float().abs().max().item(), err
