"""The port beyond bf16 activations and 64-multiple groups: K1 over f32,
bf16 and f16 ``x`` and any group size (the whole IC included), K2, K3, K8
and K9 over f32, bf16 and f16 q and caches, an f16 model on the stacked
path against JAX's ``forward``, and ``init_qparams`` with
``group_size=-1``.

The JAX kernels follow the model dtype (``out_dtype=x.dtype``,
``awq_tpu/ops/w4a16.py:422-427``; ``q.dtype``,
``awq_tpu/ops/decode_attn.py:479``), so an f16 or f32 model runs on every
path there. Tests marked ``cuda`` hold each kernel to its plain version on
a card, per dtype, and skip here; the JAX side is imported inside the CPU
tests so that the card's tests run where JAX is not installed.
"""

import math

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import decode_attn as tda
from awq_tpu_torch.ops import w4a16 as tw

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

DTYPES = ["bfloat16", "float16", "float32"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


GEOM = dict(arch="llama", vocab_size=256, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128,
            max_position_embeddings=256, dtype="float16")


def test_f16_model_prefills_40_tokens_on_the_stacked_path(monkeypatch):
    """A ``dtype="float16"`` model with an f16 cache: a 40-token prompt
    (over K5's 32) and one decode step through ``forward`` with the
    megakernels off, against JAX ``forward`` in f16. Both round every
    activation and weight to f16 at the same points and sum in f32; a
    value on an f16 rounding edge (2^-11 relative) can round the other way
    and move what follows: 1e-2 of the largest logit covers it."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama
    from awq_tpu_torch.config import ModelConfig as TConfig
    from awq_tpu_torch.convert import params_from_jax
    from awq_tpu_torch.models import llama as tllama

    monkeypatch.setenv("AWQ_TPU_DISABLE_MEGAKERNEL", "1")
    jcfg, tcfg = JConfig(**GEOM), TConfig(**GEOM)
    jparams = jllama.quantize_params(jllama.init_params(jcfg, jax.random.PRNGKey(4)),
                                     JQuant(w_bit=4, group_size=128))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    assert tparams["embed"].dtype == torch.float16
    toks = np.random.default_rng(2).integers(0, GEOM["vocab_size"], (1, 41))
    jcache = jllama.init_kv_cache(jcfg, 1, 64, jnp.float16)
    tcache = tllama.init_kv_cache(tcfg, 1, 64, torch.float16, device="cpu")
    for lo, hi in ((0, 40), (40, 41)):
        jl, jcache = jllama.forward(jparams, jcfg, jnp.asarray(toks[:, lo:hi]), jcache, lo)
        tl, _ = tllama.forward(tparams, tcfg, torch.from_numpy(toks[:, lo:hi]), tcache, lo)
        jl = np.asarray(jl, np.float32)
        assert np.isfinite(tl.numpy()).all()
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-2 * np.abs(jl).max())


@pytest.mark.parametrize("w_bit", [4, 3])
def test_init_qparams_whole_ic_groups(w_bit):
    """``group_size=-1`` is one group over each linear's own IC, as
    ``quantize_linear`` takes it, also for ``down`` whose IC (the
    intermediate size, 768) is no multiple of the hidden size (512)."""
    from awq_tpu_torch.config import ModelConfig, QuantConfig
    from awq_tpu_torch.models import llama as tllama

    cfg = ModelConfig(arch="llama", vocab_size=64, hidden_size=512,
                      intermediate_size=768, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=128, dtype="float32")
    params = tllama.init_qparams(cfg, QuantConfig(w_bit=w_bit, group_size=-1),
                                 device="cpu")
    for name, p in params["layers"].items():
        if not isinstance(p, tw.QLinear):
            continue
        ic = p.in_features
        ref = tw.quantize_linear(torch.zeros((ic, 8)), n_bit=w_bit, group_size=-1)
        assert p.group_size == ref.group_size == ic, name
        assert p.scales.shape[1:] == (1, p.out_features), name
        assert p.dense3 == ref.dense3 == (w_bit == 3 and ic % 256 == 0), name
        assert p.qweight.shape[1] == ref.qweight.shape[0], name
    assert params["layers"]["down"].in_features == 768
    x = torch.randn(3, 768)
    out = tw.qlinear_apply_stacked(params["layers"]["down"], 1, x)
    assert out.shape == (3, 512) and torch.isfinite(out).all()


# ---- on the card: each kernel against its plain version, per dtype -------
# K1: 2^-6 of the output's largest magnitude for bf16 and f16 (the output
# is rounded to x's dtype and the plain version rounds each dequantized
# weight to it); f32: the GEMV computes in f32 (1e-5), the GEMM rounds x
# and the weights to bf16 for mma.sync (2^-6). K2/K8/K9 compute in f32
# whatever the dtypes (2^-8 of the output: its rounding to q's dtype); K3
# rounds q, K, V and P to bf16 (f16 for an f16 cache) for mma.sync: 2^-6.

def _stack4(ic, oc, g, seed):
    rng = np.random.default_rng(seed)
    qw = rng.integers(-(2**31), 2**31 - 1, (ic // 8, oc), dtype=np.int64).astype(np.int32)
    s = (rng.uniform(0.5, 1.5, (ic // g, oc)) * 0.005).astype(np.float32)
    return torch.from_numpy(qw), torch.from_numpy(s), torch.from_numpy(s * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,g", [(1, 128), (8, 128), (37, 128), (1, -1), (8, -1), (37, -1),
                                 (5, 32), (20, 96), (1, 96), (8, 96),
                                 (37, 32), (200, 32), (70, 96), (200, 96), (200, -1)])
def test_k1_dtypes_and_groups_on_card(cuda, dtype, m, g):
    # g = 96 at m <= 8: the GEMV's 512-input split ends inside a group
    ic, oc = 1536, 320
    gs = ic if g == -1 else g
    qw, s, sz = (t.to(cuda) for t in _stack4(ic, oc, gs, m + gs))
    dt = getattr(torch, dtype)
    x = torch.randn(m, ic, generator=torch.Generator().manual_seed(m)).to(dt).to(cuda)
    b = torch.randn(oc, generator=torch.Generator().manual_seed(1)).to(dt).to(cuda)
    got = tw.w4a16_matmul(x, qw, s, sz, gs, b)
    ref = tw.w4a16_matmul_plain(x, qw, s, sz, gs, b)
    assert got.dtype == dt
    tol = 1e-5 if (dt == torch.float32 and m <= tw.GEMV_MAX_M) else 2 ** -6
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def _attn_inputs(dev, dt, cdt, b, nq, nkv, t, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    return (r(b, nq, 128).to(dt), r(b, nkv, 128).to(cdt), r(b, nkv, 128).to(cdt),
            (r(2, b, nkv, t, 128) * 0.5).to(cdt))


def _within(got, ref, tol):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_k2_k8_dtypes_on_card(cuda, dtype, cache_dtype):
    """K2 and K8 (a permuted pool of pages of 64) over q of one dtype and a
    cache of another, 4 rows of ragged lengths, 16 q heads per kv head."""
    dt, cdt = getattr(torch, dtype), getattr(torch, cache_dtype)
    b, nq, nkv, t = 4, 32, 2, 512
    q, kn, vn, cache = _attn_inputs(cuda, dt, cdt, b, nq, nkv, t, 3)
    lengths = torch.tensor([300, 0, 511, 64], dtype=torch.int32, device=cuda)
    got = tda.flash_decode(q, kn, vn, cache, lengths)
    assert got.dtype == dt
    _within(got, tda.flash_decode_plain(q, kn, vn, cache, lengths), 2 ** -8)
    page, mp = 64, t // 64
    perm = torch.randperm(b * mp, generator=torch.Generator().manual_seed(5)).to(cuda)
    pool = torch.empty((1, 2, b * mp, nkv, page, 128), dtype=cdt, device=cuda)
    pool[0][:, perm] = cache.reshape(2, b, nkv, mp, page, 128).permute(
        0, 1, 3, 2, 4, 5).reshape(2, b * mp, nkv, page, 128)
    tables = perm.reshape(b, mp).to(torch.int32)
    got = tda.flash_decode_paged(q, kn, vn, pool, tables, 0, lengths)
    _within(got, tda.flash_decode_paged_plain(q, kn, vn, pool, tables, 0, lengths), 2 ** -8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_k9_dtypes_on_card(cuda, dtype):
    from awq_tpu_torch.ops.cache_append import quantize_kv

    dt = getattr(torch, dtype)
    b, nq, nkv, t = 3, 8, 2, 400
    q, kn, vn, cache = _attn_inputs(cuda, dt, dt, b, nq, nkv, t, 4)
    codes, scales = quantize_kv(cache.to(torch.bfloat16))
    lengths = torch.tensor([399, 17, 0], dtype=torch.int32, device=cuda)
    got = tda.flash_decode_int8(q, kn, vn, codes, scales, lengths)
    assert got.dtype == dt
    _within(got, tda.flash_decode_int8_plain(q, kn, vn, codes, scales, lengths), 2 ** -8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_k3_dtypes_on_card(cuda, dtype, cache_dtype):
    dt, cdt = getattr(torch, dtype), getattr(torch, cache_dtype)
    b, s, nq, nkv, t, start = 2, 70, 4, 2, 256, 100
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((b, s, nq, 128), generator=g, device=cuda).to(dt)
    cache = (torch.randn((2, b, nkv, t, 128), generator=g, device=cuda) * 0.5).to(cdt)
    got = tda.flash_prefill(q, cache, start)
    assert got.dtype == dt
    _within(got, tda.flash_prefill_plain(q, cache, start), 2 ** -6)
