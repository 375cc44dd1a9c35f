"""Port parity: the W4A16 dequant matmul (K1) and its plain version.

On the CPU the port's wrapper runs the plain PyTorch version; it is held
to the JAX package's Pallas kernel (interpret mode) and to its XLA
fallback ``w4a16_matmul_xla`` on the same numpy inputs. The tests marked
``cuda`` hold the CUDA kernel to the plain version on a card and skip
without one. The JAX side is imported inside the tests that use it, so
that the card's tests run where JAX is not installed
(``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import w4a16 as tw

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

G = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _stack(L, ic, oc, seed, bias=False):
    """Random packed codes and scales [L, ...] as numpy (init_qparams-like)."""
    rng = np.random.default_rng(seed)
    qw = rng.integers(-(2**31), 2**31 - 1, (L, ic // 8, oc), dtype=np.int64)
    qw = qw.astype(np.int32)
    s = (rng.uniform(0.5, 1.5, (L, ic // G, oc)) * 0.005).astype(np.float32)
    sz = (s * 8).astype(np.float32)
    b = rng.standard_normal((L, oc)).astype(np.float32) if bias else None
    return qw, s, sz, b


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# f32 inputs on both sides. The plain version and w4a16_matmul_xla do the
# same f32 dequant and one f32 matmul: agreement to f32 summation order
# (~1e-6 relative). The Pallas kernel uses the matmul-then-scale identity,
# s*(x@q) - sum(x)*sz, whose f32 rounding differs: 1e-5 relative to the
# output's scale covers it with margin.
@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("bias", [False, True])
def test_plain_matches_pallas_and_xla(m, bias):
    import jax.numpy as jnp
    from awq_tpu.ops import w4a16 as jw

    L, ic, oc = 2, 512, 256
    qw, s, sz, b = _stack(L, ic, oc, seed=m, bias=bias)
    x = np.random.default_rng(100 + m).standard_normal((m, ic)).astype(np.float32)
    layer = 1
    ref_xla = np.asarray(jw.w4a16_matmul_xla(
        jnp.asarray(x), jnp.asarray(qw[layer]), jnp.asarray(s[layer]),
        jnp.asarray(sz[layer]), G))
    ref_pallas = np.asarray(jw.w4a16_matmul_stacked(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(s), jnp.asarray(sz),
        jnp.int32(layer), G))
    if bias:
        ref_xla = ref_xla + b[layer]
        ref_pallas = ref_pallas + b[layer]
    ql = tw.QLinear(qweight=_t(qw), scales=_t(s), szeros=_t(sz), bias=_t(b))
    got = tw.qlinear_apply_stacked(ql, layer, torch.from_numpy(x)).numpy()
    scale = np.abs(ref_xla).max()
    np.testing.assert_allclose(got, ref_xla, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(got, ref_pallas, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("oc", [200, 4544 - 4480])
def test_plain_ragged_oc_matches_xla(oc):
    """OC without a 128-wide tile (qwen2/falcon widths); only the XLA
    fallback is a reference here (the Pallas kernel needs OC % 128 == 0)."""
    import jax.numpy as jnp
    from awq_tpu.ops import w4a16 as jw

    qw, s, sz, _ = _stack(1, 256, oc, seed=oc)
    x = np.random.default_rng(oc).standard_normal((3, 256)).astype(np.float32)
    ref = np.asarray(jw.w4a16_matmul_xla(jnp.asarray(x), jnp.asarray(qw[0]),
                                         jnp.asarray(s[0]), jnp.asarray(sz[0]), G))
    got = tw.w4a16_matmul(torch.from_numpy(x), _t(qw[0]), _t(s[0]), _t(sz[0]), G)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


def test_quantize_linear_matches_jax():
    import jax.numpy as jnp
    from awq_tpu.ops import w4a16 as jw

    w = np.random.default_rng(5).standard_normal((256, 128)).astype(np.float32)
    jq = jw.quantize_linear(jnp.asarray(w), 4, G)
    tq = tw.quantize_linear(torch.from_numpy(w), 4, G)
    np.testing.assert_array_equal(tq.qweight.numpy(), np.asarray(jq.qweight))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(tq.szeros.numpy(), np.asarray(jq.szeros))
    x = np.random.default_rng(6).standard_normal((4, 256)).astype(np.float32)
    ref = np.asarray(jw.qlinear_apply(jq, jnp.asarray(x), impl="xla"))
    got = tw.qlinear_apply(tq, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * np.abs(ref).max())


def test_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor runs the plain version and launches no kernel."""
    qw, s, sz, b = _stack(1, 256, 128, seed=9, bias=True)
    for m in (1, 12):
        x = torch.randn(m, 256, generator=torch.Generator().manual_seed(m))
        before = dict(tw.LAUNCHES)
        got = tw.w4a16_matmul(x, _t(qw[0]), _t(s[0]), _t(sz[0]), G, _t(b[0]))
        ref = tw.w4a16_matmul_plain(x, _t(qw[0]), _t(s[0]), _t(sz[0]), G, _t(b[0]))
        assert torch.equal(got, ref)
        assert tw.LAUNCHES == before


# ---- on the card: the CUDA kernel against the plain version ---------------
# bf16 x and output. Tolerance 2^-6 of the output's largest magnitude: the
# output is rounded to bf16 (2^-9 relative); the plain version also rounds
# each dequantized weight to bf16 before its matmul, and both sum ~IC
# products in different orders.

def _card_case(dev, m, ic, oc, bias, seed):
    qw, s, sz, b = _stack(1, ic, oc, seed=seed, bias=bias)
    x = torch.randn(m, ic, generator=torch.Generator().manual_seed(seed))
    args = [t.to(dev) for t in (x.to(torch.bfloat16), _t(qw[0]), _t(s[0]), _t(sz[0]))]
    bb = _t(b[0]).to(torch.bfloat16).to(dev) if bias else None
    return args, bb


# The GEMM rows run the wgmma kernel on every path of its plan: the swapped
# orientation (M <= 64) at token tiles 16, 32 and 64 and the 128-token tile
# above, split-K where the tiles are few (IC 14336 splits for real), and
# column counts that are no multiple of the 128-column tile, TMA's 16-byte
# row pitch (320, 4544) or neither (202: the codes and scales by cp.async).
_GEMM_CASES = [(m, 1024, oc, m % 2 == 1) for m in (9, 16, 31, 32, 33, 64, 65, 200, 1000)
               for oc in (202, 320, 4544)] + [
    (9, 14336, 4096, False), (32, 14336, 4096, True), (64, 14336, 320, False),
    (200, 14336, 4544, True), (1000, 14336, 4096, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,ic,oc,bias", [
    (1, 512, 256, False), (3, 1024, 384, True), (8, 512, 200, False),
    (2, 512, 202, True), (20, 512, 202, False),
    (1, 4096, 6144, False), (37, 512, 256, True), (70, 1024, 200, False),
    (200, 4096, 4096, False)] + _GEMM_CASES)
def test_kernel_matches_plain_on_card(cuda, m, ic, oc, bias):
    args, bb = _card_case(cuda, m, ic, oc, bias, seed=m + oc)
    entry = "w4a16_gemv" if m <= tw.GEMV_MAX_M else "w4a16_gemm"
    before = tw.LAUNCHES[entry]
    got = tw.w4a16_matmul(*args, G, bb)
    torch.cuda.synchronize()
    assert tw.LAUNCHES[entry] == before + 1
    ref = tw.w4a16_matmul_plain(*args, G, bb)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -6 * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    args, _ = _card_case(cuda, 2, 512, 256, False, seed=1)
    x, qw, s, sz = args
    with pytest.raises(ValueError):
        tw.w4a16_matmul(x.double(), qw, s, sz, G)
    with pytest.raises(ValueError):
        tw.w4a16_matmul(x, qw, s, sz, 96)
