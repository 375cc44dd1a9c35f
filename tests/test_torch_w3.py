"""Port parity of W3A16: ``pack_int3`` and its bitplane codec, W3
``quantize_linear``, the plain W3 matmul (K1's W3 mode on the CPU),
``params_from_jax`` over the TPU's folded ``w3x`` layout, and the
megakernel gates over a W3 stack.

The JAX side is the reference, on the same numpy inputs: its packers, its
``quantize_linear``, its Pallas ``w3a16_matmul_stacked`` run in interpret
mode (as its own tests run it on the CPU) and its XLA fallback
``w4a16_matmul_xla(dense3=True)``. The tests marked ``cuda`` hold K1's W3
mode to its plain version on a card and skip here. The JAX side is
imported inside the tests, so that the card's tests run where JAX is not
installed (``pytest --noconftest -m cuda``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops import w4a16 as tw
from awq_tpu_torch.quant import packing as tp

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _codes(ic, oc, seed):
    return np.random.default_rng(seed).integers(0, 8, (ic, oc)).astype(np.uint8)


@pytest.mark.parametrize("ic,oc", [(256, 8), (768, 256), (1024, 130)])
def test_pack_int3_bit_exact(ic, oc):
    import jax.numpy as jnp
    from awq_tpu.quant import packing as jp

    q = _codes(ic, oc, ic + oc)
    ref = np.asarray(jp.pack_int3(jnp.asarray(q)))
    got = tp.pack_int3(torch.from_numpy(q))
    assert got.dtype == torch.int32 and tuple(got.shape) == (ic * 3 // 32, oc)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tp.unpack_int3(got).numpy(), q)
    # words with the sign bit set unpack as JAX's do
    w = np.random.default_rng(ic).integers(-(2**31), 2**31 - 1, (ic * 3 // 32, oc),
                                           dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(tp.unpack_int3(torch.from_numpy(w)).numpy(),
                                  np.asarray(jp.unpack_int3(jnp.asarray(w))))


@pytest.mark.parametrize("ic,oc", [(32, 8), (96, 128), (512, 200)])
def test_pack_int3_dense_bit_exact(ic, oc):
    import jax.numpy as jnp
    from awq_tpu.quant import packing as jp

    q = _codes(ic, oc, 3 * ic + oc)
    ref = np.asarray(jp.pack_int3_dense(jnp.asarray(q)))
    got = tp.pack_int3_dense(torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tp.unpack_int3_dense(got).numpy(), q)
    np.testing.assert_array_equal(
        tp.unpack_int3_dense(torch.from_numpy(ref.copy())).numpy(),
        np.asarray(jp.unpack_int3_dense(jnp.asarray(ref))))


def test_pack_int3_requires_chunk_alignment():
    with pytest.raises(ValueError, match="256"):
        tp.pack_int3(torch.zeros((128, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="32"):
        tp.pack_int3_dense(torch.zeros((48, 8), dtype=torch.uint8))


@pytest.mark.parametrize("ic,g", [(512, 128), (512, 64), (768, -1), (320, 64), (192, -1)])
def test_quantize_linear_w3_bit_exact(ic, g):
    """dense3 where IC % 256 == 0, else 3-bit codes in the nibble
    container; codes, scales and szeros bit for bit."""
    import jax.numpy as jnp
    from awq_tpu.ops import w4a16 as jw

    w = np.random.default_rng(ic).standard_normal((ic, 128)).astype(np.float32)
    jq = jw.quantize_linear(jnp.asarray(w), 3, g)
    tq = tw.quantize_linear(torch.from_numpy(w), 3, g)
    assert tq.dense3 == jq.dense3 == (ic % 256 == 0)
    assert tq.group_size == jq.group_size and tq.in_features == ic
    np.testing.assert_array_equal(tq.qweight.numpy(), np.asarray(jq.qweight))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(tq.szeros.numpy(), np.asarray(jq.szeros))


def _stack3(L, ic, oc, g, seed):
    """Random dense3 words and scales [L, ...] as numpy."""
    rng = np.random.default_rng(seed)
    qw = rng.integers(-(2**31), 2**31 - 1, (L, ic * 3 // 32, oc), dtype=np.int64)
    n_g = ic // g
    s = rng.uniform(0.1, 1.0, (L, n_g, oc)).astype(np.float32)
    sz = rng.uniform(-1.0, 1.0, (L, n_g, oc)).astype(np.float32)
    return qw.astype(np.int32), s, sz


# f32 inputs on both sides. The plain version and w4a16_matmul_xla do the
# same f32 dequant and one f32 matmul: agreement to f32 summation order,
# 2e-6 of the output's scale. The Pallas kernel uses the matmul-then-scale
# identity per group, whose f32 rounding differs: 1e-5.
@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("g", [64, 128, -1])
def test_plain_w3_matches_pallas_and_xla(m, g):
    import jax.numpy as jnp
    from awq_tpu.ops import w4a16 as jw

    L, ic, oc = 2, 512, 256
    gs = ic if g == -1 else g
    qw, s, sz = _stack3(L, ic, oc, gs, seed=m + gs)
    x = np.random.default_rng(100 + m).standard_normal((m, ic)).astype(np.float32)
    layer = 1
    ref_xla = np.asarray(jw.w4a16_matmul_xla(
        jnp.asarray(x), jnp.asarray(qw[layer]), jnp.asarray(s[layer]),
        jnp.asarray(sz[layer]), gs, dense3=True))
    ref_pallas = np.asarray(jw.w3a16_matmul_stacked(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(s), jnp.asarray(sz),
        jnp.int32(layer), gs, block_n=128))
    ql = tw.QLinear(qweight=torch.from_numpy(qw), scales=torch.from_numpy(s),
                    szeros=torch.from_numpy(sz), w_bit=3, group_size=gs, dense3=True)
    assert ql.in_features == ic
    got = tw.qlinear_apply_stacked(ql, layer, torch.from_numpy(x)).numpy()
    scale = np.abs(ref_xla).max()
    np.testing.assert_allclose(got, ref_xla, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(got, ref_pallas, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("ic", [512, 768, 1280])
@pytest.mark.parametrize("stacked", [False, True])
def test_params_from_jax_unfolds_w3x(ic, stacked):
    """JAX's folded w3x tree (tile_qlinear(..., fold_scales=True) of a
    dense3 QLinear) comes back as exactly the pack_int3 codes, with the
    fold's bf16 scales and szeros. 512: trailer groups only; 768: one full
    5-group chunk and a trailer group; 1280: two full chunks."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops import w4a16 as jw
    from awq_tpu_torch.convert import params_from_jax

    w = np.random.default_rng(ic).standard_normal((ic, 256)).astype(np.float32)
    ql = jw.quantize_linear(jnp.asarray(w), n_bit=3, group_size=128)
    assert ql.dense3
    if stacked:
        ql = jax.tree_util.tree_map(lambda a: a[None], ql)
    folded = jw.tile_qlinear(ql, block_n=128, fold_scales=True)
    assert folded.folded and folded.dense3
    got = params_from_jax(jax.device_get({"x": folded, "plain": ql}), device="cpu")
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    for name in ("x", "plain"):
        t = got[name]
        assert t.dense3 and t.w_bit == 3 and t.group_size == 128
        np.testing.assert_array_equal(t.qweight.numpy(), np.asarray(ql.qweight))
    np.testing.assert_array_equal(got["x"].scales.numpy(), bf(ql.scales))
    np.testing.assert_array_equal(got["x"].szeros.numpy(), bf(ql.szeros))
    np.testing.assert_array_equal(got["plain"].scales.numpy(), np.asarray(ql.scales))


def _gate_layers(fmt_down="w3"):
    """A uniform dense3 stack (g128) of the gate model's widths, with
    ``down`` replaced by the given format."""
    def ql(ic, oc, w_bit=3, dense3=True):
        rows = ic * 3 // 32 if dense3 else ic // 8
        return tw.QLinear(qweight=torch.zeros((2, rows, oc), dtype=torch.int32),
                          scales=torch.ones((2, ic // 128, oc)),
                          szeros=torch.zeros((2, ic // 128, oc)),
                          w_bit=w_bit, group_size=128, dense3=dense3)

    layers = {"wqkv": ql(256, 768), "wo": ql(256, 256), "wgateup": ql(256, 512),
              "down": ql(256, 256)}
    if fmt_down == "w4":
        layers["down"] = ql(256, 256, 4, False)
    elif fmt_down == "nibble3":
        layers["down"] = ql(256, 256, 3, False)
    return layers


@pytest.mark.parametrize("down", ["w3", "w4", "nibble3"])
def test_megakernel_gate_dense3(monkeypatch, down):
    """A uniform dense3 stack takes the megakernels; a mixed one, or 3-bit
    codes in the nibble container, does not (JAX's
    tests/test_megakernel.py::test_megakernel_gate_dense3)."""
    from awq_tpu_torch.config import ModelConfig

    monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    cfg = ModelConfig(arch="llama", vocab_size=64, hidden_size=256,
                      intermediate_size=256, num_layers=2, num_heads=2,
                      num_kv_heads=2, head_dim=128, max_position_embeddings=512)
    layers = _gate_layers(down)
    cache = torch.zeros((2, 2, 1, 2, 256, 128), dtype=torch.bfloat16)
    assert tmk.megakernel_supported(cfg, layers, cache) == (down == "w3")
    h, ln = torch.zeros((1, 256)), torch.ones((2, 256))
    lins = (layers["wqkv"], layers["wo"], layers["wgateup"], layers["down"])
    if down == "w3":
        assert tmk.check_operands("k4", h, lins, ln, ln, cache, 2, 2, 1) == (2, 256, 256, True)
    else:
        with pytest.raises(ValueError, match="as wqkv"):
            tmk.check_operands("k4", h, lins, ln, ln, cache, 2, 2, 1)


@pytest.mark.parametrize("head", ["w3", "w4", "w3_on_w4_body"])
def test_head_in_kernel_follows_body_format(head):
    """A W3 head runs in the kernel only with a W3 body, and a W4 head only
    with a W4 body (JAX's models/llama.py:742)."""
    body = _gate_layers("w3" if head != "w3_on_w4_body" else "w4")
    if head == "w3_on_w4_body":
        body = {k: dataclasses.replace(v, w_bit=4, dense3=False,
                                       qweight=torch.zeros((2, v.in_features // 8,
                                                            v.out_features), dtype=torch.int32))
                for k, v in body.items()}
    dense3 = head != "w4"
    rows = 256 * 3 // 32 if dense3 else 256 // 8
    lm = tw.QLinear(qweight=torch.zeros((rows, 64), dtype=torch.int32),
                    scales=torch.ones((2, 64)), szeros=torch.zeros((2, 64)),
                    w_bit=3 if dense3 else 4, group_size=128, dense3=dense3)
    assert tmk.head_in_kernel({"lm_head": lm, "layers": body}) == (head == "w3")


# ---- on the card: K1's W3 mode against its plain version -------------------
# Tolerance 2^-6 of the output's largest magnitude for bf16 and f16 x (the
# output is rounded to x's dtype, the plain version rounds each dequantized
# weight to it before its matmul, and both sum ~IC products in different
# orders); f32 x: the GEMV computes in f32 (1e-5), the GEMM rounds x and
# the dequantized weights to bf16 for mma.sync (2^-6).

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("m,g", [(1, 128), (8, -1), (37, 128), (37, -1), (3, 64), (70, 256),
                                 (1, 96), (8, 96), (33, 128), (200, 128), (33, 96), (200, -1)])
def test_w3_kernel_matches_plain_on_card(cuda, dtype, m, g):
    # g = 96 over IC = 1536: the GEMV's 512-input split ends inside a group
    ic, oc = (1536 if g == 96 else 1024), 384
    gs = ic if g == -1 else g
    qw, s, sz = _stack3(1, ic, oc, gs, seed=m + gs)
    dt = getattr(torch, dtype)
    x = torch.randn(m, ic, generator=torch.Generator().manual_seed(m)).to(dt)
    b = torch.randn(oc, generator=torch.Generator().manual_seed(oc)).to(dt)
    args = [t.to(cuda) for t in (x, torch.from_numpy(qw[0]), torch.from_numpy(s[0]),
                                 torch.from_numpy(sz[0]))]
    entry = "w3a16_gemv" if m <= tw.GEMV_MAX_M else "w3a16_gemm"
    before = tw.LAUNCHES[entry]
    got = tw.w4a16_matmul(*args, gs, b.to(cuda), dense3=True)
    torch.cuda.synchronize()
    assert tw.LAUNCHES[entry] == before + 1 and got.dtype == dt
    ref = tw.w4a16_matmul_plain(*args, gs, b.to(cuda), dense3=True)
    tol = 1e-5 if (dt == torch.float32 and m <= tw.GEMV_MAX_M) else 2 ** -6
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err
