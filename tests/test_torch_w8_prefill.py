"""Port parity of the int8-activation prefill's pieces: ``quant_per_token``,
the per-column requant and the int8 prefill weight cache
(``build_w8_stack``, ``attach_w8_caches``), the plain versions of K10
(``w4a8_matmul_plain``) and K11 (``w8a8_matmul_plain``), the routing of
``qlinear_apply_stacked`` and ``params_from_jax`` over ``_w8`` leaves.

The JAX side is the reference on the same numpy inputs: its
``quant_per_token`` as the package runs it (inside ``jit``), its
``build_w8_stack`` and its Pallas rows 7 and 8
(``w4a8_matmul_stacked_tiled_folded``, ``w8a8_matmul_stacked_tiled``) in
interpret mode, as its own tests run them on the CPU. Every comparison is
bit for bit: int8 codes and int32 sums are exact, and the port repeats
each f32 operation in JAX's order. The tests marked ``cuda`` hold K10, K11
and the quantization kernel to their plain versions on a card and skip
here; the JAX side is imported inside the CPU tests, so that they run
where JAX is not installed (``pytest --noconftest -m cuda``).
"""

import warnings

import numpy as np
import pytest
import torch

from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.ops import w4a16 as tw
from awq_tpu_torch.ops import w8a8 as tq8

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

IC, OC, BN = 256, 512, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _jax_linear(ic=IC, oc=OC, layers=2, seed=11):
    """A stacked JAX QLinear from ``quantize_linear`` (f32 scales) and its
    TPU layout, tiled and folded (bf16 qparams), as ``fuse_linears`` makes
    it."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.w4a16 import quantize_linear, tile_qlinear

    qls = [quantize_linear(jax.random.normal(k, (ic, oc), jnp.float32) * 0.05)
           for k in jax.random.split(jax.random.PRNGKey(seed), layers)]
    ql = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qls)
    return ql, tile_qlinear(ql, block_n=BN, fold_scales=True)


def _x(m, dtype, seed=3, ic=IC):
    x = np.random.default_rng(seed).standard_normal((m, ic)).astype(np.float32) * 0.3
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _to_jax(x):
    import jax.numpy as jnp
    import ml_dtypes

    a = x.float().numpy()
    return jnp.asarray(a.astype(ml_dtypes.bfloat16) if x.dtype == torch.bfloat16 else a)


# ---- quant_per_token -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_per_token_bit_exact(dtype):
    """Codes and scales equal the JAX function's as the package runs it,
    inside ``jit``, where XLA multiplies by f32(1/127) for the source's
    division by 127; a zero row takes the 1e-5 floor, and values on exact
    .5 steps round half to even."""
    import jax
    from awq_tpu.ops.w8a8 import quant_per_token as jq

    x = _x(40, dtype)
    x[3] = 0.0
    # absmax 127 gives a scale of exactly 1.0: x / 1.0 lands on the .5 ties
    x[5, :6] = torch.tensor([127.0, 2.5, -3.5, 0.5, 1.5, -0.5])
    x[5, 6:] = 0.0
    q, s = tq8.quant_per_token_plain(x)
    jqx, jsx = jax.jit(jq)(_to_jax(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsx))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and tuple(s.shape) == (40, 1)
    assert s[3].item() == np.float32(1e-5) * np.float32(1 / 127)
    assert s[5].item() == 1.0
    assert q[5, :6].tolist() == [127, 2, -4, 0, 2, 0]
    # the wrapper takes the plain version on the CPU
    for a, b in zip(tq8.quant_per_token(x), (q, s)):
        assert torch.equal(a, b)


# ---- the requant and the int8 weight cache -------------------------------------------

@pytest.mark.parametrize("source", ["folded", "f32"])
def test_build_w8_stack_bit_exact(source):
    """The cache from the port's tree equals JAX's ``build_w8_stack`` of the
    folded tree bit for bit: from ``params_from_jax`` of the folded tree
    (bf16 qparams) and from the unfolded one (f32 scales, as the port's
    ``quantize_linear`` makes them; the requant rounds them to bf16 first).
    ``params_from_jax`` carries JAX's cache across in the port's layout."""
    import jax
    from awq_tpu.ops.w4a16 import build_w8_stack

    ql, folded = _jax_linear()
    ref = build_w8_stack(folded)
    tree = params_from_jax(jax.device_get(
        {"x": folded if source == "folded" else ql, "x_w8": ref}), device="cpu")
    got = tw.build_w8_stack(tree["x"])
    carried = tree["x_w8"]
    assert isinstance(carried, tw.W8Stack)
    assert tuple(got.w8.shape) == (2, OC, IC) and got.w8.dtype == torch.int8
    assert tuple(got.scol.shape) == (2, OC) and got.scol.dtype == torch.float32
    # JAX [L, NB, IC, bn] -> [L, OC, IC]
    want_w8 = np.asarray(ref.w8).transpose(0, 1, 3, 2).reshape(2, OC, IC)
    np.testing.assert_array_equal(got.w8.numpy(), want_w8)
    np.testing.assert_array_equal(got.scol.numpy(), np.asarray(ref.scol).reshape(2, OC))
    assert torch.equal(carried.w8, got.w8) and torch.equal(carried.scol, got.scol)
    assert carried.w8.is_contiguous()


def test_port_quantize_linear_feeds_the_same_cache():
    """The port's own ``quantize_linear`` of the same float weights gives
    the cache JAX builds from its folded tree."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.w4a16 import build_w8_stack, quantize_linear, tile_qlinear

    w = np.array(jax.random.normal(jax.random.PRNGKey(5), (IC, OC), jnp.float32) * 0.05)
    ref = build_w8_stack(tile_qlinear(jax.tree_util.tree_map(
        lambda a: a[None], quantize_linear(jnp.asarray(w))), block_n=BN, fold_scales=True))
    ql = tw.quantize_linear(torch.from_numpy(w))
    w8, scol = tw.requant_w8(ql.qweight, ql.scales, ql.szeros, 128)
    np.testing.assert_array_equal(
        w8.numpy(), np.asarray(ref.w8)[0].transpose(0, 2, 1).reshape(OC, IC))
    np.testing.assert_array_equal(scol.numpy(), np.asarray(ref.scol).reshape(OC))


# ---- K10 and K11's plain versions against Pallas rows 7 and 8 -------------------------

@pytest.mark.parametrize("kind", ["w8a8", "w4a8"])
@pytest.mark.parametrize("m", [96, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmuls_match_pallas_rows_7_8(kind, m, dtype):
    """``w8a8_matmul_plain`` against interpret-mode
    ``w8a8_matmul_stacked_tiled`` (row 8) and ``w4a8_matmul_plain``
    against ``w4a8_matmul_stacked_tiled_folded`` (row 7), layers 0 and 1,
    at 96 rows and at 40 (which the Pallas kernels pad to their M block),
    with ``atol=0``; the wrappers take the plain versions on the CPU."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops import w4a16 as jw

    _, folded = _jax_linear()
    tq = params_from_jax(jax.device_get({"x": folded}), device="cpu")["x"]
    x = _x(m, dtype)
    jx = _to_jax(x)
    if kind == "w8a8":
        jc = jw.build_w8_stack(folded)
        tc = tw.build_w8_stack(tq)
    for layer in range(2):
        if kind == "w8a8":
            ref = jw.w8a8_matmul_stacked_tiled(jx, jc.w8, jc.scol, jnp.int32(layer))
            args = (x, tc.w8[layer], tc.scol[layer])
            got, wrapped = tw.w8a8_matmul_plain(*args), tw.w8a8_matmul(*args)
        else:
            ref = jw.w4a8_matmul_stacked_tiled_folded(jx, folded.qweight, jnp.int32(layer),
                                                      128, BN)
            args = (x, tq.qweight[layer], tq.scales[layer], tq.szeros[layer], 128)
            got, wrapped = tw.w4a8_matmul_plain(*args), tw.w4a8_matmul(*args)
        assert got.dtype == x.dtype and tuple(got.shape) == (m, OC)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=0, atol=0)
        assert torch.equal(wrapped, got)


# ---- the routing of qlinear_apply_stacked ---------------------------------------------

# (a8, rows, with a cache, weights, environment) -> the path taken
ROUTES = [
    (True, 32, True, "w4", {}, "k11"),
    (True, 31, True, "w4", {}, "k1"),           # under _W8_MIN_M, under _A8_MIN_M
    (True, 512, False, "w4", {}, "k10"),
    (True, 511, False, "w4", {}, "k1"),
    (True, 512, False, "w4_g64", {}, "k1"),     # K10 only at group 128
    (True, 512, False, "w3_nibbles", {}, "k10"),  # 3-bit codes in the nibble container
    (True, 512, False, "w3_dense", {}, "k1"),   # pack_int3 ignores a8
    (False, 1000, True, "w4", {}, "k1"),        # decode and a8 off
    (True, 8, True, "w4", {"AWQ_TPU_W8_MIN_M": "8"}, "k11"),
    (True, 16, False, "w4", {"AWQ_TPU_A8_MIN_M": "16"}, "k10"),
    (True, 31, True, "w4", {"AWQ_TPU_A8_MIN_M": "16"}, "k10"),  # no cache hit: K10
]


@pytest.mark.parametrize("a8,m,cached,weights,env,want", ROUTES)
def test_a8_routing(a8, m, cached, weights, env, want, monkeypatch):
    """K11 from 32 rows with a cache, else K10 from 512 rows at group 128,
    else K1, as ``awq_tpu/ops/w4a16.py:1397-1409`` routes; the JAX
    package's environment variables move the thresholds."""
    from awq_tpu.ops import w4a16 as jw

    assert (jw._A8_MIN_M, jw._W8_MIN_M) == (tw._A8_MIN_M, tw._W8_MIN_M) == (512, 32)
    for name in ("AWQ_TPU_A8_MIN_M", "AWQ_TPU_W8_MIN_M"):
        monkeypatch.delenv(name, raising=False)
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((2, 384, 128), generator=gen) * 0.05
    n_bit = 3 if weights.startswith("w3") else 4
    g = 64 if weights == "w4_g64" else 128
    ic = 384 if weights == "w3_nibbles" else 256     # IC % 256 != 0: nibbles
    qls = [tw.quantize_linear(w[l, :ic], n_bit=n_bit, group_size=g) for l in range(2)]
    ql = tw.QLinear(*(torch.stack([getattr(q, f) for q in qls])
                      for f in ("qweight", "scales", "szeros")),
                    w_bit=n_bit, group_size=g, dense3=qls[0].dense3)
    assert ql.dense3 == (weights == "w3_dense")
    cache = tw.build_w8_stack(ql) if cached else None
    taken = []
    for name, tag in (("w8a8_matmul", "k11"), ("w4a8_matmul", "k10"), ("_apply", "k1")):
        real = getattr(tw, name)
        monkeypatch.setattr(tw, name, lambda *a, _r=real, _t=tag, **k: (taken.append(_t),
                                                                         _r(*a, **k))[1])
    out = tw.qlinear_apply_stacked(ql, 1, torch.randn((m, ic), generator=gen), a8=a8,
                                   w8stack=cache)
    assert taken == [want] and tuple(out.shape) == (m, 128)


def test_a8_bias_is_added_after_the_int8_product():
    """A bias (qwen2's wqkv) is added to the int8 product in x's dtype, as
    JAX adds it after rows 7 and 8."""
    gen = torch.Generator().manual_seed(1)
    qls = [tw.quantize_linear(torch.randn((256, 128), generator=gen) * 0.05,
                              bias=torch.randn(128, generator=gen).to(torch.bfloat16))
           for _ in range(2)]
    ql = tw.QLinear(*(torch.stack([getattr(q, f) for q in qls])
                      for f in ("qweight", "scales", "szeros", "bias")))
    cache = tw.build_w8_stack(ql)
    x = torch.randn((2, 20, 256), generator=gen).to(torch.bfloat16)
    got = tw.qlinear_apply_stacked(ql, 1, x, a8=True, w8stack=cache)
    ref = tw.w8a8_matmul_plain(x.reshape(40, 256), cache.w8[1], cache.scol[1]) + ql.bias[1]
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref.reshape(2, 20, 128))


# ---- attach_w8_caches: the budget and the fit guard -----------------------------------

def _fused_jax_layers():
    """JAX's fused, tiled and folded layers of a tiny model whose every
    linear is tiled (each OC a multiple of the block width), and the
    port's copy of them."""
    import jax
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    cfg = JConfig(arch="llama", vocab_size=256, hidden_size=512, intermediate_size=1024,
                  num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                  max_position_embeddings=128, dtype="float32")
    params = jllama.fuse_linears(jllama.quantize_params(
        jllama.init_params(cfg, jax.random.PRNGKey(0)), JQuant(w_bit=4, group_size=128)), cfg)
    layers = params["layers"]
    return layers, params_from_jax(jax.device_get(layers), device="cpu")


@pytest.mark.parametrize("n_names", [1, 2, 4])
def test_attach_budget_picks_jax_names(n_names):
    """A budget covering the ``n_names`` deepest-IC caches builds the same
    ``_w8`` names as JAX's ``attach_w8_caches`` (the deepest first), and
    those caches equal JAX's."""
    from awq_tpu.ops import w4a16 as jw

    jlayers, tlayers = _fused_jax_layers()
    cost = jw.w8_cache_cost(jlayers)
    assert cost == tw.w8_cache_cost(tlayers) and len(cost) == 4
    names = sorted(cost, key=lambda n: -jlayers[n].in_features)[:n_names]
    budget = sum(cost[n] for n in names)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jout = jw.attach_w8_caches(jlayers, budget_bytes=budget)
        tout = tw.attach_w8_caches(tlayers, budget_bytes=budget)
    jnames = sorted(k for k in jout if k.endswith("_w8"))
    assert sorted(k for k in tout if k.endswith("_w8")) == jnames
    assert len(jnames) == n_names and "down_w8" in jnames
    for k in jnames:
        assert torch.equal(tout[k].w8, params_from_jax({"c": jout[k]}, device="cpu")["c"].w8)


@pytest.mark.parametrize("budget", [None, 1 << 30])
def test_attach_fit_guard_with_and_without_budget(budget, monkeypatch):
    """A cache larger than the free device memory (less the headroom) is
    refused, also when a budget larger than what is free is given: the JAX
    package skips the check under a budget (``awq_tpu/ops/w4a16.py:1250``),
    the port does not."""
    _, tlayers = _fused_jax_layers()
    need = sum(tw.w8_cache_cost(tlayers).values())
    # the CPU has no free-memory probe: no refusal there
    assert tw._device_free_bytes(torch.device("cpu")) is None
    monkeypatch.setattr(tw, "_device_free_bytes", lambda dev: 1 << 20)
    with pytest.raises(ValueError, match="prefill_w8"):
        tw.attach_w8_caches(tlayers, budget_bytes=budget)
    monkeypatch.setattr(tw, "_device_free_bytes", lambda dev: need + (1 << 30))
    out = tw.attach_w8_caches(tlayers, budget_bytes=budget)
    assert sum(k.endswith("_w8") for k in out) == 4


# ---- on the card: K10, K11 and the quantization against their plain versions ---------

def _card_linear(dev, ic, oc, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qw = torch.randint(-(2**31), 2**31 - 1, (2, ic // 8, oc), generator=g,
                       dtype=torch.int32, device=dev)
    s = (torch.rand((2, ic // 128, oc), generator=g, device=dev) + 0.5) * 0.005
    return tw.QLinear(qweight=qw, scales=s, szeros=s * (7 + torch.rand_like(s)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m", [32, 40, 200, 512, 1, 17, 33, 64, 1000])
@pytest.mark.parametrize("oc", [384, 320, 4544])
def test_k10_k11_bit_equal_plain_on_card(cuda, dtype, m, oc):
    """K10 and K11 bit-equal to their plain versions (int32 sums are exact
    and the epilogue's order is fixed), over f32/bf16/f16 x and an OC that
    is no multiple of the 128-column tile; the on-card cache equals the CPU
    build; K11 over it equals K10; the quantization kernel equals its plain
    version."""
    ql = _card_linear(cuda, 1024, oc, m + oc)
    x = (torch.randn((m, 1024), generator=torch.Generator(device=cuda).manual_seed(m),
                     device=cuda) * 0.5).to(getattr(torch, dtype))
    cache = tw.build_w8_stack(ql)
    cpu = tw.build_w8_stack(tw.QLinear(*(t.cpu() for t in (ql.qweight, ql.scales,
                                                            ql.szeros))))
    assert torch.equal(cache.w8.cpu(), cpu.w8) and torch.equal(cache.scol.cpu(), cpu.scol)
    q, s = tq8.quant_per_token(x)
    qp, sp = tq8.quant_per_token_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    for layer in range(2):
        k11 = tw.w8a8_matmul(x, cache.w8[layer], cache.scol[layer])
        k10 = tw.w4a8_matmul(x, ql.qweight[layer], ql.scales[layer], ql.szeros[layer], 128)
        torch.cuda.synchronize()
        assert k11.dtype == x.dtype and tuple(k11.shape) == (m, oc)
        assert torch.equal(k11, tw.w8a8_matmul_plain(x, cache.w8[layer], cache.scol[layer]))
        assert torch.equal(k10, tw.w4a8_matmul_plain(x, ql.qweight[layer], ql.scales[layer],
                                                     ql.szeros[layer], 128))
        assert torch.equal(k11, k10)


# Llama-3-8B's four projections at the rows K10 is routed (512 and 1000)
# and at 40 (split-K), group 128 and 64; IC = 1088 ends on a half stage.
@pytest.mark.cuda
@pytest.mark.parametrize("m", [40, 512, 1000])
@pytest.mark.parametrize("ic,oc,g", [(ic, oc, g) for ic, oc in ((4096, 6144), (4096, 4096),
                                                                (4096, 28672), (14336, 4096))
                                     for g in (128, 64)] + [(1088, 4544, 64)])
def test_k10_bit_equal_at_projection_shapes_on_card(cuda, m, ic, oc, g):
    gen = torch.Generator(device=cuda).manual_seed(m + ic + oc + g)
    qw = torch.randint(-(2**31), 2**31 - 1, (ic // 8, oc), generator=gen, dtype=torch.int32,
                       device=cuda)
    s = (torch.rand((ic // g, oc), generator=gen, device=cuda) + 0.5) * 0.005
    sz = s * (7 + torch.rand((ic // g, oc), generator=gen, device=cuda))
    x = (torch.randn((m, ic), generator=gen, device=cuda) * 0.5).to(torch.bfloat16)
    before = tw.LAUNCHES["w4a8_gemm"]
    k10 = tw.w4a8_matmul(x, qw, s, sz, g)
    torch.cuda.synchronize()
    assert tw.LAUNCHES["w4a8_gemm"] == before + 1
    assert torch.equal(k10, tw.w4a8_matmul_plain(x, qw, s, sz, g))
    assert torch.equal(k10, tw.w8a8_matmul(x, *tw.requant_w8(qw, s, sz, g)))


@pytest.mark.cuda
def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    ql = _card_linear(cuda, 1024, 256, 0)
    x = torch.randn((40, 1024), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="group_size"):
        tw.w4a8_matmul(x, ql.qweight[0], ql.scales[0], ql.szeros[0], 96)
    with pytest.raises(ValueError, match="multiple of 64"):
        tw.w8a8_matmul(x[:, :1000].contiguous(), torch.zeros((256, 1000), dtype=torch.int8,
                                                              device=cuda),
                       torch.ones(256, device=cuda))
    with pytest.raises(ValueError, match="int8"):
        tw.w8a8_matmul(x, torch.zeros((256, 1024), device=cuda), torch.ones(256, device=cuda))
