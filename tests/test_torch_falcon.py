"""Port parity for the falcon family: LayerNorm, the GELU MLP, the family's
parameter trees, ``forward`` (the parallel block, one or two norms, MQA or
grouped QKV, the S = 1 step through ``layers.attention``), the engine's
greedy ids, and ``params_from_jax`` over JAX's deployed layout with its OC
tails (``<name>_rem``).

Two tiny f32 configs at head_dim 64: falcon-7b-style (5 query heads over
ONE kv head, ``single_ln``: wqkv's OC of 448 and the hidden 320 have a
64-wide tail past their last 128-wide tile, as falcon-7b's 4672 and 4544
do) and falcon-40b-style (grouped QKV, 4 query heads over 2 kv heads, two
norms). The JAX trees are ``init_params`` with random LayerNorm weights and
biases, quantized to W4-g64 as the repo quantizes falcon-7b. JAX runs on
the CPU as its own tests do (``forward``'s masked XLA attention).
"""

import dataclasses

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import ModelConfig as TConfig, QuantConfig as TQuant
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.models import layers as tlayers
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops import megakernel_chunk as tmc
from awq_tpu_torch.ops import megakernel_tp as tmtp

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

T = 256
FALCON = dict(arch="falcon", vocab_size=512, num_layers=2, head_dim=64,
              max_position_embeddings=T, norm="layernorm", act="gelu",
              parallel_block=True, dtype="float32")
STYLES = {"7b": dict(FALCON, hidden_size=320, intermediate_size=1280, num_heads=5,
                     num_kv_heads=1, single_ln=True),
          "40b": dict(FALCON, hidden_size=256, intermediate_size=1024, num_heads=4,
                      num_kv_heads=2, grouped_qkv=True)}


def _jax_params(style, seed=1):
    """JAX's falcon tree: ``init_params`` with random norm weights and
    biases (init_params sets them to 1 and 0), real W4-g64 quantization."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    cfg = JConfig(**STYLES[style])
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed), scale=0.05)
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    for name in ("ln1", "ln1_b", "ln2", "ln2_b"):
        if name in layers:
            base = 1.0 if not name.endswith("_b") else 0.0
            layers[name] = jnp.asarray(base + 0.1 * rng.standard_normal(
                layers[name].shape).astype(np.float32))
    params = {**params, "layers": layers,
              "norm_b": jnp.asarray(0.1 * rng.standard_normal(
                  params["norm_b"].shape).astype(np.float32))}
    return cfg, jllama.quantize_params(params, JQuant(w_bit=4, group_size=64))


def test_layer_norm_matches_jax():
    import jax.numpy as jnp
    from awq_tpu.models import layers as jlayers

    rng = np.random.default_rng(0)
    x = (3.0 + rng.standard_normal((2, 5, 320))).astype(np.float32)
    w = rng.standard_normal(320).astype(np.float32)
    b = rng.standard_normal(320).astype(np.float32)
    for bias in (b, None):
        ref = np.asarray(jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                            None if bias is None else jnp.asarray(bias),
                                            1e-5))
        got = tlayers.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                                 None if bias is None else torch.from_numpy(bias), 1e-5)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6 * np.abs(ref).max())
    # bf16 in and out: f32 inside, one rounding at the end on both sides
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = jlayers.layer_norm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = tlayers.layer_norm(xb, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=2 ** -7 * float(np.abs(np.asarray(
                                   ref.astype(jnp.float32))).max()))


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("scaled", [False, True])
def test_mlp_gelu_matches_jax(act, scaled):
    import jax.numpy as jnp
    from awq_tpu.models import layers as jlayers

    rng = np.random.default_rng(len(act) + scaled)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w1 = (rng.standard_normal((64, 256)) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((256, 64)) * 0.1).astype(np.float32)
    b1 = rng.standard_normal(256).astype(np.float32) * 0.1
    s = (0.5 + rng.random(256)).astype(np.float32) if scaled else None
    ref = np.asarray(jlayers.mlp_gelu(
        jlayers.Linear(w=jnp.asarray(w1), b=jnp.asarray(b1)), jlayers.Linear(w=jnp.asarray(w2)),
        jnp.asarray(x), act=act, act_scale=None if s is None else jnp.asarray(s)))
    got = tlayers.mlp_gelu(
        tlayers.Linear(w=torch.from_numpy(w1), b=torch.from_numpy(b1)),
        tlayers.Linear(w=torch.from_numpy(w2)), torch.from_numpy(x), act=act,
        act_scale=None if s is None else torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("style", ["7b", "40b"])
def test_init_qparams_builds_the_family_tree(style):
    """The port's ``init_qparams`` lays out the tree JAX's falcon importer
    and ``init_params`` give (no gate, LayerNorm biases, ``ln2`` only with
    two norms); every packed linear has the shapes of JAX's
    ``init_qparams``."""
    import jax
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    jcfg, tcfg = JConfig(**STYLES[style]), TConfig(**STYLES[style])
    jtree = jllama.quantize_params(jllama.init_params(jcfg, jax.random.PRNGKey(0)),
                                   JQuant(w_bit=4, group_size=64))
    jq = jllama.init_qparams(jcfg, JQuant(w_bit=4, group_size=64), jax.random.PRNGKey(0))
    tp = tllama.init_qparams(tcfg, TQuant(w_bit=4, group_size=64), device="cpu")
    assert set(tp) == set(jtree) and set(tp["layers"]) == set(jtree["layers"])
    assert "gate" not in tp["layers"] and ("ln2" in tp["layers"]) == (style == "40b")
    for name, p in tp["layers"].items():
        if isinstance(p, tllama.QLinear):
            ref = jq["layers"][name]
            for f in ("qweight", "scales", "szeros"):
                assert tuple(getattr(p, f).shape) == tuple(getattr(ref, f).shape), (name, f)
            assert p.group_size == ref.group_size == 64
        else:
            assert tuple(p.shape) == tuple(jtree["layers"][name].shape), name
    assert tuple(tp["norm_b"].shape) == (tcfg.hidden_size,)
    fused = tllama.fuse_linears(tp, tcfg)["layers"]
    assert "wgateup" not in fused and fused["wqkv"].out_features == (
        tcfg.num_heads + 2 * tcfg.num_kv_heads) * 64


def _no_k2(monkeypatch):
    """K2 (and its plain version) cannot take falcon's shape: fail if the
    stacked path calls it instead of the S = 1 fallback."""
    def refuse(*a, **k):
        raise AssertionError("the S = 1 step took K2")

    monkeypatch.setattr(tllama, "flash_decode", refuse)
    monkeypatch.setattr(tllama, "flash_decode_append_plain", refuse)


# f32 on both sides, JAX's masked XLA attention against the port's (the
# same at S = 1 on the CPU) after the in-place append: same math, other
# summation orders (~1e-6 of the largest logit; 1e-5 leaves a margin).
@pytest.mark.parametrize("style", ["7b", "40b"])
@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_forward_matches_jax(style, impl, monkeypatch):
    import jax
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    _no_k2(monkeypatch)
    jcfg, jparams = _jax_params(style)
    tcfg = TConfig(**STYLES[style])
    tparams = tllama.fuse_linears(params_from_jax(jax.device_get(jparams), device="cpu"),
                                  tcfg)
    rng = np.random.default_rng(3)
    steps = [rng.integers(0, 512, (1, 11))] + [rng.integers(0, 512, (1, 1))
                                               for _ in range(16)]
    jcache = jllama.init_kv_cache(jcfg, 1, T, jnp.float32)
    tcache = tllama.init_kv_cache(tcfg, 1, T, torch.float32, device="cpu")
    pos = 0
    for toks in steps:
        jl, jcache = jllama.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), jcache,
                                    jnp.int32(pos), last_only=False)
        tl, tcache = tllama.forward(tparams, tcfg, torch.from_numpy(toks), tcache, pos,
                                    last_only=False, impl=impl)
        jl = np.asarray(jl)
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-5 * np.abs(jl).max())
        pos += toks.shape[1]
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), rtol=0, atol=1e-4)


@pytest.mark.parametrize("src_fused", [False, True])
def test_engine_greedy_ids_bit_exact(src_fused):
    """Greedy ids of ``InferenceEngine.generate`` over 20 new tokens equal
    the JAX engine's bit for bit. With ``src_fused`` the port is handed the
    JAX engine's own deployed tree (``fuse_linears(tile=True)``: wqkv, wo
    and down with OC tails ``_rem``), else the unfused tree."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import (GenConfig as JGen, RuntimeConfig as JRuntime)
    from awq_tpu.runtime.engine import InferenceEngine as JEngine
    from awq_tpu_torch.config import GenConfig as TGen, RuntimeConfig as TRuntime
    from awq_tpu_torch.runtime.engine import InferenceEngine as TEngine

    jcfg, jparams = _jax_params("7b", seed=4)
    jeng = JEngine(jcfg, jparams, JRuntime(max_seq_len=T), cache_dtype=jnp.float32)
    if src_fused:
        assert {"wqkv_rem", "wo_rem", "down_rem"} <= set(jeng.params["layers"])
    src = jeng.params if src_fused else jparams
    teng = TEngine(TConfig(**STYLES["7b"]), params_from_jax(jax.device_get(src), device="cpu"),
                   TRuntime(max_seq_len=T), cache_dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(6).integers(0, 512, 9).tolist()
    jids = np.asarray(jeng.generate(prompt, JGen(greedy=True, max_new_tokens=20))["output_ids"])
    tids = teng.generate(prompt, TGen(greedy=True, max_new_tokens=20))["output_ids"].numpy()
    assert len(jids) == 20
    np.testing.assert_array_equal(tids, jids)


def test_params_from_jax_joins_the_oc_tails():
    """JAX's ``fuse_linears(tile=True)`` cuts each OC with no 128-wide tile
    into a tiled main part and a plain tail ``<name>_rem``; the port's tree
    of it equals, tensor for tensor, its tree of the untiled fusion (at
    group 64 the tiles keep their f32 scales: nothing is folded)."""
    import jax
    from awq_tpu.models import llama as jllama

    jcfg, jparams = _jax_params("7b")
    tiled = jllama.fuse_linears(jparams, jcfg, tile=True, block_n=128)
    plain = jllama.fuse_linears(jparams, jcfg, tile=False)
    assert {"wqkv_rem", "wo_rem", "down_rem"} <= set(tiled["layers"])
    assert "up_rem" not in tiled["layers"] and tiled["layers"]["wqkv"].tiled_bn == 128
    a = params_from_jax(jax.device_get(tiled), device="cpu")
    b = params_from_jax(jax.device_get(plain), device="cpu")
    assert set(a["layers"]) == set(b["layers"]) and not any(
        k.endswith("_rem") for k in a["layers"])
    for name, p in b["layers"].items():
        q = a["layers"][name]
        if isinstance(p, tllama.QLinear):
            for f in ("qweight", "scales", "szeros"):
                assert torch.equal(getattr(q, f), getattr(p, f)), (name, f)
            assert q.out_features == p.out_features
        else:
            assert torch.equal(q, p), name


def _tiny_model(**change):
    cfg = TConfig(**{**STYLES["7b"], **change})
    params = tllama.fuse_linears(tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=64),
                                                     device="cpu"), cfg)
    return cfg, params


def test_unported_falcon_paths_raise():
    """Falcon's batched, paged and int8 paths run (``tests/test_torch_family_*.py``
    holds them to JAX); its tensor-parallel paths raise naming ROADMAP A17b,
    and the shapes of other families naming A12."""
    from awq_tpu_torch.parallel.deploy import build_tp_params
    from awq_tpu_torch.parallel.mesh import TPGroup

    cfg, params = _tiny_model()
    toks, lens = torch.tensor([1, 2]), torch.tensor([0, 3], dtype=torch.int32)
    cache = tllama.init_kv_cache(cfg, 2, 16, torch.float32, device="cpu")
    tllama.decode_step_batched(params, cfg, toks, cache, lens)
    pool = torch.zeros((2, 2, 4, 1, 8, 64))
    tables = torch.tensor([[1], [2]], dtype=torch.int32)
    tllama.decode_step_paged(params, cfg, toks, pool, tables, lens)
    tllama.forward(params, cfg, toks[None, :1], tllama.init_cache(cfg, 1, 16, "int8",
                                                                  device="cpu"), 0)
    group = TPGroup(rank=0, size=1, group=None, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="item 17b"):
        tllama.forward(params, cfg, toks[None, :1], cache[:, :, :1].contiguous(), 0,
                       tp_axis=group)
    with pytest.raises(NotImplementedError, match="item 17b"):
        build_tp_params(tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=64),
                                            device="cpu"), cfg, group)
    for change in (dict(pos_embed="alibi"), dict(pos_embed="learned"), dict(embed_ln=True),
                   dict(attn_bias=True), dict(rotary_pct=0.5), dict(norm="rmsnorm")):
        with pytest.raises(NotImplementedError, match="item 12"):
            tllama.forward(params, dataclasses.replace(cfg, **change), toks[None, :1],
                           cache[:, :, :1].contiguous(), 0)


def test_megakernel_gates_refuse_falcon(monkeypatch):
    """A falcon model at head_dim 128 with at most 8 q heads per kv head
    (K4's limits) reaches none of K4, K5 or K12: the gates read the norm,
    the activation and the parallel block, not the head_dim alone; and
    ``forward`` takes the stacked path."""
    monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    cfg, params = _tiny_model(hidden_size=512, intermediate_size=1024, num_heads=4,
                              num_kv_heads=1, head_dim=128)
    cache = tllama.init_kv_cache(cfg, 1, 32, torch.float32, device="cpu")
    layers = params["layers"]
    assert not tmk.megakernel_supported(cfg, layers, cache)
    assert not tmc.chunk_megakernel_supported(cfg, layers, cache, 8)
    assert not tmtp.tp_megakernel_supported(cfg, layers, cache)

    def refuse(*a, **k):
        raise AssertionError("a megakernel ran")

    for mod, name in ((tmk, "w4a16_llama_token_step_plain"),
                      (tmc, "w4a16_llama_chunk_step_plain")):
        monkeypatch.setattr(mod, name, refuse)
    logits, _ = tllama.forward(params, cfg, torch.tensor([[1, 2, 3]]), cache, 0)
    logits2, _ = tllama.forward(params, cfg, torch.tensor([[4]]), cache, 3)
    assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
