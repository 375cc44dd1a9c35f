"""Port parity at model level: ``forward`` logits against the JAX
``forward``, the parameter converter, and the entry points' device rules.

The JAX parameter tree (random init, then real W4-g128 quantization) is
carried across with ``params_from_jax``; prompts come from a seeded numpy
RNG. Geometry: 2 layers, hidden 512, intermediate 1024, 4 query heads,
head_dim 128, a cache of 256 positions. The JAX side is imported inside
the tests that use it, so that the card's test runs where JAX is not
installed (``pytest --noconftest -m cuda``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import ModelConfig as TConfig, QuantConfig as TQuant
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import decode_attn as tda
from awq_tpu_torch.ops import w4a16 as tw
from awq_tpu_torch.runtime.engine import InferenceEngine

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

T = 256


def _geom(arch, nkv):
    return dict(arch=arch, vocab_size=512, hidden_size=512,
                intermediate_size=1024, num_layers=2, num_heads=4,
                num_kv_heads=nkv, head_dim=128, max_position_embeddings=T,
                dtype="float32", qkv_bias=arch == "qwen2")


def _jax_params(arch, nkv, seed=1):
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama
    from awq_tpu.models.layers import Linear as JLinear

    cfg = JConfig(**_geom(arch, nkv))
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed))
    if cfg.qkv_bias:  # init_params zeroes biases: give them values
        rng = np.random.default_rng(seed)
        layers = dict(params["layers"])
        for name in ("wq", "wk", "wv"):
            lin = layers[name]
            layers[name] = JLinear(w=lin.w, b=jnp.asarray(
                rng.standard_normal(lin.b.shape).astype(np.float32) * 0.1))
        params = {**params, "layers": layers}
    return cfg, jllama.quantize_params(params, JQuant(w_bit=4, group_size=128))


def _run_both(arch, nkv, fused, tile=False, qhead=False, prompt_len=11):
    import jax
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams = _jax_params(arch, nkv)
    if qhead:
        jparams = jllama.quantize_head(jparams, jcfg)
    if fused:
        jparams = jllama.fuse_linears(jparams, jcfg, tile=tile)
    tcfg = TConfig(**_geom(arch, nkv))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 512, (1, prompt_len))
    steps = [prompt] + [rng.integers(0, 512, (1, 1)) for _ in range(4)]
    jcache = jllama.init_kv_cache(jcfg, 1, T, jnp.float32)
    tcache = tllama.init_kv_cache(tcfg, 1, T, torch.float32, device="cpu")
    pos, out = 0, []
    for toks in steps:
        jl, jcache = jllama.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                                    jcache, jnp.int32(pos))
        tl, tcache = tllama.forward(tparams, tcfg, torch.from_numpy(toks),
                                    tcache, pos)
        out.append((np.asarray(jl), tl.numpy()))
        pos += toks.shape[1]
    return out


# JAX XLA path, f32 on both sides: same math, other summation orders
# (measured ~1e-6 of the largest logit; 1e-5 leaves a 10x margin).
@pytest.mark.parametrize("arch,nkv,fused", [
    ("llama", 2, False), ("llama", 1, True), ("qwen2", 2, True)])
def test_forward_matches_jax_xla_path(arch, nkv, fused):
    for jl, tl in _run_both(arch, nkv, fused):
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5 * np.abs(jl).max())


# JAX stacked Pallas path in interpret mode (flash decode with the current
# token in registers, online-softmax flash prefill). Its prefill attention
# takes bf16 dots, so the hidden states differ at bf16 level (measured
# ~2e-3 of the largest logit; 1e-2 leaves a 5x margin).
@pytest.mark.parametrize("arch", ["llama", "qwen2"])
def test_forward_matches_jax_flash_path(arch, monkeypatch):
    import jax

    monkeypatch.setenv("AWQ_TPU_FORCE_FLASH", "1")
    monkeypatch.setenv("AWQ_TPU_FIXED_MAX", "off")
    jax.clear_caches()  # forward's trace reads the env at trace time
    try:
        for jl, tl in _run_both(arch, 2, fused=True):
            np.testing.assert_allclose(tl, jl, rtol=0,
                                       atol=1e-2 * np.abs(jl).max())
    finally:
        jax.clear_caches()


# JAX's megakernel path on its deployed tree (fuse_linears with the tiled,
# folded layout) against the port's, both forced on the CPU: the 40-token
# prompt takes the stacked flash path on both sides (JAX has no CPU hook
# for its chunk kernel), then each decode step is one whole-token
# megakernel step, with the W4 head inside it where the head is quantized.
# JAX's folded prefill kernels round every matmul input to bf16, where the
# port's stacked path on an f32 model does not, so the prefill's hidden
# states and the cache it writes differ at the bf16 level; that carries
# into the decode steps (measured up to 1.4e-2 of the largest logit, at
# the prefill with the W4 head): 3e-2 leaves a 2x margin.
@pytest.mark.parametrize("arch,qhead", [("llama", True), ("qwen2", False)])
def test_forward_matches_jax_megakernel_path(arch, qhead, monkeypatch):
    import jax

    for name, val in (("AWQ_TPU_FORCE_FLASH", "1"), ("AWQ_TPU_FIXED_MAX", "off"),
                      ("AWQ_TPU_FORCE_MEGAKERNEL", "1")):
        monkeypatch.setenv(name, val)
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    jax.clear_caches()
    try:
        for jl, tl in _run_both(arch, 2, fused=True, tile=True, qhead=qhead,
                                prompt_len=40):
            assert tl.shape == jl.shape
            np.testing.assert_allclose(tl, jl, rtol=0,
                                       atol=3e-2 * np.abs(jl).max())
    finally:
        jax.clear_caches()


def test_params_from_jax_bit_exact_and_layouts():
    import jax
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams = _jax_params("qwen2", 2)
    host = jax.device_get(jparams)
    tparams = params_from_jax(host, device="cpu")
    for name in ("wq", "wk", "wv", "down"):
        jq, tq = host["layers"][name], tparams["layers"][name]
        assert tq.qweight.dtype == torch.int32
        np.testing.assert_array_equal(tq.qweight.numpy(), np.asarray(jq.qweight))
        np.testing.assert_array_equal(tq.scales.numpy().view(np.uint32),
                                      np.asarray(jq.scales).view(np.uint32))
        np.testing.assert_array_equal(tq.szeros.numpy().view(np.uint32),
                                      np.asarray(jq.szeros).view(np.uint32))
        if jq.bias is not None:
            np.testing.assert_array_equal(tq.bias.numpy(), np.asarray(jq.bias))
    np.testing.assert_array_equal(tparams["embed"].numpy(), np.asarray(host["embed"]))
    # bf16 leaves carry their bits
    bf = {"embed": jnp.asarray(np.random.default_rng(0).standard_normal((4, 8)),
                               jnp.bfloat16)}
    got = params_from_jax(jax.device_get(bf), device="cpu")["embed"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(bf["embed"]).view(np.int16))
    # fused with tile=False is accepted as it is
    fused = params_from_jax(jax.device_get(
        jllama.fuse_linears(jparams, jcfg, tile=False)), device="cpu")
    assert "wqkv" in fused["layers"] and "wgateup" in fused["layers"]
    # the TPU's tiled and folded layouts (the default of fuse_linears) are
    # unfolded into the same codes and, for the folded ones, the bf16
    # scales the folded kernels compute with (test_torch_convert.py holds
    # every layout variant)
    tiled = params_from_jax(jax.device_get(jllama.fuse_linears(jparams, jcfg)),
                            device="cpu")
    for name in ("wqkv", "wgateup"):
        a, b = fused["layers"][name], tiled["layers"][name]
        assert torch.equal(a.qweight, b.qweight)
        assert torch.equal(a.scales.to(torch.bfloat16).float(), b.scales)
        assert torch.equal(a.szeros.to(torch.bfloat16).float(), b.szeros)
        assert (a.bias is None) == (b.bias is None)
        assert a.bias is None or torch.equal(a.bias, b.bias)


def test_quantize_params_bit_exact():
    """The port's quantize_params on the JAX package's fp weights gives the
    JAX quantize_params' codes and scales bit for bit."""
    import jax
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    jcfg = JConfig(**_geom("qwen2", 2))
    fp = jllama.init_params(jcfg, jax.random.PRNGKey(4))
    ref = jax.device_get(jllama.quantize_params(fp, JQuant()))
    got = tllama.quantize_params(params_from_jax(jax.device_get(fp), device="cpu"),
                                 TQuant())
    for name in tllama.LAYER_LINEARS:
        r, g = ref["layers"][name], got["layers"][name]
        for field in ("qweight", "scales", "szeros"):
            np.testing.assert_array_equal(getattr(g, field).numpy(),
                                          np.asarray(getattr(r, field)))
    # init_params builds the same tree shape as the JAX one
    tp = tllama.init_params(TConfig(**_geom("qwen2", 2)),
                            torch.Generator().manual_seed(0), device="cpu")
    for name, lin in fp["layers"].items():
        w = getattr(lin, "w", lin)
        assert tuple(getattr(tp["layers"][name], "w", tp["layers"][name]).shape) \
            == tuple(w.shape), name


def test_init_qparams_shapes_and_fusion():
    cfg = TConfig(**_geom("llama", 2))
    p = tllama.init_qparams(cfg, TQuant(), torch.Generator().manual_seed(0),
                            device="cpu")
    wq = p["layers"]["wq"]
    assert tuple(wq.qweight.shape) == (2, 512 // 8, 512)
    assert tuple(wq.scales.shape) == (2, 4, 512) and wq.qweight.dtype == torch.int32
    f = tllama.fuse_linears(p, cfg)
    assert f["layers"]["wqkv"].out_features == 512 + 2 * 2 * 128
    assert f["layers"]["wgateup"].out_features == 2 * 1024
    q = tllama.quantize_head(p, cfg)["lm_head"]
    assert isinstance(q, tw.QLinear) and q.out_features == 512


def test_unported_family_features_raise():
    base = _geom("llama", 2)
    for change in (dict(arch="opt"), dict(pos_embed="alibi"),
                   dict(norm="layernorm"), dict(act="gelu"),
                   dict(parallel_block=True)):
        cfg = TConfig(**{**base, **change})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tllama.forward({}, cfg, torch.zeros((1, 1), dtype=torch.long),
                           torch.zeros((2, 2, 1, 2, 8, 128)), 0)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    cfg = TConfig(**_geom("llama", 2))
    with pytest.raises(RuntimeError, match="cuda"):
        tllama.init_kv_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        tllama.init_qparams(cfg, TQuant())
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"embed": np.zeros((2, 2), np.float32)})
    params = tllama.init_qparams(cfg, TQuant(), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(cfg, params)


def test_forward_on_cpu_launches_no_kernel(monkeypatch):
    from awq_tpu_torch.ops import megakernel as tmk, megakernel_chunk as tmc

    cfg = TConfig(**_geom("llama", 2))
    params = tllama.fuse_linears(tllama.init_qparams(cfg, TQuant(), device="cpu"), cfg)
    counters = (tw.LAUNCHES, tda.LAUNCHES, tmk.LAUNCHES, tmc.LAUNCHES)
    before = [dict(c) for c in counters]
    for force in ("0", "1"):    # the stacked path, then the megakernels' plain versions
        monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", force)
        cache = tllama.init_kv_cache(cfg, 1, 64, torch.float32, device="cpu")
        tllama.forward(params, cfg, torch.zeros((1, 5), dtype=torch.long), cache, 0)
        tllama.forward(params, cfg, torch.zeros((1, 1), dtype=torch.long), cache, 5)
    assert [dict(c) for c in counters] == before


# ---- on the card: kernel path against the plain path, model level ---------
# bf16 model and cache; the two paths differ in rounding and summation
# order at every layer. 5e-2 of the largest logit bounds that drift over
# two layers (the kernels' own errors are a few 2^-9 relative).
@pytest.mark.cuda
def test_forward_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = dataclasses.replace(TConfig(**_geom("qwen2", 2)), dtype="bfloat16")
    params = tllama.fuse_linears(tllama.init_qparams(
        cfg, TQuant(), torch.Generator("cuda").manual_seed(0)), cfg)
    caches = [tllama.init_kv_cache(cfg, 1, T) for _ in range(2)]
    rng = np.random.default_rng(0)
    steps = [rng.integers(0, 512, (1, 40))] + [rng.integers(0, 512, (1, 1))
                                               for _ in range(3)]
    pos = 0
    for toks in steps:
        t = torch.from_numpy(toks).cuda()
        got, _ = tllama.forward(params, cfg, t, caches[0], pos)
        ref, _ = tllama.forward(params, cfg, t, caches[1], pos, impl="plain")
        err = (got - ref).abs().max().item()
        assert err <= 5e-2 * ref.abs().max().item(), err
        pos += toks.shape[1]
