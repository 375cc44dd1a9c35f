"""Port parity of the int8-activation prefill at the model and engine level:
``forward`` with ``cfg.prefill_a8`` (K10's plain version) and with the int8
prefill weight cache (``RuntimeConfig.prefill_w8``, K11's plain version)
against JAX's ``forward``, and the engines' ``prefill_w8`` wiring
(``InferenceEngine``, ``BatchEngine``, ``PagedBatchEngine``). The pieces
are held in ``test_torch_w8_prefill.py``.

The reference is JAX's ``forward`` on its deployed tree (fused, tiled,
folded, with JAX's own ``attach_w8_caches``) under its test hook
``AWQ_TPU_FORCE_FLASH=1``, which puts the CPU on the stacked path where
``prefill_a8`` lives, with ``awq_tpu.ops.w4a16.qlinear_apply_stacked``
pointed through pytest's ``monkeypatch`` at the interpret-mode Pallas rows
7 and 8, routed as the TPU branch routes them
(``awq_tpu/ops/w4a16.py:1397-1409``); the package is not edited. The cache
of 192 positions is no multiple of 256, so both sides attend in f32 (JAX's
flash kernels, which take bf16 dots, stay off) and the scales are rounded
to bf16 before the fold, so that JAX's CPU matmuls (which read the f32
scales) and the port (which reads the fold's bf16 values) dequantize the
same weights. The model is tiny and f32: 2 layers, hidden 512, head_dim
128, W4-g128.
"""

import dataclasses

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import GenConfig as TGen, ModelConfig as TConfig
from awq_tpu_torch.config import QuantConfig as TQuant, RuntimeConfig as TRuntime
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import w4a16 as tw
from awq_tpu_torch.runtime.batch_engine import BatchEngine
from awq_tpu_torch.runtime.engine import InferenceEngine
from awq_tpu_torch.runtime.paged import PagedBatchEngine

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

GEOM = dict(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=1024,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
            max_position_embeddings=384, dtype="float32")
T = 192


def _jax_tree(with_cache):
    """JAX's deployed tree of a tiny model with bf16-valued scales: fused,
    tiled and folded, with JAX's int8 prefill caches when asked."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama
    from awq_tpu.ops import w4a16 as jw

    cfg = JConfig(**GEOM)
    params = jllama.quantize_params(jllama.init_params(cfg, jax.random.PRNGKey(7)),
                                    JQuant(w_bit=4, group_size=128))
    bf16 = lambda a: a.astype(jnp.bfloat16).astype(jnp.float32)
    params["layers"] = {
        k: dataclasses.replace(v, scales=bf16(v.scales), szeros=bf16(v.szeros))
        if isinstance(v, jw.QLinear) else v for k, v in params["layers"].items()}
    params = jllama.fuse_linears(params, cfg)
    if with_cache:
        params["layers"] = jw.attach_w8_caches(params["layers"])
    return cfg, params


def _route_rows_7_8(monkeypatch, calls):
    """Point JAX's ``qlinear_apply_stacked`` at the interpret-mode rows 7
    and 8 for the folded linears of an a8 prefill, as its TPU branch routes
    them; everything else keeps the CPU path."""
    from awq_tpu.ops import w4a16 as jw

    orig = jw.qlinear_apply_stacked

    def routed(ql, layer_idx, x, a8=False, w8stack=None):
        x2 = x.reshape(-1, x.shape[-1])
        if not (a8 and ql.tiled_bn and ql.folded and not ql.dense3):
            return orig(ql, layer_idx, x, a8=a8, w8stack=w8stack)
        if w8stack is not None and x2.shape[0] >= jw._W8_MIN_M:
            calls.append("row 8")
            out = jw.w8a8_matmul_stacked_tiled(x2, w8stack.w8, w8stack.scol, layer_idx)
        elif x2.shape[0] >= jw._A8_MIN_M and ql.group_size == 128:
            calls.append("row 7")
            out = jw.w4a8_matmul_stacked_tiled_folded(x2, ql.qweight, layer_idx,
                                                      ql.group_size, ql.tiled_bn)
        else:
            return orig(ql, layer_idx, x, a8=a8, w8stack=w8stack)
        out = out.reshape(*x.shape[:-1], ql.out_features)
        if ql.bias is not None:
            out = out + ql.bias[layer_idx].astype(out.dtype)
        return out

    monkeypatch.setattr(jw, "qlinear_apply_stacked", routed)


# f32 on both sides and the same int8 products, bit for bit (the
# requant and the int32 sums are exact); what differs is the f32 glue's
# order (norms, rope, attention), measured ~1e-6 of the largest logit. A
# glue difference can move an activation across a code's rounding edge, one
# code step of its row; 1e-5 covers that with a 10x margin, and stays far
# below the int8 path's own distance from the W4A16 path (checked below).
@pytest.mark.parametrize("mode", ["prefill_w8", "prefill_a8"])
def test_forward_int8_prefill_matches_jax(mode, monkeypatch):
    import jax
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama
    from awq_tpu.ops import w4a16 as jw

    jcfg, jparams = _jax_tree(with_cache=mode == "prefill_w8")
    jcfg = dataclasses.replace(jcfg, prefill_a8=True)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    assert (sum(k.endswith("_w8") for k in tparams["layers"])
            == (4 if mode == "prefill_w8" else 0))
    tcfg = TConfig(**GEOM, prefill_a8=True)
    if mode == "prefill_a8":    # a 40-token prompt takes K10 / row 7
        monkeypatch.setattr(jw, "_A8_MIN_M", 32)
        monkeypatch.setenv("AWQ_TPU_A8_MIN_M", "32")
    calls = []
    _route_rows_7_8(monkeypatch, calls)
    monkeypatch.setenv("AWQ_TPU_FORCE_FLASH", "1")
    jax.clear_caches()   # forward's trace reads the env and the routing at trace time
    rng = np.random.default_rng(3)
    steps = [rng.integers(0, 512, (1, 40))] + [rng.integers(0, 512, (1, 1)) for _ in range(4)]
    jcache = jllama.init_kv_cache(jcfg, 1, T, jnp.float32)
    caches = [tllama.init_kv_cache(tcfg, 1, T, torch.float32, device="cpu") for _ in range(2)]
    pos = 0
    try:
        for toks in steps:
            jl, jcache = jllama.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), jcache,
                                        jnp.int32(pos))
            tl, _ = tllama.forward(tparams, tcfg, torch.from_numpy(toks), caches[0], pos)
            w4, _ = tllama.forward(tparams, dataclasses.replace(tcfg, prefill_a8=False),
                                   torch.from_numpy(toks), caches[1], pos)
            jl = np.asarray(jl)
            scale = np.abs(jl).max()
            np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-5 * scale)
            if pos == 0:   # the int8 prefill is not the W4A16 one
                assert np.abs(w4.numpy() - jl).max() > 1e-3 * scale
            pos += toks.shape[1]
    finally:
        jax.clear_caches()
    assert set(calls) == {"row 8" if mode == "prefill_w8" else "row 7"}


# ---- the engines ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = TConfig(**GEOM)
    params = tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=128),
                                 torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


# prompts over 32 tokens take K11 with the cache and K10 without it (its
# threshold lowered to 32), so the two must give the same ids, bit for
# bit; a 5-token prompt takes K1 on both
PROMPTS = ([int(t) for t in np.random.default_rng(1).integers(0, 512, 40)],
           [int(t) for t in np.random.default_rng(2).integers(0, 512, 33)],
           [3, 1, 4, 1, 5])


def _a8_only(cfg, monkeypatch):
    monkeypatch.setenv("AWQ_TPU_A8_MIN_M", "32")
    return dataclasses.replace(cfg, prefill_a8=True)


def test_inference_engine_prefill_w8_ids_equal_a8(tiny, monkeypatch):
    cfg, params = tiny
    gen = TGen(greedy=True, max_new_tokens=6)

    def ids(eng):
        return [eng.generate(p, gen)["output_ids"].tolist() for p in PROMPTS]

    w8 = InferenceEngine(cfg, params, TRuntime(max_seq_len=T, prefill_w8=True),
                         cache_dtype=torch.float32, device="cpu")
    assert w8.cfg.prefill_a8 and not cfg.prefill_a8
    assert sorted(k for k in w8.params["layers"] if k.endswith("_w8")) == [
        "down_w8", "wgateup_w8", "wo_w8", "wqkv_w8"]
    assert all(isinstance(v, tw.W8Stack) for k, v in w8.params["layers"].items()
               if k.endswith("_w8"))
    got = ids(w8)
    a8 = InferenceEngine(_a8_only(cfg, monkeypatch), params, TRuntime(max_seq_len=T),
                         cache_dtype=torch.float32, device="cpu")
    assert ids(a8) == got
    # a budget of the deepest linear's cache builds that one only; the
    # others take K10, so the ids stay the same
    cost = tw.w8_cache_cost(w8.params["layers"])
    part = InferenceEngine(cfg, params, TRuntime(max_seq_len=T, prefill_w8=True,
                                                 prefill_w8_budget_gb=cost["down"] / 2**30),
                           cache_dtype=torch.float32, device="cpu")
    assert [k for k in part.params["layers"] if k.endswith("_w8")] == ["down_w8"]
    assert ids(part) == got


def _drive(eng):
    rids = [eng.submit(p, TGen(greedy=True, max_new_tokens=6)) for p in PROMPTS]
    done = eng.run()
    return [done[r].out_ids for r in rids]


@pytest.mark.parametrize("engine", ["batch", "paged"])
def test_batch_engines_prefill_w8_ids_equal_a8(tiny, engine, monkeypatch):
    """The admission prefills (through the staging cache) take K11 with the
    cache and K10 without it: the same ids in both engines."""
    cfg, params = tiny

    def make(c, runtime=None):
        kw = dict(n_slots=2, max_seq_len=T, cache_dtype=torch.float32, device="cpu",
                  runtime=runtime)
        if engine == "paged":
            return PagedBatchEngine(c, params, page_size=64, **kw)
        return BatchEngine(c, params, **kw)

    w8 = make(cfg, TRuntime(prefill_w8=True))
    got = _drive(w8)
    assert all(len(ids) == 6 for ids in got)
    assert _drive(make(_a8_only(cfg, monkeypatch))) == got


# The plumbing tests of the JAX package (tests/test_w8_prefill.py), in
# place of the refusals of ``prefill_w8`` that the engines had.
def test_batch_engine_prefill_w8_plumbing(tiny):
    cfg, params = tiny
    eng = BatchEngine(cfg, params, n_slots=2, max_seq_len=64, cache_dtype=torch.float32,
                      runtime=TRuntime(prefill_w8=True), device="cpu")
    assert eng.cfg.prefill_a8
    w8_keys = [k for k in eng.params["layers"] if k.endswith("_w8")]
    assert w8_keys and all(isinstance(eng.params["layers"][k], tw.W8Stack) for k in w8_keys)
    rid = eng.submit([1, 2, 3], TGen(greedy=True, max_new_tokens=3))
    for _ in range(8):
        eng.step()
    assert rid in eng.finished and len(eng.finished[rid].out_ids) >= 1


def test_paged_engine_prefill_w8_plumbing(tiny):
    cfg, params = tiny
    eng = PagedBatchEngine(cfg, params, n_slots=2, max_seq_len=256, cache_dtype=torch.float32,
                           page_size=64, runtime=TRuntime(prefill_w8=True), device="cpu")
    assert eng.cfg.prefill_a8
    assert any(k.endswith("_w8") for k in eng.params["layers"])
    rid = eng.submit([1, 2, 3], TGen(greedy=True, max_new_tokens=2))
    for _ in range(6):
        eng.step()
    assert rid in eng.finished


def test_fuse_linears_and_params_to_carry_caches(tiny):
    """Caches attached to the unfused linears fuse with them, and
    ``params_to`` moves them: the fused caches equal those built from the
    fused linears."""
    cfg, params = tiny
    unfused = dict(params)
    unfused["layers"] = tw.attach_w8_caches(params["layers"])
    fused = tllama.fuse_linears(tllama.params_to(unfused, "cpu"), cfg)
    ref = tw.attach_w8_caches(tllama.fuse_linears(params, cfg)["layers"])
    for name in ("wqkv", "wgateup", "wo", "down"):
        got = fused["layers"][name + "_w8"]
        assert torch.equal(got.w8, ref[name + "_w8"].w8)
        assert torch.equal(got.scol, ref[name + "_w8"].scol)
    assert not any(k in fused["layers"] for k in ("wq_w8", "gate_w8"))


# ---- on the card: the int8 prefill through forward, kernels against plain -------------
# bf16 model; K11's and K10's outputs equal their plain versions', but the
# rest of the path (K3, the norms) rounds differently from the plain path:
# 5e-2 of the largest logit, as for the W4A16 path.
@pytest.mark.cuda
def test_forward_prefill_w8_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from awq_tpu_torch.ops import w8a8 as tq8

    cfg = TConfig(**{**GEOM, "dtype": "bfloat16", "prefill_a8": True})
    params = tllama.fuse_linears(tllama.init_qparams(
        cfg, TQuant(), torch.Generator("cuda").manual_seed(0)), cfg)
    params["layers"] = tw.attach_w8_caches(params["layers"])
    caches = [tllama.init_kv_cache(cfg, 1, T) for _ in range(2)]
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (1, 40))).cuda()
    before = tw.LAUNCHES["w8a8_gemm"], tq8.LAUNCHES["quant_per_token"]
    got, _ = tllama.forward(params, cfg, toks, caches[0], 0)
    ref, _ = tllama.forward(params, cfg, toks, caches[1], 0, impl="plain")
    assert tw.LAUNCHES["w8a8_gemm"] - before[0] == 4 * cfg.num_layers
    assert tq8.LAUNCHES["quant_per_token"] - before[1] == 4 * cfg.num_layers
    assert (got - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
