"""Port parity for MPT: K4's MPT shape, the family's ``forward`` and engine.

K4's MPT shape (``ops/megakernel.py``, ``shape="mpt"``: bias-free
LayerNorm, no rope, in-kernel ALiBi slopes, the erf-GELU ``up``/``down``
MLP) as its plain version, against the JAX package's interpret-mode
``w4a16_llama_token_step(norm="layernorm", act="gelu",
pos_embed="alibi")`` on the same folded W4 weights, and the gate's
refusals. A tiny f32 MPT (head_dim 128, two heads: MHA) through ``forward``
against JAX's ``forward``, on the stacked path (K2 and K3 with slopes, their
plain versions here) and on the megakernel (K4's plain version, as
``tests/test_alibi_flash.py:87-125`` runs JAX's), and the greedy ids of
``InferenceEngine`` against JAX's engine over 20 steps; the HF importer
against JAX's and ``transformers``' ``MptForCausalLM``; checkpoints both
ways; the batched, paged, int8 and tensor-parallel refusals. The tests
marked ``cuda`` hold K4's MPT units (W4 and W3) to the plain version on a
card and skip here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import ModelConfig as TConfig, QuantConfig as TQuant
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops import megakernel_batched as tmb
from awq_tpu_torch.ops import megakernel_chunk as tmc
from awq_tpu_torch.ops.w4a16 import QLinear

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

HD, T = 128, 256
MPT = dict(arch="mpt", vocab_size=512, hidden_size=256, intermediate_size=1024, num_layers=2,
           num_heads=2, num_kv_heads=2, head_dim=HD, max_position_embeddings=T,
           norm="layernorm", norm_bias=False, act="gelu", pos_embed="alibi",
           dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, ref, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = ref.float().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _jax_params(seed=1, **change):
    """JAX's MPT tree: ``init_params`` with random LayerNorm weights (it
    sets them to 1), real W4-g128 quantization."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    cfg = JConfig(**{**MPT, **change})
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed), scale=0.05)
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    for name in ("ln1", "ln2"):
        layers[name] = jnp.asarray(1.0 + 0.1 * rng.standard_normal(
            layers[name].shape).astype(np.float32))
    params = {**params, "layers": layers,
              "norm": jnp.asarray(1.0 + 0.1 * rng.standard_normal(
                  params["norm"].shape).astype(np.float32))}
    return cfg, jllama.quantize_params(params, JQuant(w_bit=4, group_size=128))


# ---- K4's MPT shape ---------------------------------------------------------

def _jax_folded(seed, H, I, nq, L, V):
    """Folded stacked W4 linears of the JAX package (the layout its
    megakernels take): wqkv, wo, up, down, and a stacked-of-1 head."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.w4a16 import quantize_linear, tile_qlinear

    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 64))

    def lin(ic, oc, layers):
        qls = [quantize_linear(jax.random.normal(next(keys), (ic, oc), jnp.float32) * 0.05)
               for _ in range(layers)]
        return tile_qlinear(jax.tree_util.tree_map(lambda *a: jnp.stack(a), *qls),
                            block_n=128, fold_scales=True)

    return {"wqkv": lin(H, 3 * nq * HD, L), "wo": lin(H, H, L), "up": lin(H, I, L),
            "down": lin(I, H, L), "lm_head": lin(H, V, 1)}


# The plain version computes in f32 what the JAX kernel computes in f32 in
# interpret mode (bf16(x) against the codes, the same rounding points); the
# JAX kernel's erf is Abramowitz-Stegun 7.1.26 (1.5e-7 off) and its codes are
# biased by 128. As for the llama shape (tests/test_torch_megakernel.py), an
# input on a bf16 rounding edge may round the other way on the two sides:
# 2^-8 of the largest output bounds the f32 logits. The residual and k/v
# leave in bf16, where such a difference that crosses a rounding edge shows
# as one bf16 step (2^-7 of an element's magnitude at most): 2^-7 of the
# largest output.
TOL, BF16_TOL = 2.0 ** -8, 2.0 ** -7


@pytest.mark.parametrize("length", [0, 37, 200])
def test_mpt_token_step_plain_matches_jax(length):
    import jax
    import jax.numpy as jnp
    from awq_tpu.ops.megakernel import w4a16_llama_token_step

    nq, H, I, L, V = 4, 512, 1024, 2, 256
    jl = _jax_folded(length + 3, H, I, nq, L, V)
    rng = np.random.default_rng(length)
    h = jnp.asarray(rng.standard_normal((1, H)).astype(np.float32) * 0.3).astype(jnp.bfloat16)
    ln1, ln2 = (jnp.asarray(rng.uniform(0.8, 1.2, (L, H)).astype(np.float32)) for _ in range(2))
    norm_w = jnp.asarray(rng.uniform(0.8, 1.2, H).astype(np.float32))
    cache = jnp.asarray(rng.standard_normal((L, 2, 1, nq, T, HD)).astype(np.float32)
                        * 0.3).astype(jnp.bfloat16)
    zeros = jnp.zeros((HD,), jnp.float32)
    res = w4a16_llama_token_step(
        h, jl["wqkv"], jl["wo"], jl["up"], jl["down"], ln1, ln2, zeros, zeros, cache,
        length, nq=nq, nkv=nq, eps=1e-5, interpret=True, whead=jl["lm_head"], norm_w=norm_w,
        norm="layernorm", act="gelu", pos_embed="alibi")
    t = params_from_jax(jax.device_get(jl), device="cpu")
    tt = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))  # noqa: E731
    tcache = tt(cache).to(torch.bfloat16)
    got = tmk.w4a16_llama_token_step(
        tt(h).to(torch.bfloat16), t["wqkv"], t["wo"], t["up"], t["down"], tt(ln1), tt(ln2),
        None, None, tcache, length, nq, nq, 1e-5, whead=t["lm_head"], norm_w=tt(norm_w),
        shape="mpt")
    assert len(got) == len(res) == 4
    for g, r in zip(got[:3], res[:3]):
        _close(g, r.astype(jnp.float32), BF16_TOL)
    _close(got[3], res[3], TOL)
    for l in range(L):        # the new k/v are written in place at `length`
        assert torch.equal(tcache[l, 0, 0, :, length], got[1][l])
        assert torch.equal(tcache[l, 1, 0, :, length], got[2][l])


def test_mpt_slopes_are_the_alibi_slopes():
    """The slopes K4's MPT shape computes from the head index are
    ``alibi_slopes`` for a power-of-two head count, to an f32 step."""
    from awq_tpu_torch.models.layers import alibi_slopes

    for n in (2, 4, 8, 16, 32, 64):
        torch.testing.assert_close(tmk.mpt_slopes(n), alibi_slopes(n), rtol=2 ** -23, atol=0)


def _tiny(**change):
    cfg = TConfig(**{**MPT, **change})
    return cfg, tllama.fuse_linears(
        tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=128), device="cpu"), cfg)


def test_gate_takes_the_mpt_shape_and_refuses_the_rest(monkeypatch):
    monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    cfg, params = _tiny()
    layers = params["layers"]
    cache = tllama.init_kv_cache(cfg, 1, 32, torch.float32, device="cpu")
    assert tmk.model_shape(cfg) == "mpt" and tmk.megakernel_supported(cfg, layers, cache)
    # K5 (the chunk window) and K6 (the batched step) take the llama shape only
    assert not tmc.chunk_megakernel_supported(cfg, layers, cache, 8)
    assert not tmb.megakernel_batched_supported(
        cfg, layers, tllama.init_kv_cache(cfg, 4, 32, torch.float32, device="cpu"), 4)
    # a head count that is no power of two: the slopes have no closed form
    cfg12, p12 = _tiny(hidden_size=12 * HD, num_heads=12, num_kv_heads=12)
    assert not tmk.megakernel_supported(cfg12, p12["layers"], tllama.init_kv_cache(
        cfg12, 1, 32, torch.float32, device="cpu"))
    # a LayerNorm bias, an int8 cache, the tanh GELU, an embedding norm
    biased = {**layers, "ln1_b": torch.zeros_like(layers["ln1"])}
    assert not tmk.megakernel_supported(cfg, biased, cache)
    assert not tmk.megakernel_supported(cfg, layers, tllama.init_cache(cfg, 1, 32, "int8",
                                                                       device="cpu"))
    for change in (dict(act="gelu_tanh"), dict(embed_ln=True)):
        assert not tmk.megakernel_supported(dataclasses.replace(cfg, **change), layers, cache)
    assert tllama.decode_step_on_k4(params, cfg, cache, 1)
    monkeypatch.setenv("AWQ_TPU_DISABLE_MEGAKERNEL", "1")
    assert not tmk.megakernel_supported(cfg, layers, cache)


def test_matmul_phases_of_the_mpt_shape():
    """K4's MPT phases per layer: QKV, o-proj, ``up`` over I (OC = I, no
    gate/up pairs) and down; every weight byte loaded once."""
    H, I, nq = 4096, 16384, 32
    phases = tmk.matmul_phases(tmk.MODE_LAYERS, 2, H, I, nq, nq, 50432, shape="mpt")
    assert [p.name for p in phases] == ["qkv", "o", "up", "down"] * 2 + ["head"]
    up = phases[2]
    assert (up.ic, up.oc, up.tiles, up.half) == (H, I, I // tmk.TILE, 0)
    assert sum(p.ic * p.oc for p in phases) // 2 == 2 * (
        H * 3 * H + H * H + 2 * H * I) // 2 + H * 50432 // 2
    for p in phases:
        seen = np.zeros((p.oc // tmk.TILE, p.ng), dtype=np.int64)
        for b in range(132):
            for w in range(tmk.WARPS):
                for col, g in tmk.warp_loads(p, b, 132, w):
                    seen[col // tmk.TILE, g] += 1
        assert (seen == 1).all(), p


# ---- the model -------------------------------------------------------------

# f32 on both sides: JAX's masked XLA attention with the bias slope * j
# against the port's K2/K3 plain versions (slope * j, slope * (j - i)); other
# summation orders, 1e-5 of the largest logit.
@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_forward_matches_jax(impl):
    import jax
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams = _jax_params()
    tcfg = TConfig(**MPT)
    tparams = tllama.fuse_linears(params_from_jax(jax.device_get(jparams), device="cpu"), tcfg)
    rng = np.random.default_rng(3)
    steps = [rng.integers(0, 512, (1, 11))] + [rng.integers(0, 512, (1, 1)) for _ in range(16)]
    jcache = jllama.init_kv_cache(jcfg, 1, T, jnp.float32)
    tcache = tllama.init_kv_cache(tcfg, 1, T, torch.float32, device="cpu")
    pos = 0
    for toks in steps:
        jl, jcache = jllama.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32), jcache,
                                    jnp.int32(pos), last_only=False)
        tl, tcache = tllama.forward(tparams, tcfg, torch.from_numpy(toks), tcache, pos,
                                    last_only=False, impl=impl)
        _close(tl, np.asarray(jl), 1e-5)
        pos += toks.shape[1]
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), rtol=0, atol=1e-4)


def test_megakernel_forward_matches_jax_megakernel(monkeypatch):
    """A decode step on K4's MPT shape (the plain version, with the quantized
    head in the kernel) against JAX's ``forward`` on its interpret-mode
    megakernel over the same fused, folded tree and cache (the setting of
    tests/test_alibi_flash.py:87-125), and the same greedy id. Two layers of
    the kernels' bf16 roundings (matmul inputs, the residual between layers)
    flip some rounding edges the other way on the two sides: 2.3e-3 to
    4.4e-3 of the largest logit measured over seeds 7-9; 2^-7 allowed."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    from awq_tpu.ops.megakernel import megakernel_supported as jgate

    wide = dict(hidden_size=512, num_heads=4, num_kv_heads=4)  # JAX's gate tiles OC by 512
    jcfg, jparams = _jax_params(7, **wide)
    jparams = jllama.quantize_head({**jparams, "lm_head": jparams["embed"].T}, jcfg)
    toks = jnp.asarray([[5, 9, 2, 7, 1, 4, 8, 3]], jnp.int32)
    jcache = jllama.init_kv_cache(jcfg, 1, T, jnp.float32)
    _, jcache = jllama.forward(jparams, jcfg, toks, jcache, jnp.int32(0))
    fused = jllama.fuse_linears(jparams, jcfg)
    assert jgate(jcfg, fused["layers"], jcache)
    monkeypatch.setenv("AWQ_TPU_FORCE_FLASH", "1")
    monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    jax.clear_caches()
    ref, _ = jllama.forward(fused, jcfg, jnp.asarray([[6]], jnp.int32), jcache, jnp.int32(8))
    tcfg = TConfig(**{**MPT, **wide})
    tparams = params_from_jax(jax.device_get(fused), device="cpu")
    assert tmk.head_in_kernel(tparams)
    tcache = torch.from_numpy(np.array(jcache))
    calls = []
    real = tmk.w4a16_llama_token_step_plain
    monkeypatch.setattr(tmk, "w4a16_llama_token_step_plain",
                        lambda *a, **k: calls.append(k["shape"]) or real(*a, **k))
    got, _ = tllama.forward(tparams, tcfg, torch.tensor([[6]]), tcache, 8, impl="plain")
    assert calls == ["mpt"]
    _close(got, np.asarray(ref), 2.0 ** -7)
    assert int(got[0, -1].argmax()) == int(jnp.argmax(ref[0, -1]))


def test_decode_step_and_graph_key_on_the_mpt_shape(monkeypatch):
    """``decode_step`` (the captured step's body, its position an int32
    tensor) takes K4's MPT shape and gives ``forward``'s bits at that
    position; ``DecodeLoop.graph_key`` tells that path from the stacked one,
    so an MPT burst replays its own graph."""
    from awq_tpu_torch.config import GenConfig as TGen
    from awq_tpu_torch.runtime.generate import DecodeLoop

    monkeypatch.setenv("AWQ_TPU_FORCE_MEGAKERNEL", "1")
    monkeypatch.delenv("AWQ_TPU_DISABLE_MEGAKERNEL", raising=False)
    cfg = TConfig(**MPT)
    params = tllama.fuse_linears(tllama.quantize_head(
        tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=128), device="cpu"), cfg), cfg)
    assert tmk.head_in_kernel(params)
    caches = [tllama.init_kv_cache(cfg, 1, 64, torch.float32, device="cpu") for _ in range(2)]
    prompt = torch.tensor([[3, 1, 4, 1, 5]])
    for c in caches:
        tllama.forward(params, cfg, prompt, c, 0)
    ref, _ = tllama.forward(params, cfg, torch.tensor([[9]]), caches[0], 5)
    got = tllama.decode_step(params, cfg, torch.tensor([9]), caches[1],
                             torch.tensor([5], dtype=torch.int32), 63)
    assert torch.equal(got, ref[:, 0]) and torch.equal(caches[0], caches[1])
    loop = DecodeLoop(params, cfg, caches[1])
    on_k4 = loop.graph_key(TGen(greedy=True), 63)
    monkeypatch.setenv("AWQ_TPU_DISABLE_MEGAKERNEL", "1")
    stacked = loop.graph_key(TGen(greedy=True), 63)
    assert on_k4 != stacked and on_k4[2] is True and stacked[2] is False


def test_engine_greedy_ids_bit_exact():
    """Greedy ids of ``InferenceEngine.generate`` over 20 new tokens equal
    the JAX engine's bit for bit (both on the stacked path of the CPU)."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen, RuntimeConfig as JRuntime
    from awq_tpu.runtime.engine import InferenceEngine as JEngine
    from awq_tpu_torch.config import GenConfig as TGen, RuntimeConfig as TRuntime
    from awq_tpu_torch.runtime.engine import InferenceEngine as TEngine

    jcfg, jparams = _jax_params(4)
    jeng = JEngine(jcfg, jparams, JRuntime(max_seq_len=T), cache_dtype=jnp.float32)
    teng = TEngine(TConfig(**MPT), params_from_jax(jax.device_get(jparams), device="cpu"),
                   TRuntime(max_seq_len=T), cache_dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(6).integers(0, 512, 9).tolist()
    jids = np.asarray(jeng.generate(prompt, JGen(greedy=True, max_new_tokens=20))["output_ids"])
    tids = teng.generate(prompt, TGen(greedy=True, max_new_tokens=20))["output_ids"].numpy()
    assert len(jids) == 20
    np.testing.assert_array_equal(tids, jids)


def test_init_qparams_builds_the_mpt_tree():
    """No gate, no LayerNorm biases, no linear biases; ``up``/``down`` of JAX's
    ``init_qparams`` shapes; ``up`` fuses into nothing."""
    import jax
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    jq = jllama.init_qparams(JConfig(**MPT), JQuant(w_bit=4, group_size=128),
                             jax.random.PRNGKey(0))
    tp = tllama.init_qparams(TConfig(**MPT), TQuant(w_bit=4, group_size=128), device="cpu")
    assert set(tp["layers"]) == {"ln1", "ln2", "wq", "wk", "wv", "wo", "up", "down"}
    assert set(tp) == set(jq) == {"embed", "layers", "norm", "lm_head"}
    for name, p in tp["layers"].items():
        if isinstance(p, QLinear):
            assert p.bias is None
            for f in ("qweight", "scales", "szeros"):
                assert tuple(getattr(p, f).shape) == tuple(getattr(jq["layers"][name], f).shape)
    assert "wgateup" not in tllama.fuse_linears(tp, TConfig(**MPT))["layers"]


# ---- HF import and checkpoints -------------------------------------------------

def _hf_mpt(seed=2):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.MptConfig(d_model=256, n_heads=2, n_layers=2, expansion_ratio=4,
                                 max_seq_len=128, vocab_size=256, no_bias=True)
    torch.manual_seed(seed)
    return transformers.MptForCausalLM(cfg).eval().float()


def test_import_equals_jax_and_logits_equal_hf():
    from awq_tpu.models.hf_import import import_hf_model as jimport
    from awq_tpu_torch.models import hf_import as thf
    from tests.test_torch_hf_import import _assert_trees_equal

    model = _hf_mpt()
    cfg, params = thf.import_hf_model(model, dtype="float32", device="cpu")
    jcfg, jparams = jimport(model, dtype="float32")
    assert cfg.__dict__ == jcfg.__dict__ and cfg.arch == "mpt"
    _assert_trees_equal(params, jparams)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 9))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens).long()).logits.numpy()
    cache = tllama.init_kv_cache(cfg, 1, 16, torch.float32, device="cpu")
    ours, _ = tllama.forward(params, cfg, torch.from_numpy(tokens), cache, 0, last_only=False)
    # the JAX package's tolerance against HF (tests/test_models_multiarch.py)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_round_trip_with_jax(direction, tmp_path):
    import jax
    from awq_tpu.config import QuantConfig as JQuant
    from awq_tpu.utils import checkpoint as jck
    from awq_tpu_torch.utils import checkpoint as tck
    from tests.test_torch_checkpoint import _assert_same

    jcfg, tree = _jax_params(5)
    qcfg = JQuant(w_bit=4, group_size=128)
    path = str(tmp_path / "ck")
    port = params_from_jax(jax.device_get(tree), device="cpu")
    if direction == "jax_to_port":
        jck.save_checkpoint(path, tree, jcfg, qcfg)
        got, tcfg, _ = tck.load_checkpoint(path, device="cpu")
        _assert_same(got, port)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    else:
        tck.save_checkpoint(path, port, TConfig(**dataclasses.asdict(jcfg)),
                            TQuant(**dataclasses.asdict(qcfg)))
        jtree, jcfg2, _ = jck.load_checkpoint(path)
        _assert_same(params_from_jax(jax.device_get(jtree), device="cpu"), port)
        assert dataclasses.asdict(jcfg2) == dataclasses.asdict(jcfg)


def test_unported_mpt_paths_raise():
    """MPT's batched, paged and int8 paths run (``tests/test_torch_family_*.py``
    holds them to JAX); its tensor-parallel paths raise naming ROADMAP A17b,
    and the shapes of other families naming A12."""
    from awq_tpu_torch.parallel.deploy import build_tp_params
    from awq_tpu_torch.parallel.mesh import TPGroup

    cfg, params = _tiny()
    toks, lens = torch.tensor([1, 2]), torch.tensor([0, 3], dtype=torch.int32)
    cache = tllama.init_kv_cache(cfg, 2, 16, torch.float32, device="cpu")
    tllama.decode_step_batched(params, cfg, toks, cache, lens)
    pool = torch.zeros((2, 2, 4, 2, 8, HD))
    tllama.decode_step_paged(params, cfg, toks, pool, torch.tensor([[1], [2]],
                                                                  dtype=torch.int32), lens)
    tllama.forward(params, cfg, toks[None, :1], tllama.init_cache(cfg, 1, 16, "int8",
                                                                  device="cpu"), 0)
    group = TPGroup(rank=0, size=1, group=None, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="item 17b"):
        tllama.forward(params, cfg, toks[None, :1], cache[:, :, :1].contiguous(), 0,
                       tp_axis=group)
    with pytest.raises(NotImplementedError, match="item 17b"):
        build_tp_params(tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=128),
                                            device="cpu"), cfg, group)
    for change in (dict(norm_bias=True), dict(act="gelu_tanh"), dict(pos_embed="rope"),
                   dict(embed_ln=True), dict(mlp_bias=True)):
        with pytest.raises(NotImplementedError, match="item 12"):
            tllama.forward(params, dataclasses.replace(cfg, **change), toks[None, :1],
                           cache[:, :, :1].contiguous(), 0)


# ---- on the card: K4's MPT units against the plain version ------------------------

CARD_TOL = 2.0 ** -6     # as the llama units' (tests/test_torch_megakernel.py)


def _card_mpt(dev, w3, L, seed):
    cfg = TConfig(**{**MPT, "hidden_size": 512, "num_heads": 4, "num_kv_heads": 4,
                     "num_layers": L, "dtype": "bfloat16"})
    g = torch.Generator(device=dev).manual_seed(seed)
    params = tllama.init_qparams(cfg, TQuant(w_bit=3 if w3 else 4, group_size=128), g,
                                 scale=0.05, device=dev)
    params["lm_head"] = params["embed"].T.contiguous()
    params = tllama.fuse_linears(tllama.quantize_head(params, cfg), cfg)
    la = params["layers"]
    for name in ("ln1", "ln2"):
        la[name] = (torch.rand(la[name].shape, generator=g, device=dev) * 0.4 + 0.8).to(
            torch.bfloat16)
    cache = (torch.randn((L, 2, 1, 4, 2048, HD), generator=g, device=dev) * 0.5).to(
        torch.bfloat16)
    h = (torch.randn((1, 512), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    return cfg, params, cache, h


@pytest.mark.cuda
@pytest.mark.parametrize("w3", [False, True])
@pytest.mark.parametrize("length", [0, 37, 1500])
def test_mpt_kernels_match_plain_on_card(cuda, w3, length):
    cfg, params, cache, h = _card_mpt(cuda, w3, 3, length)
    la = params["layers"]
    args = (la["wqkv"], la["wo"], la["up"], la["down"], la["ln1"], la["ln2"], None, None)
    kw = dict(whead=params["lm_head"], norm_w=params["norm"], shape="mpt")
    c1, c2 = cache.clone(), cache.clone()
    got = tmk.w4a16_llama_token_step(h, *args, c1, length, 4, 4, 1e-5, **kw)
    ref = tmk.w4a16_llama_token_step_plain(h, *args, c2, length, 4, 4, 1e-5, **kw)
    torch.cuda.synchronize()
    for g_, r_ in zip(got, ref):
        _close(g_.cpu(), r_.cpu(), CARD_TOL)
    _close(c1.cpu(), c2.cpu(), CARD_TOL)
    unit = "megakernel_token_mpt" + ("_w3" if w3 else "")
    before = tmk.LAUNCHES[unit]
    # the position read in device memory: the bits of the host length
    pos = torch.tensor([length], dtype=torch.int32, device=cuda)
    dev = tmk.w4a16_llama_token_step(h, *args, cache.clone(), pos, 4, 4, 1e-5,
                                     max_length=2047, **kw)
    host = tmk.w4a16_llama_token_step(h, *args, cache.clone(), length, 4, 4, 1e-5, **kw)
    assert all(torch.equal(a, b) for a, b in zip(dev, host))
    assert tmk.LAUNCHES[unit] == before + 2
    lay = tmk.w4a16_llama_layer_step(h, *args, cache.clone(), 1, length, 4, 4, 1e-5,
                                     shape="mpt")
    lref = tmk.w4a16_llama_layer_step_plain(h, *args, cache.clone(), 1, length, 4, 4, 1e-5,
                                            shape="mpt")
    for g_, r_ in zip(lay, lref):
        _close(g_.cpu(), r_.cpu(), CARD_TOL)


@pytest.mark.cuda
def test_mpt_forward_and_decode_step_on_card(cuda):
    """``forward`` of an MPT model on the card: the prompt on the stacked
    path (K1, K3 with slopes), decode on K4's MPT shape, within 5e-2 of the
    largest logit of the plain path (phase 4's bound), and ``decode_step``
    with a device position gives the bits of ``forward``'s K4 step."""
    cfg, params, _, _ = _card_mpt(cuda, False, 2, 5)
    caches = [tllama.init_kv_cache(cfg, 1, 512, device=cuda) for _ in range(3)]
    g = torch.Generator().manual_seed(1)
    steps = [torch.randint(0, 512, (1, 40), generator=g)] + [
        torch.randint(0, 512, (1, 1), generator=g) for _ in range(4)]
    pos = 0
    for toks in steps:
        toks = toks.to(cuda)
        got, _ = tllama.forward(params, cfg, toks, caches[0], pos)
        ref, _ = tllama.forward(params, cfg, toks, caches[1], pos, impl="plain")
        _close(got.cpu(), ref.cpu(), 5e-2)
        if toks.shape[1] == 1:
            at = torch.tensor([pos], dtype=torch.int32, device=cuda)
            dstep = tllama.decode_step(params, cfg, toks[:, 0], caches[2], at, 511)
            assert torch.equal(dstep, got[:, 0])
        else:
            tllama.forward(params, cfg, toks, caches[2], pos)
        pos += toks.shape[1]
