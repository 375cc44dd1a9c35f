"""Port parity for BLOOM: the embedding LayerNorm, biases on every linear,
the tanh-GELU MLP and ALiBi on the stacked path.

Tiny f32 BLOOM models at head_dim 64 (BLOOM-560m's; four heads, and twelve
for the closest-power-of-two slopes) and 128 through ``forward`` against
JAX's ``forward`` (the port's K14 through ``layers.attention`` at head_dim
64, K2 at 128, K3 for prompts, each with slopes: their plain versions
here), and the greedy ids of ``InferenceEngine`` against JAX's engine over
20 steps; the parameter tree of ``init_qparams``; the HF importer (the
per-head ``neox`` QKV interleave) against JAX's and ``transformers``'
``BloomForCausalLM``; checkpoints both ways with JAX; K4's refusal (a
LayerNorm bias, as JAX's gate) and the batched, paged, int8 and
tensor-parallel refusals. The tests marked ``cuda`` hold the stacked path
on the card to its plain version and skip here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import ModelConfig as TConfig, QuantConfig as TQuant
from awq_tpu_torch.convert import params_from_jax
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import decode_attn as tda
from awq_tpu_torch.ops import megakernel as tmk
from awq_tpu_torch.ops.w4a16 import QLinear

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

T = 256
BLOOM = dict(arch="bloom", vocab_size=512, num_layers=2, max_position_embeddings=T,
             norm="layernorm", act="gelu_tanh", pos_embed="alibi", attn_bias=True,
             mlp_bias=True, embed_ln=True, tie_word_embeddings=True, dtype="float32")
STYLES = {"hd64": dict(BLOOM, hidden_size=256, intermediate_size=1024, num_heads=4,
                       num_kv_heads=4, head_dim=64),
          "hd64x12": dict(BLOOM, hidden_size=768, intermediate_size=768, num_heads=12,
                          num_kv_heads=12, head_dim=64),
          "hd128": dict(BLOOM, hidden_size=256, intermediate_size=1024, num_heads=2,
                        num_kv_heads=2, head_dim=128)}


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


def _jax_params(style, seed=1):
    """JAX's BLOOM tree: ``init_params`` with random norm weights and biases
    and linear biases (it sets them to 1 and 0), real W4-g64 quantization."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    cfg = JConfig(**STYLES[style])
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed), scale=0.05)
    rng = np.random.default_rng(seed)

    def jitter(a, base):
        return jnp.asarray(base + 0.1 * rng.standard_normal(a.shape).astype(np.float32))

    layers = {k: (jitter(v, 0.0 if k.endswith("_b") else 1.0) if k.startswith("ln") else v)
              for k, v in params["layers"].items()}
    for name in ("wq", "wk", "wv", "wo", "up", "down"):
        layers[name] = dataclasses.replace(layers[name], b=jitter(layers[name].b, 0.0))
    params = {**params, "layers": layers,
              **{k: jitter(params[k], 0.0 if k.endswith("_b") else 1.0)
                 for k in ("norm", "norm_b", "embed_ln_w", "embed_ln_b")}}
    return cfg, jllama.quantize_params(params, JQuant(w_bit=4, group_size=64))


def test_embed_ln_matches_jax():
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    cfg = TConfig(**STYLES["hd64"])
    rng = np.random.default_rng(0)
    h = (2.0 + rng.standard_normal((1, 5, 256))).astype(np.float32)
    w, b = rng.standard_normal(256).astype(np.float32), rng.standard_normal(256).astype(np.float32)
    ref = np.asarray(jllama._embed_ln(cfg, {"embed_ln_w": jnp.asarray(w),
                                            "embed_ln_b": jnp.asarray(b)}, jnp.asarray(h)))
    got = tllama._embed_ln(cfg, {"embed_ln_w": torch.from_numpy(w),
                                 "embed_ln_b": torch.from_numpy(b)}, torch.from_numpy(h))
    _close(got, ref, 2e-6)
    no_ln = TConfig(**{**STYLES["hd64"], "embed_ln": False})
    assert torch.equal(tllama._embed_ln(no_ln, {}, torch.from_numpy(h)), torch.from_numpy(h))


# f32 on both sides: JAX's masked XLA attention with the bias slope * j
# against the port's K14 (head_dim 64, through layers.attention) or K2
# (128) and K3 plain versions; other summation orders, 1e-5 of the largest
# logit.
@pytest.mark.parametrize("style", list(STYLES))
@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_forward_matches_jax(style, impl):
    import jax
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama

    jcfg, jparams = _jax_params(style)
    tcfg = TConfig(**STYLES[style])
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


@pytest.mark.parametrize("style", ["hd64", "hd128"])
def test_engine_greedy_ids_bit_exact(style):
    """Greedy ids of ``InferenceEngine.generate`` over 20 new tokens equal
    the JAX engine's bit for bit (the CPU's stacked path on both sides)."""
    import jax
    import jax.numpy as jnp
    from awq_tpu.config import GenConfig as JGen, RuntimeConfig as JRuntime
    from awq_tpu.runtime.engine import InferenceEngine as JEngine
    from awq_tpu_torch.config import GenConfig as TGen, RuntimeConfig as TRuntime
    from awq_tpu_torch.runtime.engine import InferenceEngine as TEngine

    jcfg, jparams = _jax_params(style, seed=4)
    jeng = JEngine(jcfg, jparams, JRuntime(max_seq_len=T), cache_dtype=jnp.float32)
    teng = TEngine(TConfig(**STYLES[style]), params_from_jax(jax.device_get(jparams),
                                                             device="cpu"),
                   TRuntime(max_seq_len=T), cache_dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(6).integers(0, 512, 9).tolist()
    jids = np.asarray(jeng.generate(prompt, JGen(greedy=True, max_new_tokens=20))["output_ids"])
    tids = teng.generate(prompt, TGen(greedy=True, max_new_tokens=20))["output_ids"].numpy()
    assert len(jids) == 20
    np.testing.assert_array_equal(tids, jids)


def test_init_qparams_builds_the_bloom_tree():
    """LayerNorm biases, the embedding LayerNorm, a bias on every linear,
    no gate; the packed linears of JAX's ``init_qparams`` shapes; K4 refuses
    the tree (its LayerNorm bias, as JAX's gate), so decode takes the
    stacked path."""
    import jax
    from awq_tpu.config import ModelConfig as JConfig, QuantConfig as JQuant
    from awq_tpu.models import llama as jllama

    cfg = TConfig(**STYLES["hd128"])
    jtree = jllama.init_params(JConfig(**STYLES["hd128"]), jax.random.PRNGKey(0))
    jq = jllama.init_qparams(JConfig(**STYLES["hd128"]), JQuant(w_bit=4, group_size=64),
                             jax.random.PRNGKey(0))
    tp = tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=64), device="cpu")
    assert set(tp) == set(jtree) == {"embed", "layers", "norm", "norm_b", "embed_ln_w",
                                     "embed_ln_b"}
    assert set(tp["layers"]) == set(jtree["layers"])
    for name, p in tp["layers"].items():
        if isinstance(p, QLinear):
            assert p.bias is not None and tuple(p.bias.shape) == tuple(jq["layers"][name].bias.shape)
            for f in ("qweight", "scales", "szeros"):
                assert tuple(getattr(p, f).shape) == tuple(getattr(jq["layers"][name], f).shape)
    fused = tllama.fuse_linears(tp, cfg)
    cache = tllama.init_kv_cache(cfg, 1, 32, torch.float32, device="cpu")
    assert tmk.model_shape(cfg) is None
    assert not tmk.megakernel_supported(cfg, fused["layers"], cache)
    assert not tllama.decode_step_on_k4(fused, cfg, cache, 1)


# ---- HF import and checkpoints -------------------------------------------------

def _hf_bloom(n_head, seed):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BloomConfig(vocab_size=256, hidden_size=64 * n_head, n_layer=2,
                                   n_head=n_head)
    torch.manual_seed(seed)
    model = transformers.BloomForCausalLM(cfg).eval().float()
    with torch.no_grad():       # BLOOM initialises its LayerNorms to 1 and 0
        for name, p in model.named_parameters():
            if "layernorm" in name or "ln_f" in name:
                p.add_(0.1 * torch.randn(p.shape))
    return model


@pytest.mark.parametrize("n_head", [4, 12])
def test_import_equals_jax_and_logits_equal_hf(n_head):
    from awq_tpu.models.hf_import import import_hf_model as jimport
    from awq_tpu_torch.models import hf_import as thf
    from tests.test_torch_hf_import import _assert_trees_equal

    model = _hf_bloom(n_head, n_head)
    cfg, params = thf.import_hf_model(model, dtype="float32", device="cpu")
    jcfg, jparams = jimport(model, dtype="float32")
    assert cfg.__dict__ == jcfg.__dict__ and cfg.arch == "bloom" and cfg.head_dim == 64
    _assert_trees_equal(params, jparams)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 9))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens).long()).logits.numpy()
    cache = tllama.init_kv_cache(cfg, 1, 16, torch.float32, device="cpu")
    ours, _ = tllama.forward(params, cfg, torch.from_numpy(tokens), cache, 0, last_only=False)
    # the JAX package's tolerance against HF (tests/test_models_multiarch.py)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=3e-3, atol=3e-3)
    # one more position: the decode step (K14 with slopes) against HF's logits
    nxt = np.concatenate([tokens, [[7]]], axis=1)
    with torch.no_grad():
        ref2 = model(torch.from_numpy(nxt).long()).logits.numpy()[:, -1:]
    ours2, _ = tllama.forward(params, cfg, torch.tensor([[7]]), cache, 9)
    np.testing.assert_allclose(ours2.numpy(), ref2, rtol=3e-3, atol=3e-3)


def test_split_qkv_neox_layout():
    """The ``neox`` split takes q, k and v from each head's ``[3, hd]`` block
    of the fused output, as JAX's ``_split_qkv`` does."""
    import jax.numpy as jnp
    from awq_tpu.models import hf_import as jhf
    from awq_tpu.models.layers import Linear as JLinear
    from awq_tpu_torch.models import hf_import as thf
    from awq_tpu_torch.models.layers import Linear

    cfg = TConfig(**STYLES["hd64"])
    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, 256, 3 * 256)).astype(np.float32)
    b = rng.standard_normal((2, 3 * 256)).astype(np.float32)
    ref = jhf._split_qkv(cfg, JLinear(w=jnp.asarray(w), b=jnp.asarray(b)), "neox")
    got = thf._split_qkv(cfg, Linear(w=torch.from_numpy(w), b=torch.from_numpy(b)), "neox")
    for k in ("wq", "wk", "wv"):
        np.testing.assert_array_equal(got[k].w.numpy(), np.asarray(ref[k].w))
        np.testing.assert_array_equal(got[k].b.numpy(), np.asarray(ref[k].b))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_round_trip_with_jax(direction, tmp_path):
    import jax
    from awq_tpu.config import QuantConfig as JQuant
    from awq_tpu.utils import checkpoint as jck
    from awq_tpu_torch.utils import checkpoint as tck
    from tests.test_torch_checkpoint import _assert_same

    jcfg, tree = _jax_params("hd64", seed=5)
    qcfg = JQuant(w_bit=4, group_size=64)
    path = str(tmp_path / "ck")
    port = params_from_jax(jax.device_get(tree), device="cpu")
    assert {"embed_ln_w", "embed_ln_b", "norm_b"} <= set(port)
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


def test_unported_bloom_paths_raise():
    """BLOOM's batched, paged and int8 paths run (``tests/test_torch_family_*.py``
    holds them to JAX); its tensor-parallel paths raise naming ROADMAP A17b,
    and the shapes of other families naming A12."""
    from awq_tpu_torch.parallel.deploy import build_tp_params
    from awq_tpu_torch.parallel.mesh import TPGroup

    cfg = TConfig(**STYLES["hd128"])
    qp = tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=64), device="cpu")
    params = tllama.fuse_linears(qp, cfg)
    toks, lens = torch.tensor([1, 2]), torch.tensor([0, 3], dtype=torch.int32)
    cache = tllama.init_kv_cache(cfg, 2, 16, torch.float32, device="cpu")
    tllama.decode_step_batched(params, cfg, toks, cache, lens)
    tllama.decode_step_paged(params, cfg, toks, torch.zeros((2, 2, 4, 2, 8, 128)),
                             torch.tensor([[1], [2]], dtype=torch.int32), lens)
    tllama.forward(params, cfg, toks[None, :1], tllama.init_cache(cfg, 1, 16, "int8",
                                                                  device="cpu"), 0)
    group = TPGroup(rank=0, size=1, group=None, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="item 17b"):
        tllama.forward(params, cfg, toks[None, :1], cache[:, :, :1].contiguous(), 0,
                       tp_axis=group)
    with pytest.raises(NotImplementedError, match="item 17b"):
        build_tp_params(qp, cfg, group)
    for change in (dict(embed_ln=False), dict(mlp_bias=False), dict(act="gelu"),
                   dict(pos_embed="learned"), dict(parallel_block=True)):
        with pytest.raises(NotImplementedError, match="item 12"):
            tllama.forward(params, dataclasses.replace(cfg, **change), toks[None, :1],
                           cache[:, :, :1].contiguous(), 0)


# ---- on the card: the stacked path against its plain version -------------------

@pytest.mark.cuda
@pytest.mark.parametrize("style", ["hd64x12", "hd128"])
def test_bloom_forward_on_card(cuda, style):
    """A bf16 BLOOM on the card: the prompt on K1's GEMM and K3 with slopes,
    each decode step on K14 (head_dim 64) or K2 (128) with slopes, within
    5e-2 of the largest logit of the plain path (phase 4's bound); the ALiBi
    modes launch once a layer and step, the other modes not at all."""
    cfg = TConfig(**{**STYLES[style], "dtype": "bfloat16"})
    g = torch.Generator(device=cuda).manual_seed(2)
    params = tllama.init_qparams(cfg, TQuant(w_bit=4, group_size=64), g, scale=0.05,
                                 device=cuda)
    for name, p in params["layers"].items():
        if isinstance(p, QLinear):
            p.bias.copy_(torch.randn(p.bias.shape, generator=g, device=cuda) * 0.05)
    params = tllama.fuse_linears(params, cfg)
    caches = [tllama.init_kv_cache(cfg, 1, 512, device=cuda) for _ in range(2)]
    rng = torch.Generator().manual_seed(1)
    steps = [torch.randint(0, 512, (1, 40), generator=rng)] + [
        torch.randint(0, 512, (1, 1), generator=rng) for _ in range(4)]
    dec = "flash_decode_layer_alibi" if cfg.head_dim == 64 else "flash_decode_alibi"
    before = dict(tda.LAUNCHES)
    pos = 0
    for toks in steps:
        toks = toks.to(cuda)
        got, _ = tllama.forward(params, cfg, toks, caches[0], pos)
        ref, _ = tllama.forward(params, cfg, toks, caches[1], pos, impl="plain")
        _close(got.cpu(), ref.cpu(), 5e-2)
        pos += toks.shape[1]
    moved = {k: tda.LAUNCHES[k] - before[k] for k in tda.LAUNCHES}
    assert moved[dec] == 4 * cfg.num_layers and moved["flash_prefill_alibi"] == cfg.num_layers
    assert sum(v for k, v in moved.items() if not k.endswith("_alibi")) == 0
