"""Port parity for GPT-BigCode (StarCoder): learned positions, LayerNorm with
bias, the tanh GELU, biases, MQA.

Two tiny f32 styles of ``tests/test_torch_opt.py`` (its helpers): 4 q heads
over one kv head at head_dim 64, and StarCoder's group, 48 q heads over one
kv head at head_dim 128 (the width cut to 256, the heads kept): the
single-position step takes K14 there (wider than K2's ``decode_attn``
unit), the per-row steps K2, K8 and K9 in the unit ``decode_attn_wide``.
Against the JAX package: ``forward``, ``decode_step``, the engines' greedy
ids, the batched step over f32 and bf16 slot caches, the paged step and the
int8 cache; the importer against JAX's and ``transformers``' logits. JAX's
importer splits ``c_attn`` of an MHA model (``multi_query=False``) as q | k
| v blocks, where HF views it per head as ``[n_head, 3, head_dim]``: its
logits part from HF's, and the port takes HF's view (ROADMAP C). The tests
marked ``cuda`` hold K14, K2, K8, K9 and K3 at StarCoder's group and the
stacked path to their plain versions on a card and skip here.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.models import layers as tlayers
from awq_tpu_torch.models import llama as tllama
from awq_tpu_torch.ops import cache_append as tca
from awq_tpu_torch.ops import decode_attn as tda
from test_torch_opt import (check_batch_engines, check_batched, check_checkpoint,  # noqa: F401
                            check_decode_step, check_engine_ids, check_forward,
                            check_forward_on_card, check_hf_logits, check_import, check_int8,
                            check_paged, check_refusals, check_steps_on_card, cuda, jitter_hf)

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

BIGCODE_STYLES = ["bigcode", "bigcode48"]


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("style", BIGCODE_STYLES)
def test_forward_matches_jax(style, impl):
    check_forward(style, impl)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("style", BIGCODE_STYLES)
def test_decode_step_matches_forward(style, cache_dtype):
    check_decode_step(style, cache_dtype)


def test_single_position_step_takes_k14_per_row_steps_k2(monkeypatch):
    """At StarCoder's group the single-position step (``forward`` at S = 1,
    ``decode_step``) attends through K14 (``layers.attention`` or its
    device-length call), the per-row step through K2: the wrappers'
    calls, their plain versions on the CPU."""
    from test_torch_opt import family_model

    _, _, tcfg, tparams = family_model("bigcode48")
    assert not tda.flash_decode_supported(48, 1, 128, torch.bfloat16)
    calls = []
    for name in ("flash_decode", "flash_decode_layer", "attention"):
        real = getattr(tllama, name)
        monkeypatch.setattr(tllama, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    one = tllama.init_kv_cache(tcfg, 1, 64, torch.float32, device="cpu")
    tllama.forward(tparams, tcfg, torch.tensor([[5]]), one, 3)
    tllama.decode_step(tparams, tcfg, torch.tensor([5]), one,
                       torch.tensor([4], dtype=torch.int32), 63)
    assert calls == ["attention"] * 2 + ["flash_decode_layer"] * 2
    calls.clear()
    cache = tllama.init_kv_cache(tcfg, 3, 64, torch.float32, device="cpu")
    tllama.decode_step_batched(tparams, tcfg, torch.tensor([1, 2, 3]), cache,
                               torch.tensor([4, 0, 9], dtype=torch.int32))
    assert calls == ["flash_decode"] * 2


@pytest.mark.parametrize("style", BIGCODE_STYLES)
def test_engine_greedy_ids_bit_exact(style):
    check_engine_ids(style)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_step_batched_matches_jax(cache_dtype, monkeypatch):
    check_batched("bigcode48", cache_dtype, monkeypatch)


def test_decode_step_paged_matches_jax(monkeypatch):
    check_paged("bigcode48", monkeypatch)


def test_int8_cache_matches_jax(monkeypatch):
    check_int8("bigcode48", monkeypatch)


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_batch_engines_greedy_ids_match_jax(paged, monkeypatch):
    check_batch_engines("bigcode", paged, monkeypatch)


def _hf_bigcode(multi_query, seed):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.GPTBigCodeConfig(vocab_size=256, n_embd=256, n_layer=2, n_head=4,
                                        n_positions=64, multi_query=multi_query)
    torch.manual_seed(seed)
    return jitter_hf(transformers.GPTBigCodeForCausalLM(cfg), seed)


def test_import_equals_jax_and_logits_equal_hf():
    """StarCoder's MQA ``c_attn`` (q heads | one k | one v, the ``mqa``
    split): the port's tree equals JAX's, the logits HF's."""
    cfg = check_import(_hf_bigcode(True, 3), "bigcode")
    assert cfg.num_kv_heads == 1 and cfg.pos_embed == "learned" and cfg.act == "gelu_tanh"


def test_mha_import_takes_hf_layout_where_jax_parts():
    """``multi_query=False``: HF views ``c_attn``'s output per head as
    ``[n_head, 3, head_dim]`` (``modeling_gpt_bigcode.py``, the MHA branch
    of ``GPTBigCodeAttention.forward``). JAX's importer cuts it as q | k | v
    blocks, so its logits part from HF's by far more than its tolerance;
    the port's importer takes the per-head view and gives HF's logits."""
    import jax.numpy as jnp
    from awq_tpu.models import llama as jllama
    from awq_tpu.models.hf_import import import_hf_model as jimport
    from awq_tpu_torch.models import hf_import as thf

    model = _hf_bigcode(False, 4)
    cfg, params = thf.import_hf_model(model, dtype="float32", device="cpu")
    assert cfg.num_kv_heads == cfg.num_heads == 4
    check_hf_logits(model, cfg, params)
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 9))
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens).long()).logits.numpy()
    jcfg, jparams = jimport(model, dtype="float32")
    jl, _ = jllama.forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32),
                           jllama.init_kv_cache(jcfg, 1, 16, jnp.float32), jnp.int32(0),
                           last_only=False)
    assert np.abs(np.asarray(jl) - ref).max() > 100 * 3e-3


def test_split_qkv_mqa_is_concat_as_jax():
    """The ``mqa`` split (q heads | one k | one v) equals JAX's."""
    import jax.numpy as jnp
    from awq_tpu.models import hf_import as jhf
    from awq_tpu.models.layers import Linear as JLinear
    from awq_tpu_torch.config import ModelConfig as TConfig
    from awq_tpu_torch.models import hf_import as thf
    from awq_tpu_torch.models.layers import Linear
    from test_torch_opt import STYLES

    cfg = TConfig(**STYLES["bigcode"])
    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, 256, 256 + 2 * 64)).astype(np.float32)
    b = rng.standard_normal((2, 256 + 2 * 64)).astype(np.float32)
    ref = jhf._split_qkv(cfg, JLinear(w=jnp.asarray(w), b=jnp.asarray(b)), "mqa")
    got = thf._split_qkv(cfg, Linear(w=torch.from_numpy(w), b=torch.from_numpy(b)), "mqa")
    for k in ("wq", "wk", "wv"):
        np.testing.assert_array_equal(got[k].w.numpy(), np.asarray(ref[k].w))
        np.testing.assert_array_equal(got[k].b.numpy(), np.asarray(ref[k].b))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_round_trip_with_jax(direction, tmp_path):
    check_checkpoint("bigcode48", direction, tmp_path)


@pytest.mark.parametrize("style", BIGCODE_STYLES)
def test_refusals_and_gates(style):
    check_refusals(style)


# ---- on the card ------------------------------------------------------------------

CARD_TOL = 2.0 ** -6     # the split decode's bound (tests/test_torch_decode_attn.py)
STARCODER = (48, 1, 128)  # q heads, kv heads, head_dim
RAGGED = [1000, 0, 930, 1100, 1015, 850, 1200, 977]


def within(got, ref, tol=CARD_TOL):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def starcoder_inputs(dev, dtype, b=8, t=2048, seed=0):
    nq, nkv, hd = STARCODER
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    lens = torch.tensor(RAGGED[:b], dtype=torch.int32, device=dev)
    return rnd(b, nq, hd), rnd(b, nkv, hd), rnd(b, nkv, hd), rnd(2, b, nkv, t, hd), lens


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 1000, 2047])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_k14_starcoder_group_on_card(cuda, dtype, length):
    """K14 at 48 q heads over one kv head at head_dim 128 (its f32 plan's
    shared memory included) against its plain version, and with the length
    in device memory (a bucket of 2048) bit-equal to the host launch."""
    q, _, _, cache, _ = starcoder_inputs(cuda, dtype, b=1)
    kc, vc = cache[0].contiguous(), cache[1].contiguous()
    n0 = tda.LAUNCHES["flash_decode_layer"]
    host = tda.flash_decode_layer(q, kc, vc, length)
    dev = tda.flash_decode_layer(q, kc, vc, torch.tensor([length], dtype=torch.int32,
                                                         device=cuda), max_length=2048)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_layer"] == n0 + 2
    assert torch.equal(host, dev)
    within(host, tda.flash_decode_layer_plain(q, kc, vc, length))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_k8_k9_starcoder_group_on_card(cuda, dtype):
    """K2, K8 (pages of 256 and 16) and K9 in the wide unit at StarCoder's
    group on 8 ragged rows against their plain versions; K8 over pages of
    256 returns K2's output bit for bit."""
    from test_torch_opt import scatter

    q, kn, vn, cache, lens = starcoder_inputs(cuda, dtype, seed=1)
    mx = int(lens.max())
    n0 = dict(tda.LAUNCHES)
    k2 = tda.flash_decode(q, kn, vn, cache, lens, max_length=mx)
    within(k2, tda.flash_decode_plain(q, kn, vn, cache, lens, max_length=mx))
    for page in (256, 16):
        pool, tables = scatter(cache.float().cpu().numpy()[None], page, 3)
        pool = torch.from_numpy(pool).to(cuda, dtype)
        tables = torch.from_numpy(tables).to(cuda)
        k8 = tda.flash_decode_paged(q, kn, vn, pool, tables, 0, lens, max_length=mx)
        within(k8, tda.flash_decode_paged_plain(q, kn, vn, pool, tables, 0, lens,
                                                max_length=mx))
        if page == 256:
            assert torch.equal(k8, k2)
    codes, scales = tca.quantize_kv(cache.float())
    k9 = tda.flash_decode_int8(q, kn, vn, codes, scales, lens, max_length=mx)
    within(k9, tda.flash_decode_int8_plain(q, kn, vn, codes, scales, lens, max_length=mx))
    torch.cuda.synchronize()
    moved = {k: tda.LAUNCHES[k] - n0[k] for k in n0}
    assert (moved["flash_decode_wide"], moved["flash_decode_paged_wide"],
            moved["flash_decode_int8_wide"]) == (1, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3_starcoder_group_on_card(cuda, dtype):
    """K3 at 48 q heads over one kv head (128 packed rows a block cover two
    and a bit positions) against its plain version, a prompt of 300 after
    200 cached positions."""
    nq, nkv, hd = STARCODER
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((1, 300, nq, hd), generator=g, device=cuda).to(dtype)
    cache = torch.randn((2, 1, nkv, 1024, hd), generator=g, device=cuda).to(dtype)
    n0 = tda.LAUNCHES["flash_prefill"]
    got = tda.flash_prefill(q, cache, 200)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_prefill"] == n0 + 1
    within(got, tda.flash_prefill_plain(q, cache, 200))


@pytest.mark.cuda
@pytest.mark.parametrize("style", BIGCODE_STYLES)
def test_forward_on_card(cuda, style):
    check_forward_on_card(style, cuda, "flash_decode_layer")


@pytest.mark.cuda
def test_steps_on_card(cuda):
    check_steps_on_card("bigcode48", cuda, ("flash_decode_wide", "flash_decode_int8_wide",
                                            "flash_decode_paged_wide"))


@pytest.mark.cuda
def test_layers_attention_at_starcoder_group_on_card(cuda):
    """``layers.attention`` at S = 1 (``forward``'s single-position step) at
    StarCoder's group launches K14."""
    q, _, _, cache, _ = starcoder_inputs(cuda, torch.bfloat16, b=1, seed=2)
    n0 = tda.LAUNCHES["flash_decode_layer"]
    out = tlayers.attention(q[:, None], cache[0], cache[1], 700)
    torch.cuda.synchronize()
    assert tda.LAUNCHES["flash_decode_layer"] == n0 + 1
    within(out.reshape(q.shape), tda.flash_decode_layer_plain(q, cache[0], cache[1], 701))
