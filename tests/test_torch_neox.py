"""Port parity for GPT-NeoX (Pythia): rope over ``rotary_pct`` of the head,
LayerNorm with bias, the exact GELU, biases, the parallel block with two
norms (``use_parallel_residual``) or the sequential one, an untied head.

Two tiny f32 styles of ``tests/test_torch_opt.py`` (its helpers): Pythia's
parallel block at head_dim 128 (2 heads: K2 on the single-position step)
and the sequential block at 64 (K14 there), both with rope over a quarter
of the head. Against the JAX package: ``forward``, ``decode_step``, the
engines' greedy ids, the per-row rope rows, the batched step over f32 and
bf16 slot caches, the paged step and the int8 cache; the importer against
JAX's and ``transformers``' logits. The tests marked ``cuda`` hold the
stacked path to its plain version on a card and skip here.
"""

import numpy as np
import pytest
import torch

from awq_tpu_torch.config import ModelConfig as TConfig
from awq_tpu_torch.models import layers as tlayers
from test_torch_opt import (STYLES, check_batch_engines, check_batched,  # noqa: F401
                            check_checkpoint, check_decode_step, check_engine_ids,
                            check_forward, check_forward_on_card, check_import, check_int8,
                            check_paged, check_refusals, check_steps_on_card, cuda, jitter_hf)

# One intra-op thread: the CPU tensors here are tiny, and the test workers
# share the cores (eight threads per worker oversubscribe them many times).
torch.set_num_threads(1)

NEOX_STYLES = ["neox", "neox_seq"]


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("style", NEOX_STYLES)
def test_forward_matches_jax(style, impl):
    check_forward(style, impl)


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("style", NEOX_STYLES)
def test_decode_step_matches_forward(style, cache_dtype):
    check_decode_step(style, cache_dtype)


@pytest.mark.parametrize("style", NEOX_STYLES)
def test_partial_rope_per_row_matches_jax(style):
    """The rope tables at ``rotary_pct`` 0.25 equal JAX's to 1e-6 (the two
    libraries' cos and sin part by an ulp), and ``apply_rope`` on JAX's
    tables with per-row positions (the batched step's ``[B, 1]``) and shared
    ones (a prompt's ``[S]``) equals JAX's bit for bit: the first quarter of
    each head turns, the rest passes."""
    import jax.numpy as jnp
    from awq_tpu.config import ModelConfig as JConfig
    from awq_tpu.models import layers as jlayers

    cfg = TConfig(**STYLES[style])
    hd, nq = cfg.head_dim, cfg.num_heads
    cos, sin = tlayers.rope_table(cfg, 300)
    jcos, jsin = jlayers.rope_table(JConfig(**STYLES[style]), 300)
    assert cos.shape == (300, hd // 4)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0, atol=1e-6)
    cos, sin = torch.from_numpy(np.asarray(jcos)), torch.from_numpy(np.asarray(jsin))
    rng = np.random.default_rng(2)
    for pos in (np.array([[5], [0], [299]]), np.arange(7, 12)):
        b, s = (3, 1) if pos.ndim == 2 else (1, 5)
        q = rng.standard_normal((b, s, nq, hd)).astype(np.float32)
        k = rng.standard_normal((b, s, nq, hd)).astype(np.float32)
        got = tlayers.apply_rope(torch.from_numpy(q), torch.from_numpy(k), cos, sin,
                                 torch.from_numpy(pos))
        ref = jlayers.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin, jnp.asarray(pos))
        for a, r in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))
        np.testing.assert_array_equal(got[0][..., hd // 4:].numpy(), q[..., hd // 4:])


@pytest.mark.parametrize("style", NEOX_STYLES)
def test_engine_greedy_ids_bit_exact(style):
    check_engine_ids(style)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_step_batched_matches_jax(cache_dtype, monkeypatch):
    check_batched("neox", cache_dtype, monkeypatch)


def test_decode_step_paged_matches_jax(monkeypatch):
    check_paged("neox_seq", monkeypatch)


def test_int8_cache_matches_jax(monkeypatch):
    check_int8("neox", monkeypatch)


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
def test_batch_engines_greedy_ids_match_jax(paged, monkeypatch):
    check_batch_engines("neox", paged, monkeypatch)


@pytest.mark.parametrize("parallel", [True, False], ids=["parallel", "sequential"])
def test_import_equals_jax_and_logits_equal_hf(parallel):
    """Pythia's ``GPTNeoXForCausalLM`` (the per-head ``neox`` QKV split, the
    untied ``embed_out``), with and without ``use_parallel_residual``: the
    port's tree equals JAX's, the logits HF's."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.GPTNeoXConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                                    num_hidden_layers=2, num_attention_heads=2,
                                    max_position_embeddings=64, rotary_pct=0.25,
                                    use_parallel_residual=parallel)
    torch.manual_seed(5)
    model = jitter_hf(transformers.GPTNeoXForCausalLM(hf), 5)
    cfg = check_import(model, "neox")
    assert cfg.parallel_block == parallel and cfg.rotary_pct == 0.25
    assert cfg.head_dim == 128 and not cfg.tie_word_embeddings


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_round_trip_with_jax(direction, tmp_path):
    check_checkpoint("neox", direction, tmp_path, extra=("lm_head", "norm_b"))


@pytest.mark.parametrize("style", NEOX_STYLES)
def test_refusals_and_gates(style):
    check_refusals(style)


# ---- on the card ------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("style,kernel", [("neox", "flash_decode"),
                                          ("neox_seq", "flash_decode_layer")])
def test_forward_on_card(cuda, style, kernel):
    check_forward_on_card(style, cuda, kernel)


@pytest.mark.cuda
def test_steps_on_card(cuda):
    check_steps_on_card("neox", cuda, ("flash_decode", "flash_decode_int8",
                                       "flash_decode_paged"))
