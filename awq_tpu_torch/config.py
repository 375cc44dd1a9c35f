"""Typed configuration objects (the PyTorch port's own copy).

A copy of ``awq_tpu/config.py``: the port imports nothing of the JAX
package, not even modules that import no JAX. Keep the two in step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Weight-quantization settings (counterpart of the reference q_config).

    Mirrors the semantics of ``awq/quantize/quantizer.py:61-103``:
    group-wise asymmetric min/max quantization with a zero point.
    """

    w_bit: int = 4
    group_size: int = 128  # -1 => one group spanning the whole input dim
    zero_point: bool = True

    def __post_init__(self):
        if self.w_bit not in (2, 3, 4, 8):
            raise ValueError(f"unsupported w_bit={self.w_bit}")
        if self.group_size != -1 and self.group_size <= 0:
            raise ValueError(f"bad group_size={self.group_size}")

    @property
    def max_int(self) -> int:
        return 2**self.w_bit - 1


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Rope scaling config (llama3-style by default)."""

    rope_type: str = "llama3"
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description, derived from an HF config.json.

    One config type covers every decoder-only family the reference ships
    rewritten models for (``tinychat/models/*``): llama/qwen2/mistral via
    rope+rmsnorm+swiglu, opt via learned-pos+layernorm+gelu, mpt via alibi,
    falcon via mqa, bigcode (starcoder) via mqa+learned-pos.
    """

    # llama | qwen2 | mistral | opt | mpt | falcon | bigcode | neox | bloom
    arch: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_position_embeddings: int = 4096
    rms_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    tie_word_embeddings: bool = False
    qkv_bias: bool = False          # qwen2
    attn_bias: bool = False         # opt/bigcode: bias on all attn projs
    mlp_bias: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_bias: bool = True          # layernorm beta (mpt no_bias: False)
    act: str = "silu"               # silu (swiglu mlp) | gelu (plain mlp)
    pos_embed: str = "rope"         # rope | learned | alibi | none
    do_layer_norm_before: bool = True  # opt pre/post-LN variant
    parallel_block: bool = False    # falcon/neox: attn+mlp share the residual
    single_ln: bool = False         # falcon-7b: one LN feeds both branches
    grouped_qkv: bool = False       # falcon-40b/180b new_decoder_architecture:
    # fused QKV stored per kv-group [n_kv, q_per_group+2, head_dim]
    rotary_pct: float = 1.0         # neox: rope on a prefix of head_dim
    embed_ln: bool = False          # bloom: LayerNorm after the embedding
    # (word_embeddings_layernorm — params carry embed_ln_w/embed_ln_b)
    # runtime
    dtype: str = "bfloat16"
    prefill_a8: bool = False        # int8-activation prefill matmuls
    # (W4A8: per-token act quant + per-column weight requant; 2x MXU)

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """Sampling parameters (counterpart of tinychat's gen_params,
    ``tinychat/demo.py:19-47``)."""

    temperature: float = 0.7
    top_p: float = 0.9
    top_k: int = 40
    repetition_penalty: float = 1.0
    max_new_tokens: int = 512
    greedy: bool = False


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Engine-level settings (counterpart of tinychat/utils/constants.py)."""

    max_seq_len: int = 2048
    max_batch_size: int = 1
    prefill_chunk: int = 0  # 0 => whole-prompt prefill
    # quantize the fp16 lm_head to W4 at engine construction so decode
    # runs the whole model (head included) inside the megakernel — on
    # Llama-3's 128k vocab the fp16 head alone streams ~1 GB/token.
    # Off by default: it perturbs logits slightly (the reference keeps
    # lm_head fp16 too), so opt in from serving/demo entrypoints.
    quantize_head: bool = False
    # TTFT mode: cache per-column-int8 prefill weights at engine init
    # (ops/w4a16.py::W8Stack) so prefill matmuls run pure int8 MXU dots
    # with no in-kernel requant and no minimum-length a8 gate. Implies
    # prefill_a8. Costs IC*OC bytes of HBM per layer (~6.6 GB at 7B) —
    # opt in for TTFT-optimized serving; decode is unaffected (W4 stream).
    prefill_w8: bool = False
    # HBM budget for the prefill_w8 cache in GiB (0 = no explicit cap):
    # builds the deepest-IC linears' caches first until the budget is
    # spent, leaving the rest on the in-kernel-requant a8 path. Without
    # a budget, a platform that reports memory stats refuses cleanly at
    # engine init when the full cache cannot fit free HBM.
    prefill_w8_budget_gb: float = 0.0
    # multi-device serving: a device mesh with a 'tp' axis in the JAX
    # package; in the port, this rank's tensor-parallel group
    # (awq_tpu_torch.parallel.mesh.TPGroup, dp = 1), which InferenceEngine
    # serves through. BatchEngine over a group is ROADMAP queue A, item 17b.
    mesh: Optional[Any] = None


def _get(d: Mapping[str, Any], *names, default=None):
    for n in names:
        if n in d and d[n] is not None:
            return d[n]
    return default


def model_config_from_hf(hf: Mapping[str, Any]) -> ModelConfig:
    """Build a ModelConfig from a raw HF ``config.json`` mapping."""
    mt = _get(hf, "model_type", default="llama")
    if mt in ("llama", "mistral", "qwen2"):
        hidden = hf["hidden_size"]
        heads = hf["num_attention_heads"]
        head_dim = _get(hf, "head_dim", default=hidden // heads)
        rs = None
        raw_rs = _get(hf, "rope_scaling")
        if raw_rs and _get(raw_rs, "rope_type", "type") == "llama3":
            rs = RopeScaling(
                rope_type="llama3",
                factor=raw_rs.get("factor", 8.0),
                low_freq_factor=raw_rs.get("low_freq_factor", 1.0),
                high_freq_factor=raw_rs.get("high_freq_factor", 4.0),
                original_max_position_embeddings=raw_rs.get(
                    "original_max_position_embeddings", 8192
                ),
            )
        return ModelConfig(
            arch=mt,
            vocab_size=hf["vocab_size"],
            hidden_size=hidden,
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=_get(hf, "num_key_value_heads", default=heads),
            head_dim=head_dim,
            max_position_embeddings=_get(
                hf, "max_position_embeddings", default=4096
            ),
            rms_eps=_get(hf, "rms_norm_eps", default=1e-5),
            rope_theta=_get(hf, "rope_theta", default=10000.0),
            rope_scaling=rs,
            tie_word_embeddings=_get(hf, "tie_word_embeddings", default=False),
            qkv_bias=(mt == "qwen2"),
        )
    if mt == "opt":
        hidden = hf["hidden_size"]
        return ModelConfig(
            arch="opt",
            vocab_size=hf["vocab_size"],
            hidden_size=hidden,
            intermediate_size=hf["ffn_dim"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf["num_attention_heads"],
            head_dim=hidden // hf["num_attention_heads"],
            max_position_embeddings=_get(
                hf, "max_position_embeddings", default=2048
            ),
            norm="layernorm",
            act="relu" if _get(hf, "activation_function", default="relu") == "relu" else "gelu",
            pos_embed="learned",
            attn_bias=True,
            mlp_bias=True,
            do_layer_norm_before=_get(hf, "do_layer_norm_before", default=True),
            tie_word_embeddings=_get(hf, "tie_word_embeddings", default=True),
        )
    if mt in ("falcon", "RefinedWeb", "RefinedWebModel"):
        hidden = hf["hidden_size"]
        heads = _get(hf, "num_attention_heads", "n_head")
        if _get(hf, "new_decoder_architecture", default=False):
            n_kv = _get(hf, "num_kv_heads", default=8)
        else:
            n_kv = heads if not _get(hf, "multi_query", default=True) else 1
        return ModelConfig(
            arch="falcon",
            vocab_size=hf["vocab_size"],
            hidden_size=hidden,
            intermediate_size=_get(hf, "ffn_hidden_size",
                                   default=4 * hidden),
            num_layers=_get(hf, "num_hidden_layers", "n_layer"),
            num_heads=heads,
            num_kv_heads=n_kv,
            head_dim=hidden // heads,
            max_position_embeddings=_get(
                hf, "max_position_embeddings", default=2048
            ),
            rms_eps=_get(hf, "layer_norm_epsilon", default=1e-5),
            rope_theta=_get(hf, "rope_theta", default=10000.0),
            norm="layernorm",
            act="gelu",
            pos_embed="rope" if not _get(hf, "alibi", default=False)
            else "alibi",
            attn_bias=_get(hf, "bias", default=False),
            mlp_bias=_get(hf, "bias", default=False),
            parallel_block=_get(hf, "parallel_attn", default=True),
            single_ln=_get(hf, "parallel_attn", default=True)
            and not _get(hf, "new_decoder_architecture", default=False),
            grouped_qkv=_get(hf, "new_decoder_architecture", default=False),
            tie_word_embeddings=_get(hf, "tie_word_embeddings", default=True),
        )
    if mt == "mpt":
        hidden = hf["d_model"]
        return ModelConfig(
            arch="mpt",
            vocab_size=hf["vocab_size"],
            hidden_size=hidden,
            intermediate_size=_get(hf, "expansion_ratio", default=4) * hidden,
            num_layers=hf["n_layers"],
            num_heads=hf["n_heads"],
            num_kv_heads=hf["n_heads"],
            head_dim=hidden // hf["n_heads"],
            max_position_embeddings=_get(hf, "max_seq_len", default=2048),
            norm="layernorm",
            norm_bias=not _get(hf, "no_bias", default=True),
            act="gelu",
            pos_embed="alibi",
            tie_word_embeddings=True,
        )
    if mt == "bloom":
        hidden = _get(hf, "hidden_size", "n_embed")
        heads = _get(hf, "n_head", "num_attention_heads")
        return ModelConfig(
            arch="bloom",
            vocab_size=hf["vocab_size"],
            hidden_size=hidden,
            intermediate_size=4 * hidden,
            num_layers=_get(hf, "n_layer", "num_hidden_layers"),
            num_heads=heads,
            num_kv_heads=heads,
            head_dim=hidden // heads,
            max_position_embeddings=_get(
                hf, "seq_length", default=2048
            ),
            rms_eps=_get(hf, "layer_norm_epsilon", default=1e-5),
            norm="layernorm",
            act="gelu_tanh",
            pos_embed="alibi",
            attn_bias=True,
            mlp_bias=True,
            embed_ln=True,
            tie_word_embeddings=True,
        )
    if mt in ("gpt_bigcode", "bigcode"):
        hidden = hf["n_embd"]
        return ModelConfig(
            arch="bigcode",
            vocab_size=hf["vocab_size"],
            hidden_size=hidden,
            intermediate_size=_get(hf, "n_inner", default=4 * hidden),
            num_layers=hf["n_layer"],
            num_heads=hf["n_head"],
            num_kv_heads=1 if _get(hf, "multi_query", default=True)
            else hf["n_head"],
            head_dim=hidden // hf["n_head"],
            max_position_embeddings=_get(hf, "n_positions", default=8192),
            norm="layernorm",
            act="gelu_tanh",
            pos_embed="learned",
            attn_bias=True,
            mlp_bias=True,
            tie_word_embeddings=True,
        )
    if mt == "gpt_neox":
        hidden = hf["hidden_size"]
        return ModelConfig(
            arch="neox",
            vocab_size=hf["vocab_size"],
            hidden_size=hidden,
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf["num_attention_heads"],
            head_dim=hidden // hf["num_attention_heads"],
            max_position_embeddings=_get(
                hf, "max_position_embeddings", default=2048
            ),
            rms_eps=_get(hf, "layer_norm_eps", default=1e-5),
            rope_theta=_get(hf, "rotary_emb_base", default=10000.0),
            norm="layernorm",
            act="gelu",
            pos_embed="rope",
            rotary_pct=_get(hf, "rotary_pct", default=0.25),
            attn_bias=True,
            mlp_bias=True,
            parallel_block=_get(hf, "use_parallel_residual", default=True),
        )
    raise NotImplementedError(f"model_type={mt}")
