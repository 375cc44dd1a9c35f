"""HuggingFace checkpoint -> the port's parameter tree (PyTorch port of
``awq_tpu/models/hf_import.py``).

:func:`import_hf_model` takes an in-memory ``transformers`` model (the tests
build tiny random ones) or a checkpoint directory holding ``config.json``
and ``*.safetensors`` shards (or ``*.bin`` ones). Weights are transposed to
the ``[IC, OC]`` convention and stacked on a leading layer axis, the tree
:func:`~awq_tpu_torch.models.llama.forward` reads. The llama family
(llama, mistral, qwen2), falcon (7b-style MQA with one norm, and the
40b-style grouped QKV with two), MPT (the ``concat`` QKV of ``attn.Wqkv``),
BLOOM (the per-head ``neox`` interleave of ``query_key_value`` and the
embedding LayerNorm), OPT (separate q/k/v, the position table from row 2),
GPT-BigCode (``c_attn``: q heads, one k and one v under ``multi_query``,
else HF's per-head ``[n_head, 3, head_dim]`` interleave) and GPT-NeoX (the
per-head interleave, an untied ``embed_out`` head) are ported; the other
families raise, naming ROADMAP A12, and so do OPT's projected embedding
(``word_embed_proj_dim != hidden_size``, OPT-350m) and its post-LN
variant.

Shards are read by :func:`read_safetensors`, a reader of the format
itself (an 8-byte little-endian header length, a JSON header, then raw
little-endian tensors): the card's machine has neither ``safetensors``
nor ``transformers``, and the in-memory branch needs only the model's
``config`` and ``state_dict``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Tuple

import torch

from awq_tpu_torch import _device
from awq_tpu_torch.config import ModelConfig, model_config_from_hf
from awq_tpu_torch.models.layers import Linear

Params = Dict[str, Any]

_LLAMA_MAP = {
    "ln1": "model.layers.{i}.input_layernorm.weight",
    "ln2": "model.layers.{i}.post_attention_layernorm.weight",
    "wq": "model.layers.{i}.self_attn.q_proj",
    "wk": "model.layers.{i}.self_attn.k_proj",
    "wv": "model.layers.{i}.self_attn.v_proj",
    "wo": "model.layers.{i}.self_attn.o_proj",
    "gate": "model.layers.{i}.mlp.gate_proj",
    "up": "model.layers.{i}.mlp.up_proj",
    "down": "model.layers.{i}.mlp.down_proj",
}

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
              "U16": torch.uint16}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        blob = f.read()
    (n,) = struct.unpack("<Q", blob[:8])
    header = json.loads(blob[8:8 + n])
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} of dtype {meta['dtype']}")
        dt = _ST_DTYPES[meta["dtype"]]
        lo, hi = meta["data_offsets"]
        raw = blob[8 + n + lo:8 + n + hi]
        out[name] = (torch.frombuffer(bytearray(raw), dtype=dt) if raw
                     else torch.empty(0, dtype=dt)).reshape(meta["shape"])
    return out


def _load_dir_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of a checkpoint directory (safetensors preferred)."""
    sd: Dict[str, torch.Tensor] = {}
    names = sorted(os.listdir(path))
    shards = [f for f in names if f.endswith(".safetensors")]
    if shards:
        for f in shards:
            sd.update(read_safetensors(os.path.join(path, f)))
        return sd
    bins = [f for f in names if f.endswith(".bin")]
    if bins:
        for f in bins:
            sd.update(torch.load(os.path.join(path, f), map_location="cpu",
                                 weights_only=True))
        return sd
    raise FileNotFoundError(f"no weights found in {path}")


def import_hf_model(model_or_path, dtype: str = "bfloat16",
                    device="cuda") -> Tuple[ModelConfig, Params]:
    """Import an HF decoder checkpoint into ``(ModelConfig, params)``, the
    parameters on ``device`` in ``dtype`` (f32 weights rounded to nearest,
    as the JAX package's ``jnp.asarray`` rounds them)."""
    dev = _device.resolve(device)
    if isinstance(model_or_path, str):
        with open(os.path.join(model_or_path, "config.json")) as f:
            raw_cfg = json.load(f)
        sd = _load_dir_state_dict(model_or_path)
    else:
        raw_cfg = model_or_path.config.to_dict()
        sd = {k: v.detach().cpu() for k, v in model_or_path.state_dict().items()}
    cfg = model_config_from_hf(raw_cfg)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    builders = {"llama": _build_llama_params, "mistral": _build_llama_params,
                "qwen2": _build_llama_params, "falcon": _build_falcon_params,
                "mpt": _build_mpt_params, "bloom": _build_bloom_params,
                "opt": _build_opt_params, "bigcode": _build_bigcode_params,
                "neox": _build_neox_params}
    if cfg.arch not in builders:
        raise NotImplementedError(f"importer: arch {cfg.arch!r}; the other decoder "
                                  "families are ROADMAP queue A, item 12")
    proj = raw_cfg.get("word_embed_proj_dim", cfg.hidden_size)
    if cfg.arch == "opt" and proj != cfg.hidden_size:
        # JAX's importer drops project_in / project_out and runs a wrong model
        raise NotImplementedError(
            f"importer: OPT with word_embed_proj_dim {proj} != hidden_size {cfg.hidden_size} "
            "(project_in / project_out, OPT-350m): ROADMAP queue A, item 12")
    from awq_tpu_torch.models.llama import STACKED_ARCHS, _check_supported, params_to

    if cfg.arch in STACKED_ARCHS:
        _check_supported(cfg)     # OPT's post-LN variant, GPT-NeoX-20B's head_dim 96
    return cfg, params_to(builders[cfg.arch](cfg, sd), dev)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _stack_lin(cfg: ModelConfig, sd, fmt: str) -> Linear:
    """The linears ``fmt.format(i=l)`` of every layer as one ``[L, IC, OC]``
    :class:`Linear`, with their biases where the checkpoint has them."""
    dt, L = _dt(cfg), cfg.num_layers
    w = torch.stack([sd[fmt.format(i=i) + ".weight"].T for i in range(L)]).to(dt)
    b = None
    if fmt.format(i=0) + ".bias" in sd:
        b = torch.stack([sd[fmt.format(i=i) + ".bias"] for i in range(L)]).to(dt)
    return Linear(w=w.contiguous(), b=b)


def _stack_vec(cfg: ModelConfig, sd, fmt: str) -> torch.Tensor:
    return torch.stack([sd[fmt.format(i=i)] for i in range(cfg.num_layers)]).to(_dt(cfg))


def _split_qkv(cfg: ModelConfig, fused: Linear, layout: str) -> Dict[str, Linear]:
    """Split a stacked fused-QKV Linear ``[L, H, qkv_out]``: ``"concat"`` or
    ``"mqa"`` (q | k | v blocks: falcon-7b's q heads, its one k and one v;
    MPT; GPT-BigCode's ``c_attn`` under ``multi_query``),
    ``"neox"`` (the per-head ``[n_heads, 3, head_dim]`` interleave of
    BLOOM, GPT-NeoX and GPT-BigCode without ``multi_query``, HF
    ``BloomAttention._split_heads``) or ``"grouped"`` (falcon's
    new_decoder_architecture: per kv group ``[n_kv, q_per_group + 2,
    head_dim]``)."""
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    w, b = fused.w, fused.b
    if layout == "neox":
        L, H, _ = w.shape
        w3 = w.reshape(L, H, nq, 3, hd)
        b3 = None if b is None else b.reshape(L, nq, 3, hd)

        def part(j):
            return Linear(w=w3[:, :, :, j].reshape(L, H, nq * hd).contiguous(),
                          b=None if b3 is None
                          else b3[:, :, j].reshape(L, nq * hd).contiguous())

        return {"wq": part(0), "wk": part(1), "wv": part(2)}
    if layout == "grouped":
        L, H, _ = w.shape
        g = nq // nkv
        wg = w.reshape(L, H, nkv, g + 2, hd)
        bg = None if b is None else b.reshape(L, nkv, g + 2, hd)

        def take(lo, hi, nh):
            return Linear(w=wg[:, :, :, lo:hi].reshape(L, H, nh * hd).contiguous(),
                          b=None if bg is None
                          else bg[:, :, lo:hi].reshape(L, nh * hd).contiguous())

        return {"wq": take(0, g, nq), "wk": take(g, g + 1, nkv),
                "wv": take(g + 1, g + 2, nkv)}

    def cut(lo, hi):
        return Linear(w=w[:, :, lo:hi].contiguous(),
                      b=None if b is None else b[:, lo:hi].contiguous())

    q_dim, kv_dim = nq * hd, nkv * hd
    return {"wq": cut(0, q_dim), "wk": cut(q_dim, q_dim + kv_dim),
            "wv": cut(q_dim + kv_dim, q_dim + 2 * kv_dim)}


def _build_llama_params(cfg: ModelConfig, sd) -> Params:
    dt = _dt(cfg)
    layers: Params = {"ln1": _stack_vec(cfg, sd, _LLAMA_MAP["ln1"]),
                      "ln2": _stack_vec(cfg, sd, _LLAMA_MAP["ln2"])}
    for name in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
        layers[name] = _stack_lin(cfg, sd, _LLAMA_MAP[name])
    params: Params = {"embed": sd["model.embed_tokens.weight"].to(dt), "layers": layers,
                      "norm": sd["model.norm.weight"].to(dt)}
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = sd["lm_head.weight"].T.to(dt).contiguous()
    return params


def _build_mpt_params(cfg: ModelConfig, sd) -> Params:
    """MPT (``awq_tpu/models/hf_import.py:290-306``): the fused ``attn.Wqkv``
    in the ``concat`` layout, bias-free norms ``norm_1``/``norm_2``, the MLP
    ``ffn.up_proj``/``ffn.down_proj``; the head is the tied embedding."""
    dt = _dt(cfg)
    pre = "transformer.blocks.{i}."
    fused = _stack_lin(cfg, sd, pre + "attn.Wqkv")
    layers: Params = {
        "ln1": _stack_vec(cfg, sd, pre + "norm_1.weight"),
        "ln2": _stack_vec(cfg, sd, pre + "norm_2.weight"),
        **_split_qkv(cfg, fused, "concat"),
        "wo": _stack_lin(cfg, sd, pre + "attn.out_proj"),
        "up": _stack_lin(cfg, sd, pre + "ffn.up_proj"),
        "down": _stack_lin(cfg, sd, pre + "ffn.down_proj"),
    }
    return {"embed": sd["transformer.wte.weight"].to(dt), "layers": layers,
            "norm": sd["transformer.norm_f.weight"].to(dt)}


def _build_bloom_params(cfg: ModelConfig, sd) -> Params:
    """BLOOM (``awq_tpu/models/hf_import.py:332-366``): the fused
    ``query_key_value`` in the per-head ``neox`` interleave, LayerNorms with
    bias, the MLP ``dense_h_to_4h``/``dense_4h_to_h``, and the embedding's
    ``word_embeddings_layernorm`` (``embed_ln_w``/``embed_ln_b``); the head
    is the tied embedding."""
    dt = _dt(cfg)
    pre = "transformer.h.{i}."
    fused = _stack_lin(cfg, sd, pre + "self_attention.query_key_value")
    layers: Params = {
        "ln1": _stack_vec(cfg, sd, pre + "input_layernorm.weight"),
        "ln1_b": _stack_vec(cfg, sd, pre + "input_layernorm.bias"),
        "ln2": _stack_vec(cfg, sd, pre + "post_attention_layernorm.weight"),
        "ln2_b": _stack_vec(cfg, sd, pre + "post_attention_layernorm.bias"),
        **_split_qkv(cfg, fused, "neox"),
        "wo": _stack_lin(cfg, sd, pre + "self_attention.dense"),
        "up": _stack_lin(cfg, sd, pre + "mlp.dense_h_to_4h"),
        "down": _stack_lin(cfg, sd, pre + "mlp.dense_4h_to_h"),
    }
    return {"embed": sd["transformer.word_embeddings.weight"].to(dt),
            "embed_ln_w": sd["transformer.word_embeddings_layernorm.weight"].to(dt),
            "embed_ln_b": sd["transformer.word_embeddings_layernorm.bias"].to(dt),
            "layers": layers, "norm": sd["transformer.ln_f.weight"].to(dt),
            "norm_b": sd["transformer.ln_f.bias"].to(dt)}


def _build_falcon_params(cfg: ModelConfig, sd) -> Params:
    dt = _dt(cfg)
    pre = "transformer.h.{i}."
    fused = _stack_lin(cfg, sd, pre + "self_attention.query_key_value")
    # new_decoder_architecture (falcon-40b/180b): QKV grouped per kv head and
    # one norm per parallel branch (ln_attn / ln_mlp) for input_layernorm
    ln1 = "ln_attn" if cfg.grouped_qkv else "input_layernorm"
    layers: Params = {
        "ln1": _stack_vec(cfg, sd, pre + ln1 + ".weight"),
        "ln1_b": _stack_vec(cfg, sd, pre + ln1 + ".bias"),
        **_split_qkv(cfg, fused, "grouped" if cfg.grouped_qkv else "concat"),
        "wo": _stack_lin(cfg, sd, pre + "self_attention.dense"),
        "up": _stack_lin(cfg, sd, pre + "mlp.dense_h_to_4h"),
        "down": _stack_lin(cfg, sd, pre + "mlp.dense_4h_to_h"),
    }
    if not cfg.single_ln:
        ln2 = "ln_mlp" if cfg.grouped_qkv else "post_attention_layernorm"
        layers["ln2"] = _stack_vec(cfg, sd, pre + ln2 + ".weight")
        layers["ln2_b"] = _stack_vec(cfg, sd, pre + ln2 + ".bias")
    params: Params = {"embed": sd["transformer.word_embeddings.weight"].to(dt),
                      "layers": layers, "norm": sd["transformer.ln_f.weight"].to(dt),
                      "norm_b": sd["transformer.ln_f.bias"].to(dt)}
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = sd["lm_head.weight"].T.to(dt).contiguous()
    return params


def _build_opt_params(cfg: ModelConfig, sd) -> Params:
    """OPT (``awq_tpu/models/hf_import.py:233-256``): separate q/k/v/out
    projections with biases, the LayerNorms ``self_attn_layer_norm`` and
    ``final_layer_norm`` with bias, the MLP ``fc1``/``fc2``, the position
    table ``embed_positions`` (row ``p + 2`` for position ``p``) and the
    final norm; the head is the tied embedding."""
    dt = _dt(cfg)
    pre = "model.decoder.layers.{i}."
    layers: Params = {
        "ln1": _stack_vec(cfg, sd, pre + "self_attn_layer_norm.weight"),
        "ln1_b": _stack_vec(cfg, sd, pre + "self_attn_layer_norm.bias"),
        "ln2": _stack_vec(cfg, sd, pre + "final_layer_norm.weight"),
        "ln2_b": _stack_vec(cfg, sd, pre + "final_layer_norm.bias"),
        "wq": _stack_lin(cfg, sd, pre + "self_attn.q_proj"),
        "wk": _stack_lin(cfg, sd, pre + "self_attn.k_proj"),
        "wv": _stack_lin(cfg, sd, pre + "self_attn.v_proj"),
        "wo": _stack_lin(cfg, sd, pre + "self_attn.out_proj"),
        "up": _stack_lin(cfg, sd, pre + "fc1"),
        "down": _stack_lin(cfg, sd, pre + "fc2"),
    }
    params: Params = {"embed": sd["model.decoder.embed_tokens.weight"].to(dt),
                      "pos_embed": sd["model.decoder.embed_positions.weight"].to(dt),
                      "layers": layers,
                      "norm": sd["model.decoder.final_layer_norm.weight"].to(dt),
                      "norm_b": sd["model.decoder.final_layer_norm.bias"].to(dt)}
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = sd["lm_head.weight"].T.to(dt).contiguous()
    return params


def _build_bigcode_params(cfg: ModelConfig, sd) -> Params:
    """GPT-BigCode, StarCoder (``awq_tpu/models/hf_import.py:309-330``): the
    fused ``attn.c_attn`` split ``"mqa"`` under ``multi_query`` (one kv
    head), else per head as HF views it (``"neox"``; the JAX importer takes
    ``"concat"`` there, ROADMAP C), LayerNorms ``ln_1``/``ln_2`` with
    bias, the MLP ``mlp.c_fc``/``mlp.c_proj``, the position table ``wpe``
    and the final norm ``ln_f``; the head is the tied embedding."""
    dt = _dt(cfg)
    pre = "transformer.h.{i}."
    fused = _stack_lin(cfg, sd, pre + "attn.c_attn")
    layers: Params = {
        "ln1": _stack_vec(cfg, sd, pre + "ln_1.weight"),
        "ln1_b": _stack_vec(cfg, sd, pre + "ln_1.bias"),
        "ln2": _stack_vec(cfg, sd, pre + "ln_2.weight"),
        "ln2_b": _stack_vec(cfg, sd, pre + "ln_2.bias"),
        **_split_qkv(cfg, fused, "mqa" if cfg.num_kv_heads == 1 else "neox"),
        "wo": _stack_lin(cfg, sd, pre + "attn.c_proj"),
        "up": _stack_lin(cfg, sd, pre + "mlp.c_fc"),
        "down": _stack_lin(cfg, sd, pre + "mlp.c_proj"),
    }
    params: Params = {"embed": sd["transformer.wte.weight"].to(dt),
                      "pos_embed": sd["transformer.wpe.weight"].to(dt), "layers": layers,
                      "norm": sd["transformer.ln_f.weight"].to(dt),
                      "norm_b": sd["transformer.ln_f.bias"].to(dt)}
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = sd["lm_head.weight"].T.to(dt).contiguous()
    return params


def _build_neox_params(cfg: ModelConfig, sd) -> Params:
    """GPT-NeoX, Pythia (``awq_tpu/models/hf_import.py:368-388``): the fused
    ``attention.query_key_value`` in the per-head ``neox`` interleave,
    LayerNorms ``input_layernorm`` and ``post_attention_layernorm`` with
    bias (the two norms of the parallel block, or of the sequential one),
    the MLP ``dense_h_to_4h``/``dense_4h_to_h``, the final norm and the
    untied head ``embed_out``."""
    dt = _dt(cfg)
    pre = "gpt_neox.layers.{i}."
    fused = _stack_lin(cfg, sd, pre + "attention.query_key_value")
    layers: Params = {
        "ln1": _stack_vec(cfg, sd, pre + "input_layernorm.weight"),
        "ln1_b": _stack_vec(cfg, sd, pre + "input_layernorm.bias"),
        "ln2": _stack_vec(cfg, sd, pre + "post_attention_layernorm.weight"),
        "ln2_b": _stack_vec(cfg, sd, pre + "post_attention_layernorm.bias"),
        **_split_qkv(cfg, fused, "neox"),
        "wo": _stack_lin(cfg, sd, pre + "attention.dense"),
        "up": _stack_lin(cfg, sd, pre + "mlp.dense_h_to_4h"),
        "down": _stack_lin(cfg, sd, pre + "mlp.dense_4h_to_h"),
    }
    return {"embed": sd["gpt_neox.embed_in.weight"].to(dt), "layers": layers,
            "norm": sd["gpt_neox.final_layer_norm.weight"].to(dt),
            "norm_b": sd["gpt_neox.final_layer_norm.bias"].to(dt),
            "lm_head": sd["embed_out.weight"].T.to(dt).contiguous()}
