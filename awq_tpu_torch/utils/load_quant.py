"""Import third-party AWQ quantized checkpoints (PyTorch port of
``awq_tpu/utils/load_quant.py``; the repacker is the port's own shim,
:mod:`awq_tpu_torch.native`, and files are read and written without the
``safetensors`` package).

Counterpart of ``tinychat/utils/load_quant.py`` (v1/v2 packed torch
checkpoints) and ``examples/convert_to_hf.py`` (AutoAWQ HF exports): detects
the packing flavor, unpacks via the native repacker, and re-packs into the
TPU layout:

- **AutoAWQ / HF "gemm"**: per-linear ``qweight`` int32 ``[IC, OC/8]``,
  ``qzeros`` int32 ``[IC/G, OC/8]`` (same nibble order), ``scales`` f16
  ``[IC/G, OC]``.
- **llm-awq v2 (TinyChat)**: ``qweight`` int16 ``[OC/4, IC]`` interleaved,
  ``scales``/``scaled_zeros`` transposed+padded.

Dequant conventions differ: AutoAWQ's ``w = (q - z) * s`` maps to our
``szeros = s * z``; TinyChat v2 stores ``scaled_zeros = -(z * s)`` style
already folded — handled per flavor.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from awq_tpu_torch import _device, native
from awq_tpu_torch.config import ModelConfig, QuantConfig, model_config_from_hf
from awq_tpu_torch.models.hf_import import _LLAMA_MAP, _load_dir_state_dict
from awq_tpu_torch.ops.w4a16 import QLinear
from awq_tpu_torch.quant.packing import unpack_int4
from awq_tpu_torch.utils.checkpoint import write_safetensors


def _np(t) -> np.ndarray:
    """A host array of a tensor (f32 for any float) or array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype.is_floating_point else t).numpy()
    return np.asarray(t)


def _dev_tensor(a: np.ndarray, dev, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=dev, dtype=dtype or t.dtype)


def _unpack_autoawq_linear(
    qweight: np.ndarray,      # int32 [IC, OC/8]
    qzeros: np.ndarray,       # int32 [IC/G, OC/8]
    scales: np.ndarray,       # [IC/G, OC]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (codes uint8 [IC, OC], scales f32, szeros f32)."""
    ic = qweight.shape[0]
    oc = qweight.shape[1] * 8
    codes = native.unpack_awq_gemm(qweight, ic, oc)
    zeros = native.unpack_awq_gemm(qzeros, qzeros.shape[0], oc)
    s = scales.astype(np.float32)
    sz = s * zeros.astype(np.float32)
    return codes, s, sz


def _pack_autoawq_codes(codes: np.ndarray) -> np.ndarray:
    """codes uint8 [K, N] -> AutoAWQ int32 [K, N/8] (nibble order
    0,2,4,6,1,3,5,7 along N)."""
    order = np.array([0, 2, 4, 6, 1, 3, 5, 7])
    k, n = codes.shape
    nib = codes.reshape(k, n // 8, 8)[:, :, order].astype(np.uint32)
    out = np.zeros((k, n // 8), np.uint32)
    for s in range(8):
        out |= nib[:, :, s] << (4 * s)
    return out.view(np.int32)


def save_autoawq_checkpoint(
    params: Dict[str, Any],
    cfg: ModelConfig,
    qcfg: QuantConfig,
    out_dir: str,
) -> None:
    """Export packed params to an AutoAWQ-format HF directory.

    Counterpart of ``examples/convert_to_hf.py`` (HF-hub export with
    AwqConfig metadata): the result loads in AutoAWQ/transformers and
    round-trips through :func:`load_autoawq_checkpoint`.
    """
    if qcfg.w_bit != 4:
        raise NotImplementedError("autoawq export is 4-bit")
    layers = params["layers"]
    if "wqkv" in layers:
        raise ValueError("export unfused params (before fuse_linears)")
    L = cfg.num_layers
    sd: Dict[str, np.ndarray] = {}

    inv = {v: k for k, v in _LLAMA_MAP.items()}
    for name in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
        ql: QLinear = layers[name]
        fmt = _LLAMA_MAP[name]
        for i in range(L):
            codes = unpack_int4(ql.qweight[i].cpu()).numpy()
            s = _np(ql.scales[i]).astype(np.float32)
            z = np.round(_np(ql.szeros[i]).astype(np.float32)
                         / np.maximum(s, 1e-12)).astype(np.uint8)
            p = fmt.format(i=i)
            sd[p + ".qweight"] = _pack_autoawq_codes(codes)
            sd[p + ".qzeros"] = _pack_autoawq_codes(z)
            sd[p + ".scales"] = s
            if ql.bias is not None:
                sd[p + ".bias"] = _np(ql.bias[i]).astype(np.float32)
    for i in range(L):
        sd[_LLAMA_MAP["ln1"].format(i=i)] = _np(layers["ln1"][i]).astype(np.float32)
        sd[_LLAMA_MAP["ln2"].format(i=i)] = _np(layers["ln2"][i]).astype(np.float32)
    sd["model.embed_tokens.weight"] = _np(params["embed"]).astype(np.float32)
    sd["model.norm.weight"] = _np(params["norm"]).astype(np.float32)
    if "lm_head" in params:
        sd["lm_head.weight"] = np.ascontiguousarray(
            _np(params["lm_head"]).astype(np.float32).T)

    os.makedirs(out_dir, exist_ok=True)
    write_safetensors(os.path.join(out_dir, "model.safetensors"), sd)
    hf_cfg = {
        "model_type": cfg.arch if cfg.arch != "mistral" else "mistral",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_eps,
        "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "torch_dtype": "float16",
        "quantization_config": {
            "quant_method": "awq",
            "bits": qcfg.w_bit,
            "group_size": qcfg.group_size,
            "zero_point": qcfg.zero_point,
            "version": "gemm",
        },
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=1)


def _unpack_tinychat_v2_linear(
    qweight: np.ndarray,       # int16 [OC/4, IC] interleaved
    scales: np.ndarray,        # [padded_groups, OC] (transposed variants ok)
    scaled_zeros: np.ndarray,  # [padded_groups, OC]
    oc: int,
    ic: int,
    group_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (codes [IC, OC], scales f32 [IC/G, OC], szeros f32).

    TinyChat's kernel computes ``q*s + scaled_zeros`` with
    ``scaled_zeros = -(z*s)`` (``qmodule.py:139-199``); our convention is
    ``q*s - szeros``, so ``szeros = -scaled_zeros``.

    TinyChat pads the *group* (row) axis of scales/scaled_zeros up to
    ``calculate_zeros_width(ic, G) * pack_num`` rows (``qmodule.py:11-23``,
    e.g. llama-7b down_proj IC=11008, G=128: 86 groups stored as 88) — strip
    that after normalizing orientation to [groups, OC].
    """
    codes_nk = native.unpack_awq_v2(qweight, oc, ic)       # [OC, IC]
    codes = np.ascontiguousarray(codes_nk.T)               # [IC, OC]
    n_groups = ic // group_size
    s = np.asarray(scales, np.float32)
    if s.shape[0] == oc:  # stored transposed [OC, padded_groups]
        s = s.T
    sz = -np.asarray(scaled_zeros, np.float32)
    if sz.shape[0] == oc:
        sz = sz.T
    return codes, s[:n_groups], sz[:n_groups]


def load_tinychat_v2_checkpoint(
    pt_path: str,
    hf_config_path: str,
    dtype: str = "bfloat16",
    group_size: int = 128,
    device="cuda",
) -> Tuple[ModelConfig, Dict[str, Any], QuantConfig]:
    """Load a TinyChat ``*-v2.pt`` torch checkpoint (llama-family), the
    params on ``device``."""
    dev = _device.resolve(device)
    with open(os.path.join(hf_config_path, "config.json")) as f:
        raw = json.load(f)
    cfg = model_config_from_hf(raw)
    cfg = ModelConfig(**{**cfg.__dict__, "dtype": dtype})
    qcfg = QuantConfig(w_bit=4, group_size=group_size)
    blob = torch.load(pt_path, map_location="cpu", weights_only=True)
    sd = {k: v.float().numpy() if v.dtype.is_floating_point
          else v.numpy() for k, v in blob.items()}
    dt = getattr(torch, dtype)
    L = cfg.num_layers

    def qlin(prefix_fmt: str, ic: int, oc: int) -> QLinear:
        qws, ss, szs = [], [], []
        for i in range(L):
            p = prefix_fmt.format(i=i)
            codes, s, sz = _unpack_tinychat_v2_linear(
                sd[p + ".qweight"], sd[p + ".scales"],
                sd[p + ".scaled_zeros"], oc, ic, qcfg.group_size,
            )
            qws.append(native.pack_int4_tpu(codes))
            ss.append(s)
            szs.append(sz)
        return QLinear(
            qweight=_dev_tensor(np.stack(qws), dev),
            scales=_dev_tensor(np.stack(ss), dev),
            szeros=_dev_tensor(np.stack(szs), dev),
            w_bit=4, group_size=qcfg.group_size,
        )

    def vec(fmt: str):
        return _dev_tensor(np.stack([np.asarray(sd[fmt.format(i=i)]) for i in range(L)]),
                           dev, dt)

    h, i_sz = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_kv_heads * cfg.head_dim
    dims = {"wq": (h, h), "wk": (h, kv), "wv": (h, kv), "wo": (h, h),
            "gate": (h, i_sz), "up": (h, i_sz), "down": (i_sz, h)}
    layers: Dict[str, Any] = {
        "ln1": vec(_LLAMA_MAP["ln1"]),
        "ln2": vec(_LLAMA_MAP["ln2"]),
    }
    for name, (ic, oc) in dims.items():
        layers[name] = qlin(_LLAMA_MAP[name], ic, oc)
    params: Dict[str, Any] = {
        "embed": _dev_tensor(np.asarray(sd["model.embed_tokens.weight"]), dev, dt),
        "layers": layers,
        "norm": _dev_tensor(np.asarray(sd["model.norm.weight"]), dev, dt),
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = _dev_tensor(np.asarray(sd["lm_head.weight"]).T, dev, dt)
    return cfg, params, qcfg


def load_autoawq_checkpoint(
    path: str, dtype: str = "bfloat16", device="cuda"
) -> Tuple[ModelConfig, Dict[str, Any], QuantConfig]:
    """Load an AutoAWQ-format HF directory into (cfg, params, qcfg), the
    params on ``device``."""
    dev = _device.resolve(device)
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    qc = raw.get("quantization_config", {})
    qcfg = QuantConfig(
        w_bit=qc.get("bits", qc.get("w_bit", 4)),
        group_size=qc.get("group_size", qc.get("q_group_size", 128)),
        zero_point=qc.get("zero_point", True),
    )
    if qcfg.w_bit != 4:
        raise NotImplementedError("autoawq import supports 4-bit")
    cfg = model_config_from_hf(raw)
    cfg = ModelConfig(**{**cfg.__dict__, "dtype": dtype})
    if cfg.arch not in ("llama", "mistral", "qwen2"):
        raise NotImplementedError(f"autoawq import: arch {cfg.arch}")
    sd = {k: _np(v) for k, v in _load_dir_state_dict(path).items()}
    dt = getattr(torch, dtype)
    L = cfg.num_layers

    def qlin(prefix_fmt: str) -> QLinear:
        qws, ss, szs, bs = [], [], [], []
        has_bias = prefix_fmt.format(i=0) + ".bias" in sd
        for i in range(L):
            p = prefix_fmt.format(i=i)
            codes, s, sz = _unpack_autoawq_linear(
                np.ascontiguousarray(sd[p + ".qweight"]),
                np.ascontiguousarray(sd[p + ".qzeros"]),
                np.asarray(sd[p + ".scales"]),
            )
            qws.append(native.pack_int4_tpu(codes))
            ss.append(s)
            szs.append(sz)
            if has_bias:
                bs.append(np.asarray(sd[p + ".bias"], np.float32))
        return QLinear(
            qweight=_dev_tensor(np.stack(qws), dev),
            scales=_dev_tensor(np.stack(ss), dev),
            szeros=_dev_tensor(np.stack(szs), dev),
            bias=_dev_tensor(np.stack(bs), dev, dt) if bs else None,
            w_bit=qcfg.w_bit,
            group_size=qcfg.group_size,
        )

    def vec(fmt: str):
        return _dev_tensor(np.stack([np.asarray(sd[fmt.format(i=i)]) for i in range(L)]),
                           dev, dt)

    layers: Dict[str, Any] = {
        "ln1": vec(_LLAMA_MAP["ln1"]),
        "ln2": vec(_LLAMA_MAP["ln2"]),
    }
    for name in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
        layers[name] = qlin(_LLAMA_MAP[name])
    params: Dict[str, Any] = {
        "embed": _dev_tensor(np.asarray(sd["model.embed_tokens.weight"]), dev, dt),
        "layers": layers,
        "norm": _dev_tensor(np.asarray(sd["model.norm.weight"]), dev, dt),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = _dev_tensor(np.asarray(sd["lm_head.weight"]).T, dev, dt)
    return cfg, params, qcfg
