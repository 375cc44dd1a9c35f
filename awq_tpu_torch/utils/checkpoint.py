"""Quantized-checkpoint serialization (PyTorch port of
``awq_tpu/utils/checkpoint.py``), in the JAX package's format: one
``<path>.safetensors`` and a JSON sidecar ``<path>.json`` holding the model
and quant configs, the pack-layout version, each leaf's kind (``tags``) and
the keys stored as raw bf16 bits (``bf16_keys``, uint16 arrays: safetensors'
numpy side has no bf16).

The port reads what :func:`awq_tpu.utils.checkpoint.save_checkpoint` writes
and writes what its ``load_checkpoint`` reads, bit for bit, without the
``safetensors`` package: files are read by
:func:`~awq_tpu_torch.models.hf_import.read_safetensors` and written by
:func:`write_safetensors`. A loaded tree goes through the same numpy code
as :func:`~awq_tpu_torch.convert.params_from_jax` (records with the JAX
leaves' fields), so a checkpoint of JAX's tiled or folded layouts arrives
in the port's plain one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import types
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from awq_tpu_torch.config import ModelConfig, QuantConfig, RopeScaling
from awq_tpu_torch.models.hf_import import read_safetensors
from awq_tpu_torch.models.layers import Linear
from awq_tpu_torch.ops.w4a16 import QLinear

PACK_LAYOUT_VERSION = 1  # int32 [IC//8, OC], 64-channel chunks (packing.py)

_ST_NAMES = {np.dtype(np.float64): "F64", np.dtype(np.float32): "F32",
             np.dtype(np.float16): "F16", np.dtype(np.int64): "I64",
             np.dtype(np.int32): "I32", np.dtype(np.int16): "I16", np.dtype(np.int8): "I8",
             np.dtype(np.uint8): "U8", np.dtype(np.uint16): "U16", np.dtype(np.bool_): "BOOL"}


def write_safetensors(path: str, arrays: Dict[str, np.ndarray]) -> int:
    """Write ``arrays`` as one safetensors file: the header's length (8
    bytes, little-endian), the JSON header padded with spaces to 8 bytes,
    then each array's little-endian bytes in name order. Returns the bytes
    written."""
    header: Dict[str, Any] = {}
    blobs = []
    off = 0
    for name in sorted(arrays):
        a = np.asarray(arrays[name])
        if a.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {a.dtype} has no safetensors name here")
        raw = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes(order="C")
        header[name] = {"dtype": _ST_NAMES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    return 8 + len(head) + off


def _numpy(t: torch.Tensor) -> Tuple[np.ndarray, bool]:
    """``(array, is_bf16)``: a tensor as numpy, bf16 as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def _flatten(params: Dict[str, Any], prefix: str = ""):
    """The tree as ``{dotted name: tensor}`` and each leaf's tag, as JAX's
    ``_flatten`` names them (a port :class:`QLinear` is JAX's plain
    layout: not tiled, not folded)."""
    flat: Dict[str, torch.Tensor] = {}
    tags: Dict[str, Any] = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            f, t = _flatten(v, name + ".")
            flat.update(f)
            tags.update(t)
        elif isinstance(v, QLinear):
            tags[name] = {"kind": "qlinear", "w_bit": v.w_bit, "group_size": v.group_size,
                          "tiled_bn": 0, "folded": False, "dense3": v.dense3, "n_groups": 0}
            flat[name + ".qweight"] = v.qweight
            flat[name + ".scales"] = v.scales
            flat[name + ".szeros"] = v.szeros
            if v.bias is not None:
                flat[name + ".bias"] = v.bias
        elif isinstance(v, Linear):
            tags[name] = {"kind": "linear"}
            flat[name + ".w"] = v.w
            if v.b is not None:
                flat[name + ".b"] = v.b
        elif v is None:
            continue
        elif isinstance(v, torch.Tensor):
            tags[name] = {"kind": "array"}
            flat[name] = v
        else:
            raise TypeError(f"{name}: a {type(v).__name__} leaf has no checkpoint kind "
                            "(the int8 prefill cache is built by the engine, not saved)")
    return flat, tags


def _unflatten(flat: Dict[str, torch.Tensor], tags: Dict[str, Any]) -> Dict[str, Any]:
    """The tree of JAX's ``_unflatten`` with records in place of its
    ``QLinear`` and ``Linear`` (the fields :func:`params_from_jax` reads)."""
    params: Dict[str, Any] = {}

    def put(name: str, value):
        parts = name.split(".")
        d = params
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = value

    for name, tag in tags.items():
        kind = tag["kind"]
        if kind == "qlinear":
            put(name, types.SimpleNamespace(
                qweight=flat[name + ".qweight"], scales=flat[name + ".scales"],
                szeros=flat[name + ".szeros"], bias=flat.get(name + ".bias"),
                w_bit=tag["w_bit"], group_size=tag["group_size"],
                tiled_bn=tag.get("tiled_bn", 0), folded=tag.get("folded", False),
                dense3=tag.get("dense3", False), n_groups=tag.get("n_groups", 0)))
        elif kind == "linear":
            put(name, types.SimpleNamespace(w=flat[name + ".w"], b=flat.get(name + ".b")))
        else:
            put(name, flat[name])
    return params


def save_checkpoint(path: str, params: Dict[str, Any], cfg: ModelConfig,
                    qcfg: Optional[QuantConfig] = None) -> int:
    """Write ``<path>.safetensors`` + ``<path>.json``; returns the bytes of
    the tensor file."""
    flat, tags = _flatten(params)
    arrays, bf16_keys = {}, []
    for k, v in flat.items():
        arrays[k], is_bf16 = _numpy(v)
        if is_bf16:
            bf16_keys.append(k)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    n = write_safetensors(path + ".safetensors", arrays)
    meta = {
        "pack_layout_version": PACK_LAYOUT_VERSION,
        "model_config": dataclasses.asdict(cfg),
        "quant_config": dataclasses.asdict(qcfg) if qcfg else None,
        "tags": tags,
        "bf16_keys": bf16_keys,
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return n


def _check_version(meta: Dict[str, Any], what: str) -> None:
    ver = meta.get("pack_layout_version")
    if ver != PACK_LAYOUT_VERSION:
        raise ValueError(
            f"{what} pack layout v{ver} != supported v{PACK_LAYOUT_VERSION}"
            " — repack the checkpoint (cf. the reference's v1->v2 repacker,"
            " tinychat/offline-weight-repacker.py)")


def _configs(meta: Dict[str, Any]) -> Tuple[ModelConfig, Optional[QuantConfig]]:
    mc = dict(meta["model_config"])
    if mc.get("rope_scaling"):
        mc["rope_scaling"] = RopeScaling(**mc["rope_scaling"])
    qc = meta.get("quant_config")
    return ModelConfig(**mc), (QuantConfig(**qc) if qc else None)


def _tree(flat: Dict[str, torch.Tensor], meta: Dict[str, Any], device):
    from awq_tpu_torch.convert import params_from_jax

    for k in meta.get("bf16_keys", []):
        flat[k] = flat[k].view(torch.bfloat16)
    return params_from_jax(_unflatten(flat, meta["tags"]), device=device)


def split_checkpoint(path: str, out_dir: str) -> int:
    """Split a saved checkpoint into one file per tensor (``meta.json``,
    ``index.json`` and ``t00000.safetensors``...), as JAX's does. Returns
    the tensor count."""
    flat = read_safetensors(path + ".safetensors")
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(path + ".json", os.path.join(out_dir, "meta.json"))
    names = sorted(flat)
    for i, k in enumerate(names):
        write_safetensors(os.path.join(out_dir, f"t{i:05d}.safetensors"),
                          {k: flat[k].numpy()})
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump({k: f"t{i:05d}.safetensors" for i, k in enumerate(names)}, f)
    return len(flat)


def load_split_checkpoint(out_dir: str, device="cuda"):
    """Shard-by-shard loader of :func:`split_checkpoint`'s directory:
    ``(params, cfg, qcfg)`` with the params on ``device``."""
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    _check_version(meta, "split checkpoint")
    with open(os.path.join(out_dir, "index.json")) as f:
        index = json.load(f)
    flat: Dict[str, torch.Tensor] = {}
    for fname in index.values():
        flat.update(read_safetensors(os.path.join(out_dir, fname)))
    cfg, qcfg = _configs(meta)
    return _tree(flat, meta, device), cfg, qcfg


def load_checkpoint(path: str, device="cuda"
                    ) -> Tuple[Dict[str, Any], ModelConfig, Optional[QuantConfig]]:
    """Load a checkpoint that :func:`save_checkpoint` (the port's or the
    JAX package's) wrote: ``(params, cfg, qcfg)``, the params in the port's
    layout on ``device``."""
    with open(path + ".json") as f:
        meta = json.load(f)
    _check_version(meta, "checkpoint")
    flat = read_safetensors(path + ".safetensors")
    cfg, qcfg = _configs(meta)
    return _tree(flat, meta, device), cfg, qcfg
