"""One rank's shards of the parameters and the KV cache (PyTorch port of
the roles in ``awq_tpu/parallel/shard.py``).

The JAX package writes Megatron-style tensor parallelism as
PartitionSpecs over a mesh; the port's ranks are processes, so each rank
slices its own shard of the plain (unfused) tree:

- ``wq/wk/wv/gate/up`` are column-parallel: output channels (heads, the
  MLP's intermediate) split over the ranks; OC is the last axis of the
  codes, scales, szeros and bias in both packings.
- ``wo/down`` are row-parallel: input channels split in whole quantization
  groups (packed rows and group rows alike); the bias is NOT split, it is
  added once after the all-reduce (``models/llama.py``).
- ``embed`` is split on the vocabulary, an fp ``lm_head`` and a quantized
  one on their output (vocabulary) axis; norms are replicated.
- the KV cache ``[L, 2, B, n_kv, T, hd]`` (and a ``KVCache8``'s scales) is
  split on its kv heads (``shard_cache``, as JAX's ``shard_cache``); a
  cache whose kv heads ``tp`` does not divide stays whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from awq_tpu_torch.models.layers import Linear
from awq_tpu_torch.ops.w4a16 import QLinear

COLUMN_PARALLEL = ("wq", "wk", "wv", "gate", "up")
ROW_PARALLEL = ("wo", "down")


def _part(t: torch.Tensor, axis: int, rank: int, tp: int) -> torch.Tensor:
    n = t.shape[axis]
    if n % tp:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split into {tp}")
    # a copy, never a view: a leading-axis slice (the embedding's vocab) is
    # contiguous already, and a view would keep the whole tensor alive
    return t.narrow(axis, rank * n // tp, n // tp).clone(memory_format=torch.contiguous_format)


def slice_oc(p, rank: int, tp: int):
    """Rank ``rank``'s output channels of a column-parallel linear."""
    if isinstance(p, QLinear):
        return dataclasses.replace(
            p, qweight=_part(p.qweight, -1, rank, tp), scales=_part(p.scales, -1, rank, tp),
            szeros=_part(p.szeros, -1, rank, tp),
            bias=None if p.bias is None else _part(p.bias, -1, rank, tp))
    return Linear(w=_part(p.w, -1, rank, tp), b=None if p.b is None else _part(p.b, -1, rank, tp))


def slice_ic(p, rank: int, tp: int):
    """Rank ``rank``'s input channels of a row-parallel linear: whole groups
    (``check_tp_compatible`` holds it), contiguous packed rows; the bias
    stays whole."""
    if isinstance(p, QLinear):
        return dataclasses.replace(
            p, qweight=_part(p.qweight, -2, rank, tp), scales=_part(p.scales, -2, rank, tp),
            szeros=_part(p.szeros, -2, rank, tp))
    return Linear(w=_part(p.w, -2, rank, tp), b=p.b)


def shard_params(params: Dict[str, Any], rank: int, tp: int) -> Dict[str, Any]:
    """Rank ``rank`` of ``tp``'s shard of a plain parameter tree (the
    counterpart of placing it with ``param_pspecs``). ``tp == 1`` returns
    the tree."""
    if tp == 1:
        return params
    layers = {}
    for name, p in params["layers"].items():
        if p is None or not isinstance(p, (QLinear, Linear)):
            layers[name] = p
        elif name in COLUMN_PARALLEL:
            layers[name] = slice_oc(p, rank, tp)
        elif name in ROW_PARALLEL:
            layers[name] = slice_ic(p, rank, tp)
        else:
            layers[name] = p
    out = dict(params, layers=layers)
    emb = params["embed"]
    if emb.shape[0] % tp == 0:
        out["embed"] = _part(emb, 0, rank, tp)          # vocab-sharded
    head = params.get("lm_head")
    if isinstance(head, QLinear):
        out["lm_head"] = slice_oc(head, rank, tp)
    elif head is not None and head.shape[-1] % tp == 0:
        out["lm_head"] = _part(head, -1, rank, tp)
    return out


def shard_cache(cache, rank: int, tp: int):
    """Rank ``rank``'s kv heads of a cache ``[L, 2, B, n_kv, T, hd]`` or of a
    ``KVCache8`` (codes and scales); the whole cache where ``tp`` does not
    divide ``n_kv``."""
    from awq_tpu_torch.models.llama import KVCache8

    data = cache.data if isinstance(cache, KVCache8) else cache
    if tp == 1 or data.shape[3] % tp:
        return cache
    if isinstance(cache, KVCache8):
        return KVCache8(data=_part(cache.data, 3, rank, tp),
                        scales=_part(cache.scales, 3, rank, tp))
    return _part(cache, 3, rank, tp)
