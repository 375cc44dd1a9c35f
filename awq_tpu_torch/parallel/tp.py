"""Tensor-parallel forward and decode over a ``torch.distributed`` group
(PyTorch port of ``awq_tpu/parallel/tp.py``: ``tp_local_cfg``,
``check_tp_compatible``, ``tp_forward`` and ``tp_decode_scan``).

The JAX package runs the model inside ``shard_map`` over a mesh; the
port runs one process per rank, each calling these functions with its own
shards (``parallel/deploy.py``) and its :class:`~awq_tpu_torch.parallel.
mesh.TPGroup`. The Megatron collectives live in ``models/llama.py::
forward`` under its ``tp_axis``: an all-reduce after the row-parallel
``wo``/``down`` (or after each of K12 and K13), and one for the
vocab-sharded embedding. :func:`tp_forward` gathers the vocab-sharded
logits: each rank writes its slice into a zero-filled ``[.., V]`` buffer
at its offset and the group all-reduces it, one code path for NCCL and
for gloo (whose CUDA tensors take ``all_reduce`` and ``broadcast`` but no
``all_gather``); every element then has one nonzero term, so every rank
holds the same logits bit for bit. The decode is a host loop
(``runtime/generate.py::decode_scan``), as the port's single-device one
is; there is no trace cache to keep (JAX's ``_STEP_CACHE`` is not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from awq_tpu_torch.config import GenConfig, ModelConfig


def tp_local_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The per-rank view of ``cfg``: head counts divided by ``tp``; the
    hidden size and the vocabulary stay global (the residual stream is
    replicated)."""
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


def check_tp_compatible(params: Dict[str, Any], cfg: ModelConfig, tp: int) -> None:
    """Raise where the JAX package's ``check_tp_compatible`` raises: heads
    and vocabulary that ``tp`` does not divide, fused linears, an
    ``act_scale``, row-parallel linears whose groups do not split into
    ``tp`` whole shares, and dense 3-bit row-parallel shards that are not
    whole 256-channel chunks. (JAX's refusal of tiled layouts has no
    counterpart: the port has none.)"""
    from awq_tpu_torch.ops.w4a16 import QLinear
    from awq_tpu_torch.parallel.shard import ROW_PARALLEL

    if tp == 1:
        return
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_heads={cfg.num_heads} and "
                         f"num_kv_heads={cfg.num_kv_heads}")
    if cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size={cfg.vocab_size} "
                         "(vocab-sharded embedding / output head)")
    layers = params.get("layers", {})
    for fused in ("wqkv", "wgateup"):
        if fused in layers:
            raise ValueError(f"explicit TP needs unfused linears (found {fused}); "
                             "skip fuse_linears for multi-chip serving")
    if "act_scale" in layers:
        raise ValueError("per-channel act_scale not supported under tp")
    for name, leaf in layers.items():
        if not isinstance(leaf, QLinear) or name not in ROW_PARALLEL:
            continue
        path = f"(DictKey(key='layers'), DictKey(key='{name}'))"     # JAX's key path
        n_g = leaf.in_features // leaf.group_size
        if n_g % tp:
            raise ValueError(f"tp={tp} must divide the group count {n_g} of row-parallel "
                             f"{path} (IC shards must hold whole quantization groups)")
        if leaf.dense3 and (leaf.in_features // tp) % 256:
            raise ValueError(f"dense-3-bit row-parallel {path}: IC/tp must be a multiple "
                             "of the 256-channel packing chunk")


def gather_vocab(local: torch.Tensor, mesh, vocab: int) -> torch.Tensor:
    """The global ``[..., vocab]`` logits from every rank's vocab slice
    ``local [..., vocab / tp]`` (rank ``r`` holds ``[r V/tp, (r+1) V/tp)``)."""
    if mesh.size == 1:
        return local
    shard = local.shape[-1]
    buf = local.new_zeros(local.shape[:-1] + (vocab,))
    buf[..., mesh.rank * shard:(mesh.rank + 1) * shard] = local
    return mesh.all_reduce(buf)


def _local(params: Dict[str, Any], cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The rank's shards: a deploy layout (``build_tp_params``, fused) as
    it is, or a raw PLAIN tree (unfused, whole) validated and sliced, as
    JAX's ``_resolve_params`` takes either."""
    if "wqkv" in params["layers"]:
        return params
    from awq_tpu_torch.parallel.shard import shard_params

    check_tp_compatible(params, cfg, mesh.size)
    return shard_params(params, mesh.rank, mesh.size)


def tp_forward(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor, cache,
               start_pos: int, mesh, last_only: bool = True,
               impl: str = "auto") -> Tuple[torch.Tensor, Any]:
    """One forward step of this rank: ``cfg`` global, ``params`` the rank's
    deploy layout (or a plain tree), ``cache`` its kv-head shard (written in
    place). Every rank calls it with the same ``tokens``. Returns the
    GLOBAL logits ``[B, S(or 1), V]`` on every rank, and the cache."""
    from awq_tpu_torch.models.llama import forward

    local = _local(params, cfg, mesh)
    logits, cache = forward(local, tp_local_cfg(cfg, mesh.size), tokens, cache, start_pos,
                            last_only=last_only, impl=impl, tp_axis=mesh)
    return gather_vocab(logits, mesh, cfg.vocab_size), cache


def tp_decode_scan(params: Dict[str, Any], cfg: ModelConfig, cache, first_token: torch.Tensor,
                   start_pos: int, stop_ids: Sequence[int], seen: torch.Tensor,
                   gen: GenConfig, num_steps: int, mesh,
                   generator: Optional[torch.Generator] = None):
    """The decode burst of ``generate`` on this rank: ``num_steps`` steps of
    :func:`tp_forward` and sampling, a host loop. Every rank samples from
    the same gathered logits; a sampled (non-greedy) token is broadcast from
    rank 0, so that the ranks never part even without a shared generator.
    Returns ``(tokens [B, n], cache)`` as ``decode_scan`` does."""
    from awq_tpu_torch.runtime.generate import decode_scan

    local = _local(params, cfg, mesh)

    def step(token, pos):
        return tp_forward(local, cfg, token[:, None], cache, pos, mesh)[0][:, -1]

    return decode_scan(step, first_token, start_pos, stop_ids, seen, gen, num_steps,
                       generator, agree=agree_fn(gen, mesh)), cache


def agree_fn(gen: GenConfig, mesh):
    """How the ranks come to one sampled token: greedy ids agree by
    themselves (every rank holds the same logits), a draw is broadcast from
    rank 0. None for greedy, else ``mesh.broadcast``."""
    return None if gen.greedy or gen.temperature < 1e-5 else mesh.broadcast
