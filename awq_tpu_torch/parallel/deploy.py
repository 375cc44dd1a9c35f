"""The tensor-parallel deploy layout of one rank (PyTorch port of
``awq_tpu/parallel/deploy.py::build_tp_params``).

The JAX package builds every device's local fused layout first and
assembles the global arrays as rank-order concatenations, so that its
shardings hand each device its own local fold. A port rank is a process
of its own and keeps only its local layout, built the same way from the
plain (unfused) params: the rank's column shards of q, k and v fused into
``wqkv`` (q_r | k_r | v_r), its gate and up shards into ``wgateup`` (gate_r
| up_r, the port's fused order, which K4's relatives read), its
input-channel shards of ``wo`` and ``down``, a vocab-sharded embedding and
head, and the norms whole. No fold or tiling: those layouts exist for
Mosaic only; the port's kernels read ``pack_int4``/``pack_int3`` as stored.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict

from awq_tpu_torch.config import ModelConfig
from awq_tpu_torch.ops.w4a16 import QLinear
from awq_tpu_torch.parallel.shard import shard_params
from awq_tpu_torch.parallel.tp import check_tp_compatible


def build_tp_params(params: Dict[str, Any], cfg: ModelConfig, mesh, quantize_head: bool = False,
                    prefill_w8: bool = False) -> Dict[str, Any]:
    """This rank's deploy-layout parameters from PLAIN (unfused) quantized
    params. ``mesh`` is the rank's :class:`~awq_tpu_torch.parallel.mesh.
    TPGroup` (its ``rank`` and ``size`` are read). Validated as JAX
    validates them (:func:`~awq_tpu_torch.parallel.tp.check_tp_compatible`).

    The shards are sliced on the params' own device: a caller that keeps
    the whole model on the host and moves only the result to the rank's card
    never holds more than the rank's shard there.

    ``quantize_head`` real-quantizes the rank's slice of an fp ``lm_head``, unless
    ``vocab / tp`` is not a multiple of 128 (Llama-3's 128256 at tp = 4, say),
    where the JAX package keeps the head fp and vocab-sharded
    (``awq_tpu/parallel/deploy.py:276-289``). The port has no 128-column
    tile to fit, but it makes the same decision: the two packages then
    compute the same head, and a test can hold one to the other."""
    from awq_tpu_torch.models.llama import check_llama_family, fuse_linears
    from awq_tpu_torch.models.llama import quantize_head as _qhead

    check_llama_family(cfg, "the tensor-parallel deploy layout")
    tp, rank = mesh.size, mesh.rank
    if prefill_w8:
        raise NotImplementedError(
            "prefill_w8 under tensor parallelism (the int8 weight cache of a rank's "
            "shards) is ROADMAP queue A, item 17b")
    if quantize_head and tp > 1 and (cfg.vocab_size // tp) % 128:
        warnings.warn(
            f"quantize_head skipped: vocab {cfg.vocab_size} / tp={tp} = "
            f"{cfg.vocab_size // tp} columns per rank is not a multiple of 128, where "
            "the JAX package keeps the lm_head fp (and vocab-sharded)")
        quantize_head = False
    check_tp_compatible(params, cfg, tp)
    layers = params["layers"]
    if "wqkv" in layers or "wq" not in layers:
        raise ValueError("build_tp_params takes the UNFUSED plain layout")
    for name in ("wq", "wk", "wv", "wo", "down") + (("gate", "up") if "gate" in layers else ()):
        if not isinstance(layers.get(name), QLinear):
            raise ValueError(f"deploy layout requires quantized {name}")
    local = shard_params(params, rank, tp)
    local["layers"] = {k: v for k, v in local["layers"].items() if v is not None}
    if quantize_head:
        # the rank quantizes its own vocab columns only: each output column's
        # groups are quantized on their own, so this is the rank's slice of
        # the whole head quantized, at 1/tp of the work and memory
        local = _qhead(local, cfg)
    head = local.get("lm_head")
    if isinstance(head, QLinear) and head.qweight.dim() != 2:
        raise ValueError("lm_head must be a plain 2D QLinear")
    return fuse_linears(local, cfg)
