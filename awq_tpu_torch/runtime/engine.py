"""Single-model inference engine (PyTorch port of ``awq_tpu/runtime/engine.py``).

Owns the parameters (fused QKV and gate/up) and the KV cache on one
device (bf16 by default; ``cache_dtype="int8"`` holds a ``KVCache8`` of
int8 codes and f32 scales, half the bytes), and keeps the ``start_pos`` bookkeeping across dialogue rounds so
that a round prefills only its new tokens and reuses the history's KV. A
round's last id that was never fed is carried into the next round's
prompt, so that no round attends over an unwritten cache slot.

``RuntimeConfig.prefill_w8`` builds the int8 prefill weight cache after
the fusion and turns on ``cfg.prefill_a8`` (``attach_prefill_w8``):
prompts of 32 tokens and more on the stacked path then prefill through
K11 (a float-cache prompt of up to 32 tokens still takes K5).

``RuntimeConfig.mesh`` (this rank's :class:`~awq_tpu_torch.parallel.mesh.
TPGroup`, ``dp == 1``) serves through tensor parallelism, as the JAX
engine does over a mesh: every rank of the group builds an engine from the
same plain (unfused) params and drives it with the same calls. The engine
keeps the rank's deploy layout (``build_tp_params``) and its kv-head shard
of the cache (bf16, or int8 codes and scales), on the group's device;
prefill and decode run through ``tp_forward`` and ``tp_decode_scan``, and
every rank returns the same ids.

On a card the decode runs through a
:class:`~awq_tpu_torch.runtime.generate.DecodeLoop` over the engine's cache:
a decode step captured as a CUDA graph per length bucket, path and sampling
configuration and replayed once a token. On the CPU it is one ``forward``
call a token (``decode_scan``). :meth:`InferenceEngine.stream` streams a
round through the same steps.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from awq_tpu_torch import _device
from awq_tpu_torch.config import GenConfig, ModelConfig, RuntimeConfig
from awq_tpu_torch.models.llama import (
    attach_prefill_w8,
    cache_seq_len,
    cache_tensors,
    forward,
    fuse_linears,
    init_cache,
    params_to,
    quantize_head,
)
from awq_tpu_torch.parallel.deploy import build_tp_params
from awq_tpu_torch.parallel.tp import tp_forward, tp_local_cfg
from awq_tpu_torch.runtime.generate import DecodeLoop, StreamGenerator, generate


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        runtime: Optional[RuntimeConfig] = None,
        cache_dtype=torch.bfloat16,
        device="cuda",
        tokenizer=None,
    ):
        self.cfg = cfg
        self.rt = runtime or RuntimeConfig()
        self.mesh = self.rt.mesh
        self.tokenizer = tokenizer
        self.loop = None
        t = min(self.rt.max_seq_len, cfg.max_position_embeddings)
        self._pending = []      # an id returned but not yet fed (see generate)
        self.start_pos = 0
        if self.mesh is not None:
            if self.mesh.dp != 1:
                raise ValueError("engines require a dp=1 mesh (the batch axis is the "
                                 f"engine's slot axis); got dp={self.mesh.dp}, "
                                 f"tp={self.mesh.size}")
            self.device = _device.resolve(self.mesh.device)
            # sliced where the params lie (the host, for a model larger than a
            # card), and only the rank's shard moves to its card
            self.params = params_to(build_tp_params(params, cfg, self.mesh,
                                                    quantize_head=self.rt.quantize_head,
                                                    prefill_w8=self.rt.prefill_w8),
                                    self.device)
            self.cache = init_cache(tp_local_cfg(cfg, self.mesh.size), self.rt.max_batch_size,
                                    t, cache_dtype, device=self.device)
            return
        self.device = _device.resolve(device)
        params = params_to(params, self.device)
        if self.rt.quantize_head:
            params = quantize_head(params, cfg)
        self.params = fuse_linears(params, cfg)
        if self.rt.prefill_w8:
            self.params, self.cfg = attach_prefill_w8(self.params, cfg, self.rt)
        self.cache = init_cache(cfg, self.rt.max_batch_size, t, cache_dtype,
                                device=self.device)
        if self.device.type == "cuda":
            self.loop = DecodeLoop(self.params, self.cfg, self.cache, self.rt.max_batch_size)

    # ---- conversation state (history KV reused across rounds) ----

    def reset(self):
        self.start_pos = 0
        self._pending = []
        for t in cache_tensors(self.cache):
            t.zero_()

    @property
    def max_seq_len(self) -> int:
        return cache_seq_len(self.cache)

    def _forward(self, tokens, start_pos):
        if self.mesh is not None:
            return tp_forward(self.params, self.cfg, tokens, self.cache, start_pos, self.mesh)
        return forward(self.params, self.cfg, tokens, self.cache, start_pos)

    def warmup(self, seq_len: int = 64):
        """Run one prefill and one decode step (first launches load the
        kernels), then clear the cache they wrote."""
        toks = torch.zeros((self.rt.max_batch_size, seq_len), dtype=torch.long,
                           device=self.device)
        self._forward(toks, 0)
        self._forward(toks[:, :1], seq_len)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reset()

    def generate(
        self,
        prompt_ids: Sequence[int],
        gen: GenConfig,
        stop_ids: Sequence[int] = (),
        generator: Optional[torch.Generator] = None,
        continue_dialogue: bool = True,
    ) -> Dict[str, Any]:
        """One dialogue round: prefill only the new tokens (history KV is
        reused via ``start_pos``), then decode.

        When the round's last id was never fed (it is the final decode
        step's output: the round ran out of steps, or stopped on its very
        last one), its KV slot is unwritten. With ``continue_dialogue``,
        ``start_pos`` then stops at that id's position and the id stays
        pending: the next round prepends it to its prompt, so its KV is
        written before the history is attended."""
        ids = self.round_ids(prompt_ids, gen.max_new_tokens)
        tokens = torch.tensor([ids], dtype=torch.long, device=self.device)
        out = generate(self.params, self.cfg, tokens, self.cache, gen,
                       stop_ids=stop_ids, start_pos=self.start_pos,
                       generator=generator, mesh=self.mesh, loop=self.loop)
        self.cache = out["cache"]
        n_new = int(out["n_valid"][0])
        ids_out = out["output_ids"][0, :n_new]
        if continue_dialogue:
            unfed = n_new == out["output_ids"].shape[1]
            self.start_pos += len(ids) + n_new - int(unfed)
            self._pending = [int(ids_out[-1])] if unfed else []
        out["output_ids"] = ids_out
        if self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(ids_out.tolist())
        return out

    def round_ids(self, prompt_ids: Sequence[int], max_new_tokens: int):
        """A round's ids to prefill: the pending id, if any, then the
        prompt; a round that would overrun the cache resets it first."""
        ids = self._pending + list(prompt_ids)
        if self.start_pos + len(ids) + max_new_tokens > self.max_seq_len:
            self.reset()  # simplistic eviction; the paged cache lands later
            ids = list(prompt_ids)
        return ids

    def stream(self, gen: GenConfig, stop_ids: Sequence[int] = (),
               stream_interval: int = 2) -> StreamGenerator:
        """A :class:`~awq_tpu_torch.runtime.generate.StreamGenerator` over
        the engine's cache and decode loop. Call it with
        :meth:`round_ids` and ``start_pos=self.start_pos``; its last chunk's
        ``new_start_pos`` and ``pending`` are the engine's next
        ``start_pos`` and pending ids."""
        return StreamGenerator(self.params, self.cfg, self.tokenizer, gen, self.cache,
                               stop_ids=stop_ids, stream_interval=stream_interval,
                               mesh=self.mesh, loop=self.loop)

    def generate_speculative(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int,
        stop_ids: Sequence[int] = (),
        k: int = 7,
        n: int = 3,
        continue_dialogue: bool = True,
        device_loop: Optional[bool] = None,
        gen: Optional[GenConfig] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """Generation with prompt-lookup speculative verification
        (``runtime/speculative.py``; ``awq_tpu/runtime/engine.py:169-245``):
        up to ``k`` drafted tokens verified a forward, the output identical
        to :meth:`generate` with ``GenConfig(greedy=True)``. Returns
        ``{"output_ids", "stats": {steps, drafted, accepted, length}}``
        (and ``text`` with a tokenizer); the first stop id of ``stop_ids``
        ends the round and is returned.

        By default a greedy round runs the host loop
        (:func:`~awq_tpu_torch.runtime.speculative.generate_speculative`: the
        drafts found on the host, a window of ``k + 1`` through ``forward``,
        K5 on the card, or of the one last token where none is found).
        ``device_loop`` (the default for a sampled ``gen``) runs JAX's
        device-side loop (:func:`~awq_tpu_torch.runtime.speculative.
        spec_decode_device`: a fixed ``k + 1`` window a step through
        ``forward``, a host loop here with one read a step).
        ``gen``: a sampling :class:`GenConfig` (``temperature > 0``) rides
        rejection-sampling acceptance, its draws from ``generator``; it needs
        the device loop. Under a mesh the host loop routes every window
        through ``tp_forward``, greedy only, as in the JAX engine.

        History KV is reused as in :meth:`generate`: the round prefills the
        pending id, if any, and its prompt from ``start_pos``. An id the
        round returned but never fed (its last, unless a stop id among the
        accepted drafts ended it) stays pending for the next round, and
        ``start_pos`` stops at its position. (JAX's engine moves past that
        id's slot, which no step wrote.)"""
        from awq_tpu_torch.runtime.speculative import generate_speculative, spec_decode_device

        ids = self.round_ids(prompt_ids, max_new_tokens)
        tokens = torch.tensor([ids], dtype=torch.long, device=self.device)
        eos = int(stop_ids[0]) if len(stop_ids) else None
        sampled = gen is not None and not gen.greedy and gen.temperature >= 1e-5
        if self.mesh is not None:
            if device_loop:
                raise ValueError("device_loop is single-device; mesh speculation uses the "
                                 "host verify loop")
            if sampled:
                raise NotImplementedError(
                    "sampled speculation under a mesh: BatchEngine(spec_k=...) over a mesh is "
                    "ROADMAP queue A, item 17b")
            out_ids, stats = generate_speculative(self.params, self.cfg, tokens, self.cache,
                                                  max_new_tokens, k=k, n=n, eos=eos,
                                                  start_pos=self.start_pos, mesh=self.mesh)
        else:
            if device_loop is None:
                device_loop = sampled
            if sampled and not device_loop:
                raise ValueError("sampled speculation (gen.temperature > 0) requires "
                                 "device_loop=True")
            if device_loop:
                out_ids, stats = spec_decode_device(self.params, self.cfg, tokens, self.cache,
                                                    max_new_tokens, k=k, n=n, eos=eos,
                                                    start_pos=self.start_pos, gen=gen,
                                                    generator=generator)
            else:
                out_ids, stats = generate_speculative(self.params, self.cfg, tokens,
                                                      self.cache, max_new_tokens, k=k, n=n,
                                                      eos=eos, start_pos=self.start_pos)
        self.cache = stats.pop("cache")
        if continue_dialogue:
            # every step feeds the ids it emitted but its last (an accepted
            # stop id ends a round fed, with the drafts after it written too),
            # so the last id was fed iff the written length reaches it
            written = int(np.max(stats["length"])) - self.start_pos - len(ids)
            unfed = bool(out_ids) and written < len(out_ids)
            self.start_pos += len(ids) + len(out_ids) - int(unfed)
            self._pending = [int(out_ids[-1])] if unfed else []
        out: Dict[str, Any] = {"output_ids": out_ids, "stats": stats}
        if self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(list(map(int, out_ids)))
        return out
