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
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

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
from awq_tpu_torch.runtime.generate import generate


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        runtime: Optional[RuntimeConfig] = None,
        cache_dtype=torch.bfloat16,
        device="cuda",
    ):
        self.device = _device.resolve(device)
        self.cfg = cfg
        self.rt = runtime or RuntimeConfig()
        if self.rt.mesh is not None:
            raise NotImplementedError(
                "multi-GPU serving (RuntimeConfig.mesh) is ROADMAP queue A, item 17")
        t = min(self.rt.max_seq_len, cfg.max_position_embeddings)
        params = params_to(params, self.device)
        if self.rt.quantize_head:
            params = quantize_head(params, cfg)
        self.params = fuse_linears(params, cfg)
        if self.rt.prefill_w8:
            self.params, self.cfg = attach_prefill_w8(self.params, cfg, self.rt)
        self.cache = init_cache(cfg, self.rt.max_batch_size, t, cache_dtype,
                                device=self.device)
        self.start_pos = 0
        self._pending = []      # an id returned but not yet fed (see generate)

    # ---- conversation state (history KV reused across rounds) ----

    def reset(self):
        self.start_pos = 0
        self._pending = []
        for t in cache_tensors(self.cache):
            t.zero_()

    @property
    def max_seq_len(self) -> int:
        return cache_seq_len(self.cache)

    def warmup(self, seq_len: int = 64):
        """Run one prefill and one decode step (first launches load the
        kernels), then clear the cache they wrote."""
        toks = torch.zeros((self.rt.max_batch_size, seq_len), dtype=torch.long,
                           device=self.device)
        forward(self.params, self.cfg, toks, self.cache, 0)
        forward(self.params, self.cfg, toks[:, :1], self.cache, seq_len)
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
        ids = self._pending + list(prompt_ids)
        if self.start_pos + len(ids) + gen.max_new_tokens > self.max_seq_len:
            self.reset()  # simplistic eviction; the paged cache lands later
            ids = list(prompt_ids)
        tokens = torch.tensor([ids], dtype=torch.long, device=self.device)
        out = generate(self.params, self.cfg, tokens, self.cache, gen,
                       stop_ids=stop_ids, start_pos=self.start_pos,
                       generator=generator)
        self.cache = out["cache"]
        n_new = int(out["n_valid"][0])
        ids_out = out["output_ids"][0, :n_new]
        if continue_dialogue:
            unfed = n_new == out["output_ids"].shape[1]
            self.start_pos += len(ids) + n_new - int(unfed)
            self._pending = [int(ids_out[-1])] if unfed else []
        out["output_ids"] = ids_out
        return out

    def generate_speculative(self, *args, **kwargs):
        raise NotImplementedError("speculative decoding is ROADMAP queue A, item 11")
