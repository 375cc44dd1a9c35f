"""Continuous-batching inference engine (PyTorch port of
``awq_tpu/runtime/batch_engine.py``).

A slot-based scheduler over the batch axis of one shared static KV cache
``[L, 2, n_slots, n_kv, T, hd]``. Requests are admitted into free slots (a
prefill writes that slot's cache rows), and every engine step runs ONE
batched decode for all slots at their own lengths
(:func:`~awq_tpu_torch.models.llama.decode_step_batched`: per-row rope
positions, per-row attention lengths). Finished slots free at once and new
requests join between steps, so decode never drains the batch.

The host keeps its own copies of the per-slot lengths and next tokens, as
the JAX engine does: a step uploads them and fetches one thing from the
device, the sampled ids.

Prefill into a slot. The JAX engine slices the slot's row out of the cache,
runs ``forward`` on it and writes the row back. Here the single-stream
kernels (K2-K5) take a contiguous cache of batch 1, and the view
``cache[:, :, slot:slot + 1]`` of an ``n_slots`` cache is not contiguous.
So the engine prefills into a one-slot staging cache of the same length
(allocated at the first admission) and copies only the prefix ``[0, S)``
that the prompt wrote into the slot: S positions per layer and head, not a
``T``-long row.

The ``_can_admit`` and ``_on_release`` hooks are the JAX engine's: the
paged subclass (``runtime/paged.py``) overrides them, and ``_decode`` may
release slots there (preemption).

Two departures from the JAX engine, both faults of the reference that
show only under preemption (ROADMAP.md, section C):

- ``step`` skips a slot that ``_decode`` released; the JAX engine reads
  ``.rid`` of the freed slot and raises ``AttributeError``
  (``awq_tpu/runtime/batch_engine.py:377-383`` after
  ``awq_tpu/runtime/paged.py:190-223``).
- A preempted request comes back with its generated ids folded into its
  prompt. ``_admit`` counts only the tokens it still has to generate
  against the cache length; the JAX engine counts ``max_new_tokens`` on
  top of the longer prompt and drops a request that fits.

``cache_dtype="int8"`` holds a ``KVCache8`` (int8 codes and f32 scales):
half the bytes of the bf16 cache, so twice the slots or the context on
the same card. The staging cache is one too, and the prefix copy moves
codes and scales.

``RuntimeConfig.prefill_w8`` builds the int8 prefill weight cache and
turns on ``cfg.prefill_a8``, as in ``InferenceEngine``.

``spec_k`` turns on speculative verify (prompt-lookup drafting,
``runtime/speculative.py``): each step drafts up to ``spec_k`` tokens a
slot from its own context and verifies every slot's ``spec_k + 1``-token
window in ONE :func:`~awq_tpu_torch.models.llama.verify_step_batched` (the
window mode of K2, or K9 over an int8 cache, a layer, which appends the
windows), then accepts on the device
(:func:`~awq_tpu_torch.runtime.sampling.spec_accept_sample`: greedy rows by
the argmax, whose ids are plain decoding's; sampled rows by rejection
sampling). A step then returns a LIST of ids a rid. Where a slot's window
would not fit its cache, or the model is ALiBi (JAX's verify step has none),
the step decodes without speculation; the paged engine never verifies.

Not ported: a device mesh raises ``NotImplementedError`` (ROADMAP A17b).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from awq_tpu_torch import _device
from awq_tpu_torch.config import GenConfig, ModelConfig
from awq_tpu_torch.models.llama import (
    attach_prefill_w8,
    cache_seq_len,
    cache_tensors,
    decode_step_batched,
    forward,
    fuse_linears,
    init_cache,
    params_to,
)
from awq_tpu_torch.models.llama import quantize_head as _quantize_head
from awq_tpu_torch.runtime.sampling import sample_logits, sample_logits_batched


@dataclasses.dataclass
class Request:
    rid: int
    prompt_ids: List[int]
    gen: GenConfig
    stop_ids: frozenset
    out_ids: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    submitted_at: float = dataclasses.field(default_factory=time.time)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class BatchEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        # default 8: 2..64 slots ride the batched whole-token megakernel on
        # the card (ops/megakernel_batched.py), one launch per step instead
        # of ~50 per layer
        n_slots: int = 8,
        max_seq_len: int = 2048,
        cache_dtype=torch.bfloat16,
        quantize_head: bool = False,
        runtime=None,   # Optional[RuntimeConfig]: quantize_head, prefill_w8
        # speculative verify (prompt-lookup drafting): each step verifies a
        # spec_k + 1 window a slot instead of decoding one token
        spec_k: int = 0,
        spec_n: int = 3,
        device="cuda",
    ):
        self.device = _device.resolve(device)
        self.cfg = cfg
        self.spec_k = int(spec_k)
        self.spec_n = int(spec_n)
        if getattr(runtime, "mesh", None) is not None:
            raise NotImplementedError(
                "BatchEngine over a tensor-parallel group (RuntimeConfig.mesh) is "
                "ROADMAP queue A, item 17b")
        if runtime is not None and runtime.quantize_head:
            quantize_head = True
        params = params_to(params, self.device)
        if quantize_head:
            params = _quantize_head(params, cfg)
        self.params = fuse_linears(params, cfg)
        if getattr(runtime, "prefill_w8", False):
            # admission prefills (through the staging cache) then take K11
            self.params, cfg = attach_prefill_w8(self.params, cfg, runtime)
            self.cfg = cfg
        self.n_slots = n_slots
        self.cache_dtype = cache_dtype
        self._stage = None                             # one-slot prefill cache
        self._init_cache(cfg, n_slots, max_seq_len, cache_dtype)
        self.lengths = np.zeros(n_slots, np.int32)     # host copy
        self.tokens = np.zeros(n_slots, np.int64)      # next input per slot
        # per-slot sampling params (requests carry their own GenConfig)
        self.temps = np.ones(n_slots, np.float32)
        self.top_ks = np.zeros(n_slots, np.int64)
        self.top_ps = np.ones(n_slots, np.float32)
        self.greedy = np.ones(n_slots, bool)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.waiting: Deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0
        self._generator = torch.Generator(device=self.device).manual_seed(0)

    # ---- cache strategy ----------------------------------------------------

    def _init_cache(self, cfg, n_slots, max_seq_len, cache_dtype) -> None:
        self.cache = init_cache(cfg, n_slots, max_seq_len, cache_dtype,
                                device=self.device)
        self.max_seq = cache_seq_len(self.cache)

    def _stage_prefill(self, toks: torch.Tensor) -> torch.Tensor:
        """Prefill ``toks [1, S]`` into the one-slot staging cache
        ``[L, 2, 1, n_kv, max_seq, hd]`` (allocated at the first admission);
        returns the final-position logits ``[1, V]``."""
        if self._stage is None:
            self._stage = init_cache(self.cfg, 1, self.max_seq, self.cache_dtype,
                                     device=self.device)
        logits, _ = forward(self.params, self.cfg, toks, self._stage, 0)
        return logits[:, -1]

    def _can_admit(self, req: Request) -> bool:
        """Room for ``req`` now (a free slot is enough here; the paged
        engine also needs pages)."""
        return True

    def _prefill_slot(self, slot: int, toks: torch.Tensor) -> torch.Tensor:
        """Prefill ``toks [1, S]`` into ``slot``'s cache rows; returns the
        final-position logits ``[1, V]``."""
        logits = self._stage_prefill(toks)
        s = toks.shape[1]
        for dst, src in zip(cache_tensors(self.cache), cache_tensors(self._stage)):
            dst[:, :, slot, :, :s] = src[:, :, 0, :, :s]
        return logits

    def _decode(self) -> torch.Tensor:
        """One batched decode step over all slots -> logits [n_slots, V]."""
        logits, _ = decode_step_batched(
            self.params, self.cfg,
            torch.from_numpy(self.tokens).to(self.device), self.cache,
            torch.from_numpy(self.lengths).to(self.device),
            max_length=int(self.lengths.max()),
        )
        return logits

    def _on_release(self, slot: int) -> None:
        """Slot freed (request finished or preempted)."""

    # ---- request API ------------------------------------------------------

    def submit(self, prompt_ids: Sequence[int], gen: GenConfig,
               stop_ids: Sequence[int] = ()) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(
            rid=rid, prompt_ids=list(prompt_ids), gen=gen,
            stop_ids=frozenset(int(t) for t in stop_ids),
        ))
        return rid

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    # ---- scheduling -------------------------------------------------------

    def _admit(self) -> None:
        """Prefill waiting requests into free slots (continuous admission)."""
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                return
            req = self.waiting[0]
            n = len(req.prompt_ids)
            # a preempted request's prompt holds its generated ids already
            if n + req.gen.max_new_tokens - len(req.out_ids) > self.max_seq:
                self.waiting.popleft()
                req.done = True
                req.finished_at = time.time()
                self.finished[req.rid] = req
                continue
            if not self._can_admit(req):
                return  # no capacity right now (e.g. the page pool is full)
            self.waiting.popleft()
            toks = torch.tensor([req.prompt_ids], dtype=torch.long,
                                device=self.device)
            last_logits = self._prefill_slot(slot, toks)
            first = int(sample_logits(last_logits, req.gen,
                                      generator=self._generator)[0])
            req.slot = slot
            req.first_token_at = time.time()
            self.slots[slot] = req
            self.lengths[slot] = n
            self.tokens[slot] = first
            self.temps[slot] = req.gen.temperature
            self.top_ks[slot] = req.gen.top_k
            self.top_ps[slot] = req.gen.top_p
            self.greedy[slot] = req.gen.greedy
            self._record(req, first)

    def _finish(self, req: Request) -> None:
        req.done = True
        req.finished_at = time.time()
        self.finished[req.rid] = req
        self.slots[req.slot] = None
        self._on_release(req.slot)

    def _record(self, req: Request, token: int) -> None:
        req.out_ids.append(token)
        if (token in req.stop_ids
                or len(req.out_ids) >= req.gen.max_new_tokens):
            if req.out_ids and req.out_ids[-1] in req.stop_ids:
                req.out_ids.pop()
            self._finish(req)

    # ---- speculative verify -----------------------------------------------

    def _spec_eligible(self, active) -> bool:
        """Whether this step verifies (``awq_tpu/runtime/batch_engine.py:
        281-294``): ``spec_k`` set, a model the verify step takes (no ALiBi),
        and every active slot's window inside its cache. The paged engine
        overrides it off."""
        if not self.spec_k:
            return False
        if self.cfg.pos_embed not in ("rope", "learned", "none"):
            return False
        w = self.spec_k + 1
        return all(self.lengths[i] + w <= self.max_seq for i in active)

    def _step_spec(self, active) -> Dict[int, List[int]]:
        """One verify step (``awq_tpu/runtime/batch_engine.py:296-355``):
        per-slot prompt-lookup drafts, ONE batched ``spec_k + 1`` forward,
        acceptance on the device, and one device fetch (the emitted ids and
        counts), as the plain decode fetches its ids."""
        from awq_tpu_torch.models.llama import verify_step_batched
        from awq_tpu_torch.runtime.sampling import spec_accept_sample
        from awq_tpu_torch.runtime.speculative import ngram_propose

        k = self.spec_k
        drafts = np.zeros((self.n_slots, k), np.int64)
        m_cap = np.zeros(self.n_slots, np.int64)
        for i in active:
            req = self.slots[i]
            ctx = np.asarray(list(req.prompt_ids) + list(req.out_ids), np.int32)
            d = ngram_propose(ctx, k, self.spec_n)
            drafts[i, :len(d)] = d
            budget = req.gen.max_new_tokens - len(req.out_ids)
            m_cap[i] = max(min(len(d), budget - 1), 0)
        windows = torch.from_numpy(np.concatenate([self.tokens[:, None], drafts], axis=1))
        windows = windows.to(self.device)
        logits, _ = verify_step_batched(self.params, self.cfg, windows, self.cache,
                                        torch.from_numpy(self.lengths).to(self.device),
                                        max_length=int(self.lengths.max()))
        emit, take = spec_accept_sample(
            logits, windows, torch.from_numpy(m_cap), torch.from_numpy(self.temps),
            torch.from_numpy(self.top_ks), torch.from_numpy(self.top_ps),
            torch.from_numpy(self.greedy), generator=self._generator)
        read = torch.cat([emit, take[:, None]], dim=1).cpu().numpy()   # the step's one fetch
        out: Dict[int, List[int]] = {}
        for i in active:
            req = self.slots[i]
            take_i = int(read[i, k + 1])
            emit_i = [int(t) for t in read[i, :take_i]]
            self.lengths[i] += take_i
            self.tokens[i] = emit_i[-1]
            got = []
            for tok in emit_i:
                if req.done:
                    break
                got.append(tok)
                self._record(req, tok)
            out[req.rid] = got
            if not req.done and self.lengths[i] + 1 >= self.max_seq:
                self._finish(req)
        return out

    def step(self) -> Dict[int, int]:
        """Admit + one batched decode step. Returns {rid: new_token} for
        slots that produced a token this step; with ``spec_k`` a step that
        verifies returns {rid: [new tokens]} (a slot may produce several)."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return {}
        if self._spec_eligible(active):
            return self._step_spec(active)
        logits = self._decode()
        nxt = sample_logits_batched(
            logits, torch.from_numpy(self.temps), torch.from_numpy(self.top_ks),
            torch.from_numpy(self.top_ps), torch.from_numpy(self.greedy),
            generator=self._generator,
        ).cpu().numpy()                      # the step's one device fetch
        out: Dict[int, int] = {}
        for i in active:
            req = self.slots[i]
            if req is None:
                continue                     # released during _decode (preempted)
            self.lengths[i] += 1
            tok = int(nxt[i])
            self.tokens[i] = tok
            out[req.rid] = tok
            self._record(req, tok)
            if not req.done and self.lengths[i] + 1 >= self.max_seq:
                self._finish(req)  # out of cache slots
        return out

    def run(self) -> Dict[int, Request]:
        """Drain all submitted requests; returns {rid: Request}."""
        while self.waiting or self.n_active:
            self.step()
        return self.finished
