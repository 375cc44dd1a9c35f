"""Paged KV-cache continuous-batching engine (PyTorch port of
``awq_tpu/runtime/paged.py``).

:class:`PagedBatchEngine` is :class:`~awq_tpu_torch.runtime.batch_engine.
BatchEngine` over a block-table cache: one page pool ``[L, 2, n_pages,
n_kv, page, hd]`` shared by all slots, plus a host table ``[n_slots,
max_pages]`` of physical page ids per slot. The memory a request holds
grows with its actual length, a page at a time, instead of ``max_seq`` per
slot. Each engine step is one
:func:`~awq_tpu_torch.models.llama.decode_step_paged` (K6's paged mode, or
the stacked path with K8, which appends each layer's token to its pages).

Page 0 is the trash page: :class:`PageAllocator` never hands it out, and a
freed slot's table row is all 0, so the k/v that the step still writes for
that slot (it decodes every slot, as the slot engine does) land there.

Scheduling on pool exhaustion, as in JAX: preempt the youngest other
active request with recompute. It frees its pages and goes back to the
head of the queue with its generated ids folded into its prompt.
Admission needs pages for the whole prompt plus one decode position. The
host table is uploaded once per step after ``_grow_tables``, with the
lengths and tokens.

Prefill reuses the slot engine's one-slot staging cache: the prompt runs
through ``forward`` there, and ONE indexed copy moves its pages into their
physical pages (JAX's ``_copy_page``, an XLA copy; plain PyTorch here). The
tail of the prompt's last page comes from the staging cache: it lies past
the prompt's length, so it is masked, and it lands only in a page this
slot owns.

Not ported: the paged int8 cache raises ``NotImplementedError``, as in JAX
(``awq_tpu/runtime/paged.py:107-109``), whose paged engine has none; a mesh
raises as in ``BatchEngine``. The paged engine never verifies speculatively
(``_spec_eligible`` is False, as JAX's: the verify step's window append
needs contiguous rows).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from awq_tpu_torch.config import ModelConfig
from awq_tpu_torch.models.llama import decode_step_paged
from awq_tpu_torch.runtime.batch_engine import BatchEngine, Request


class PageAllocator:
    """Host-side free list over the physical page pool. The ``reserved``
    low pages are never handed out: page 0 is the trash page."""

    def __init__(self, n_pages: int, reserved: int = 1):
        self.n_pages = n_pages
        self.reserved = reserved
        self._free: List[int] = list(range(n_pages - 1, reserved - 1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            assert self.reserved <= p < self.n_pages and p not in self._free
            self._free.append(p)


class PagedBatchEngine(BatchEngine):
    """BatchEngine with pages instead of per-slot rows.

    ``n_pages`` defaults to ``n_slots * max_seq_len / page_size / 2``
    (at least ``n_slots + 2``): half the slot engine's cache; size it to the
    workload. ``n_preempted`` counts the preemptions."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        # 2..64 slots ride K6's paged mode on the card
        n_slots: int = 8,
        max_seq_len: int = 2048,
        cache_dtype=torch.bfloat16,
        page_size: int = 256,
        n_pages: Optional[int] = None,
        runtime=None,   # Optional[RuntimeConfig]: quantize_head, prefill_w8
        device="cuda",
    ):
        if cache_dtype in ("int8", torch.int8):
            raise NotImplementedError(
                "paged int8 KV: the JAX package has none either "
                "(awq_tpu/runtime/paged.py:107-109); use BatchEngine(cache_dtype="
                "'int8'). ROADMAP queue A, item 10")
        self.page_size = page_size
        self.n_pages = n_pages  # resolved in _init_cache
        self.n_preempted = 0
        super().__init__(cfg, params, n_slots=n_slots, max_seq_len=max_seq_len,
                         cache_dtype=cache_dtype, runtime=runtime, device=device)

    # ---- cache strategy ----------------------------------------------------

    def _init_cache(self, cfg, n_slots, max_seq_len, cache_dtype) -> None:
        p = self.page_size
        if max_seq_len % p:
            raise ValueError(f"max_seq_len {max_seq_len} is not a multiple of the "
                             f"page size {p}")
        if self.n_pages is None:
            self.n_pages = max(n_slots * max_seq_len // p // 2, n_slots + 2)
        self.max_pages = max_seq_len // p
        self.cache = torch.zeros((cfg.num_layers, 2, self.n_pages, cfg.num_kv_heads, p,
                                  cfg.head_dim), dtype=cache_dtype, device=self.device)
        self.max_seq = max_seq_len
        self.alloc = PageAllocator(self.n_pages)
        # 0 = the trash page: a freed slot's writes land there
        self.tables = np.zeros((n_slots, self.max_pages), np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(n_slots)]

    def _spec_eligible(self, active) -> bool:
        return False   # the verify window's append needs contiguous rows

    def _can_admit(self, req: Request) -> bool:
        need = math.ceil((len(req.prompt_ids) + 1) / self.page_size)
        return self.alloc.n_free >= need

    def _prefill_slot(self, slot: int, toks: torch.Tensor) -> torch.Tensor:
        n, p = toks.shape[1], self.page_size
        n_pg = math.ceil((n + 1) / p)
        pages = self.alloc.alloc(n_pg)
        assert pages is not None, "checked by _can_admit"
        self.slot_pages[slot] = pages
        self.tables[slot, :] = 0
        self.tables[slot, :n_pg] = pages
        logits = self._stage_prefill(toks)
        # staging positions [j*p, (j+1)*p) -> physical page pages[j], one copy
        L, _, _, nkv, _, hd = self.cache.shape
        src = self._stage[:, :, 0, :, :n_pg * p].reshape(L, 2, nkv, n_pg, p, hd)
        self.cache[:, :, torch.tensor(pages, device=self.device)] = \
            src.permute(0, 1, 3, 2, 4, 5)
        return logits

    def _decode(self) -> torch.Tensor:
        self._grow_tables()
        logits, _ = decode_step_paged(
            self.params, self.cfg,
            torch.from_numpy(self.tokens).to(self.device), self.cache,
            torch.from_numpy(self.tables).to(self.device),
            torch.from_numpy(self.lengths).to(self.device),
            max_length=int(self.lengths.max()),
        )
        return logits

    def _on_release(self, slot: int) -> None:
        if self.slot_pages[slot]:
            self.alloc.free(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.tables[slot, :] = 0

    # ---- page growth / preemption -------------------------------------------

    def _grow_tables(self) -> None:
        """Give every active slot a page for this step's write position;
        preempt the youngest other request when the pool is empty."""
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            need_idx = int(self.lengths[i]) // self.page_size
            while need_idx >= len(self.slot_pages[i]):
                got = self.alloc.alloc(1)
                if got is None:
                    if not self._preempt(exclude=i):
                        raise RuntimeError(
                            f"page pool exhausted: {self.n_pages} pages cannot hold "
                            f"slot {i} at length {self.lengths[i]} with nothing left "
                            "to preempt")
                    continue
                self.slot_pages[i].append(got[0])
                self.tables[i, len(self.slot_pages[i]) - 1] = got[0]

    def _preempt(self, exclude: int) -> bool:
        """Free the youngest other active request and re-queue it at the head
        with its generated ids folded into its prompt (recompute)."""
        victims = [(r.rid, i) for i, r in enumerate(self.slots)
                   if r is not None and i != exclude]
        if not victims:
            return False
        _, vi = max(victims)
        req = self.slots[vi]
        req.prompt_ids = list(req.prompt_ids) + list(req.out_ids)
        req.slot = None
        self.slots[vi] = None
        self._on_release(vi)
        self.waiting.appendleft(req)
        self.n_preempted += 1
        return True
