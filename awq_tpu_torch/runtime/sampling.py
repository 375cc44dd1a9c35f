"""Sampling / logits processors (PyTorch port of ``awq_tpu/runtime/sampling.py``).

Repetition penalty -> temperature -> top-k -> top-p, then greedy
(``argmax``) or categorical sampling from an explicit ``torch.Generator``.
Sampled draws differ from ``jax.random``'s for the same seed; greedy ids
are the same function of the logits.
"""

from __future__ import annotations

from typing import Optional

import torch

from awq_tpu_torch.config import GenConfig


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """``logits [B, V]`` f32, ``seen [B, V]`` bool (tokens present so far)."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # keep the smallest prefix with cumulative prob >= p (always keep top-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                      cum[..., :-1] < p], dim=-1)
    thresh = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, float("-inf"), logits)


def sample_logits(logits: torch.Tensor, gen: GenConfig,
                  seen: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Process ``logits [B, V]`` and draw one token per row -> ``[B]`` int64.

    Greedy when ``gen.greedy`` or temperature < 1e-5."""
    logits = logits.float()
    if seen is not None:
        logits = apply_repetition_penalty(logits, seen, gen.repetition_penalty)
    if gen.greedy or gen.temperature < 1e-5:
        return torch.argmax(logits, dim=-1)
    logits = logits / gen.temperature
    logits = apply_top_k(logits, gen.top_k)
    logits = apply_top_p(logits, gen.top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
