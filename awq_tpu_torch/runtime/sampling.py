"""Sampling / logits processors (PyTorch port of ``awq_tpu/runtime/sampling.py``).

Repetition penalty -> temperature -> top-k -> top-p, then greedy
(``argmax``) or categorical sampling from an explicit ``torch.Generator``.
Sampled draws differ from ``jax.random``'s for the same seed; greedy ids
are the same function of the logits. :func:`process_logits` and
:func:`sample_logits_batched` take ROW-VARYING parameters: continuous
batching mixes requests with different ``GenConfig``s in one step.
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


def process_logits(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row temperature / top-k / top-p masking of ``logits [..., V]``
    f32. ``temperature``, ``top_k`` (int, 0 = off) and ``top_p`` (1.0 = off)
    have shape ``logits.shape[:-1]`` or broadcast to it."""
    v = logits.shape[-1]
    lead = logits.shape[:-1]
    proc = logits / temperature.clamp(min=1e-5)[..., None]

    sorted_desc = torch.sort(proc, dim=-1, descending=True).values
    # per-row top-k threshold: the value at index k-1; k = 0 -> the last (off)
    k = torch.where(top_k > 0, top_k.clamp(1, v), torch.full_like(top_k, v))
    k = k.to(torch.long).broadcast_to(lead)
    kth = torch.gather(sorted_desc, -1, (k - 1)[..., None])
    proc = torch.where(proc < kth, float("-inf"), proc)

    # per-row top-p on the logits already masked by top-k
    s2 = torch.sort(proc, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(s2, dim=-1), dim=-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                      cum[..., :-1] < top_p[..., None]], dim=-1)
    thresh = torch.where(keep, s2, torch.full_like(s2, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    return torch.where(proc < thresh, float("-inf"), proc)


def sample_logits_batched(logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor,
                          greedy: torch.Tensor,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One token per row of ``logits [B, V]`` with per-row parameters
    ``[B]`` -> ``[B]`` int64. Rows with ``greedy`` set or a temperature
    under 1e-5 take the argmax of the raw logits; the others draw from
    their masked distribution with ``generator``. The parameters may live
    on the host (the engine's copies): a step whose rows are all greedy is
    then decided without a device sync and runs the argmax only."""
    logits = logits.float()
    arg = torch.argmax(logits, dim=-1)
    take_arg = greedy | (temperature < 1e-5)
    if bool(take_arg.all()):
        return arg
    dev = logits.device
    proc = process_logits(logits, temperature.to(dev), top_k.to(dev), top_p.to(dev))
    sampled = torch.multinomial(torch.softmax(proc, dim=-1), 1,
                                generator=generator)[:, 0]
    return torch.where(take_arg.to(dev), arg, sampled)


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
