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


def spec_accept_sample(logits: torch.Tensor, windows: torch.Tensor, m_cap: torch.Tensor,
                       temperature: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                       greedy: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> tuple:
    """Speculative window acceptance of a verify step, greedy and sampled
    rows (``awq_tpu/runtime/sampling.py:109-178``). ``logits [B, W, V]``,
    ``windows [B, W]`` (``windows[:, 1:]`` the drafts), ``m_cap [B]`` (at
    most that many drafts accepted: ``min(draft_len, budget - 1)``) and the
    per-row parameters ``[B]``. Returns ``(emit [B, W], take [B])`` int64 on
    the logits' device: row ``b`` emits ``emit[b, :take[b]]``, its accepted
    draft prefix and one bonus token.

    Greedy rows (``greedy`` or a temperature under 1e-5) keep the longest
    draft prefix equal to the argmax of the raw logits and take the argmax
    at the first disagreement: the ids of plain greedy decoding. Sampled
    rows run rejection sampling against the point-mass drafter: draft ``d``
    at position ``j`` is accepted with probability ``p_j(d)`` of the
    processed distribution (:func:`process_logits`), and the first
    rejection draws from ``p_j`` with ``d`` masked out; a stop forced by the
    drafts or the budget draws from ``p_m`` whole. A residual with no mass
    left (``top_k=1`` masked the draft) takes the argmax. The uniforms and
    the bonus draw come from ``generator``; they are not ``jax.random``'s,
    so sampled rows agree with JAX's in distribution, greedy rows bit for
    bit. ``emit`` past ``take`` holds the drafts (0 in the last column), as
    JAX's does. The parameters may live on the host: a step whose rows are
    all greedy then runs the argmax only, with no device sync."""
    b, w, v = logits.shape
    k = w - 1
    dev = logits.device
    lf = logits.float()
    windows = windows.to(dev).long()
    m_cap = m_cap.to(dev).long()
    drafts = windows[:, 1:]
    argm = torch.argmax(lf, dim=-1)                                   # [B, W]
    take_arg = greedy | (temperature < 1e-5)
    all_greedy = bool(take_arg.all())
    cols = torch.arange(k, device=dev)[None]
    if all_greedy:
        ok = drafts == argm[:, :k]
    else:
        proc = process_logits(lf, temperature.to(dev)[:, None], top_k.to(dev)[:, None],
                              top_p.to(dev)[:, None])                 # [B, W, V]
        p = torch.softmax(proc, dim=-1)
        pd = torch.gather(p[:, :k], -1, drafts[..., None])[..., 0]    # [B, k]
        u = torch.rand((b, k), generator=generator, device=dev)
        g_rows = take_arg.to(dev)[:, None]
        ok = torch.where(g_rows, drafts == argm[:, :k], u < pd)
    ok = ok & (cols < m_cap[:, None])
    m = torch.cumprod(ok.long(), dim=-1).sum(dim=-1)                  # [B]
    bonus = torch.gather(argm, 1, m[:, None])[:, 0]
    if not all_greedy:
        # a true rejection (m < m_cap) masks the rejected draft out of the
        # residual; a forced stop draws from the whole distribution
        proc_m = torch.gather(proc, 1, m[:, None, None].expand(b, 1, v))[:, 0]   # [B, V]
        d_next = torch.gather(windows, 1, (m + 1).clamp(max=k)[:, None])[:, 0]
        mask = (m < m_cap)[:, None] & (torch.arange(v, device=dev)[None] == d_next[:, None])
        proc_m = proc_m.masked_fill(mask, float("-inf"))
        empty = torch.isneginf(proc_m).all(dim=-1)
        probs = torch.softmax(proc_m.masked_fill(empty[:, None], 0.0), dim=-1)
        drawn = torch.multinomial(probs, 1, generator=generator)[:, 0]
        bonus = torch.where(take_arg.to(dev) | empty, bonus, drawn)
    emit = torch.cat([drafts, torch.zeros((b, 1), dtype=torch.long, device=dev)], dim=1)
    emit = torch.where(torch.arange(w, device=dev)[None] == m[:, None], bonus[:, None], emit)
    return emit, m + 1


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
