"""Speculative decoding with prompt-lookup (n-gram) drafting (PyTorch port of
``awq_tpu/runtime/speculative.py``).

Draft tokens are proposed by matching the trailing n-gram of the context
against its own earlier occurrences (no draft model), then the whole window
``[next, d1..dk]`` is verified by ONE forward of ``k + 1 <= 32`` tokens: at
batch 1 that is :func:`~awq_tpu_torch.models.llama.forward` with
``last_only=False``, which rides K5 (the chunk megakernel) on the card; in a
batch it is :func:`~awq_tpu_torch.models.llama.verify_step_batched`, the
window mode of K2 or K9 a layer. A verify step emits up to ``k + 1`` tokens.

Greedy speculative output is IDENTICAL to plain greedy decoding token for
token, whatever the drafts: draft ``d_j`` is kept only when it equals the
model's own argmax after the accepted prefix, and the first disagreement
contributes the argmax instead. Rolling the cache back costs nothing: it
masks by length, so rows written for rejected drafts are overwritten later.

Two loops. :func:`generate_speculative`, the single-stream greedy loop,
drafts on the host (numpy) and sends a window of ``k + 1`` where a draft is
found, else the one last token. :func:`spec_decode_device` is JAX's
device-side speculation, which runs inside one jitted ``while_loop`` with
one host fetch a generation: here it is a host loop with ONE device-to-host
read a verify step (the emitted ids and counts), the draft and the
acceptance tensor operations, a fixed ``k + 1`` window a step through
``verify_step_batched`` (``forward`` at one row), rejection sampling for
sampled rows. JAX has a single-stream sibling of that loop for ``b == 1``
greedy; it gives the batched loop's ids, windows, tail and stats at one
row, so the port keeps the one loop. Capturing a verify step as a CUDA graph is later work
(ROADMAP A11's tail).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from awq_tpu_torch.models.llama import cache_seq_len


def ngram_propose(ctx: np.ndarray, k: int, n: int = 3, max_scan: int = 2048) -> np.ndarray:
    """Draft up to ``k`` tokens: find the most recent earlier occurrence of
    the trailing ``n``-gram (falling back to shorter grams) and return the
    tokens that followed it. Empty when nothing matches."""
    L = len(ctx)
    lo = max(0, L - max_scan)
    for m in range(n, 0, -1):
        if L < m + 1:
            continue
        tail = ctx[L - m:]
        # scan right-to-left over earlier occurrences (skip the tail itself)
        hay = ctx[lo:L - 1]
        if len(hay) < m:
            continue
        win = np.lib.stride_tricks.sliding_window_view(hay, m)
        hits = np.nonzero((win == tail).all(axis=1))[0]
        if len(hits):
            start = lo + hits[-1] + m
            return np.asarray(ctx[start:start + k], np.int32)
    return np.zeros((0,), np.int32)


def _forward_fn(mesh):
    """``forward(params, cfg, tokens, cache, pos, last_only)``: the port's
    ``forward``, or through ``tp_forward`` on ``mesh`` (this rank's group)."""
    if mesh is None:
        from awq_tpu_torch.models.llama import forward

        return forward
    from awq_tpu_torch.parallel.tp import tp_forward

    def forward(params, cfg, toks, cache, pos, last_only=True):
        return tp_forward(params, cfg, toks, cache, pos, mesh, last_only=last_only)

    return forward


def generate_speculative(params, cfg, tokens: torch.Tensor, cache, max_new: int, k: int = 7,
                         n: int = 3, eos: Optional[int] = None, start_pos: int = 0,
                         mesh=None) -> Tuple[List[int], dict]:
    """Greedy generation with n-gram speculative verification, the host
    loop (``awq_tpu/runtime/speculative.py:56-146``).

    ``tokens [1, S0]`` is the (possibly incremental: ``start_pos``) prompt on
    the cache's device. Returns ``(new_tokens, stats)``, ``stats`` with
    ``steps``, ``drafted``, ``accepted``, ``length`` (the cache positions
    written: the prompt's and every fed id's, the drafts accepted after a
    stop id too) and the ``cache``. A window is ``k + 1``
    tokens, the drafts padded with zeros, or the one last token when no
    draft is found or the cache has no room for one: two shapes of
    ``forward``. ``mesh``: every forward goes through ``tp_forward`` (this
    rank's shards and cache; every rank of the group calls it)."""
    forward = _forward_fn(mesh)
    ctx = tokens[0].tolist()
    logits, cache = forward(params, cfg, tokens, cache, start_pos)
    nxt = int(torch.argmax(logits[0, -1]))
    length = start_pos + tokens.shape[1]
    out: List[int] = [nxt]
    max_t = cache_seq_len(cache)
    steps, drafted, accepted = 1, 0, 0
    dev = tokens.device

    while len(out) < max_new and (eos is None or out[-1] != eos):
        room = max_t - length - 2
        remaining = max_new - len(out)
        draft = np.zeros((0,), np.int32)
        if room >= k and remaining > 1:
            draft = ngram_propose(np.asarray(ctx + out, np.int32), k, n)
        true_k = len(draft)
        if true_k:
            # a fixed window of k + 1: the drafts padded (pad positions are
            # never accepted below)
            draft = np.concatenate([draft, np.zeros(k - true_k, np.int32)])
            window = np.concatenate([[out[-1]], draft]).astype(np.int64)
        else:
            window = np.asarray([out[-1]], np.int64)
        logits, cache = forward(params, cfg, torch.from_numpy(window[None]).to(dev), cache,
                                length, last_only=False)
        greedy = torch.argmax(logits[0], dim=-1).tolist()     # the step's one read
        # accept no more than the caller asked for
        m_max = min(true_k, remaining - 1)
        m = 0
        while m < m_max and draft[m] == greedy[m]:
            m += 1
        emit = [int(t) for t in draft[:m]] + [int(greedy[m])]
        steps += 1
        drafted += m_max
        accepted += m
        length += m + 1          # window[0..m] are written
        if eos is not None and eos in emit:
            emit = emit[:emit.index(eos) + 1]
        out.extend(emit)
        if length >= max_t - 1:
            break
    return out[:max_new], dict(steps=steps, drafted=drafted, accepted=accepted, length=length,
                               cache=cache)


def _device_draft(ctx: torch.Tensor, p: torch.Tensor, k: int, n: int):
    """Draft ``k`` tokens a row from the most recent earlier occurrence of
    the trailing m-gram (m = n..1, the first that matches), vectorized over
    the rows (``awq_tpu/runtime/speculative.py:153-184``). ``ctx [B, C]``
    int64, ``p [B]`` the valid lengths. Returns ``(draft [B, k], found
    [B])``; a row with no match carries whatever the clamped slice reads: the
    verify step accepts only tokens equal to the model's argmax (or drawn by
    rejection sampling), so junk drafts cost acceptance, never correctness.
    The slices clamp their starts as ``jax.lax.dynamic_slice`` does."""
    b, c = ctx.shape
    dev = ctx.device
    idx = torch.arange(c, device=dev)
    start = torch.zeros((b,), dtype=torch.long, device=dev)
    found = torch.zeros((b,), dtype=torch.bool, device=dev)
    for m in range(n, 0, -1):
        # tail = ctx[p - m : p], an n-long slice from max(p - m, 0) cut to m
        t0 = (p - m).clamp(min=0).clamp(max=c - n)
        tail = torch.gather(ctx, 1, t0[:, None] + torch.arange(n, device=dev))[:, :m]
        hit = torch.ones((b, c), dtype=torch.bool, device=dev)
        for j in range(m):
            hit &= torch.roll(ctx, -j, dims=1) == tail[:, j:j + 1]
        # the window ends strictly before the tail's last token
        ok = hit & (idx[None] + m <= (p - 1)[:, None]) & (p >= m + 1)[:, None]
        t_star = torch.where(ok, idx[None], torch.full_like(ok, -1, dtype=torch.long)).amax(1)
        this = t_star >= 0
        start = torch.where(found, start, torch.where(this, t_star + m, start))
        found = found | this
    at = start.clamp(0, c - k)
    draft = torch.gather(ctx, 1, at[:, None] + torch.arange(k, device=dev))
    return draft, found


def _spec_loop_batched(params, cfg, cache, ctx: np.ndarray, out: np.ndarray, s0: int,
                       lengths: np.ndarray, eos_id: int, gen_rows, max_new: int, k: int, n: int,
                       generator: torch.Generator):
    """The batched and sampled loop (``_spec_loop_device_batched``,
    ``awq_tpu/runtime/speculative.py:260-357``): B rows advance together, one
    :func:`~awq_tpu_torch.models.llama.verify_step_batched` a step (one
    ``forward`` over the window at ``B = 1``), each row
    accepted by :func:`~awq_tpu_torch.runtime.sampling.spec_accept_sample`
    (greedy rows by the argmax, sampled rows by rejection sampling). Once a
    live row has no room for a ``k + 1`` window, every row drops to batched
    single-token steps. The host holds the rows' buffers and counters; a
    step reads the emitted ids and counts once."""
    from awq_tpu_torch.models.llama import decode_step_batched, forward, verify_step_batched
    from awq_tpu_torch.runtime.sampling import sample_logits_batched, spec_accept_sample

    b = out.shape[0]
    w = k + 1
    max_t = cache_seq_len(cache)
    dev = cache.device
    temps, top_ks, top_ps, greedy = gen_rows
    js = np.arange(w)[None]
    rows = np.arange(b)
    n_ctx = np.full(b, s0 + 1, np.int64)
    n_out = np.ones(b, np.int64)
    done = (out[:, 0] == eos_id) & (eos_id >= 0)
    steps = 1
    drafted = np.zeros(b, np.int64)
    accepted = np.zeros(b, np.int64)
    while True:
        active = ~done & (n_out < max_new)
        room = lengths + w + 1 < max_t
        if not (active.any() and np.where(active, room, True).all()):
            break
        last = out[rows, np.maximum(n_out - 1, 0)]
        draft, found = _device_draft(torch.from_numpy(ctx).to(dev),
                                     torch.from_numpy(n_ctx).to(dev), k, n)
        windows = torch.cat([torch.from_numpy(last).to(dev)[:, None], draft], dim=1)
        if b == 1:
            # one row: the window through ``forward`` (K5 on the card), as
            # JAX's single-stream loop; verify_step_batched at one row is the
            # eager stacked path, ~10x slower on an H100 (PERF.md §5)
            logits, cache = forward(params, cfg, windows, cache, int(lengths[0]),
                                    last_only=False)
        else:
            logits, cache = verify_step_batched(params, cfg, windows, cache,
                                                torch.from_numpy(lengths).to(dev),
                                                max_length=int(lengths.max()))
        m_cap = np.where(active, np.clip(max_new - n_out - 1, 0, k), 0)
        emit, take = spec_accept_sample(logits, windows, torch.from_numpy(m_cap), temps, top_ks,
                                        top_ps, greedy, generator=generator)
        read = torch.cat([emit, take[:, None], found.long()[:, None]], dim=1).cpu().numpy()
        emit, take, found = read[:, :w], read[:, w], read[:, w + 1].astype(bool)
        take = np.where(active, take, 0)
        is_eos = (emit == eos_id) & (js < take[:, None]) & (eos_id >= 0)
        hit = is_eos.any(axis=1)
        take = np.where(hit, is_eos.argmax(axis=1) + 1, take)
        for i in range(b):
            out[i, n_out[i]:n_out[i] + w] = emit[i]
            ctx[i, n_ctx[i]:n_ctx[i] + w] = emit[i]
        m = np.maximum(take - 1, 0)
        n_ctx += take
        lengths = np.where(active, lengths + m + 1, lengths).astype(np.int32)
        n_out += take
        done |= hit
        steps += 1
        drafted += np.where(active & found, np.minimum(k, m_cap), 0)
        accepted += np.where(active, m, 0)
    # the tail: batched single-token steps for the rows still short of max_new
    while ((~done) & (n_out < max_new) & (lengths + 1 < max_t)).any():
        active = (~done) & (n_out < max_new) & (lengths + 1 < max_t)
        last = out[rows, np.maximum(n_out - 1, 0)]
        logits, cache = decode_step_batched(params, cfg, torch.from_numpy(last).to(dev), cache,
                                            torch.from_numpy(lengths).to(dev),
                                            max_length=int(lengths.max()))
        nxt = sample_logits_batched(logits, temps, top_ks, top_ps, greedy,
                                    generator=generator).cpu().numpy()
        out[rows, n_out] = nxt
        hit = active & (nxt == eos_id) & (eos_id >= 0)
        lengths = np.where(active, lengths + 1, lengths).astype(np.int32)
        n_out = np.where(active, n_out + 1, n_out)
        done |= hit
        steps += 1
    return np.minimum(n_out, max_new), cache, lengths, steps, drafted, accepted


def spec_decode_device(params, cfg, tokens: torch.Tensor, cache, max_new: int, k: int = 7,
                       n: int = 3, eos: Optional[int] = None, start_pos: int = 0, gen=None,
                       generator: Optional[torch.Generator] = None):
    """The counterpart of JAX's device-side speculation
    (``awq_tpu/runtime/speculative.py:360-437``): the same greedy-identity
    contract as :func:`generate_speculative`, a fixed ``k + 1`` window a
    step through ``verify_step_batched`` (the window mode of K2 or K9 on the
    card; at ``b == 1`` through ``forward``, K5), the tail of single-token
    steps and JAX's stats, as a host loop
    with one read a verify step. ``cache`` must leave room for ``k + 1``
    optimistic rows a window.

    ``tokens [b, s0]``: one prompt length for every row, a batched cache. A
    sampling ``gen`` (``GenConfig`` with ``temperature > 0``, every row)
    rides rejection-sampling acceptance, its draws from ``generator`` (one
    on the cache's device, seed 0, by default); greedy rows keep the argmax.
    Returns ``(new_tokens, stats)``: a list per row where ``b > 1``; stats
    ``steps``, ``accepted``, ``drafted``, ``length`` (an int at ``b == 1``)
    and the ``cache``."""
    from awq_tpu_torch.models.llama import forward
    from awq_tpu_torch.runtime.sampling import sample_logits

    b, s0 = tokens.shape
    dev = tokens.device
    sampled = gen is not None and not gen.greedy and gen.temperature >= 1e-5
    c = s0 + max_new + k + 1
    eos_id = -1 if eos is None else int(eos)
    logits, cache = forward(params, cfg, tokens, cache, start_pos)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if sampled:
        gen_rows = (torch.full((b,), gen.temperature), torch.full((b,), gen.top_k),
                    torch.full((b,), gen.top_p), torch.zeros((b,), dtype=torch.bool))
        first = sample_logits(logits[:, -1], gen, generator=generator)
    else:
        gen_rows = (torch.ones((b,)), torch.zeros((b,), dtype=torch.long), torch.ones((b,)),
                    torch.ones((b,), dtype=torch.bool))
        first = torch.argmax(logits[:, -1], dim=-1)
    first = first.cpu().numpy()
    ctx = np.zeros((b, c), np.int64)
    ctx[:, :s0] = tokens.cpu().numpy()
    ctx[:, s0] = first
    out = np.zeros((b, max_new + k + 1), np.int64)
    out[:, 0] = first
    lengths = np.full(b, start_pos + s0, np.int32)
    n_out, cache, lengths, steps, drafted, accepted = _spec_loop_batched(
        params, cfg, cache, ctx, out, s0, lengths, eos_id, gen_rows, max_new, k, n, generator)
    toks = [[int(t) for t in out[i, :int(n_out[i])]] for i in range(b)]
    stats = dict(steps=steps, accepted=int(accepted.sum()), drafted=int(drafted.sum()),
                 length=int(lengths[0]) if b == 1 else lengths, cache=cache)
    return (toks[0] if b == 1 else toks), stats
