"""Token generation (PyTorch port of ``awq_tpu/runtime/generate.py``).

:func:`generate` prefills the prompt (timed as TTFT), then decodes one
token per :func:`~awq_tpu_torch.models.llama.forward` call in a Python
loop, the counterpart of the JAX package's ``decode_scan``, with its stop
and repetition-penalty (``seen``) logic. The cache is written in place.

The JAX ``generate`` ran each burst on a power-of-two prefix of the cache
(``cache_bucket``) and copied it back afterwards; the port's kernels read
only the valid prefix, so there is no bucket and no copy.

With ``mesh`` (this rank's :class:`~awq_tpu_torch.parallel.mesh.TPGroup`;
``params`` and ``cache`` its shards) every rank of the group calls
:func:`generate` with the same prompt: the prefill runs through
``tp_forward`` and the decode through ``tp_decode_scan``
(``parallel/tp.py``), as the JAX package's ``mesh`` branch does; every
rank returns the same ids.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from awq_tpu_torch.config import GenConfig, ModelConfig
from awq_tpu_torch.models.llama import forward
from awq_tpu_torch.runtime.sampling import sample_logits


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_scan(step: Callable[[torch.Tensor, int], torch.Tensor], first: torch.Tensor,
                start_pos: int, stop_ids: Sequence[int], seen: torch.Tensor, gen: GenConfig,
                num_steps: int, generator: Optional[torch.Generator] = None,
                agree: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """The decode loop (the JAX package's ``decode_scan``): ``num_steps``
    times, ``step(token [B], pos)`` feeds the last ids at ``pos`` and returns
    the next logits ``[B, V]``, from which a token is sampled (``agree``, if
    given, makes the ranks of a group take one token). ``seen`` is updated
    in place. Returns the new ids ``[B, num_steps]``: a row that stopped
    repeats its stop id, and once every row has stopped (its stop id fed)
    the loop ends early with the rest repeated, as the JAX scan's would."""
    b = first.shape[0]
    dev = first.device
    rows = torch.arange(b, device=dev)
    stop = torch.tensor(list(stop_ids) or [-1], dtype=first.dtype, device=dev)
    token, pos = first, start_pos
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    steps = []
    for i in range(num_steps):
        logits = step(token, pos)
        pos += 1
        if bool(done.all()):
            steps.extend([token] * (num_steps - i))
            break
        nxt = sample_logits(logits, gen, seen, generator)
        if agree is not None:
            nxt = agree(nxt)
        nxt = torch.where(done, token, nxt)
        done = done | torch.isin(nxt, stop)
        seen[rows, nxt] = True
        steps.append(nxt)
        token = nxt
    if not steps:
        return first.new_zeros((b, 0))
    return torch.stack(steps, dim=1)


def generate(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,          # [B, S] prompt ids on the cache's device
    cache: torch.Tensor,
    gen: GenConfig,
    stop_ids: Sequence[int] = (),
    start_pos: int = 0,
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> Dict[str, Any]:
    """Prefill + decode loop. Returns a dict with ``output_ids [B, N]``
    (N = ``gen.max_new_tokens``), ``n_valid [B]`` (tokens up to and
    including the first stop), the cache and a timing dict.

    The positions written follow the JAX ``generate`` exactly. A row that
    has stopped keeps feeding its stop token, so the stop token's KV is
    written; once every row has stopped and that position is written, the
    loop ends and the remaining ids repeat the stop token, as the JAX
    scan's would. The id at the last index ``N - 1`` is never fed, so its
    KV slot is not written: a caller that continues the sequence feeds it
    first (``InferenceEngine.generate`` keeps it pending for the next
    round)."""
    dev = cache.device
    b, s = tokens.shape
    vocab = cfg.vocab_size

    _sync(dev)
    t0 = time.perf_counter()
    agree = None
    if mesh is None:
        logits, cache = forward(params, cfg, tokens, cache, start_pos)
    else:
        from awq_tpu_torch.parallel.tp import agree_fn, tp_forward

        logits, cache = tp_forward(params, cfg, tokens, cache, start_pos, mesh)
        agree = agree_fn(gen, mesh)
    seen = torch.zeros((b, vocab), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    if gen.repetition_penalty != 1.0:
        seen[rows[:, None], tokens] = True
    first = sample_logits(logits[:, -1], gen, seen, generator)
    if agree is not None:
        first = agree(first)
    _sync(dev)
    ttft = time.perf_counter() - t0

    n = max(gen.max_new_tokens - 1, 0)
    seen[rows, first] = True
    t1 = time.perf_counter()
    if mesh is None:
        steps = decode_scan(
            lambda tok, pos: forward(params, cfg, tok[:, None], cache, pos)[0][:, -1],
            first, start_pos + s, stop_ids, seen, gen, n, generator)
    else:
        from awq_tpu_torch.parallel.tp import tp_decode_scan

        steps, cache = tp_decode_scan(params, cfg, cache, first, start_pos + s, stop_ids,
                                      seen, gen, n, mesh, generator)
    _sync(dev)
    decode_time = time.perf_counter() - t1

    stop = torch.tensor(list(stop_ids) or [-1], dtype=first.dtype, device=dev)
    toks = torch.cat([first[:, None], steps], dim=1)
    dones = torch.isin(toks, stop)
    n_valid = torch.where(dones.any(dim=1), dones.int().argmax(dim=1) + 1,
                          torch.full((b,), toks.shape[1], device=dev))
    return {
        "output_ids": toks,
        "n_valid": n_valid,
        "cache": cache,
        "timing": {
            "ttft_s": ttft,
            "decode_s": decode_time,
            "new_tokens": int(n_valid.sum()),
            "ms_per_token": (decode_time / max(n, 1)) * 1e3,
        },
    }
