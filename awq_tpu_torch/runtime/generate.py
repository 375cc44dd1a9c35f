"""Token generation (PyTorch port of ``awq_tpu/runtime/generate.py``).

:func:`generate` prefills the prompt (timed as TTFT), then decodes one
token per :func:`~awq_tpu_torch.models.llama.forward` call in a Python
loop, the counterpart of the JAX package's ``decode_scan``, with its stop
and repetition-penalty (``seen``) logic. The cache is written in place.

The JAX ``generate`` ran each burst on a power-of-two prefix of the cache
(``cache_bucket``) and copied it back afterwards; the port's kernels read
only the valid prefix, so there is no bucket and no copy.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import torch

from awq_tpu_torch.config import GenConfig, ModelConfig
from awq_tpu_torch.models.llama import forward
from awq_tpu_torch.runtime.sampling import sample_logits


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,          # [B, S] prompt ids on the cache's device
    cache: torch.Tensor,
    gen: GenConfig,
    stop_ids: Sequence[int] = (),
    start_pos: int = 0,
    generator: Optional[torch.Generator] = None,
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
    logits, cache = forward(params, cfg, tokens, cache, start_pos)
    seen = torch.zeros((b, vocab), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    if gen.repetition_penalty != 1.0:
        seen[rows[:, None], tokens] = True
    first = sample_logits(logits[:, -1], gen, seen, generator)
    _sync(dev)
    ttft = time.perf_counter() - t0

    n = max(gen.max_new_tokens - 1, 0)
    stop = torch.tensor(list(stop_ids) or [-1], dtype=first.dtype, device=dev)
    seen[rows, first] = True
    t1 = time.perf_counter()
    token, pos = first, start_pos + s
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    steps = []
    for step in range(n):
        logits, cache = forward(params, cfg, token[:, None], cache, pos)
        pos += 1
        if bool(done.all()):
            steps.extend([token] * (n - step))
            break
        nxt = sample_logits(logits[:, -1], gen, seen, generator)
        nxt = torch.where(done, token, nxt)
        done = done | torch.isin(nxt, stop)
        seen[rows, nxt] = True
        steps.append(nxt)
        token = nxt
    _sync(dev)
    decode_time = time.perf_counter() - t1

    toks = torch.stack([first] + steps, dim=1)
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
