"""Token generation (PyTorch port of ``awq_tpu/runtime/generate.py``).

:func:`generate` prefills the prompt (timed as TTFT), then decodes. The
cache is written in place. Two decode loops, with the JAX ``decode_scan``'s
stop and repetition-penalty (``seen``) logic:

- :func:`decode_scan`, one :func:`~awq_tpu_torch.models.llama.forward`
  call a token with a host position (:func:`decode_steps` yields its steps
  one at a time): the CPU's engine, a caller that gives no loop, and the
  tensor-parallel loop (``tp_decode_scan``) on its model.
- :class:`DecodeLoop`, the counterpart of JAX's one executable a burst: a
  decode step whose position lives in device memory
  (:func:`~awq_tpu_torch.models.llama.decode_step`, then the sampling and
  the ``done``/``seen`` updates) on static buffers. On a card it captures
  that step into a CUDA graph once per :meth:`DecodeLoop.graph_key` (the
  graphs share one memory pool; at most :data:`MAX_GRAPHS` are kept) and
  replays it once a token; the host reads ``done`` every
  :data:`CHECK_EVERY` steps through a non-blocking copy. A sampled step
  draws from the loop's own generator, registered with its graphs, whose
  state comes from the burst's generator and goes back to it after the
  burst, so a burst draws the ids :func:`decode_scan` draws from the same
  state. On the CPU it runs the step eagerly.

The JAX ``generate`` ran each burst on a power-of-two prefix of the cache
(``cache_bucket``); the port's kernels read only the valid prefix, and the
bucket (:func:`plan_bound`) bounds a burst's positions: the stacked path's
attention kernels plan their grids for it and split by the length they
read, K4 sizes its workspace by it, so a replay gives the bits of the
``forward`` step at its position.

:class:`StreamGenerator` (JAX's, one decode step a token) yields the ids
every ``stream_interval`` tokens; it steps the engine's :class:`DecodeLoop`
where the rows are greedy and one is given, else :func:`decode_steps`.

With ``mesh`` (this rank's :class:`~awq_tpu_torch.parallel.mesh.TPGroup`;
``params`` and ``cache`` its shards) every rank of the group calls
:func:`generate` with the same prompt: the prefill runs through
``tp_forward`` and the decode through ``tp_decode_scan``
(``parallel/tp.py``), as the JAX package's ``mesh`` branch does; every
rank returns the same ids.
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch

from awq_tpu_torch.config import GenConfig, ModelConfig
from awq_tpu_torch.models.llama import cache_seq_len, decode_step, decode_step_on_k4, forward
from awq_tpu_torch.runtime.sampling import sample_logits

#: Decode steps between two reads of ``done`` in a graph-replayed burst.
CHECK_EVERY = 16
#: Stop ids a :class:`DecodeLoop` holds (its static buffer).
MAX_STOPS = 16
#: Captured steps a :class:`DecodeLoop` keeps; the least recently replayed
#: one goes first.
MAX_GRAPHS = 16


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_steps(step: Callable[[torch.Tensor, int], torch.Tensor], first: torch.Tensor,
                 start_pos: int, stop_ids: Sequence[int], seen: torch.Tensor, gen: GenConfig,
                 generator: Optional[torch.Generator] = None,
                 agree: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                 ) -> Iterator[torch.Tensor]:
    """The decode loop's steps (the JAX package's ``decode_scan`` body):
    each feeds the last ids at the next position, ``step(token [B], pos)``
    returning the next logits ``[B, V]``, and yields the ids ``[B]``
    sampled from them (``agree``, if given, makes the ranks of a group take
    one token); a row that stopped repeats its stop id. ``seen`` is updated
    in place. Once every row has stopped, the step that feeds the stop ids
    is the last: the iterator ends after it."""
    b = first.shape[0]
    dev = first.device
    rows = torch.arange(b, device=dev)
    stop = torch.tensor(list(stop_ids) or [-1], dtype=first.dtype, device=dev)
    token, pos = first, start_pos
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    while True:
        logits = step(token, pos)
        pos += 1
        if bool(done.all()):
            return
        nxt = sample_logits(logits, gen, seen, generator)
        if agree is not None:
            nxt = agree(nxt)
        nxt = torch.where(done, token, nxt)
        done = done | torch.isin(nxt, stop)
        seen[rows, nxt] = True
        yield nxt
        token = nxt


def decode_scan(step: Callable[[torch.Tensor, int], torch.Tensor], first: torch.Tensor,
                start_pos: int, stop_ids: Sequence[int], seen: torch.Tensor, gen: GenConfig,
                num_steps: int, generator: Optional[torch.Generator] = None,
                agree: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """The decode loop (the JAX package's ``decode_scan``): at most
    ``num_steps`` of :func:`decode_steps`. Returns the new ids ``[B,
    num_steps]``: once every row has stopped (its stop id fed) the loop
    ends early with the rest repeated, as the JAX scan's would."""
    steps = list(itertools.islice(
        decode_steps(step, first, start_pos, stop_ids, seen, gen, generator, agree), num_steps))
    if not steps:
        return first.new_zeros((first.shape[0], 0))
    steps += [steps[-1]] * (num_steps - len(steps))
    return torch.stack(steps, dim=1)


def cache_bucket(t_total: int, need: int, min_bucket: int = 256) -> int:
    """Smallest power-of-two cache prefix covering ``need`` positions, at
    least ``min_bucket`` and at most ``t_total`` (the JAX package's)."""
    if need >= t_total:
        return t_total
    return min(t_total, max(min_bucket, 1 << (need - 1).bit_length()))


def plan_bound(t_total: int, need: int) -> int:
    """The ``max_length`` of a burst that writes positions below ``need``:
    the last position of its :func:`cache_bucket`."""
    return cache_bucket(t_total, need) - 1


def _greedy(gen: GenConfig) -> bool:
    return gen.greedy or gen.temperature < 1e-5


class DecodeLoop:
    """The single-device decode loop over one cache: static buffers for the
    token, the position, ``done``, ``seen``, the stop ids and the ids
    written, and one decode step over them (:meth:`step`) that reads and
    advances them in place and reads nothing back to the host.

    On a CUDA cache the first step of a burst whose :meth:`graph_key` is new
    runs eagerly on a side stream (the warm-up: every kernel loads, sets its
    attributes and caches its plan), then the step is captured into a CUDA
    graph for that key and replayed for every later step and burst; the
    graphs share one memory pool, and the least recently replayed goes when
    a capture would keep more than :data:`MAX_GRAPHS`. A capture that fails
    raises. On the CPU every step runs eagerly.

    The kernel wrappers count their calls: the warm-up's, which launch,
    and the capture's, which record the launches into the graph. A replay
    calls no wrapper."""

    def __init__(self, params, cfg: ModelConfig, cache, rows: int = 1):
        from awq_tpu_torch.models.llama import cache_tensors

        self.params, self.cfg, self.cache = params, cfg, cache
        dev = cache_tensors(cache)[0].device
        self.device = dev
        self.graphed = dev.type == "cuda"
        t = cache_seq_len(cache)
        self.tok = torch.zeros((rows,), dtype=torch.long, device=dev)
        self.pos = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.done = torch.zeros((rows,), dtype=torch.bool, device=dev)
        self.all_done = torch.zeros((1,), dtype=torch.bool, device=dev)
        self.seen = torch.zeros((rows, cfg.vocab_size), dtype=torch.bool, device=dev)
        self.stop = torch.full((MAX_STOPS,), -1, dtype=torch.long, device=dev)
        self.out = torch.zeros((rows, t), dtype=torch.long, device=dev)
        self.idx = torch.zeros((1,), dtype=torch.long, device=dev)
        self.graphs: "OrderedDict[tuple, Any]" = OrderedDict()
        self.pool = None
        self.rng = None               # the sampled graphs' generator (a card's)
        self._src = None
        self.capture_s = 0.0          # seconds spent capturing (warm-up steps excluded)
        self.pool_bytes = 0           # device memory the captures reserved
        self._flags = None
        self._key = None

    # ---- one step --------------------------------------------------------

    def _body(self) -> None:
        logits = decode_step(self.params, self.cfg, self.tok, self.cache, self.pos,
                             self._max_length)
        nxt = sample_logits(logits, self._gen, self.seen, self._rng)
        nxt = torch.where(self.done, self.tok, nxt)
        self.done |= (nxt[:, None] == self.stop[None, :]).any(dim=1)   # isin syncs
        self.seen.scatter_(1, nxt[:, None], True)   # no host scalar copied in
        self.out.index_copy_(1, self.idx, nxt[:, None])
        self.tok.copy_(nxt)
        self.pos += 1
        self.idx += 1
        self.all_done.copy_(self.done.all()[None])

    def graph_key(self, gen: GenConfig, max_length: int) -> tuple:
        """What a captured step holds of a burst: its ``max_length``, the
        path (K4 or the stacked kernels) and what sampling reads of ``gen``:
        the repetition penalty, and for sampled rows the temperature, top-k
        and top-p."""
        key = (int(max_length), float(gen.repetition_penalty),
               decode_step_on_k4(self.params, self.cfg, self.cache, self.tok.shape[0]))
        if _greedy(gen):
            return key + ("greedy",)
        return key + ("sampled", float(gen.temperature), int(gen.top_k), float(gen.top_p))

    def begin(self, first: torch.Tensor, pos: int, stop_ids: Sequence[int],
              seen: torch.Tensor, gen: GenConfig, max_length: int,
              generator: Optional[torch.Generator] = None) -> None:
        """Load a burst: ``first [B]`` is fed at position ``pos``, the
        positions bounded by ``max_length``; ``seen`` is copied in. Sampled
        rows draw from ``generator`` (the device's default without one):
        on a card through the loop's own generator, which takes its state
        now and hands it back in :meth:`end`."""
        stop_ids = list(stop_ids)
        if len(stop_ids) > MAX_STOPS:
            raise ValueError(f"at most {MAX_STOPS} stop ids, got {len(stop_ids)}")
        self.tok.copy_(first)
        self.pos.fill_(int(pos))
        self.done.zero_()
        self.all_done.zero_()
        self.seen.copy_(seen)
        self.stop.fill_(-1)
        if stop_ids:
            self.stop[:len(stop_ids)] = torch.tensor(stop_ids, dtype=torch.long)
        self.idx.zero_()
        self._gen, self._max_length = gen, int(max_length)
        self._key = self.graph_key(gen, max_length)
        self._rng = None if _greedy(gen) else generator
        if self.graphed and not _greedy(gen):
            src = generator if generator is not None else \
                torch.cuda.default_generators[self.device.index or torch.cuda.current_device()]
            if self.rng is None:
                self.rng = torch.Generator(device=self.device)
            self.rng.set_state(src.get_state())
            self._rng, self._src = self.rng, src

    def end(self) -> None:
        """End the loaded burst: the generator it drew from takes the state
        the loop's generator reached."""
        if self._src is not None:
            self._src.set_state(self.rng.get_state())
            self._src = None

    def step(self) -> None:
        """One decode step of the loaded burst: on a card a replay of its
        graph (the first step of a new key runs eagerly, then the step is
        captured), on the CPU the step run eagerly."""
        if not self.graphed:
            self._body()
            return
        g = self.graphs.get(self._key)
        if g is not None:
            self.graphs.move_to_end(self._key)
            g.replay()
            return
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        torch.cuda.empty_cache()      # as the capture does: the rest is the graph's pool
        reserved = torch.cuda.memory_reserved(self.device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        if self._rng is not None:
            g.register_generator_state(self._rng)
        with torch.cuda.graph(g, pool=self.pool):
            self._body()          # recorded, not run: the buffers stay as they are
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0
        torch.cuda.empty_cache()
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        self.graphs[self._key] = g
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)

    # ---- bursts ----------------------------------------------------------

    def ids(self, n: int) -> torch.Tensor:
        """The ids of the burst's first ``n`` steps ``[B, n]`` (device)."""
        return self.out[:, :n]

    def finished(self) -> bool:
        """Whether every row has stopped (reads the device)."""
        return bool(self.all_done[0])

    def run(self, first: torch.Tensor, pos: int, stop_ids: Sequence[int], seen: torch.Tensor,
            gen: GenConfig, num_steps: int, max_length: int,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``num_steps`` steps from ``first`` at ``pos``: the new ids ``[B,
        num_steps]``, ``decode_scan``'s: a row that stopped repeats its stop
        id, and once every row has stopped and the stop ids are fed the
        rest repeat. ``seen`` is updated in place. A graphed burst reads
        ``done`` every :data:`CHECK_EVERY` steps, from a copy issued one
        check earlier, so the host waits on no step it has just queued; an
        eager one after every step, as ``decode_scan`` does."""
        self.begin(first, pos, stop_ids, seen, gen, max_length, generator)
        n = int(num_steps)
        i = 0
        if self.graphed:
            if self._flags is None:
                self._flags = torch.zeros((2,), dtype=torch.bool, pin_memory=True)
            events = [None, None]
            while i < n:
                self.step()
                i += 1
                if i % CHECK_EVERY == 0 and i < n:
                    k = (i // CHECK_EVERY) % 2
                    prev = events[1 - k]
                    self._flags[k].copy_(self.all_done[0], non_blocking=True)
                    events[k] = torch.cuda.Event()
                    events[k].record()
                    if prev is not None:
                        prev.synchronize()
                        if bool(self._flags[1 - k]):
                            break
        else:
            while i < n:
                stopped = i > 0 and self.finished()
                self.step()
                i += 1
                if stopped:
                    break
        if i < n:
            self.out[:, i:n] = self.tok[:, None]
        seen.copy_(self.seen)
        self.end()
        return self.ids(n)


class _ForwardSteps:
    """:func:`decode_steps` over one :func:`forward` call a token, with
    :class:`DecodeLoop`'s ``begin``/``step``/``ids``/``end``: how a stream
    steps where no loop is given. A step after the iterator has ended runs
    nothing and repeats the last ids."""

    def __init__(self, params, cfg: ModelConfig, cache):
        self.params, self.cfg, self.cache = params, cfg, cache

    def begin(self, first, pos, stop_ids, seen, gen, generator=None) -> None:
        fwd = lambda tok, p: forward(self.params, self.cfg, tok[:, None], self.cache, p)[0][:, -1]  # noqa: E731
        self._it = decode_steps(fwd, first, pos, stop_ids, seen, gen, generator)
        self._ids = [first]

    def step(self) -> None:
        self._ids.append(next(self._it, self._ids[-1]))

    def ids(self, n: int) -> torch.Tensor:
        return torch.stack(self._ids[1:n + 1], dim=1)

    def end(self) -> None:
        """Nothing to hand back: the steps drew from the caller's generator."""


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
    loop: Optional[DecodeLoop] = None,
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
    round).

    With ``loop`` (a :class:`DecodeLoop` over this cache) the decode runs
    through it, its positions bounded by the burst's :func:`plan_bound`;
    else one :func:`forward` call a token.
    ``timing["loop"]`` says which ran: ``graph`` (a card's replays),
    ``eager`` (the loop's device-position step on the CPU) or ``forward``."""
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
    which = "forward"
    if mesh is None and loop is not None:
        bound = plan_bound(cache_seq_len(cache), start_pos + s + gen.max_new_tokens)
        steps = loop.run(first, start_pos + s, stop_ids, seen, gen, n, bound, generator)
        which = "graph" if loop.graphed else "eager"
    elif mesh is None:
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
            "loop": which,
        },
    }


class StreamGenerator:
    """Interactive streaming generation (the JAX package's, one decode step
    a token): iterate to receive dicts with the ids (and, with a tokenizer,
    the text) so far, every ``stream_interval`` tokens; the last one is
    ``finished`` and carries ``timing``, ``new_start_pos`` and ``pending``.

    The decode steps are :func:`generate`'s: ``loop`` (a
    :class:`DecodeLoop` over ``cache``: on a card, replays of the engine's
    captured step), bounded by the round's :func:`plan_bound`, or where no
    loop is given :func:`decode_steps` over :func:`forward`. So a round
    streams the ids that :func:`generate` returns. The ids are read from the device once every
    ``stream_interval`` steps.

    Unlike JAX's, a stop id is fed (its KV written) before the round ends,
    and an id that was never fed (the round ran out of steps) comes back in
    ``pending``, ``new_start_pos`` at its position: the caller feeds it
    first in the next round, as ``InferenceEngine.generate`` does (JAX's
    ``new_start_pos`` moves past that id's slot, which it never wrote). The
    chunks' ids are JAX's: up to the stop id while streaming, without it at
    the end."""

    def __init__(self, params, cfg: ModelConfig, tokenizer, gen: GenConfig, cache,
                 stop_ids: Sequence[int] = (), stream_interval: int = 2, mesh=None,
                 loop: Optional[DecodeLoop] = None):
        if mesh is not None:
            raise NotImplementedError("streaming under tensor parallelism is ROADMAP "
                                      "queue A, item 17b")
        self.params, self.cfg, self.tok = params, cfg, tokenizer
        self.gen, self.cache = gen, cache
        self.stop_ids = list(stop_ids)
        self.stream_interval = max(int(stream_interval), 1)
        self.loop = loop

    def _chunk(self, ids: List[int], finished: bool) -> Dict[str, Any]:
        return {"text": self.tok.decode(ids) if self.tok else None, "ids": list(ids),
                "finished": finished}

    @torch.no_grad()
    def __call__(self, input_ids: Sequence[int], start_pos: int = 0,
                 generator: Optional[torch.Generator] = None) -> Iterator[Dict[str, Any]]:
        cfg, gen = self.cfg, self.gen
        dev = self.cache.device
        tokens = torch.tensor([list(input_ids)], dtype=torch.long, device=dev)
        b, s = tokens.shape
        seen = torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=dev)
        if gen.repetition_penalty != 1.0:
            seen[0, tokens[0]] = True

        _sync(dev)
        t0 = time.perf_counter()
        logits, self.cache = forward(self.params, cfg, tokens, self.cache, start_pos)
        first = sample_logits(logits[:, -1], gen, seen, generator)
        out_ids = [int(first[0])]
        ttft = time.perf_counter() - t0
        n = max(gen.max_new_tokens - 1, 0)
        fed = 0                                   # decode steps run: ids fed
        token_times: List[float] = []
        stopped = out_ids[0] in self.stop_ids
        which = "none"
        if n:
            seen[0, first] = True
            if self.loop is not None:
                loop = self.loop
                loop.begin(first, start_pos + s, self.stop_ids, seen, gen, plan_bound(
                    cache_seq_len(self.cache), start_pos + s + gen.max_new_tokens), generator)
                which = "graph" if loop.graphed else "eager"
            else:
                loop = _ForwardSteps(self.params, cfg, self.cache)
                loop.begin(first, start_pos + s, self.stop_ids, seen, gen, generator)
                which = "forward"
            if stopped:                           # feed the stop id
                loop.step()
                fed = 1
            t1 = time.perf_counter()
            while fed < n and not stopped:
                k = min(self.stream_interval, n - fed)
                for _ in range(k):
                    loop.step()
                fed += k
                new = loop.ids(fed)[0, fed - k:fed].tolist()     # waits for the steps
                t2 = time.perf_counter()
                token_times += [(t2 - t1) / k] * k
                t1 = t2
                for j, t in enumerate(new):
                    out_ids.append(t)
                    if (len(out_ids) - 1) % self.stream_interval == 0:
                        yield self._chunk(out_ids, False)
                    if t in self.stop_ids:
                        # JAX feeds nothing after a stop id; the port feeds
                        # it, one more step where none came after it yet
                        stopped = True
                        if j == k - 1 and fed < n:
                            loop.step()
                            fed += 1
                        break
            loop.end()
        # engine.generate's rule: an id that was never fed (the round used
        # all its steps) stays pending for the next round
        unfed = len(out_ids) == n + 1
        pending = [out_ids[-1]] if unfed else []
        ids = out_ids[:-1] if out_ids[-1] in self.stop_ids else out_ids
        done = self._chunk(ids, True)
        done.update({
            "new_start_pos": start_pos + s + len(out_ids) - len(pending),
            "pending": pending,
            "timing": {
                "ttft_s": ttft,
                "token_times_s": token_times,
                "ms_per_token": sum(token_times) / max(len(token_times), 1) * 1e3,
                "loop": which,
            },
        })
        yield done
