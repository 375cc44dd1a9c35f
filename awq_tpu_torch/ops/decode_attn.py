"""Flash attention over the static KV cache (PyTorch port of
``awq_tpu/ops/decode_attn.py``).

Both functions take ONE layer of the stacked cache, the free view
``cache[l] = [2, B, n_kv, T, hd]`` (K at index 0, V at 1), and read only
its valid prefix.

- :func:`flash_decode` wraps kernel K2 (``csrc/decode_attn.cu``), which
  replaces ``flash_decode_stacked``: one query position per row, GQA,
  softmax over the cache prefix ``[0, len_b)`` plus the current token's
  k/v given as operands (not yet in the cache).
- :func:`flash_decode_paged` wraps kernel K8, which replaces
  ``flash_decode_paged``: K2's attention over ONE layer of a page pool
  ``[L, 2, NP, n_kv, page, hd]``, row ``b``'s position ``p`` at page
  ``tables[b, p // page]``, offset ``p % page``. K8 is K2's body with a
  paged address functor (``csrc/decode_attn.cu``); its slices are whole
  pages.
- :func:`flash_decode_int8` wraps kernel K9, which replaces
  ``flash_decode_stacked8``: K2's attention over ONE layer of an int8 KV
  cache, codes ``[2, B, n_kv, T, hd]`` int8 and scales ``[2, B, n_kv, T]``
  f32 (a ``KVCache8``'s ``data[l]`` and ``scales[l]``), with the current
  token's k/v in full precision. Nothing is dequantized elementwise: K's
  scale multiplies a position's score after ``q·k_int8``, V's scale folds
  into its softmax weight before ``p·v_int8``. K9 is K2's body with an
  int8 address functor.
- :func:`flash_prefill` wraps kernel K3, which replaces
  ``flash_prefill_stacked`` with its online softmax: the chunk at
  ``[start_pos, start_pos + S)`` is already in the cache and query row
  ``r`` attends positions ``j <= start_pos + r``. head_dim 64 or 128, any
  number of query heads per kv head. Over a bf16 or f16 cache a block
  takes 128 packed (position, head-in-group) rows of one kv head, so each
  K/V tile it loads serves the whole group; :func:`prefill_plan` is the
  host plan of those tiles and of their heavy-first order, which the
  kernel follows.
- :func:`flash_decode_layer` wraps kernel K14, which replaces JAX's
  ``flash_decode`` (``_flash_decode_kernel``; the port's
  :func:`flash_decode` is K2): one query position per row over positions
  ``[0, length)`` of one layer's ``k_cache``/``v_cache [B, n_kv, T, hd]``,
  one length for every row, the current token already written. head_dim
  64 or 128 and up to 128 query heads per kv head (falcon-7b: 71 over one
  kv head at head_dim 64). ``layers.attention`` calls it at S = 1.
- :func:`flash_verify` and :func:`flash_verify_int8` are the window mode of
  K2 and K9, the attention of ``models/llama.py::verify_step_batched`` (XLA
  in the JAX package, no TPU kernel): W <= 32 queries a row over the row's
  prefix and its causal window, the window's k/v as operands, appended by
  the same launch (the section at the end of this module).

K2, K8 and K9 also APPEND the current token to the layer's cache, in
place, after their attention has read it: row ``b``'s k/v at position
``min(max(len_b, 0), T - 1)`` in the cache's dtype (K8: at page
``tables[b, p // page]``, offset ``p % page``, ``p`` clamped to ``MP * page -
1``; K9: :func:`~awq_tpu_torch.ops.cache_append.quantize_kv`'s codes and
scale). It is the write JAX makes after its layer scan
(``awq_tpu/models/llama.py:1156``, ``:1313-1332``) and the port's K7
(``ops/cache_append.py``) made in a launch of its own over every layer,
fused into the attention's launch by cluster rank 0 of each (row, kv head)
after the cluster's last barrier, so the attention never sees it. The CPU
path keeps JAX's order: the plain attention, then the plain append
(``*_append_plain``). The wrappers count each append under K7's names
(``cache_append.LAUNCHES``: ``cache_append``, ``cache_append_paged``,
``cache_append_int8``). ``append_to`` (of these wrappers and of the window
mode's) is a seam for the checks alone: no caller on the serving path passes
it. It sends the write to another tensor of the cache's layout, so that the
card tests (``tests/test_torch_fused_append.py``, ``test_torch_verify.py``)
and ``chip_smoke.py`` can hold the output of a launch that appended in
place, bit for bit, against one whose attention read a cache that nothing
wrote: the proof that the attention never sees its own write.

K2, K8, K9 and K14 are one split-and-merge body, one launch a call: the
positions of each (row, kv head) are cut into slices whose blocks form a
thread-block cluster and merge their online-softmax states through
distributed shared memory, streaming K/V through a ring of asynchronous
copies; the kv head's query group forms the rows of ``mma.sync`` products
(q·scale split into two halves of the mma type, P rounded to the cache's
dtype for P·V, as the TPU kernels round it, to f16 over K9's codes; an f32
cache on CUDA cores).
:func:`decode_plan` is their host plan (cluster size, positions a block,
ring stages, shared memory), which the C entries check and never adjust.

Each has a plain PyTorch version beside it (``*_plain``): the CPU path,
and the reference the kernels are held to on the card. On a CUDA tensor
the wrappers launch the kernel or raise. The kernels take f32, bf16 and
f16 for q (the output's dtype), the current token's k/v and the cache,
each of its own dtype, as the JAX kernels follow ``q.dtype``. Every
decode kernel takes head_dim 64 (the TPU kernels' paired mode: Falcon-7B,
BLOOM) or 128 and up to 128 query heads per kv head (Falcon-7B's 71 over
one); another head_dim or a wider group raises ``NotImplementedError``
naming ROADMAP A12.

ALiBi (MPT, BLOOM): every kernel takes ``slopes``, f32 ``[nq]`` on q's
device (``models/layers.py::alibi_slopes``), and adds the bias to each f32
score before the running max, in JAX's forms: ``slope * j`` over key
positions ``j`` in decode (the current token of K2, K8 and K9 at ``j =
len_b``; K9's after K's scale), the row-relative ``slope * (j - i)`` in
prefill (query position ``i``), which keeps the scores bounded at long
prompts. With slopes the wrappers launch the unit ``decode_attn_alibi``
(the bias compiled in; at most 32 query heads per kv head, the ALiBi
families being MHA). Without them K2, K8 and K9 at head_dim 128 and up to
32 query heads per kv head launch ``decode_attn``, the kernels as before,
and their other shapes the unit ``decode_attn_wide``; K3 and K14 launch
``decode_attn``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Union

import torch

from awq_tpu_torch.ops import cache_append
from awq_tpu_torch.ops.cache_append import (
    batched_cache_append_int8_plain,
    batched_cache_append_plain,
)

#: Launches of K2, K8, K9, K3 and K14, counted where the wrappers launch them;
#: with ALiBi slopes they count under ``<name>_alibi``, and K2, K8 and K9 at
#: head_dim 64 or a group wider than 32 (the unit ``decode_attn_wide``) under
#: ``<name>_wide``. The appends of K2, K8 and K9 count in
#: ``cache_append.LAUNCHES``. The window modes of K2 and K9 (the unit
#: ``decode_attn_verify``) count under ``flash_verify`` and
#: ``flash_verify_int8``; the window's append is part of that launch and
#: counts nowhere else.
LAUNCHES = {"flash_decode": 0, "flash_decode_paged": 0, "flash_decode_int8": 0,
            "flash_prefill": 0, "flash_decode_layer": 0, "flash_decode_alibi": 0,
            "flash_prefill_alibi": 0, "flash_decode_layer_alibi": 0,
            "flash_decode_paged_alibi": 0, "flash_decode_int8_alibi": 0,
            "flash_decode_wide": 0, "flash_decode_paged_wide": 0, "flash_decode_int8_wide": 0,
            "flash_verify": 0, "flash_verify_int8": 0}

HEAD_DIM = 128            # the head_dim of the unit decode_attn's K2, K8 and K9
HEAD_DIMS = (64, 128)     # the head_dims every decode and prefill kernel takes
LAYER_MAX_GROUP = 128     # the most query heads per kv head of K2, K8, K9 and K14
NARROW_GROUP = 32         # the most of decode_attn's K2, K8, K9 and of any ALiBi mode
DECODE_TILE = 64          # positions of a ring stage (csrc dec::TILE)
# K2's and K8's slices are whole 256-position units (the paged engine's
# page), so that K8 over pages dividing 256 slices rows as K2 does and
# returns K2's output bit for bit
K2_UNIT = 256
#: each wrapper's slice unit (the ``unit`` of its :func:`decode_plan`)
PLAN_UNIT = {"flash_decode": K2_UNIT, "flash_decode_paged": K2_UNIT,
             "flash_decode_int8": DECODE_TILE, "flash_decode_layer": DECODE_TILE}
MAX_CLUSTER = 16          # blocks of a cluster (csrc dec::MAX_CLUSTER)
SMEM_MAX = 232448         # shared memory a block may have (227 KB)
SMEM_SM = 233472          # shared memory of an SM (228 KB), 1 KB of it reserved a block
H100_SMS = 132
_LOG2E = 1.4426950408889634
PREFILL_ROWS = 128        # K3: packed query rows of a block (csrc k3::BQ)
PREFILL_KV_TILE = {128: 64, 64: 128}   # K3: positions of a K/V tile by head_dim
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
VERIFY_ROWS = 64          # the window mode: packed query rows of a block (csrc ver::ROWS)
VERIFY_MAX_W = 32         # the longest window it takes (csrc ver::MAX_W)


def flash_decode_plain(q: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, cache: torch.Tensor,
                       lengths: torch.Tensor,
                       max_length: Optional[int] = None,
                       slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K2, in f32: ``[B, nq, hd]`` in ``q.dtype``. With
    ALiBi ``slopes [nq]``, score ``j`` gains ``slope * j`` (the current
    token's ``slope * len_b``), as JAX's ``flash_decode_stacked`` adds it."""
    b, nq, hd = q.shape
    nkv = cache.shape[2]
    g = nq // nkv
    t = cache.shape[3] if max_length is None else max_length
    qf = q.float().reshape(b, nkv, g, hd) * (1.0 / math.sqrt(hd))
    kf = cache[0, :, :, :t].float()
    vf = cache[1, :, :, :t].float()
    s = torch.einsum("bkgh,bkth->bkgt", qf, kf)
    s_cur = torch.einsum("bkgh,bkh->bkg", qf, k_new.float())[..., None]
    if slopes is not None:
        sl = slopes.float().to(q.device).reshape(1, nkv, g, 1)
        s = s + sl * torch.arange(t, dtype=torch.float32, device=q.device)
        s_cur = s_cur + sl * lengths.to(q.device).float().reshape(b, 1, 1, 1)
    live = torch.arange(t, device=q.device)[None, :] < lengths[:, None].to(q.device)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.softmax(torch.cat([s, s_cur], dim=-1), dim=-1)
    out = (torch.einsum("bkgt,bkth->bkgh", p[..., :t], vf)
           + p[..., t:] * v_new.float()[:, :, None, :])
    return out.reshape(b, nq, hd).to(q.dtype)


def flash_decode_int8_plain(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, cache: torch.Tensor,
                            scales: torch.Tensor, lengths: torch.Tensor,
                            max_length: Optional[int] = None,
                            slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K9, in f32, in the TPU kernel's order: scores
    ``(q·scale)·k_int8`` times K's scale, softmax weights times V's scale
    before ``p·v_int8``. ``[B, nq, hd]`` in ``q.dtype``. With ALiBi
    ``slopes [nq]``, score ``j`` gains ``slope * j`` after K's scale (the
    current token's ``slope * len_b``), as JAX's XLA attention over the
    dequantized cache adds it (``decode_step_batched``'s ``xla_attn``)."""
    b, nq, hd = q.shape
    nkv = cache.shape[2]
    g = nq // nkv
    t = cache.shape[3] if max_length is None else max_length
    qf = q.float().reshape(b, nkv, g, hd) * (1.0 / math.sqrt(hd))
    s = (torch.einsum("bkgh,bkth->bkgt", qf, cache[0, :, :, :t].float())
         * scales[0, :, :, None, :t])
    s_cur = torch.einsum("bkgh,bkh->bkg", qf, k_new.to(q.dtype).float())[..., None]
    if slopes is not None:
        sl = slopes.float().to(q.device).reshape(1, nkv, g, 1)
        s = s + sl * torch.arange(t, dtype=torch.float32, device=q.device)
        s_cur = s_cur + sl * lengths.to(q.device).float().reshape(b, 1, 1, 1)
    live = torch.arange(t, device=q.device)[None, :] < lengths[:, None].to(q.device)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.softmax(torch.cat([s, s_cur], dim=-1), dim=-1)
    out = (torch.einsum("bkgt,bkth->bkgh", p[..., :t] * scales[1, :, :, None, :t],
                        cache[1, :, :, :t].float())
           + p[..., t:] * v_new.to(q.dtype).float()[:, :, None, :])
    return out.reshape(b, nq, hd).to(q.dtype)


def gather_pages(pool: torch.Tensor, tables: torch.Tensor, layer: int,
                 n_pages: int) -> torch.Tensor:
    """The first ``n_pages`` pages of each row's table, gathered from layer
    ``layer`` of the pool into a contiguous ``[2, B, n_kv, n_pages*page, hd]``."""
    _, _, _, nkv, page, hd = pool.shape
    b = tables.shape[0]
    idx = tables[:, :n_pages].to(pool.device).long()
    g = pool[layer][:, idx]                          # [2, B, n, n_kv, page, hd]
    return g.permute(0, 1, 3, 2, 4, 5).reshape(2, b, nkv, n_pages * page, hd)


def flash_decode_paged_plain(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, pool: torch.Tensor,
                             tables: torch.Tensor, layer: int,
                             lengths: torch.Tensor,
                             max_length: Optional[int] = None,
                             slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K8: gather each row's pages into a contiguous view
    and run :func:`flash_decode_plain` over it (ALiBi ``slopes`` as there).
    The current token's k/v are rounded to the pool dtype first, as JAX's
    wrapper does. Lengths are clamped to ``[0, MP * page]``, as the kernel
    clamps them."""
    page, mp = pool.shape[4], tables.shape[1]
    lengths = lengths.to(q.device).clamp(0, mp * page)
    t = int(lengths.max()) if max_length is None else min(int(max_length), mp * page)
    n_pages = -(-t // page)
    cache = gather_pages(pool, tables, int(layer), n_pages)
    return flash_decode_plain(q, k_new.to(pool.dtype), v_new.to(pool.dtype), cache,
                              lengths, max_length=t, slopes=slopes)


def _append_plain(cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor, tables: Optional[torch.Tensor] = None) -> None:
    """K7's plain version over ONE layer ``cache [2, B, n_kv, T, hd]`` (or a
    pool layer ``[2, NP, n_kv, page, hd]`` with ``tables``): the current
    token ``k``, ``v [B, n_kv, hd]`` at each row's clamped position, in the
    cache's dtype, in place."""
    batched_cache_append_plain(cache[None], torch.stack([k, v])[None], lengths, tables)


def flash_decode_append_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                              cache: torch.Tensor, lengths: torch.Tensor,
                              max_length: Optional[int] = None,
                              slopes: Optional[torch.Tensor] = None, by_length: bool = False,
                              append_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`flash_decode` in JAX's order: K2's plain
    attention, then K7's plain append of the current token into ``cache``
    (or ``append_to``). ``by_length`` changes nothing here."""
    out = flash_decode_plain(q, k_new, v_new, cache, lengths, max_length, slopes)
    _append_plain(cache if append_to is None else append_to, k_new, v_new, lengths)
    return out


def flash_decode_int8_append_plain(q: torch.Tensor, k_new: torch.Tensor,
                                   v_new: torch.Tensor, cache: torch.Tensor,
                                   scales: torch.Tensor, lengths: torch.Tensor,
                                   max_length: Optional[int] = None,
                                   slopes: Optional[torch.Tensor] = None,
                                   by_length: bool = False,
                                   k_app: Optional[torch.Tensor] = None,
                                   v_app: Optional[torch.Tensor] = None,
                                   append_to=None) -> torch.Tensor:
    """Plain version of :func:`flash_decode_int8` in JAX's order: K9's plain
    attention, then K7's plain int8 append (``quantize_kv``) of ``k_app``,
    ``v_app`` (by default ``k_new``, ``v_new``) into ``(cache, scales)`` (or
    ``append_to``, a pair of the same layouts)."""
    out = flash_decode_int8_plain(q, k_new, v_new, cache, scales, lengths, max_length, slopes)
    codes, scl = (cache, scales) if append_to is None else append_to
    kv = torch.stack([k_new if k_app is None else k_app, v_new if v_app is None else v_app])
    batched_cache_append_int8_plain(codes[None], scl[None], kv[None], lengths)
    return out


def flash_decode_paged_append_plain(q: torch.Tensor, k_new: torch.Tensor,
                                    v_new: torch.Tensor, pool: torch.Tensor,
                                    tables: torch.Tensor, layer: int, lengths: torch.Tensor,
                                    max_length: Optional[int] = None,
                                    slopes: Optional[torch.Tensor] = None,
                                    append_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`flash_decode_paged` in JAX's order: K8's
    plain attention, then K7's plain paged append of the current token
    (rounded to the pool's dtype) into layer ``layer`` of ``pool`` (or of
    ``append_to``)."""
    out = flash_decode_paged_plain(q, k_new, v_new, pool, tables, layer, lengths, max_length,
                                   slopes)
    dst = pool if append_to is None else append_to
    _append_plain(dst[int(layer)], k_new.to(dst.dtype), v_new.to(dst.dtype), lengths,
                  tables.to(dst.device))
    return out


def flash_prefill_plain(q: torch.Tensor, cache: torch.Tensor,
                        start_pos: int,
                        slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K3, in f32: ``[B, S, nq*hd]`` in ``q.dtype``. With
    ALiBi ``slopes [nq]``, the score of query position ``i`` and key ``j``
    gains the row-relative ``slope * (j - i)``, as JAX's
    ``flash_prefill_stacked`` adds it."""
    b, s, nq, hd = q.shape
    nkv = cache.shape[2]
    g = nq // nkv
    end = start_pos + s
    qf = q.float().reshape(b, s, nkv, g, hd)
    kf = cache[0, :, :, :end].float()
    vf = cache[1, :, :, :end].float()
    scores = torch.einsum("bskgh,bkth->bkgst", qf, kf) * (1.0 / math.sqrt(hd))
    rows = start_pos + torch.arange(s, device=q.device)
    if slopes is not None:
        rel = (torch.arange(end, device=q.device)[None, :] - rows[:, None]).float()
        scores = scores + slopes.float().to(q.device).reshape(1, nkv, g, 1, 1) * rel
    mask = torch.arange(end, device=q.device)[None, :] <= rows[:, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bkth->bskgh", p, vf)
    return out.reshape(b, s, nq * hd).to(q.dtype)


def flash_decode_layer_plain(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, length: int,
                             slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K14, in f32: ``q [B, nq, hd]`` over positions
    ``[0, length)`` of ``k_cache``/``v_cache [B, nkv, T, hd]``; ``[B, nq,
    hd]`` in ``q.dtype``. With ALiBi ``slopes [nq]``, score ``j`` gains
    ``slope * j``."""
    b, nq, hd = q.shape
    nkv = k_cache.shape[1]
    length = int(length)
    qf = q.float().reshape(b, nkv, nq // nkv, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgh,bkth->bkgt", qf, k_cache[:, :, :length].float())
    if slopes is not None:
        s = s + (slopes.float().to(q.device).reshape(1, nkv, nq // nkv, 1)
                 * torch.arange(length, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,bkth->bkgh", p, v_cache[:, :, :length].float())
    return out.reshape(b, nq, hd).to(q.dtype)


def _check(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_head_dim(what: str, hd: int, dims=(HEAD_DIM,)) -> None:
    if hd not in dims:
        raise NotImplementedError(
            f"{what}: head_dim {hd}; the kernel is built for "
            f"{' and '.join(map(str, dims))} (other head_dims wait for their model "
            "families, ROADMAP queue A, item 12)")


def _check_common(what: str, q: torch.Tensor, cache: torch.Tensor,
                  dims=(HEAD_DIM,)) -> None:
    hd = q.shape[-1]
    _check_head_dim(what, hd, dims)
    _check(cache.dim() == 5 and cache.shape[0] == 2 and cache.shape[-1] == hd,
           what, f"cache must be one layer [2, B, n_kv, T, {hd}], got "
           f"{tuple(cache.shape)}")
    _check(q.dtype in _DTYPE_CODE and cache.dtype in _DTYPE_CODE, what,
           f"q and cache must be f32, bf16 or f16, got {q.dtype} and {cache.dtype}")
    _check(q.is_contiguous() and cache.is_contiguous(), what,
           "q and cache must be contiguous")
    _check(cache.device == q.device, what, "q and cache on different devices")
    _check(cache.data_ptr() % 16 == 0, what, "cache must be 16-byte aligned")


def flash_decode_supported(nq: int, nkv: int, hd: int, cache_dtype) -> bool:
    """Whether the single-position step at one shared position takes K2 for
    this shape and float cache dtype: head_dim 128, ``nq`` a multiple of
    ``nkv`` with at most 32 query heads per kv head (16 over an f32 cache),
    the unit ``decode_attn``'s shapes. A static test; that step falls back
    to :func:`flash_decode_layer` (K14) where it fails (falcon, BLOOM), as
    it did before K2 took their shapes, so that their single-stream paths
    keep their kernels and their bits. The per-row batched and paged steps
    take K2, K8 and K9 at every shape :func:`_check_decode_group` admits."""
    most = 16 if cache_dtype == torch.float32 else 32
    return (hd == HEAD_DIM and cache_dtype in _DTYPE_CODE and nq % nkv == 0
            and nq // nkv <= most)


def _check_layer(what: str, nq: int, nkv: int, hd: int, q_dtype, k_dtype, v_dtype) -> None:
    """K14's checks: head_dim 64 or 128 and at most 128 query heads per kv
    head (``NotImplementedError`` naming ROADMAP A12 otherwise), ``nq`` a
    multiple of ``nkv``, q and both caches f32, bf16 or f16, the two caches
    of one dtype."""
    _check_head_dim(what, hd, HEAD_DIMS)
    _check(nq % nkv == 0, what, f"nq={nq} is not a multiple of nkv={nkv}")
    if nq // nkv > LAYER_MAX_GROUP:
        raise NotImplementedError(
            f"{what}: {nq // nkv} q heads per kv head; the kernel takes at most "
            f"{LAYER_MAX_GROUP} (wider groups wait for their model families, ROADMAP "
            "queue A, item 12)")
    _check(q_dtype in _DTYPE_CODE and k_dtype in _DTYPE_CODE and v_dtype == k_dtype, what,
           f"q and the caches must be f32, bf16 or f16 and the caches of one dtype; got "
           f"{q_dtype}, {k_dtype} and {v_dtype}")


def _check_decode_group(what: str, nq: int, nkv: int, alibi: bool) -> None:
    """The query group of K2, K8 and K9: ``nq`` a multiple of ``nkv``
    (``ValueError``), at most :data:`LAYER_MAX_GROUP` query heads per kv head
    and :data:`NARROW_GROUP` with ALiBi slopes (``NotImplementedError``
    naming ROADMAP A12 beyond)."""
    _check(nkv > 0 and nq % nkv == 0, what, f"nq={nq} is not a multiple of nkv={nkv}")
    most = NARROW_GROUP if alibi else LAYER_MAX_GROUP
    if nq // nkv > most:
        raise NotImplementedError(
            f"{what}: {nq // nkv} q heads per kv head{' with ALiBi slopes' if alibi else ''}; "
            f"the kernel takes at most {most} (wider groups wait for their model families, "
            "ROADMAP queue A, item 12)")


def _decode_unit(sptr: int, hd: int, g: int, entry: str, by_length: bool = False):
    """``(library, entry name, head_dim argument, slopes argument, counter
    suffix)`` of a K2, K8 or K9 launch: the unit ``decode_attn_alibi`` with
    slopes; without them ``decode_attn`` at its shapes (head_dim 128, at most
    32 q heads a kv head; its entries take no head_dim), else
    ``decode_attn_wide``. ``by_length``: the entry ``<name>_dev``, which
    splits by the lengths it reads (K2 and K9; the wide unit has K9's)."""
    from awq_tpu_torch import _build

    dev = "_dev" if by_length else ""
    if sptr:
        return (_build.load("decode_attn_alibi"), entry + "_alibi" + dev, (hd,), (sptr,),
                "_alibi")
    if hd == HEAD_DIM and g <= NARROW_GROUP:
        return _build.load("decode_attn"), entry + dev, (), (), ""
    if by_length and entry == "awq_flash_decode":
        raise NotImplementedError(
            f"flash_decode split by the length it reads at head_dim {hd} and {g} q heads a kv "
            "head: the single-position step takes K14 at these shapes (flash_decode_supported)")
    return _build.load("decode_attn_wide"), entry + "_wide" + dev, (hd,), (), "_wide"


def _slopes_ptr(what: str, slopes: Optional[torch.Tensor], nq: int, dev) -> int:
    """The device pointer of ALiBi ``slopes`` (f32 ``[nq]``, contiguous on
    ``dev``), or 0 without them."""
    if slopes is None:
        return 0
    _check(slopes.dtype == torch.float32 and tuple(slopes.shape) == (nq,)
           and slopes.is_contiguous() and slopes.device == dev, what,
           f"slopes must be contiguous f32 [{nq}] on {dev}, got {slopes.dtype} "
           f"{tuple(slopes.shape)} on {slopes.device}")
    return slopes.data_ptr()


def _unit(sptr: int, entry: str):
    """``(library, entry name, slopes argument)`` of a launch: the unit
    ``decode_attn`` without slopes, ``decode_attn_alibi`` (its ``*_alibi``
    entries, the slopes pointer before the stream) with them."""
    from awq_tpu_torch import _build

    if sptr:
        return _build.load("decode_attn_alibi"), entry + "_alibi", (sptr,)
    return _build.load("decode_attn"), entry, ()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How the split flash-decode body (K2, K8, K9, K14) covers one call.

    For each (row b, kv head) the positions ``[0, max_length)`` are cut into
    ``cluster`` slices of ``per`` positions (a multiple of ``unit``:
    :data:`DECODE_TILE`, or :data:`K2_UNIT` and whole pages for K2 and K8),
    one block each: block ``rank``
    takes ``[rank * per, min(len_b, (rank + 1) * per))``, streamed through a
    ring of ``stages`` tiles. The blocks of a (row, kv head) are one
    thread-block cluster (the grid is ``(cluster, nkv, b)``) and merge their
    softmax states on chip. The kv head's ``g`` query heads are padded to
    ``row_tiles`` 16-row tiles of ``mma.sync``; ``warps_per_tile`` warps
    share a tile's positions, ``npw`` each. ``cur``: the current token rides
    as an operand (K2, K8, K9; not K14), its scores in the header. ``smem``
    mirrors ``csrc/decode_attn.cu::dec_layout``; the C entry refuses a plan
    whose bytes differ."""

    b: int
    nq: int
    nkv: int
    hd: int
    max_length: int
    esize: int            # bytes of a cache element: 1 (int8 codes), 2 or 4
    page: int             # K8's page size; 0 for a contiguous cache
    cluster: int
    per: int
    stages: int
    cur: bool = True
    want: int = 1             # the slices aimed at (decode_split)
    unit: int = DECODE_TILE   # what ``per`` is a multiple of
    by_length: bool = False   # the kernel splits by the length it reads

    @property
    def g(self) -> int:
        return self.nq // self.nkv

    @property
    def row_tiles(self) -> int:
        return -(-self.g // 16)

    @property
    def npw(self) -> int:
        return 16 if self.row_tiles <= 2 else 32

    @property
    def warps(self) -> int:
        return self.row_tiles * (DECODE_TILE // self.npw)

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def blocks(self) -> int:
        return self.cluster * self.nkv * self.b

    @property
    def row_bytes(self) -> int:
        """Bytes of one position's K (or V) row: a whole number of the
        16-byte ``cp.async`` copies."""
        return self.hd * self.esize

    def layout(self, stages: Optional[int] = None) -> dict:
        """The block's shared-memory regions in bytes (see the C layout)."""
        stages = self.stages if stages is None else stages
        r128 = lambda x: (x + 127) & ~127   # noqa: E731
        rows, t = 16 * self.row_tiles, DECODE_TILE
        # the current token's scores: 32, or one a q row of a wide group
        n_sc = rows if self.cur and self.npw == 32 else 32
        lay = dict(hdr=r128((n_sc + self.hd) * 4), q=r128(rows * self.hd * 4),
                   stage=r128(2 * t * self.row_bytes + (2 * t * 4 if self.esize == 1 else 0)),
                   wide=2 * t * self.hd * 2 if self.esize == 1 else 0,
                   ps=self.warps * 16 * self.npw * 4 if self.esize == 4 else 0,
                   merge=r128((self.warps * 16 * (self.hd + 6) + 6 * rows) * 4))
        lay["ring"] = stages * lay["stage"]
        lay["total"] = lay["hdr"] + max(lay["q"] + lay["ring"] + lay["wide"] + lay["ps"],
                                        lay["merge"])
        return lay

    @property
    def smem(self) -> int:
        return self.layout()["total"]

    def slice(self, rank: int, length: int) -> tuple:
        """Positions ``[lo, hi)`` that block ``rank`` reads of a row of
        ``length`` cached positions (empty past the row's end); with
        ``by_length`` the slices of that length's split."""
        per = decode_split(length, self.want, self.unit)[0] if self.by_length else self.per
        lo = rank * per
        return lo, max(lo, min(length, lo + per))

    def describe(self) -> str:
        return (f"cluster {self.cluster}, {self.per} positions a block, {self.stages} stages, "
                f"{self.threads} threads, {self.smem} B shared")


def decode_split(length: int, want: int, unit: int) -> tuple:
    """``(per, n)``: a row of ``length`` positions in ``n`` slices of ``per``
    positions, ``per`` a multiple of ``unit``, about ``want`` slices and at
    least one (``csrc/decode_attn.cu::dec_split``, which the kernels run
    when they split by the length they read)."""
    per = max(unit, _round_up(-(-length // want), unit))
    return per, max(1, -(-length // per))


@functools.lru_cache(maxsize=512)
def decode_plan(b: int, nq: int, nkv: int, hd: int, max_length: int, esize: int,
                unit: int = DECODE_TILE, page: int = 0, sms: int = H100_SMS,
                max_cluster: int = MAX_CLUSTER, cur: bool = True,
                by_length: bool = False) -> DecodePlan:
    """The split flash decode's host plan (see :class:`DecodePlan`) for
    ``b`` rows of ``nq`` query heads over ``nkv`` kv heads at head_dim
    ``hd``, rows at most ``max_length`` long, a cache of ``esize``-byte
    elements, slices a multiple of ``unit`` (K8: and of its ``page``),
    ``cur`` for K2, K8 and K9 (the current token an operand), not K14. The
    cluster fills one wave of ``sms``
    blocks: ``sms // (b * nkv)`` blocks a (row, kv head), at most
    ``max_cluster``, fewer when the rows are short; a longer cache gives
    each block more tiles. The ring takes 4 stages where the blocks an SM
    must hold still fit its shared memory, else 3 or 2, and no more than a
    block's tiles plus one. An SM must hold the blocks of one wave, and
    two when the cluster is above 8: a 16-block cluster whose blocks take
    an SM each waits for a GPC with 16 free SMs (on the H100, clusters of
    16 at 140 KB a block ran 1.5x slower than at 107 KB,
    ``scripts/exp_decode_plan.py``).

    ``by_length``: the plan of a launch that reads its rows' lengths on the
    device and splits each by :func:`decode_split` (a decode step captured
    once and replayed at every length up to ``max_length``): the cluster
    holds the most slices of any such length, ``min(want, ceil(max_length /
    unit))``, and the ring and shared memory are planned for ``max_length``.
    A replay then gives the bits of the launch planned for its length."""
    unit = math.lcm(DECODE_TILE, unit, page or 1)
    want = max(1, min(max_cluster, sms // (b * nkv)))
    per, cluster = decode_split(max_length, want, unit)
    if by_length:
        cluster = max(1, min(want, -(-max_length // unit)))
    plan = DecodePlan(b=b, nq=nq, nkv=nkv, hd=hd, max_length=max_length, esize=esize,
                      page=page, cluster=cluster, per=per, stages=2, cur=cur, want=want,
                      unit=unit, by_length=by_length)
    per_sm = max(-(-plan.blocks // sms), 2 if cluster > 8 else 1)
    most = max(2, min(4, -(-min(per, max_length) // DECODE_TILE) + 1))
    for stages in range(most, 1, -1):
        total = plan.layout(stages)["total"]
        if total <= SMEM_MAX and (per_sm * (total + 1024) <= SMEM_SM or stages == 2):
            return dataclasses.replace(plan, stages=stages)
    raise ValueError(f"decode_plan: {nq} q heads over {nkv} kv heads at head_dim {hd} need "
                     f"{plan.layout(2)['total']} B of shared memory, more than {SMEM_MAX}")


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_args(plan: DecodePlan) -> tuple:
    return plan.cluster, plan.per, plan.stages, plan.smem


def _split_args(plan: DecodePlan) -> tuple:
    """The ``*_dev`` entries' ``want``, ``unit`` and bound of a ``by_length``
    plan; nothing for a host plan."""
    return (plan.want, plan.unit, plan.max_length) if plan.by_length else ()


def _check_kv_new(what: str, k_new: torch.Tensor, v_new: torch.Tensor, shape: tuple,
                  dev, dtypes=tuple(_DTYPE_CODE), names=("k_new", "v_new")) -> None:
    """Two ``shape`` tensors of one dtype of ``dtypes``, contiguous on ``dev``."""
    _check(k_new.dtype == v_new.dtype and k_new.dtype in dtypes, what,
           f"{names[0]} and {names[1]} must share one of {', '.join(map(str, dtypes))}")
    for name, kv in zip(names, (k_new, v_new)):
        _check(tuple(kv.shape) == shape and kv.is_contiguous() and kv.device == dev, what,
               f"{name} must be contiguous {list(shape)} on {dev}")


def _check_append_to(what: str, dst: torch.Tensor, like: torch.Tensor) -> None:
    """``append_to`` must have the layout it stands in for."""
    _check(dst.shape == like.shape and dst.dtype == like.dtype and dst.device == like.device
           and dst.is_contiguous() and dst.data_ptr() % 16 == 0, what,
           f"append_to must be a contiguous, 16-byte aligned {like.dtype} "
           f"{tuple(like.shape)} on {like.device}")


def _launch(what: str, lib, entry: str, ptrs: tuple, ints: tuple, scale: float,
            codes: tuple, tail_ptrs: tuple, plan: DecodePlan, dev) -> None:
    """One K2, K8 or K9 launch: the C entry's pointers, ints, scale, dtype
    codes (and a ``by_length`` plan's split), slopes, stream."""
    from awq_tpu_torch import _build

    fn = getattr(lib, entry)
    tail = codes + _split_args(plan)
    _build.declare(fn, *([_build.P] * len(ptrs)), *([_build.I] * len(ints)), _build.F,
                   *([_build.I] * len(tail)), *([_build.P] * len(tail_ptrs)), _build.P)
    err = fn(*ptrs, *ints, scale, *tail, *tail_ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        _build.check(lib, err, f"{what} ({plan.describe()})")


def flash_decode(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                 cache: torch.Tensor, lengths: torch.Tensor,
                 max_length: Optional[int] = None,
                 slopes: Optional[torch.Tensor] = None,
                 by_length: bool = False,
                 append_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 wrapper. ``q [B, nq, hd]``, ``k_new``/``v_new [B, nkv, hd]`` (the
    current token, post-rope), ``cache [2, B, nkv, T, hd]`` (one layer),
    ``lengths [B]`` int32 cache-prefix lengths. ``max_length`` (at least
    ``lengths.max()``) sizes the split-K grid without a device sync.
    ``slopes``: ALiBi slopes f32 ``[nq]`` or None. head_dim 64 or 128, up
    to 128 q heads a kv head (32 with slopes). Returns ``[B, nq, hd]``.

    After the attention the launch appends the current token to ``cache``
    in place (``cache[:, b, :, min(max(len_b, 0), T - 1)] = k_new, v_new``
    in the cache's dtype), or to ``append_to`` (a tensor of the cache's
    layout; the checks' seam, see the module's docstring), leaving
    ``cache`` as it was.

    ``by_length`` (``max_length`` given; rows that share one length, as a
    single-position step's): the kernel splits each row by the length it
    reads, as :func:`decode_plan` plans that length, clamped to
    ``max_length``, the bound the grid is planned for. A captured step
    replayed at any length then gives the bits of the launch planned for
    that length on the host. Head_dim 128 and at most 32 q heads a kv
    head (:func:`flash_decode_supported`), or ALiBi slopes."""
    if q.device.type == "cpu":
        return flash_decode_append_plain(q, k_new, v_new, cache, lengths, max_length, slopes,
                                         append_to=append_to)
    what = "flash_decode"
    _check(q.is_cuda, what, f"unsupported device {q.device}")
    _check_common(what, q, cache, HEAD_DIMS)
    b, nq, hd = q.shape
    nkv, t = cache.shape[2], cache.shape[3]
    _check(cache.shape[1] == b, what,
           f"q {tuple(q.shape)} does not fit cache {tuple(cache.shape)}")
    _check_decode_group(what, nq, nkv, slopes is not None)
    _check_kv_new(what, k_new, v_new, (b, nkv, hd), q.device)
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,)
           and lengths.device == q.device and lengths.is_contiguous(), what,
           f"lengths must be int32 [{b}] on {q.device}")
    dst = cache if append_to is None else append_to
    _check_append_to(what, dst, cache)
    _check(max_length is not None or not by_length, what, "by_length needs max_length")
    if max_length is None:
        max_length = int(lengths.max())
    _check(0 <= max_length <= t, what, f"max_length {max_length} not in [0, {t}]")
    sptr = _slopes_ptr(what, slopes, nq, q.device)
    plan = decode_plan(b, nq, nkv, hd, max_length, cache.element_size(), PLAN_UNIT[what],
                       sms=_sm_count(q.device), by_length=by_length)
    out = torch.empty_like(q)
    lib, entry, hd_arg, tail, tag = _decode_unit(sptr, hd, nq // nkv, "awq_flash_decode",
                                                 by_length)
    _launch(what, lib, entry,
            (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache.data_ptr(), dst.data_ptr(),
             lengths.data_ptr(), out.data_ptr()),
            (b, nq, nkv, t, *hd_arg, *_plan_args(plan)), 1.0 / math.sqrt(hd),
            (_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_new.dtype], _DTYPE_CODE[cache.dtype]), tail,
            plan, q.device)
    LAUNCHES[what + tag] += 1
    cache_append.LAUNCHES["cache_append"] += 1
    return out


def flash_decode_int8(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                      cache: torch.Tensor, scales: torch.Tensor, lengths: torch.Tensor,
                      max_length: Optional[int] = None,
                      slopes: Optional[torch.Tensor] = None,
                      by_length: bool = False,
                      k_app: Optional[torch.Tensor] = None,
                      v_app: Optional[torch.Tensor] = None,
                      append_to=None) -> torch.Tensor:
    """K9 wrapper. As :func:`flash_decode`, over one layer of an int8 cache:
    ``cache [2, B, nkv, T, hd]`` int8 codes and ``scales [2, B, nkv, T]``
    f32. ``k_new``/``v_new`` (in q's dtype) are the current token: in full
    precision, or already dequantized (``models/llama.py``'s ALiBi
    single-position step). ``slopes``: ALiBi slopes f32 ``[nq]`` or None.
    ``by_length`` as in :func:`flash_decode`, at every shape K9 takes.

    After the attention the launch quantizes ``k_app``, ``v_app`` (f32,
    bf16 or f16 ``[B, nkv, hd]``; by default ``k_new``, ``v_new``) as
    :func:`~awq_tpu_torch.ops.cache_append.quantize_kv` does and writes the
    codes and scales at each row's clamped position, in place, or into
    ``append_to``, a ``(codes, scales)`` pair of the same layouts."""
    if q.device.type == "cpu":
        return flash_decode_int8_append_plain(q, k_new, v_new, cache, scales, lengths,
                                              max_length, slopes, k_app=k_app, v_app=v_app,
                                              append_to=append_to)
    what = "flash_decode_int8"
    _check(q.is_cuda, what, f"unsupported device {q.device}")
    b, nq, hd = q.shape
    _check_head_dim(what, hd, HEAD_DIMS)
    _check(cache.dim() == 5 and cache.shape[0] == 2 and cache.shape[1] == b
           and cache.shape[-1] == hd and cache.dtype == torch.int8, what,
           f"cache must be int8 [2, {b}, n_kv, T, {hd}], got {cache.dtype} "
           f"{tuple(cache.shape)}")
    nkv, t = cache.shape[2], cache.shape[3]
    _check(tuple(scales.shape) == (2, b, nkv, t) and scales.dtype == torch.float32,
           what, f"scales must be f32 [2, {b}, {nkv}, {t}], got {scales.dtype} "
           f"{tuple(scales.shape)}")
    _check(q.dtype in _DTYPE_CODE, what, f"q must be f32, bf16 or f16, got {q.dtype}")
    _check_decode_group(what, nq, nkv, slopes is not None)
    _check_kv_new(what, k_new, v_new, (b, nkv, hd), q.device, (q.dtype,))
    k_app = k_new if k_app is None else k_app
    v_app = v_new if v_app is None else v_app
    _check_kv_new(what, k_app, v_app, (b, nkv, hd), q.device, names=("k_app", "v_app"))
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,), what,
           f"lengths must be int32 [{b}]")
    _check(all(x.device == q.device and x.is_contiguous()
               for x in (q, cache, scales, lengths)), what,
           f"operands must be contiguous on {q.device}")
    _check(cache.data_ptr() % 16 == 0, what, "cache must be 16-byte aligned")
    dst, dst_s = (cache, scales) if append_to is None else append_to
    _check_append_to(what, dst, cache)
    _check_append_to(what, dst_s, scales)
    _check(max_length is not None or not by_length, what, "by_length needs max_length")
    if max_length is None:
        max_length = int(lengths.max())
    _check(0 <= max_length <= t, what, f"max_length {max_length} not in [0, {t}]")
    sptr = _slopes_ptr(what, slopes, nq, q.device)
    plan = decode_plan(b, nq, nkv, hd, max_length, 1, PLAN_UNIT[what],
                       sms=_sm_count(q.device), by_length=by_length)
    out = torch.empty_like(q)
    lib, entry, hd_arg, tail, tag = _decode_unit(sptr, hd, nq // nkv, "awq_flash_decode_int8",
                                                 by_length)
    _launch(what, lib, entry,
            (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_app.data_ptr(),
             v_app.data_ptr(), cache.data_ptr(), scales.data_ptr(), dst.data_ptr(),
             dst_s.data_ptr(), lengths.data_ptr(), out.data_ptr()),
            (b, nq, nkv, t, *hd_arg, *_plan_args(plan)), 1.0 / math.sqrt(hd),
            (_DTYPE_CODE[q.dtype], _DTYPE_CODE[k_app.dtype]), tail, plan, q.device)
    LAUNCHES[what + tag] += 1
    cache_append.LAUNCHES["cache_append_int8"] += 1
    return out


def flash_decode_paged(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                       pool: torch.Tensor, tables: torch.Tensor, layer: int,
                       lengths: torch.Tensor,
                       max_length: Optional[int] = None,
                       slopes: Optional[torch.Tensor] = None,
                       append_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8 wrapper, JAX's signature. ``q [B, nq, hd]``, ``k_new``/``v_new
    [B, nkv, hd]`` (the current token, post-rope), ``pool [L, 2, NP, nkv,
    page, hd]``, ``tables [B, MP]`` int32 page ids (in ``[0, NP)``: not
    checked, that would take a sync), ``layer`` the pool's layer,
    ``lengths [B]`` int32. ``max_length`` (at least ``lengths.max()``)
    sizes the split-K grid without a device sync. ``slopes``: ALiBi slopes
    f32 ``[nq]`` or None. Returns ``[B, nq, hd]``.

    After the attention the launch appends the current token (rounded to
    the pool's dtype) to layer ``layer`` of ``pool`` in place, or of
    ``append_to`` (a tensor of the pool's layout): row ``b``'s position
    ``p = min(max(len_b, 0), MP * page - 1)`` at page ``tables[b, p //
    page]``, offset ``p % page``. Rows that share a page (freed rows all
    point at page 0, the trash page) race there, and their outputs are
    not defined; a live row's pages are its own."""
    if q.device.type == "cpu":
        return flash_decode_paged_append_plain(q, k_new, v_new, pool, tables, layer, lengths,
                                               max_length, slopes, append_to=append_to)
    what = "flash_decode_paged"
    _check(q.is_cuda, what, f"unsupported device {q.device}")
    layer = int(layer)
    _check(pool.dim() == 6 and pool.shape[1] == 2 and 0 <= layer < pool.shape[0], what,
           f"pool must be [L, 2, NP, n_kv, page, hd] with layer {layer} in it, got "
           f"{tuple(pool.shape)}")
    _check_common(what, q, pool[layer], HEAD_DIMS)
    b, nq, hd = q.shape
    np_, nkv, page = pool.shape[2], pool.shape[3], pool.shape[4]
    _check_decode_group(what, nq, nkv, slopes is not None)
    _check_kv_new(what, k_new, v_new, (b, nkv, hd), q.device)
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,)
           and lengths.device == q.device and lengths.is_contiguous(), what,
           f"lengths must be int32 [{b}] on {q.device}")
    _check(tables.dtype == torch.int32 and tables.dim() == 2 and tables.shape[0] == b
           and tables.shape[1] > 0 and tables.device == q.device
           and tables.is_contiguous(), what,
           f"tables must be contiguous int32 [{b}, MP] on {q.device}")
    dst = pool if append_to is None else append_to
    _check_append_to(what, dst, pool)
    mp = tables.shape[1]
    if max_length is None:
        max_length = int(lengths.max())
    max_length = min(max(int(max_length), 0), mp * page)
    sptr = _slopes_ptr(what, slopes, nq, q.device)
    plan = decode_plan(b, nq, nkv, hd, max_length, pool.element_size(), PLAN_UNIT[what],
                       page, sms=_sm_count(q.device))
    out = torch.empty_like(q)
    lib, entry, hd_arg, tail, tag = _decode_unit(sptr, hd, nq // nkv, "awq_flash_decode_paged")
    # the plain version rounds the current token to the pool dtype first
    k_new, v_new = k_new.to(pool.dtype), v_new.to(pool.dtype)
    cd = _DTYPE_CODE[pool.dtype]
    _launch(what, lib, entry,
            (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), pool[layer].data_ptr(),
             dst[layer].data_ptr(), tables.data_ptr(), lengths.data_ptr(), out.data_ptr()),
            (b, nq, nkv, np_, page, mp, *hd_arg, *_plan_args(plan)), 1.0 / math.sqrt(hd),
            (_DTYPE_CODE[q.dtype], cd, cd), tail, plan, q.device)
    LAUNCHES[what + tag] += 1
    cache_append.LAUNCHES["cache_append_paged"] += 1
    return out


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    """How K3's bf16/f16 mode covers one chunk: the ``S * g`` query rows of
    each (row b, kv head), packed as ``r = position * g + head-in-group``
    (q's own order within a kv head's group), cut into ``n_tiles`` tiles of
    ``PREFILL_ROWS``; one block per (tile, b, kv head), launched in the
    order of :meth:`tile`: block ``x`` takes tile ``n_tiles - 1 - x // (B *
    nkv)``, so the tiles with the longest causal frontier start first."""

    b: int
    s: int
    nq: int
    nkv: int
    t: int
    start: int
    hd: int

    @property
    def g(self) -> int:
        return self.nq // self.nkv

    @property
    def rows(self) -> int:
        return self.s * self.g

    @property
    def n_tiles(self) -> int:
        return -(-self.rows // PREFILL_ROWS)

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.b * self.nkv

    @property
    def kv_tile(self) -> int:
        return PREFILL_KV_TILE[self.hd]

    def tile(self, x: int):
        """Block ``x``'s ``(b, kv head, first row, end row, frontier)``: its
        rows ``[r0, r1)`` attend keys below ``frontier = start + (r1 - 1) //
        g + 1`` (never past T), each row up to ``start + r // g``."""
        bh = x % (self.b * self.nkv)
        tile = self.n_tiles - 1 - x // (self.b * self.nkv)
        r0 = tile * PREFILL_ROWS
        r1 = min(r0 + PREFILL_ROWS, self.rows)
        return bh // self.nkv, bh % self.nkv, r0, r1, min(self.start + (r1 - 1) // self.g + 1,
                                                          self.t)


def prefill_plan(b: int, s: int, nq: int, nkv: int, t: int, start: int, hd: int) -> PrefillPlan:
    """K3's host plan for ``q [b, s, nq, hd]`` over a cache of ``t`` positions
    from ``start`` (see :class:`PrefillPlan`)."""
    return PrefillPlan(b=b, s=s, nq=nq, nkv=nkv, t=t, start=start, hd=hd)


def flash_prefill(q: torch.Tensor, cache: torch.Tensor,
                  start_pos: Union[int, torch.Tensor],
                  slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 wrapper. ``q [B, S, nq, hd]`` post-rope queries of the chunk at
    ``[start_pos, start_pos + S)``, already written into ``cache
    [2, B, nkv, T, hd]`` (one layer); hd 64 or 128; ``slopes``: ALiBi slopes
    f32 ``[nq]`` or None. Returns ``[B, S, nq*hd]``."""
    start_pos = int(start_pos)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, cache, start_pos, slopes)
    what = "flash_prefill"
    _check(q.is_cuda, what, f"unsupported device {q.device}")
    _check_common(what, q, cache, HEAD_DIMS)
    b, s, nq, hd = q.shape
    nkv, t = cache.shape[2], cache.shape[3]
    _check(cache.shape[1] == b and nq % nkv == 0, what,
           f"q {tuple(q.shape)} does not fit cache {tuple(cache.shape)}")
    _check(start_pos >= 0 and start_pos + s <= t, what,
           f"chunk [{start_pos}, {start_pos + s}) outside the cache (T={t})")
    sptr = _slopes_ptr(what, slopes, nq, q.device)
    out = torch.empty((b, s, nq * hd), dtype=q.dtype, device=q.device)
    if s == 0:
        return out

    from awq_tpu_torch import _build

    lib, entry, tail = _unit(sptr, "awq_flash_prefill")
    fn = getattr(lib, entry)
    plan = prefill_plan(b, s, nq, nkv, t, start_pos, hd)
    _build.declare(fn, *([_build.P] * 3), *([_build.I] * 8), _build.F, _build.I, _build.I,
                   *([_build.P] * len(tail)), _build.P)
    err = fn(q.data_ptr(), cache.data_ptr(), out.data_ptr(), b, s, nq, nkv,
             t, start_pos, hd, plan.n_tiles, _LOG2E / math.sqrt(hd), _DTYPE_CODE[q.dtype],
             _DTYPE_CODE[cache.dtype], *tail, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, what)
    LAUNCHES["flash_prefill_alibi" if sptr else "flash_prefill"] += 1
    return out


def flash_decode_layer(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       length: Union[int, torch.Tensor],
                       max_length: Optional[int] = None,
                       slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K14 wrapper, JAX's ``flash_decode`` signature. ``q [B, nq, hd]`` one
    query position per row; ``k_cache``/``v_cache [B, nkv, T, hd]`` one
    layer's cache (two tensors, e.g. the views ``kv[0]``, ``kv[1]``),
    ``length`` the positions ``[0, length)`` every row attends, the current
    token's included (it is already written). Returns ``[B, nq, hd]``.

    ``length`` may be an int32 tensor ``[1]`` on the device: the kernel
    reads it there (a captured decode step replays at every length) and
    splits by it as :func:`decode_plan` plans that length, and
    ``max_length`` (at least the length, at most T) is the bound its grid
    is planned for, to which it clamps the length. It gives the bits of
    the host-length launch planned for that length (``max_length`` None).
    ``slopes``: ALiBi slopes f32 ``[nq]`` or None."""
    dev_len = isinstance(length, torch.Tensor) and length.device.type != "cpu"
    if not dev_len:
        length = int(length)
    if q.device.type == "cpu":
        return flash_decode_layer_plain(q, k_cache, v_cache, length, slopes)
    what = "flash_decode_layer"
    _check(q.is_cuda, what, f"unsupported device {q.device}")
    b, nq, hd = q.shape
    _check(k_cache.dim() == 4 and tuple(k_cache.shape) == tuple(v_cache.shape)
           and k_cache.shape[0] == b and k_cache.shape[-1] == hd, what,
           f"k_cache and v_cache must be [{b}, n_kv, T, {hd}], got "
           f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    nkv, t = k_cache.shape[1], k_cache.shape[2]
    _check_layer(what, nq, nkv, hd, q.dtype, k_cache.dtype, v_cache.dtype)
    _check(all(x.is_contiguous() and x.device == q.device for x in (q, k_cache, v_cache)),
           what, f"q, k_cache and v_cache must be contiguous on {q.device}")
    _check(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0, what,
           "k_cache and v_cache must be 16-byte aligned")
    if dev_len:
        _check(length.dtype == torch.int32 and length.numel() == 1 and length.is_contiguous()
               and length.device == q.device, what, f"a device length is one int32 on {q.device}")
        _check(max_length is not None, what, "a device length needs max_length")
        bound, lptr = int(max_length), length.data_ptr()
        n_len = bound          # the C entry's length: the bound the kernel clamps to
    else:
        bound = length if max_length is None else int(max_length)
        _check(1 <= length <= bound, what, f"length {length} not in [1, {bound}]")
        lptr, n_len = 0, length
    _check(1 <= bound <= t, what, f"length bound {bound} not in [1, {t}]")
    sptr = _slopes_ptr(what, slopes, nq, q.device)
    if sptr and nq // nkv > 32:
        raise NotImplementedError(
            f"{what}: ALiBi slopes with {nq // nkv} q heads per kv head; the ALiBi unit takes "
            "at most 32 (the ALiBi families are MHA; wider groups are ROADMAP queue A, item 12)")
    plan = decode_plan(b, nq, nkv, hd, bound, k_cache.element_size(), PLAN_UNIT[what],
                       sms=_sm_count(q.device), cur=False, by_length=dev_len)
    out = torch.empty_like(q)

    from awq_tpu_torch import _build

    lib, entry, tail = _unit(sptr, "awq_flash_decode_layer")
    fn = getattr(lib, entry + ("_dev" if dev_len else ""))
    _build.declare(fn, *([_build.P] * 5), *([_build.I] * 10), _build.F, _build.I, _build.I,
                   *([_build.I] * (2 * dev_len)), *([_build.P] * len(tail)), _build.P)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), lptr, b,
             nq, nkv, t, n_len, hd, *_plan_args(plan), 1.0 / math.sqrt(hd),
             _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype], *_split_args(plan)[:2], *tail,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        _build.check(lib, err, f"{what} ({plan.describe()})")
    LAUNCHES["flash_decode_layer_alibi" if sptr else "flash_decode_layer"] += 1
    return out


# ---- The window mode of K2 and K9: the batched speculative verify ----------
#
# ``models/llama.py::verify_step_batched`` attends, in every layer, a window
# of W tokens a row: query j of row b over the cache positions t < len_b and
# the window positions 0..j, the window's k/v as operands in full precision
# (JAX's ``xla_attn``, ``awq_tpu/models/llama.py:1407-1434``; no Pallas
# kernel). :func:`flash_verify` (over a float cache) and
# :func:`flash_verify_int8` (over a ``KVCache8`` layer) launch the window
# mode of K2's and K9's split body (``csrc/decode_attn.cu``, unit
# ``decode_attn_verify``), which also appends the window after its last
# cluster barrier: W positions at ``min(max(len_b, 0), T - W)``, where
# JAX's ``dynamic_update_slice`` puts them (:1484-1502), in the cache's
# dtype or as ``quantize_kv``'s codes and scales.


def verify_layout(hd: int, esize: int, stages: int) -> dict:
    """A window-mode block's shared memory in bytes
    (``csrc/decode_attn.cu::ver_layout``): q's hi and lo halves, the ring of
    ``stages`` K/V tiles (K9's scales beside), the 16-bit tile of an int8
    or f32 cache; the merge state overlays them after the loop."""
    r128 = lambda x: (x + 127) & ~127   # noqa: E731
    lay = dict(q=2 * VERIFY_ROWS * hd * 2,
               stage=r128(2 * DECODE_TILE * hd * esize + (2 * DECODE_TILE * 4 if esize == 1
                                                          else 0)),
               wide=2 * DECODE_TILE * hd * 2 if esize != 2 else 0,
               merge=r128((VERIFY_ROWS * (hd + 4) + 2 * VERIFY_ROWS) * 4))
    lay["ring"] = stages * lay["stage"]
    lay["total"] = max(lay["q"] + lay["ring"] + lay["wide"], lay["merge"])
    return lay


@dataclasses.dataclass(frozen=True)
class VerifyPlan:
    """How the window mode covers one call: the ``g * w`` query rows of each
    (row b, kv head), packed as ``r = j * g + head-in-group``, in ``chunks``
    blocks of :data:`VERIFY_ROWS`; the prefix ``[0, max_length)`` cut into
    ``cluster`` slices of ``per`` positions, one block each, the blocks of
    a slice set one thread-block cluster (the grid is ``(cluster, chunks *
    nkv, b)``), ``stages`` ring stages, ``smem`` bytes a block."""

    b: int
    w: int
    nq: int
    nkv: int
    hd: int
    max_length: int
    esize: int
    chunks: int
    cluster: int
    per: int
    stages: int

    @property
    def smem(self) -> int:
        return verify_layout(self.hd, self.esize, self.stages)["total"]

    def describe(self) -> str:
        return (f"{self.chunks} chunks of rows, cluster {self.cluster}, {self.per} positions a "
                f"block, {self.stages} stages, {self.smem} B shared")


@functools.lru_cache(maxsize=512)
def verify_plan(b: int, w: int, nq: int, nkv: int, hd: int, max_length: int, esize: int,
                sms: int = H100_SMS) -> VerifyPlan:
    """The window mode's host plan (see :class:`VerifyPlan`): as
    :func:`decode_plan`, the cluster fills one wave of ``sms`` blocks, at
    most :data:`MAX_CLUSTER` (8 over an f32 cache, whose 192 KB blocks take
    an SM each), fewer when the rows are short; two ring stages."""
    chunks = -(-(nq // nkv) * w // VERIFY_ROWS)
    most = 8 if esize == 4 else MAX_CLUSTER
    want = max(1, min(most, sms // (b * nkv * chunks)))
    per, cluster = decode_split(max_length, want, DECODE_TILE)
    return VerifyPlan(b=b, w=w, nq=nq, nkv=nkv, hd=hd, max_length=max_length, esize=esize,
                      chunks=chunks, cluster=cluster, per=per, stages=2)


def _verify_attend(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                   kf: torch.Tensor, vf: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """JAX's ``xla_attn`` of ``verify_step_batched`` in f32 over the prefix
    ``kf``/``vf [B, nkv, t, hd]`` f32: ``[B, W, nq, hd]`` in ``q.dtype``."""
    b, w, nq, hd = q.shape
    nkv, t = kf.shape[1], kf.shape[2]
    g = nq // nkv
    qf = q.transpose(1, 2).reshape(b, nkv, g, w, hd).float()
    scores = torch.einsum("bkgwh,bkth->bkgwt", qf, kf) / math.sqrt(hd)
    live = torch.arange(t, device=q.device)[None, :] < lengths.to(q.device).long()[:, None]
    scores = scores.masked_fill(~live[:, None, None, None, :], float("-inf"))
    kw = k_new.transpose(1, 2).float()                                 # [B, nkv, W, hd]
    s_win = torch.einsum("bkgwh,bkjh->bkgwj", qf, kw) / math.sqrt(hd)
    causal = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    s_win = s_win.masked_fill(~causal, float("-inf"))
    p = torch.softmax(torch.cat([scores, s_win], dim=-1), dim=-1)
    o = (torch.einsum("bkgwt,bkth->bkgwh", p[..., :t], vf)
         + torch.einsum("bkgwj,bkjh->bkgwh", p[..., t:], v_new.transpose(1, 2).float()))
    return o.reshape(b, nq, w, hd).transpose(1, 2).to(q.dtype)


def _prefix_bound(lengths: torch.Tensor, t: int, max_length: Optional[int]) -> int:
    return min(max(int(lengths.max()) if max_length is None else int(max_length), 0), t)


def flash_verify_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                       cache: torch.Tensor, lengths: torch.Tensor,
                       max_length: Optional[int] = None) -> torch.Tensor:
    """Plain version of the window mode's attention over one float cache
    layer ``[2, B, nkv, T, hd]``: ``q [B, W, nq, hd]``, the window's
    ``k_new``/``v_new [B, W, nkv, hd]``, ``lengths [B]``; ``[B, W, nq, hd]``
    in ``q.dtype``. ``max_length`` (at least ``lengths.max()``) bounds the
    positions read."""
    t = _prefix_bound(lengths, cache.shape[3], max_length)
    return _verify_attend(q, k_new, v_new, cache[0, :, :, :t].float(),
                          cache[1, :, :, :t].float(), lengths)


def flash_verify_int8_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                            codes: torch.Tensor, scales: torch.Tensor, lengths: torch.Tensor,
                            max_length: Optional[int] = None) -> torch.Tensor:
    """As :func:`flash_verify_plain` over one int8 layer (codes ``[2, B,
    nkv, T, hd]``, scales ``[2, B, nkv, T]``), dequantized in f32 as JAX's
    ``xla_attn`` does (``kc.astype(f32) * ksc[..., None]``); the window in
    full precision."""
    t = _prefix_bound(lengths, codes.shape[3], max_length)
    deq = codes[:, :, :, :t].float() * scales[:, :, :, :t, None]
    return _verify_attend(q, k_new, v_new, deq[0], deq[1], lengths)


def _window_rows(lengths: torch.Tensor, t: int, w: int, dev) -> tuple:
    """The ``(rows [B, 1], positions [B, W])`` index pair of every row's
    window, which starts at ``min(max(len_b, 0), T - W)`` (JAX's
    ``dynamic_update_slice`` clamp)."""
    b = lengths.shape[0]
    pos = lengths.to(dev).long().clamp(0, t - w)[:, None] + torch.arange(w, device=dev)
    return torch.arange(b, device=dev)[:, None], pos


def window_append_plain(cache: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor) -> None:
    """Each row's window ``k``, ``v [B, W, nkv, hd]`` into one float cache
    layer ``[2, B, nkv, T, hd]`` at its positions (:func:`_window_rows`), in
    the cache's dtype, in place."""
    rows, pos = _window_rows(lengths, cache.shape[3], k.shape[1], cache.device)
    # cache[s][rows, :, pos] is [B, W, nkv, hd]
    cache[0][rows, :, pos] = k.to(device=cache.device, dtype=cache.dtype)
    cache[1][rows, :, pos] = v.to(device=cache.device, dtype=cache.dtype)


def window_append_int8_plain(codes: torch.Tensor, scales: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lengths: torch.Tensor) -> None:
    """As :func:`window_append_plain` into one int8 layer: ``quantize_kv``
    of f32(k), f32(v) (JAX's quantize after its layer scan), the codes and
    the scales at the window's positions, in place."""
    rows, pos = _window_rows(lengths, codes.shape[3], k.shape[1], codes.device)
    for s, x in enumerate((k, v)):
        cq, cs = cache_append.quantize_kv(x.float().to(codes.device))
        codes[s][rows, :, pos] = cq
        scales[s][rows, :, pos] = cs


def flash_verify_append_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                              cache: torch.Tensor, lengths: torch.Tensor,
                              max_length: Optional[int] = None,
                              append_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`flash_verify` in JAX's order: the attention,
    then the window's append into ``cache`` (or ``append_to``)."""
    out = flash_verify_plain(q, k_new, v_new, cache, lengths, max_length)
    window_append_plain(cache if append_to is None else append_to, k_new, v_new, lengths)
    return out


def flash_verify_int8_append_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                                   codes: torch.Tensor, scales: torch.Tensor,
                                   lengths: torch.Tensor, max_length: Optional[int] = None,
                                   append_to=None) -> torch.Tensor:
    """Plain version of :func:`flash_verify_int8` in JAX's order: the
    attention over the dequantized prefix and the full-precision window,
    then the window quantized into ``(codes, scales)`` (or ``append_to``)."""
    out = flash_verify_int8_plain(q, k_new, v_new, codes, scales, lengths, max_length)
    dst, dst_s = (codes, scales) if append_to is None else append_to
    window_append_int8_plain(dst, dst_s, k_new, v_new, lengths)
    return out


def _check_verify(what: str, q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                  cache: torch.Tensor, lengths: torch.Tensor) -> tuple:
    """The window mode's checks common to both wrappers; ``(b, w, nq, nkv,
    t, hd)``."""
    _check(q.is_cuda, what, f"unsupported device {q.device}")
    _check(q.dim() == 4, what, f"q must be [B, W, nq, hd], got {tuple(q.shape)}")
    b, w, nq, hd = q.shape
    _check_head_dim(what, hd, HEAD_DIMS)
    _check(cache.dim() == 5 and cache.shape[0] == 2 and cache.shape[1] == b
           and cache.shape[-1] == hd, what,
           f"cache must be one layer [2, {b}, n_kv, T, {hd}], got {tuple(cache.shape)}")
    nkv, t = cache.shape[2], cache.shape[3]
    _check_decode_group(what, nq, nkv, False)
    _check(1 <= w <= min(VERIFY_MAX_W, t), what,
           f"a window of {w} positions: the kernel takes 1 to {VERIFY_MAX_W}, at most T = {t}")
    _check(q.dtype in _DTYPE_CODE, what, f"q must be f32, bf16 or f16, got {q.dtype}")
    _check_kv_new(what, k_new, v_new, (b, w, nkv, hd), q.device, (q.dtype,))
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,)
           and lengths.device == q.device and lengths.is_contiguous(), what,
           f"lengths must be int32 [{b}] on {q.device}")
    _check(q.is_contiguous() and cache.is_contiguous() and cache.device == q.device, what,
           f"q and the cache must be contiguous on {q.device}")
    _check(cache.data_ptr() % 16 == 0, what, "cache must be 16-byte aligned")
    return b, w, nq, nkv, t, hd


def flash_verify(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                 cache: torch.Tensor, lengths: torch.Tensor,
                 max_length: Optional[int] = None,
                 append_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2's window mode. ``q [B, W, nq, hd]`` (post-rope), the window's
    ``k_new``/``v_new [B, W, nkv, hd]`` (post-rope, q's dtype), ``cache [2,
    B, nkv, T, hd]`` one float layer (f32, bf16 or f16), ``lengths [B]``
    int32 prefix lengths. ``max_length`` (at least ``lengths.max()``) sizes
    the split without a device sync. head_dim 64 or 128, up to 128 q heads
    a kv head, ``1 <= W <= 32``. Returns ``[B, W, nq, hd]``.

    After the attention the launch writes the window into ``cache`` in
    place (row ``b``'s positions ``min(max(len_b, 0), T - W) + [0, W)`` in
    the cache's dtype), or into ``append_to`` (the checks' seam, as
    :func:`flash_decode`'s)."""
    if q.device.type == "cpu":
        return flash_verify_append_plain(q, k_new, v_new, cache, lengths, max_length,
                                         append_to=append_to)
    what = "flash_verify"
    b, w, nq, nkv, t, hd = _check_verify(what, q, k_new, v_new, cache, lengths)
    _check(cache.dtype in _DTYPE_CODE, what, f"cache must be f32, bf16 or f16, got {cache.dtype}")
    dst = cache if append_to is None else append_to
    _check_append_to(what, dst, cache)
    plan = verify_plan(b, w, nq, nkv, hd, _prefix_bound(lengths, t, max_length),
                       cache.element_size(), sms=_sm_count(q.device))
    out = torch.empty_like(q)

    from awq_tpu_torch import _build

    lib = _build.load("decode_attn_verify")
    fn = lib.awq_flash_verify
    _build.declare(fn, *([_build.P] * 7), *([_build.I] * 10), _build.F, _build.I, _build.I,
                   _build.P)
    err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache.data_ptr(), dst.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), b, w, nq, nkv, t, hd, plan.cluster, plan.per,
             plan.stages, plan.smem, 1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype],
             _DTYPE_CODE[cache.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        _build.check(lib, err, f"{what} ({plan.describe()})")
    LAUNCHES[what] += 1
    return out


def flash_verify_int8(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                      cache: torch.Tensor, scales: torch.Tensor, lengths: torch.Tensor,
                      max_length: Optional[int] = None, append_to=None) -> torch.Tensor:
    """K9's window mode. As :func:`flash_verify` over one layer of an int8
    cache: ``cache [2, B, nkv, T, hd]`` int8 codes and ``scales [2, B, nkv,
    T]`` f32; the window attends in full precision. After the attention the
    launch quantizes the window as :func:`~awq_tpu_torch.ops.cache_append.
    quantize_kv` does and writes its codes and scales in place, or into
    ``append_to``, a ``(codes, scales)`` pair of the same layouts."""
    if q.device.type == "cpu":
        return flash_verify_int8_append_plain(q, k_new, v_new, cache, scales, lengths,
                                              max_length, append_to=append_to)
    what = "flash_verify_int8"
    b, w, nq, nkv, t, hd = _check_verify(what, q, k_new, v_new, cache, lengths)
    _check(cache.dtype == torch.int8, what, f"cache must be int8, got {cache.dtype}")
    _check(tuple(scales.shape) == (2, b, nkv, t) and scales.dtype == torch.float32
           and scales.is_contiguous() and scales.device == q.device, what,
           f"scales must be contiguous f32 [2, {b}, {nkv}, {t}] on {q.device}")
    dst, dst_s = (cache, scales) if append_to is None else append_to
    _check_append_to(what, dst, cache)
    _check_append_to(what, dst_s, scales)
    plan = verify_plan(b, w, nq, nkv, hd, _prefix_bound(lengths, t, max_length), 1,
                       sms=_sm_count(q.device))
    out = torch.empty_like(q)

    from awq_tpu_torch import _build

    lib = _build.load("decode_attn_verify")
    fn = lib.awq_flash_verify_int8
    _build.declare(fn, *([_build.P] * 9), *([_build.I] * 10), _build.F, _build.I, _build.P)
    err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache.data_ptr(),
             scales.data_ptr(), dst.data_ptr(), dst_s.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), b, w, nq, nkv, t, hd, plan.cluster, plan.per, plan.stages,
             plan.smem, 1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        _build.check(lib, err, f"{what} ({plan.describe()})")
    LAUNCHES[what] += 1
    return out
