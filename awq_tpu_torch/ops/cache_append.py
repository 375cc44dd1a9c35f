"""Batched KV-cache append (PyTorch port of ``awq_tpu/ops/cache_append.py``).

The continuous-batching decode step produces the new ``kv [L, 2, B, n_kv,
hd]`` of every layer and row, and row ``b`` writes at its own position
``lengths[b]``. :func:`batched_cache_append` scatters all of it into
``cache [L, 2, B, n_kv, T, hd]`` in ONE launch of kernel K7
(``csrc/cache_append.cu``), reading ``lengths`` on the device. The cache
is written IN PLACE (the JAX function donated its cache and returned the
new one; this one returns the tensor it was given).

A length at or past ``T`` is clamped to ``T - 1``, as the JAX wrapper
clamps: it can spoil only the last position. A negative one writes
position 0.

int8 mode (:func:`batched_cache_append_int8`): the cache is a
``KVCache8``'s codes ``data [L, 2, B, n_kv, T, hd]`` int8 and ``scales
[L, 2, B, n_kv, T]`` f32, head_dim 128 or 64 (Falcon-7B, BLOOM). The
kernel quantizes every row of ``kv`` as :func:`quantize_kv` does and
writes its codes and its scale at the row's position, clamped as above. JAX does this with ``quantize_kv`` and a
per-row ``dynamic_update_slice`` loop in XLA (``models/llama.py:1313-1325``
and ``:1015-1027``); the kernel is bit-equal to it.

With ``tables [B, MP]`` (int32 page ids) the cache is a page pool ``[L, 2,
NP, n_kv, page, hd]`` and row ``b``'s position ``p`` lives at page
``tables[b, p // page]``, offset ``p % page``: the stacked paged step's one
append per step (JAX does it with a per-row ``dynamic_update_slice`` loop,
``models/llama.py:1729-1736``), with ``T = MP * page`` for the clamp.

:func:`batched_cache_append_plain` is the plain PyTorch version: the CPU
path and the reference the kernel is held to on the card, bit for bit. On
a CUDA tensor the wrapper launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

#: Launches of K7 on a slot cache, on a page pool and in int8 mode, counted
#: where the wrapper launches it.
LAUNCHES = {"cache_append": 0, "cache_append_paged": 0, "cache_append_int8": 0}
#: The head_dims of K7's int8 mode: a warp a row at 128, a half-warp at 64.
INT8_HEAD_DIMS = (64, 128)


def quantize_kv(k: torch.Tensor):
    """Symmetric int8 over the last axis (head_dim), one scale per row: the
    JAX package's ``quantize_kv`` (``models/llama.py:391``) as its callers
    run it, under ``jit``, bit for bit. ``k [..., hd]`` -> ``(codes int8
    [..., hd], scales f32 [...])`` with ``s = max(absmax(f32(k)), 1e-6) *
    f32(1/127)`` and ``q = clip(round_half_even(f32(k) / s), -127, 127)``.
    The JAX source writes ``/ 127.0``, but XLA turns a division by a
    constant into a multiplication by its reciprocal; the division of the
    codes is by a tensor and stays a true one."""
    kf = k.float()
    s = torch.clamp_min(kf.abs().amax(dim=-1), 1e-6) * (1.0 / 127.0)
    q = torch.clamp(torch.round(kf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def dequantize_kv(codes: torch.Tensor, scales: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """``f32(codes) * scales`` over the last axis, in ``dtype``."""
    return (codes.float() * scales[..., None]).to(dtype)


def batched_cache_append_plain(cache: torch.Tensor, kv: torch.Tensor,
                               lengths: torch.Tensor,
                               tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K7: one indexed assignment, in place."""
    b = kv.shape[2]
    rows = torch.arange(b, device=cache.device)
    if tables is None:
        where = rows
        pos = lengths.to(device=cache.device, dtype=torch.long).clamp(0, cache.shape[4] - 1)
    else:
        page = cache.shape[4]
        t = tables.shape[1] * page
        p = lengths.to(device=cache.device, dtype=torch.long).clamp(0, t - 1)
        where = tables.to(cache.device).long()[rows, p // page]
        pos = p % page
    # cache[:, :, where[b], :, pos[b]] <- kv[:, :, b]: the indexed view is [B, L, 2, n_kv, hd]
    cache[:, :, where, :, pos] = kv.to(cache.dtype).permute(2, 0, 1, 3, 4)
    return cache


def batched_cache_append_int8_plain(data: torch.Tensor, scales: torch.Tensor,
                                    kv: torch.Tensor,
                                    lengths: torch.Tensor) -> None:
    """Plain version of K7's int8 mode: :func:`quantize_kv` of ``kv`` and one
    indexed assignment each of the codes and the scales, in place."""
    b = kv.shape[2]
    rows = torch.arange(b, device=data.device)
    pos = lengths.to(device=data.device, dtype=torch.long).clamp(0, data.shape[4] - 1)
    q, s = quantize_kv(kv.to(data.device))
    data[:, :, rows, :, pos] = q.permute(2, 0, 1, 3, 4)
    scales[:, :, rows, :, pos] = s.permute(2, 0, 1, 3)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"batched_cache_append: {msg}")


def batched_cache_append_int8(data: torch.Tensor, scales: torch.Tensor,
                              kv: torch.Tensor, lengths: torch.Tensor) -> None:
    """K7's int8 mode: quantize ``kv [L, 2, B, n_kv, hd]`` (bf16 or f32) per
    row and write the codes into ``data [L, 2, B, n_kv, T, hd]`` int8 and the
    scales into ``scales [L, 2, B, n_kv, T]`` f32 at the per-row positions
    ``lengths [B]`` (int32, on the cache's device), in place."""
    if data.device.type == "cpu":
        return batched_cache_append_int8_plain(data, scales, kv, lengths)
    _check(data.is_cuda, f"unsupported device {data.device}")
    _check(data.dim() == 6 and data.shape[1] == 2 and data.dtype == torch.int8,
           f"data must be int8 [L, 2, B, n_kv, T, hd], got {data.dtype} "
           f"{tuple(data.shape)}")
    L, _, b, nkv, t, hd = data.shape
    if hd not in INT8_HEAD_DIMS:
        raise NotImplementedError(
            f"batched_cache_append_int8: head_dim {hd}; the int8 mode is built for "
            f"{' and '.join(map(str, INT8_HEAD_DIMS))} (other head_dims wait for their "
            "model families, ROADMAP queue A, item 12)")
    _check(tuple(scales.shape) == (L, 2, b, nkv, t) and scales.dtype == torch.float32,
           f"scales must be f32 [{L}, 2, {b}, {nkv}, {t}]")
    _check(tuple(kv.shape) == (L, 2, b, nkv, hd)
           and kv.dtype in (torch.bfloat16, torch.float32),
           f"kv must be bf16 or f32 [{L}, 2, {b}, {nkv}, {hd}], got {kv.dtype} "
           f"{tuple(kv.shape)}")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,),
           f"lengths must be int32 [{b}]")
    _check(all(x.device == data.device for x in (scales, kv, lengths)),
           "operands on different devices")
    _check(all(x.is_contiguous() for x in (data, scales, kv, lengths)),
           "operands must be contiguous")

    from awq_tpu_torch import _build

    lib = _build.load("cache_append")
    fn = lib.awq_cache_append_int8
    _build.declare(fn, *([_build.P] * 4), *([_build.I] * 6), _build.P)
    err = fn(data.data_ptr(), scales.data_ptr(), kv.data_ptr(), lengths.data_ptr(),
             L * 2 * b * nkv, b, nkv, t, int(kv.dtype == torch.float32), hd,
             torch.cuda.current_stream(data.device).cuda_stream)
    _build.check(lib, err, "cache_append_int8")
    LAUNCHES["cache_append_int8"] += 1


def batched_cache_append(cache: torch.Tensor, kv: torch.Tensor,
                         lengths: torch.Tensor,
                         tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 wrapper: scatter ``kv [L, 2, B, n_kv, hd]`` into ``cache
    [L, 2, B, n_kv, T, hd]`` at the per-row positions ``lengths [B]``
    (int32, on the cache's device), in place; with ``tables [B, MP]`` (int32,
    same device) into the page pool ``cache [L, 2, NP, n_kv, page, hd]``.
    Returns ``cache``."""
    if cache.device.type == "cpu":
        return batched_cache_append_plain(cache, kv, lengths, tables)
    _check(cache.is_cuda, f"unsupported device {cache.device}")
    _check(cache.dim() == 6 and cache.shape[1] == 2,
           f"cache must be [L, 2, B, n_kv, T, hd], got {tuple(cache.shape)}")
    L, _, slots, nkv, t, hd = cache.shape
    b = kv.shape[2] if tables is not None else slots
    _check(tuple(kv.shape) == (L, 2, b, nkv, hd),
           f"kv must be [{L}, 2, {b}, {nkv}, {hd}], got {tuple(kv.shape)}")
    _check(kv.dtype == cache.dtype, f"kv is {kv.dtype}, the cache {cache.dtype}")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,),
           f"lengths must be int32 [{b}]")
    _check(kv.device == cache.device and lengths.device == cache.device,
           "operands on different devices")
    _check(cache.is_contiguous() and kv.is_contiguous() and lengths.is_contiguous(),
           "operands must be contiguous")
    row_bytes = hd * cache.element_size()
    _check(row_bytes % 16 == 0 and cache.data_ptr() % 16 == 0
           and kv.data_ptr() % 16 == 0,
           "rows must be 16-byte multiples, 16-byte aligned")

    from awq_tpu_torch import _build

    lib = _build.load("cache_append")
    stream = torch.cuda.current_stream(cache.device).cuda_stream
    if tables is not None:
        mp = tables.shape[1] if tables.dim() == 2 else 0
        _check(tables.dtype == torch.int32 and tuple(tables.shape) == (b, mp) and mp > 0
               and tables.device == cache.device and tables.is_contiguous(),
               f"tables must be contiguous int32 [{b}, MP] on {cache.device}")
        fn = lib.awq_cache_append_paged
        _build.declare(fn, *([_build.P] * 4), *([_build.I] * 7), _build.P)
        err = fn(cache.data_ptr(), kv.data_ptr(), lengths.data_ptr(), tables.data_ptr(),
                 L * 2 * b * nkv, b, nkv, slots, t, mp, row_bytes, stream)
        _build.check(lib, err, "cache_append_paged")
        LAUNCHES["cache_append_paged"] += 1
        return cache
    fn = lib.awq_cache_append
    _build.declare(fn, *([_build.P] * 3), *([_build.I] * 5), _build.P)
    err = fn(cache.data_ptr(), kv.data_ptr(), lengths.data_ptr(),
             L * 2 * b * nkv, b, nkv, t, row_bytes, stream)
    _build.check(lib, err, "cache_append")
    LAUNCHES["cache_append"] += 1
    return cache
