"""Chunked-prefill megakernel (PyTorch port of
``awq_tpu/ops/megakernel_chunk.py``).

:func:`w4a16_llama_chunk_step` runs ALL decoder layers for a window of
``s`` tokens (1..``CHUNK_S``) of one sequence at ``[hist, hist + s)`` in
ONE launch of kernel K5, the chunk mode of K6's body
(``csrc/megakernel_batched.cu`` built with ``AWQ_MEGA_CHUNK``): the
multi-round chat prefill. Window row ``i`` attends to the cache ``[0,
hist)`` and to window rows ``0..i``, causally. Its schedule is K6's plan
(``megakernel_batched.batched_plan`` with ``cluster`` > 0): thread-block
clusters of ``CLUSTER`` blocks split each matmul's input channels, so that
a block stages its rows over a ``1/CLUSTER`` share of them.

The arithmetic follows the JAX kernel's (``_cchunk_kernel``), rounding
points included: every matmul consumes ``bf16(x)`` with per-group scale
and szero corrections in f32; the QKV and gate/up outputs are rounded to
bf16 (the JAX kernel's bf16 scratch), the QKV bias is added after that
rounding; ``hm = bf16(silu(gate) * up)``; the residual is f32 within a
layer and rounded to bf16 between layers. The window's own k/v enter its
attention in f32 here, as JAX's in-register causal tail does; the kernel's
tensor-core attention keeps q, k and P at about f32's precision (hi and lo
halves of the mma type) and V in the mma type.

JAX pads the window to ``CHUNK_S`` rows and lets the caller append the
first ``s`` k/v rows. Here there is no padding: the kernel (or the plain
version on the CPU) writes the window's k/v into the cache IN PLACE at
``[hist, hist + s)``, and returns them too, in the cache dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from awq_tpu_torch.ops import megakernel_batched as mkb
from awq_tpu_torch.ops.megakernel import (
    HEAD_DIM,
    _CACHE_CODE,
    _DTYPE_CODE,
    _fail,
    check_operands,
    check_small,
    launch,
    megakernel_supported,
    model_shape,
    qdot_layer,
    qlinear_ptrs,
    rms_rows,
    rope_rows,
)

#: Launches of K5 in W4 and in W3 mode, counted where the wrapper launches it.
LAUNCHES = {"megakernel_chunk": 0, "megakernel_chunk_w3": 0}

CHUNK_S = 32      # most window rows per launch, as in the JAX kernel
CLUSTER = 2       # blocks a thread-block cluster: they split IC and merge in rank order


def chunk_megakernel_supported(cfg, layers, cache, s: int) -> bool:
    """A window of 1..``CHUNK_S`` tokens under the single-token gate
    (:func:`~awq_tpu_torch.ops.megakernel.megakernel_supported`); the
    JAX gate's VMEM budget for 32 activation rows is a TPU fact. An int8
    ``KVCache8`` is refused, as JAX refuses it (``megakernel_chunk.py:269``,
    and ``forward`` gates its chunk kernel on ``not is_q8``), and so is K4's
    MPT shape: JAX's chunk gate takes rope and RMSNorm only
    (``awq_tpu/models/llama.py:698-701``)."""
    return (0 < s <= CHUNK_S and not isinstance(cache, tuple)
            and model_shape(cfg) == "llama" and megakernel_supported(cfg, layers, cache))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def attend_window(qs, keys, vals, hist, dtype):
    """The window's attention in f32: ``qs [s, nkv, grp, hd]`` (roped and
    scaled) over ``keys``/``vals [nkv, hist + s, hd]`` (the cache's ``[0,
    hist)`` and the window's own f32 k/v; ``dtype`` the cache's), window row
    ``i`` seeing positions ``[0, hist + i]``; returns ``[s, nkv, grp, hd]``."""
    s = qs.shape[0]
    causal = torch.arange(s)[None, :] <= torch.arange(s)[:, None]     # [i, j]
    mask = torch.cat([torch.ones((s, hist), dtype=torch.bool), causal], dim=1)
    mask = mask.to(qs.device)
    sc = torch.einsum("ikgh,kth->kgit", qs, keys)
    sc = sc.masked_fill(~mask, float("-inf"))
    return torch.einsum("kgit,kth->ikgh", torch.softmax(sc, dim=-1), vals)


def w4a16_llama_chunk_step_plain(h, wqkv, wo, wgu, wdn, ln1, ln2, cos_rows,
                                 sin_rows, cache, hist, nq, nkv, eps=1e-5):
    """Plain version of K5: ``(h_new [s, H] in h.dtype, k_new, v_new
    [L, nkv, s, hd] in the cache dtype)``; writes the cache."""
    hd = HEAD_DIM
    s = h.shape[0]
    grp = nq // nkv
    hist = int(hist)
    cos, sin = cos_rows.float()[:, None, :], sin_rows.float()[:, None, :]
    hh = h.float()
    ks, vs = [], []
    for l in range(cache.shape[0]):
        qkv = _bf16(qdot_layer(wqkv, l, rms_rows(hh, ln1[l], eps)))
        if wqkv.bias is not None:
            qkv = qkv + wqkv.bias[l].float()
        q = rope_rows(qkv[:, :nq * hd].reshape(s, nq, hd), cos, sin)
        k = rope_rows(qkv[:, nq * hd:(nq + nkv) * hd].reshape(s, nkv, hd), cos, sin)
        v = qkv[:, (nq + nkv) * hd:].reshape(s, nkv, hd)
        keys = torch.cat([cache[l, 0, 0, :, :hist].float(), k.transpose(0, 1)], dim=1)
        vals = torch.cat([cache[l, 1, 0, :, :hist].float(), v.transpose(0, 1)], dim=1)
        qs = (q * (1.0 / math.sqrt(hd))).reshape(s, nkv, grp, hd)
        attn = attend_window(qs, keys, vals, hist, cache.dtype)
        cache[l, 0, 0, :, hist:hist + s] = k.transpose(0, 1).to(cache.dtype)
        cache[l, 1, 0, :, hist:hist + s] = v.transpose(0, 1).to(cache.dtype)
        h1 = hh + qdot_layer(wo, l, attn.reshape(s, nq * hd))
        gu = _bf16(qdot_layer(wgu, l, rms_rows(h1, ln2[l], eps)))
        gate, up = gu.chunk(2, dim=-1)
        hm = _bf16(gate * torch.sigmoid(gate) * up)
        hh = _bf16(h1 + qdot_layer(wdn, l, hm))
        ks.append(k.transpose(0, 1))
        vs.append(v.transpose(0, 1))
    return (hh.to(h.dtype), torch.stack(ks).to(cache.dtype),
            torch.stack(vs).to(cache.dtype))


def w4a16_llama_chunk_step(h, wqkv, wo, wgu, wdn, ln1, ln2, cos_rows,
                           sin_rows, cache, hist, nq, nkv, eps=1e-5):
    """All decoder layers for the window ``h [s, H]`` at ``[hist, hist+s)``
    in one launch of K5. ``cos_rows``/``sin_rows [s, hd]`` f32 are the
    rope rows of the window's positions. Returns ``(h_new [s, H], k_new,
    v_new [L, nkv, s, hd])``; the cache is written at ``[hist, hist+s)``.
    The caller runs the final norm and head on the rows it needs."""
    if cache.device.type == "cpu":
        return w4a16_llama_chunk_step_plain(h, wqkv, wo, wgu, wdn, ln1, ln2,
                                            cos_rows, sin_rows, cache, hist,
                                            nq, nkv, eps)
    what = "megakernel_chunk"
    dev = cache.device
    if not cache.is_cuda:
        _fail(what, f"unsupported device {dev}")
    s = h.shape[0]
    if not 0 < s <= CHUNK_S:
        _fail(what, f"window of {s} rows; the kernel takes 1..{CHUNK_S}")
    L, H, inter, w3 = check_operands(what, h, (wqkv, wo, wgu, wdn), ln1, ln2,
                                     cache, nq, nkv, s)
    T = cache.shape[4]
    hist = int(hist)
    if hist < 0 or hist + s > T:
        _fail(what, f"window [{hist}, {hist + s}) outside the cache (T={T})")
    check_small(what, dev, None, h=h, ln1=ln1, ln2=ln2, cache=cache)
    check_small(what, dev, torch.float32, cos_rows=cos_rows, sin_rows=sin_rows)
    if tuple(cos_rows.shape) != (s, HEAD_DIM) or tuple(sin_rows.shape) != (s, HEAD_DIM):
        _fail(what, f"cos/sin rows must be [{s}, {HEAD_DIM}]")
    bias = wqkv.bias
    check_small(what, dev, h.dtype, bias=bias)
    unit = "megakernel_chunk_" + {torch.float32: "f32", torch.bfloat16: "bf16",
                                  torch.float16: "f16"}[cache.dtype] + ("_w3" if w3 else "")
    # clusters of CLUSTER blocks split IC; a model too narrow to give every
    # rank a chunk takes clusters of one
    cl = CLUSTER if min(H, inter) // mkb.chunk_channels(bool(w3)) >= CLUSTER else 1
    grid = _card_grid(dev.index if dev.index is not None else torch.cuda.current_device(),
                      unit, cl)
    try:
        plan = mkb._chunk_plan_ints(s, H, inter, nq, nkv, bool(w3), grid, cl)
    except ValueError as e:
        _fail(what, f"no plan for this launch: {e}")
    _, nsplit, split = mkb.chunk_slices(s, hist, nq, nkv, grid)
    out = torch.empty_like(h)
    k_new = torch.empty((L, nkv, s, HEAD_DIM), dtype=cache.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    # K6's operands, with no lengths, head, logits, page tables or int8 scales
    ptrs = ([h.data_ptr(), out.data_ptr()]
            + qlinear_ptrs(wqkv, dev) + [bias.data_ptr() if bias is not None else 0]
            + qlinear_ptrs(wo, dev) + qlinear_ptrs(wgu, dev) + qlinear_ptrs(wdn, dev)
            + [ln1.data_ptr(), ln2.data_ptr(), cos_rows.data_ptr(),
               sin_rows.data_ptr(), cache.data_ptr(), k_new.data_ptr(),
               v_new.data_ptr()] + [0] * 8)
    ints = [s, L, H, inter, nq, nkv, T, hist + s - 1, 0, _DTYPE_CODE[h.dtype],
            _CACHE_CODE[cache.dtype], int(bias is not None), 0, 0, 0, int(w3), *plan,
            hist, nsplit, split]
    launch("awq_mega_chunk", unit, ptrs, ints, eps, dev)
    LAUNCHES["megakernel_chunk" + ("_w3" if w3 else "")] += 1
    return out, k_new, v_new


@functools.lru_cache(maxsize=None)
def _card_grid(index: int, unit: str, cluster: int) -> int:
    """The grid card ``index`` runs at once in clusters of ``cluster``
    blocks of K5 (the unit's ``awq_mega_chunk_grid``)."""
    from awq_tpu_torch import _build

    lib = _build.load(unit)
    fn = lib.awq_mega_chunk_grid
    _build.declare(fn, _build.I, _build.P)
    g = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(lib, fn(cluster, ctypes.byref(g)), f"megakernel_chunk ({unit})")
    return g.value
